"""VoiceConverter (counterpart of ``autovc_tpu/voice_converter.py``):
``__init__``, ``_embed``, ``_speaker_embedding``, ``convert`` on its
``cut=True`` path, ``learn_speakers``, ``train`` (the AutoVC generator,
the GE2E speaker encoder and the vocoder), ``setup_logging`` and ``save``.

``convert`` runs the JAX package's fused accelerator chain
(``_fused_convert``): host preprocessing and slice geometry, then on the
device PCM16 wav -> AE mel chunks -> AutoVC generator with the overlap-add
merge -> WaveRNN generation -> PCM16 waveform, with only the wav going up
and the waveform coming back.  The kernels' packed weights (decoder lstm2,
the vocoder loop) are built once, at construction.

Each stage of ``convert`` is a ``torch.profiler`` range named
``convert/<stage>``.  Setting ``stage_times`` to a dict makes ``convert``
synchronise the device around each stage and record its wall seconds
there (for a breakdown; it adds the synchronisations).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from autovc_tpu_torch.audio import Audio, dsp, io
from autovc_tpu_torch.config import ConverterConfig
from autovc_tpu_torch.models import LoadedModel, load_model, save_model
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.utils import resolve_device, retrieve_file_paths
from autovc_tpu_torch.utils.logging import MetricsLogger


class VoiceConverter:
    def __init__(self,
                 auto_encoder: str | None = None,
                 speaker_encoder: str | None = None,
                 vocoder: str | None = None,
                 config: ConverterConfig | None = None,
                 auto_encoder_params: Dict[str, Any] | None = None,
                 speaker_encoder_params: Dict[str, Any] | None = None,
                 vocoder_params: Dict[str, Any] | None = None,
                 wandb_params: Dict[str, Any] | None = None,
                 verbose: bool = True,
                 ae_precision: str | None = "auto",
                 vocoder_backend: str | None = None, *,
                 vocoder_precision: str = "auto",
                 device=None, seed: int = 0):
        """Build a converter from checkpoint paths + config overrides.

        The positional parameters are the JAX constructor's, in its order;
        ``wandb_params`` merges into ``config.wandb``.  ``ae_precision`` is
        the auto-encoder's matmul/conv policy and ``vocoder_precision`` the
        vocoder sampling loop's ("bf16" = the JAX package's
        ``fast_math``): each "f32", "bf16" or "auto" (None: "auto"; bf16
        on the GPU, f32 on the CPU).  ``vocoder_backend`` None, "auto" or
        "pallas" all mean the port's one sampling path (kernel 1 on the
        GPU, its plain loop on the CPU); the JAX package's "xla" scan is
        not ported.  Keyword-only, the port's own: ``device`` (None runs
        on the GPU and raises when there is none; ``"cpu"`` runs on the
        CPU) and ``seed`` (fresh parameters of the models with no
        checkpoint)."""
        if vocoder_backend == "xla":
            raise NotImplementedError(
                "vocoder_backend='xla' is not ported: the port has one "
                "sampling path, kernel 1 on the GPU and its plain loop on "
                "the CPU (ROADMAP, Queue 3, deliberate deviations)")
        if vocoder_backend not in (None, "auto", "pallas"):
            raise ValueError(f"unknown vocoder_backend {vocoder_backend!r}")
        cfg = config or ConverterConfig()
        if auto_encoder_params:
            cfg = cfg.with_overrides(auto_encoder=auto_encoder_params)
        if speaker_encoder_params:
            cfg = cfg.with_overrides(speaker_encoder=speaker_encoder_params)
        if vocoder_params:
            cfg = cfg.with_overrides(vocoder=vocoder_params)
        if wandb_params:
            cfg = cfg.with_overrides(wandb=wandb_params)
        self.config = cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        self.ae_precision = PREC.resolve(ae_precision or "auto", self.device)
        self.vocoder_precision = PREC.resolve(vocoder_precision, self.device)
        kw = dict(verbose=verbose, seed=seed, device=self.device)
        self.AE: LoadedModel = load_model(
            "auto_encoder", auto_encoder, cfg.auto_encoder.model_dir,
            cfg.auto_encoder, **kw)
        self.SE: LoadedModel = load_model(
            "speaker_encoder", speaker_encoder,
            cfg.speaker_encoder.model_dir, cfg.speaker_encoder, **kw)
        self.vocoder: LoadedModel = load_model(
            "vocoder", vocoder, cfg.vocoder.model_dir, cfg.vocoder, **kw)
        self._lstm2_packed = LK.pack(self.AE.params["decoder"]["lstm2"],
                                     self.ae_precision)
        self._vocoder_packed = WK.pack_weights(
            self.vocoder.params, self.vocoder.config,
            self.vocoder_precision == "bf16")
        self.stage_times: Dict[str, float] | None = None
        self.logger: MetricsLogger | None = None

    @contextlib.contextmanager
    def _stage(self, name: str):
        """One named stage of ``convert`` (see the module docstring)."""
        with torch.profiler.record_function(f"convert/{name}"):
            if self.stage_times is None:
                yield
                return
            sync = (torch.cuda.synchronize if self.device.type == "cuda"
                    else (lambda: None))
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            self.stage_times[name] = time.perf_counter() - t0

    @property
    def speakers(self) -> Dict[str, np.ndarray]:
        """Mean-speaker embedding registry (rides in the SE checkpoint)."""
        return self.SE.speakers

    def _embed(self, audio: Audio) -> np.ndarray:
        """d-vector of an utterance, at the SE's native sample rate."""
        from autovc_tpu_torch.models import speaker_encoder as SEm
        wav = audio.wav
        if audio.sr != self.SE.config.spectrogram.sr:
            wav = io.resample(wav, audio.sr, self.SE.config.spectrogram.sr)
        return SEm.embed_utterances(self.SE.params, [wav], self.SE.config,
                                    self.device)[0]

    def _speaker_embedding(self, target, preprocess, preprocess_args,
                           sr) -> np.ndarray:
        """Registry lookup by name, else embed the utterance (path or
        :class:`Audio`)."""
        if isinstance(target, str) and target in self.speakers:
            return np.asarray(self.speakers[target])
        audio = Audio(target, sr) if isinstance(target, str) else target
        audio.preprocess(*preprocess, **preprocess_args)
        return self._embed(audio)

    def _ae_params(self, use_ema: bool):
        if not use_ema:
            return self.AE.params
        ema = self.AE.extras.get("ema_params")
        if ema is None:
            raise ValueError("use_ema=True but the auto-encoder checkpoint "
                             "carries no 'ema_params'")
        return ema

    def _fused_convert(self, wav, c_source, c_target, ae_cfg, overlap,
                       seed, ae_params, lstm2_packed) -> np.ndarray:
        """Slice geometry on the host, then the device chain wav -> mel
        chunks -> AE -> vocoder -> PCM16 (``voice_converter.py:188-225``)."""
        from autovc_tpu_torch.models import autoencoder as AEm
        from autovc_tpu_torch.models import wavernn as WRm
        from autovc_tpu_torch.ops import melspec as MEL

        dev = self.device
        mel_cfg = ae_cfg.spectrogram
        wav_slices, mel_slices = dsp.compute_partial_slices(
            len(wav), mel_cfg.sr,
            partial_utterance_n_frames=mel_cfg.partial_utterance_n_frames,
            overlap=overlap, mel_window_step=mel_cfg.mel_window_step)
        wav_p = dsp.pad_for_slices(np.asarray(wav), wav_slices)
        starts = tuple(int(s.start) for s in mel_slices)
        N = mel_cfg.partial_utterance_n_frames
        total_frames = N + (len(starts) - 1) * int(N * (1 - overlap))
        wr_cfg = self.vocoder.config
        g = wr_cfg.generate
        target = (WRm.auto_fold_target((total_frames - 1) * wr_cfg.hop_length,
                                       g.overlap, wr_cfg)
                  if g.auto_target else g.target)
        mu_law = g.mu_law and wr_cfg.mode == "RAW"
        with torch.inference_mode():
            with self._stage("mel"):
                wav_i16 = torch.from_numpy(MEL.pcm16_quantise(wav_p)).to(dev)
                chunks = MEL._slice_mel(wav_i16, mel_cfg, starts, N)
            with self._stage("autoencoder"):
                c_src = torch.as_tensor(np.asarray(c_source, np.float32),
                                        device=dev)
                c_trg = torch.as_tensor(np.asarray(c_target, np.float32),
                                        device=dev)
                post = AEm.batch_forward(ae_params, chunks, c_src, c_trg,
                                         ae_cfg, overlap, self.ae_precision,
                                         lstm2_packed)
            with self._stage("vocoder"):
                gen = torch.Generator(device=dev).manual_seed(seed)
                out = WRm._generate_program(
                    self.vocoder.params, post[None], gen, wr_cfg, target,
                    g.overlap, g.batched, mu_law,
                    self.vocoder_precision == "bf16", self._vocoder_packed)
                pcm = torch.clamp(torch.round(out * 32767.0), -32767,
                                  32767).to(torch.int16)
            with self._stage("download"):
                return pcm.cpu().numpy().astype(np.float32) / 32767.0

    def convert(self, source, target, sr: int | None = None,
                save_name=None, save_dir=None,
                preprocess=None, preprocess_args=None,
                outprocess=None, outprocess_args=None,
                cut: bool = True, overlap: float = 0.5,
                audio_log_dict: Dict[str, Any] | None = None, seed: int = 0,
                use_ema: bool = False,
                partial_frames: int | None = None) -> Audio:
        """Convert the content of ``source`` into the voice of ``target``.

        ``source``/``target`` are wav paths or :class:`Audio`; ``target``
        may also be a learned mean-speaker name.  ``save_name=False`` skips
        saving; ``save_dir="wandb"`` logs the audio (and ``audio_log_dict``)
        through the logger of :meth:`setup_logging` and writes no file.
        Only the ``cut=True`` path (overlapping mel chunks) is ported.
        Returns the converted :class:`Audio`."""
        if not cut:
            raise NotImplementedError("only convert(cut=True) is ported")
        cc = self.config.convert
        sr = sr or cc.sr
        preprocess = cc.preprocess if preprocess is None else preprocess
        preprocess_args = dict(cc.preprocess_args if preprocess_args is None
                               else preprocess_args)
        outprocess = cc.outprocess if outprocess is None else outprocess
        outprocess_args = dict(cc.outprocess_args if outprocess_args is None
                               else outprocess_args)
        if self.verbose:
            print(f"Converting '{source}' -> '{target}'...")
        t0 = time.time()

        with self._stage("preprocess"):
            audio_src = (Audio(source, sr) if isinstance(source, str)
                         else source)
            audio_src.preprocess(*preprocess, **preprocess_args)
        with self._stage("embed_source"):
            c_source = self._embed(audio_src)[None]
        with self._stage("embed_target"):
            c_target = self._speaker_embedding(target, preprocess,
                                               preprocess_args, sr)[None]
        ae_cfg = self.AE.config
        if partial_frames is not None:
            if partial_frames < ae_cfg.freq:
                raise ValueError(
                    f"partial_frames must be >= the encoder's downsampling "
                    f"freq ({ae_cfg.freq}): shorter chunks produce no "
                    f"forward content codes")
            ae_cfg = ae_cfg.with_overrides(
                spectrogram={"partial_utterance_n_frames": partial_frames})
        mel_cfg = ae_cfg.spectrogram
        waveform = self._fused_convert(
            audio_src.wav, c_source, c_target, ae_cfg, overlap, seed,
            self._ae_params(use_ema), None if use_ema else self._lstm2_packed)

        with self._stage("outprocess"):
            audio_out = Audio(waveform, sr=sr, sr_org=mel_cfg.sr)
            audio_out.preprocess(*outprocess, **outprocess_args)
        if self.verbose:
            dur = len(audio_out.wav) / audio_out.sr
            dt = time.time() - t0
            print(f"  {dur:.2f}s audio in {dt:.2f}s "
                  f"({dur / dt:.2f}x realtime)")
        if save_name is False:
            return audio_out
        if save_name is None:
            src_name = (os.path.splitext(os.path.basename(source))[0]
                        if isinstance(source, str) else "source")
            trg_name = os.path.splitext(os.path.basename(str(target)))[0]
            save_name = f"{src_name}_to_{trg_name}.wav"
        if save_dir == "wandb":
            assert self.logger is not None, \
                "setup_logging() must run before save_dir='wandb'"
            self.logger.log_audio(save_name.replace(".wav", ""),
                                  audio_out.wav, audio_out.sr,
                                  caption=save_name)
            if audio_log_dict:
                self.logger.log(audio_log_dict)
            return audio_out
        # as the JAX package: under results/ unless save_dir already is
        if save_dir is None:
            save_dir = "results"
        elif not save_dir.startswith("results"):
            save_dir = os.path.join("results", save_dir)
        os.makedirs(save_dir, exist_ok=True)
        out_path = os.path.join(save_dir, save_name)
        audio_out.save(out_path)
        if self.verbose:
            print(f"  saved '{out_path}'")
        return audio_out

    def learn_speakers(self, mean_speaker_path,
                       mean_speaker_path_excluded=()):
        """Learn mean speaker embeddings into :attr:`speakers` (which
        ``save("speaker_encoder", ...)`` writes).  ``mean_speaker_path``:
        dict name -> path, or a list of 'name=path' strings."""
        from autovc_tpu_torch.models import speaker_encoder as SEm
        if not isinstance(mean_speaker_path, dict):
            try:
                mean_speaker_path = {
                    k.strip(): v.strip()
                    for k, v in (arg.split("=") for arg in mean_speaker_path)}
            except Exception as e:
                raise ValueError(
                    "mean_speaker_path must be a dict or list of 'name=path' "
                    "strings") from e
        for speaker, path in mean_speaker_path.items():
            files = retrieve_file_paths(path,
                                        list(mean_speaker_path_excluded))
            if self.verbose:
                print(f"Learning mean embedding for '{speaker}' "
                      f"({len(files)} files)...")
            self.speakers[speaker] = SEm.learn_speaker(
                self.SE.params, files, self.SE.config, self.device)
        return self.speakers

    def train(self, data_path, model_type: str = "auto_encoder", **kwargs):
        """Train one of the models (``autovc_tpu.train.train_model``):
        ``"auto_encoder"``, ``"speaker_encoder"`` or ``"vocoder"``.  Runs
        on the converter's device.  The kernels' packed weights of a
        trained auto-encoder (lstm2's) or vocoder (the sampling loop's) are
        rebuilt afterwards, so ``convert`` runs with them; the speaker
        encoder packs its weights per call."""
        from autovc_tpu_torch import train as train_mod
        if model_type not in ("auto_encoder", "speaker_encoder", "vocoder"):
            raise ValueError(f"'{model_type}' is not a supported model_type")
        self.setup_logging()
        info = train_mod.train_model(self, model_type, data_path, **kwargs)
        with torch.no_grad():
            if model_type == "auto_encoder":
                self._lstm2_packed = LK.pack(
                    self.AE.params["decoder"]["lstm2"], self.ae_precision)
            elif model_type == "vocoder":
                self._vocoder_packed = WK.pack_weights(
                    self.vocoder.params, self.vocoder.config,
                    self.vocoder_precision == "bf16")
        return info

    def setup_logging(self, **params) -> MetricsLogger:
        if self.logger is None:
            self.logger = MetricsLogger(
                self.config.wandb,
                run_config={"config": "autovc_tpu_torch"}, **params)
        return self.logger

    def save(self, model_type: str, model_name: str, save_dir=None) -> str:
        """Write one model as a v2 ``.ckpt`` (readable by both packages)."""
        model: LoadedModel = {"auto_encoder": self.AE,
                              "speaker_encoder": self.SE,
                              "vocoder": self.vocoder}[model_type]
        path = save_model(model, model_name, save_dir)
        if self.logger is not None:
            self.logger.log_artifact(path, model_name, model_type)
        return path
