"""VoiceConverter (counterpart of ``autovc_tpu/voice_converter.py``):
``__init__``, ``_embed``, ``_embed_many``, ``_speaker_embedding``,
``convert`` (``cut=True`` and ``cut=False``, ``pad_to_seconds``),
``convert_batch``, ``convert_multiple``, ``learn_speakers``, ``train``
(the AutoVC generator, the GE2E speaker encoder and the vocoder),
``setup_logging`` (and its alias ``setup_wandb``), ``save`` and ``close``.
The multi-device paths run over a local mesh
(:mod:`autovc_tpu_torch.parallel`): ``convert(parallel="chunks")`` shards
the mel chunks over the positions, ``convert(parallel="ring")`` runs the
generator time-sharded over the unchunked mel, and
``convert_batch(parallel="pipeline")`` streams the utterances through a
generator stage and a vocoder stage.

``convert`` runs the JAX package's fused accelerator chain
(``_fused_convert``): host preprocessing and slice geometry, then on the
device PCM16 wav -> AE mel chunks -> AutoVC generator with the overlap-add
merge -> WaveRNN generation -> PCM16 waveform, with only the wav going up
and the waveform coming back.  ``cut=False`` converts the host mel of the
whole utterance in one generator pass (``autoencoder.infer``) and vocodes
it with ``wavernn.generate``.  ``convert_batch`` is batch serving: every
source's chunks through the slab-planned generator
(``autoencoder.batch_forward_packed``), every utterance's folds through
one sampling loop (``wavernn.generate_many``).  The kernels' packed
weights (decoder lstm2, the vocoder loop) are built at construction and
rebuilt by ``_pack_weights`` wherever training changes the parameters.

Each stage of ``convert`` is a ``torch.profiler`` range named
``convert/<stage>``.  Setting ``stage_times`` to a dict makes ``convert``
synchronise the device around each stage and record its wall seconds
there (for a breakdown; it adds the synchronisations).
"""
from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
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
        self._pack_weights("auto_encoder")
        self._pack_weights("vocoder")
        self.stage_times: Dict[str, float] | None = None
        self.logger: MetricsLogger | None = None

    @torch.no_grad()
    def _pack_weights(self, model_type: str) -> None:
        """Rebuild the kernels' packed weights of ``model_type`` from its
        current parameters: decoder lstm2's (``"auto_encoder"``) or the
        sampling loop's (``"vocoder"``).  ``convert`` runs lstm2 and the
        loop from these, not from the parameter tree, so whoever changes
        the parameters (``train``, the per-epoch examples) calls this."""
        if model_type == "auto_encoder":
            self._lstm2_packed = LK.pack(self.AE.params["decoder"]["lstm2"],
                                         self.ae_precision)
        elif model_type == "vocoder":
            self._vocoder_packed = WK.pack_weights(
                self.vocoder.params, self.vocoder.config,
                self.vocoder_precision == "bf16")

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

    def _embed_many(self, audios) -> torch.Tensor:
        """d-vectors of several utterances in one forward, as one (n, emb)
        tensor on the converter's device (``embed_utterances(...,
        block=False)``): the speaker encoder -> generator chain of batch
        serving never reads back."""
        from autovc_tpu_torch.models import speaker_encoder as SEm
        se_sr = self.SE.config.spectrogram.sr
        wavs = [a.wav if a.sr == se_sr else io.resample(a.wav, a.sr, se_sr)
                for a in audios]
        return SEm.embed_utterances(self.SE.params, wavs, self.SE.config,
                                    self.device, block=False)

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
                       seed, ae_params, lstm2_packed,
                       mesh=None) -> np.ndarray:
        """Slice geometry on the host, then the device chain wav -> mel
        chunks -> AE -> vocoder -> PCM16 (``voice_converter.py:188-225``).
        With ``mesh`` (``parallel="chunks"``) the chunks, zero-padded to a
        multiple of the mesh's data axis, convert over its data slices
        (``parallel.steps.chunk_sharded_convert``) and the merged mel comes
        back to the converter's device."""
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
                if mesh is None:
                    post = AEm.batch_forward(ae_params, chunks, c_src, c_trg,
                                             ae_cfg, overlap,
                                             self.ae_precision, lstm2_packed)
                else:
                    from autovc_tpu_torch.parallel import steps as psteps
                    M = len(starts)
                    padded = torch.nn.functional.pad(
                        chunks, (0, 0, 0, 0, 0, (-M) % mesh.data_size))
                    post = psteps.chunk_sharded_convert(
                        ae_params, padded, c_src, c_trg, M, ae_cfg, overlap,
                        self.ae_precision, mesh, lstm2_packed)
                    post = post[:, :total_frames].to(dev)
            with self._stage("vocoder"):
                gen = torch.Generator(device=dev).manual_seed(seed)
                out = WRm._generate_program(
                    self.vocoder.params, post[None], gen, wr_cfg, target,
                    g.overlap, g.batched, mu_law,
                    self.vocoder_precision == "bf16", self._vocoder_packed)
                pcm = WRm._pcm16(out)
            with self._stage("download"):
                return pcm.cpu().numpy().astype(np.float32) / 32767.0

    def _unchunked_convert(self, wav, c_source, c_target, ae_cfg, seed,
                           ae_params, lstm2_packed) -> np.ndarray:
        """``cut=False`` (``voice_converter.py:400-404``): the host mel of
        the whole utterance, one eval-mode generator pass over it
        (``autoencoder.infer``: lstm2 at one row over every frame), then
        ``wavernn.generate`` with the converter's packed loop weights."""
        from autovc_tpu_torch.models import autoencoder as AEm
        from autovc_tpu_torch.models import wavernn as WRm

        dev = self.device
        with torch.inference_mode():
            with self._stage("mel"):
                mel = dsp.mel_spec_auto_encoder(wav, ae_cfg.spectrogram)
                mel = torch.from_numpy(np.asarray(mel, np.float32)).to(dev)
            with self._stage("autoencoder"):
                post = AEm.infer(
                    ae_params, mel[None],
                    torch.as_tensor(np.asarray(c_source, np.float32),
                                    device=dev),
                    torch.as_tensor(np.asarray(c_target, np.float32),
                                    device=dev),
                    ae_cfg, self.ae_precision, lstm2_packed)
            with self._stage("vocoder"):
                return WRm.generate(
                    self.vocoder.params, post, self.vocoder.config,
                    torch.Generator(device=dev).manual_seed(seed),
                    fast_math=self.vocoder_precision == "bf16", device=dev,
                    packed=self._vocoder_packed)

    def _ring_convert(self, wav, c_source, c_target, ae_cfg, seed,
                      ae_params, mesh) -> np.ndarray:
        """``parallel="ring"`` (``voice_converter.py:347-363``): the host
        mel of the whole utterance, trimmed to a multiple of the mesh
        size, through the time-sharded generator
        (``parallel.ring.ring_autovc_infer``), then ``wavernn.generate``
        on the converter's device."""
        from autovc_tpu_torch.models import wavernn as WRm
        from autovc_tpu_torch.parallel import ring as pring

        n = int(mesh.shape["data"])
        dev0 = mesh.devices[0]
        with torch.inference_mode():
            with self._stage("mel"):
                mel = dsp.mel_spec_auto_encoder(wav, ae_cfg.spectrogram)
                Tn = (mel.shape[-1] // n) * n
                if Tn == 0:
                    raise ValueError(f"input too short for ring SP over {n} "
                                     f"devices ({mel.shape[-1]} mel frames)")
                x = torch.from_numpy(np.ascontiguousarray(
                    mel[None, :, :Tn], np.float32)).to(dev0)
            with self._stage("autoencoder"):
                post = pring.ring_autovc_infer(
                    ae_params, x,
                    torch.as_tensor(np.asarray(c_source, np.float32),
                                    device=dev0),
                    torch.as_tensor(np.asarray(c_target, np.float32),
                                    device=dev0),
                    ae_cfg, mesh, "data", self.ae_precision)
            with self._stage("vocoder"):
                return WRm.generate(
                    self.vocoder.params, post.to(self.device),
                    self.vocoder.config,
                    torch.Generator(device=self.device).manual_seed(seed),
                    fast_math=self.vocoder_precision == "bf16",
                    device=self.device, packed=self._vocoder_packed)

    def convert(self, source, target, sr: int | None = None,
                save_name=None, save_dir=None,
                preprocess=None, preprocess_args=None,
                outprocess=None, outprocess_args=None,
                cut: bool = True, overlap: float = 0.5,
                audio_log_dict: Dict[str, Any] | None = None, seed: int = 0,
                use_ema: bool = False, pad_to_seconds: float | None = None,
                partial_frames: int | None = None,
                parallel: str | None = None, mesh=None,
                fuse_dispatch: bool | None = None) -> Audio:
        """Convert the content of ``source`` into the voice of ``target``.

        ``source``/``target`` are wav paths or :class:`Audio`; ``target``
        may also be a learned mean-speaker name.  ``save_name=False`` skips
        saving; ``save_dir="wandb"`` logs the audio (and ``audio_log_dict``)
        through the logger of :meth:`setup_logging` and writes no file.
        ``cut=False`` converts the unchunked mel in one pass.
        ``pad_to_seconds=s`` zero-pads the preprocessed source up to a
        multiple of ``s`` seconds before embedding and converting, and
        trims the waveform to the span of the unpadded wav's slices.
        ``fuse_dispatch`` is accepted with any value and changes nothing:
        in the JAX package it chooses between one jitted program for mel,
        generator and vocoder (the wav uploaded as PCM16) and staged
        programs; the port always runs the chain of the first, issued on
        one stream and synchronised once, when the waveform comes back
        (``_fused_convert``).

        ``parallel`` spreads the generator over a local ``mesh``
        (``parallel.sharding.make_mesh(devices=...)``; None: every local
        CUDA device): ``"chunks"`` converts the same PCM16 mel chunks as
        the default path, split over the positions (it needs ``cut``);
        ``"ring"`` converts the unchunked host mel, trimmed to a multiple
        of the mesh size, time-sharded (not with ``pad_to_seconds``).  On
        a mesh with a 'model' axis both split over the 'data' axis alone,
        as the JAX paths do, each data slice on the first position of its
        model row with the generator's parameters whole.  Returns the
        converted :class:`Audio`."""
        if parallel not in (None, "chunks", "ring"):
            raise ValueError(f"parallel must be None, 'chunks' or 'ring', "
                             f"got {parallel!r}")
        if parallel == "chunks" and not cut:
            raise ValueError("parallel='chunks' shards the chunk axis; it "
                             "requires cut=True")
        if parallel == "ring" and pad_to_seconds:
            raise ValueError("pad_to_seconds trims by chunk geometry and "
                             "does not compose with parallel='ring'")
        from autovc_tpu_torch.parallel import sharding as shd
        if mesh is not None and not isinstance(mesh, shd.Mesh):
            raise TypeError(f"mesh must be an autovc_tpu_torch.parallel."
                            f"sharding.Mesh, got {type(mesh).__name__}")
        if parallel is not None:
            mesh = mesh or shd.make_mesh()
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
        true_samples = len(audio_src.wav)
        if pad_to_seconds:
            bucket = int(round(pad_to_seconds * audio_src.sr))
            pad = (-len(audio_src.wav)) % bucket
            if pad:
                audio_src.wav = np.pad(audio_src.wav, (0, pad))
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
        ae_params = self._ae_params(use_ema)
        lstm2_packed = None if use_ema else self._lstm2_packed
        if parallel == "ring":
            waveform = self._ring_convert(audio_src.wav, c_source, c_target,
                                          ae_cfg, seed, ae_params, mesh)
        elif cut:
            waveform = self._fused_convert(
                audio_src.wav, c_source, c_target, ae_cfg, overlap, seed,
                ae_params, lstm2_packed,
                mesh if parallel == "chunks" else None)
        else:
            waveform = self._unchunked_convert(
                audio_src.wav, c_source, c_target, ae_cfg, seed, ae_params,
                lstm2_packed)
        if pad_to_seconds:
            # keep exactly the span the unpadded slice set gives
            _, true_slices = dsp.compute_partial_slices(
                true_samples, mel_cfg.sr,
                partial_utterance_n_frames=mel_cfg.partial_utterance_n_frames,
                overlap=overlap, mel_window_step=mel_cfg.mel_window_step)
            waveform = waveform[:(true_slices[-1].stop - 1)
                                * mel_cfg.hop_length]

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

    def convert_batch(self, sources, target, sr: int | None = None,
                      preprocess=None, preprocess_args=None,
                      outprocess=None, outprocess_args=None,
                      overlap: float = 0.5, seed: int = 0,
                      save_dir=None, use_ema: bool = False,
                      parallel: str | None = None, devices=None):
        """Batch serving: many sources (wav paths or directories) into one
        target voice, each stage one pass over every utterance.

        Host preprocessing runs in a thread pool; then, on the calling
        thread, each source's PCM16 mel chunks on the device, one speaker
        encoder forward for all sources, every chunk through the
        slab-planned generator merged into one packed timeline, and every
        utterance's folds through one sampling loop; the outprocessing and
        the files (``{name}_to_{trg}.wav`` directly in ``save_dir``, as the
        JAX package writes them) in a thread pool again.  Returns a list of
        converted :class:`Audio`.

        ``parallel="pipeline"`` serves through two stages over the mesh
        positions ``devices`` (None: every local CUDA device; at least two,
        and they may repeat a device), ``parallel.pipeline.
        conversion_pipeline``: each utterance's chunks through the
        generator on the first group, then its own vocoder pass, seeded
        ``seed + i`` for utterance i, on the second, utterance i + 1's
        generator stage queued while utterance i vocodes."""
        from autovc_tpu_torch.models import autoencoder as AEm
        from autovc_tpu_torch.models import wavernn as WRm
        from autovc_tpu_torch.ops import melspec as MEL

        if parallel not in (None, "pipeline"):
            raise ValueError(f"parallel must be None or 'pipeline', "
                             f"got {parallel!r}")
        cc = self.config.convert
        sr = sr or cc.sr
        preprocess = cc.preprocess if preprocess is None else preprocess
        preprocess_args = dict(cc.preprocess_args if preprocess_args is None
                               else preprocess_args)
        outprocess = cc.outprocess if outprocess is None else outprocess
        outprocess_args = dict(cc.outprocess_args if outprocess_args is None
                               else outprocess_args)
        sources = retrieve_file_paths(sources)
        c_target = self._speaker_embedding(target, preprocess,
                                           preprocess_args, sr)[None]
        ae_cfg = self.AE.config

        def load(src):
            audio = Audio(src, sr)
            audio.preprocess(*preprocess, **preprocess_args)
            return audio

        workers = min(8, len(sources) or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            audios = list(ex.map(load, sources))
        with torch.inference_mode():
            all_chunks = [MEL.mel_spec_auto_encoder_sliced(
                a.wav, ae_cfg.spectrogram, overlap=overlap, pcm16=True,
                device=self.device)[0] for a in audios]
            c_orgs = self._embed_many(audios)
            lstm2_packed = None if use_ema else self._lstm2_packed
            if parallel == "pipeline":
                from autovc_tpu_torch.parallel import pipeline as ppipe
                pipe = ppipe.conversion_pipeline(
                    self._ae_params(use_ema), self.vocoder.params, ae_cfg,
                    self.vocoder.config, devices, overlap,
                    self.ae_precision, self.vocoder_precision == "bf16",
                    lstm2_packed, self._vocoder_packed)
                c_trg = torch.as_tensor(np.asarray(c_target, np.float32),
                                        device=self.device)
                wavs = [w.astype(np.float32) / 32767.0 for w in pipe.run(
                    [(chunks, c_orgs[i:i + 1], c_trg, seed + i)
                     for i, chunks in enumerate(all_chunks)])]
            else:
                packed, starts, lengths = AEm.batch_forward_packed(
                    self._ae_params(use_ema), all_chunks, c_orgs, c_target,
                    ae_cfg, overlap, self.ae_precision,
                    lstm2_packed=lstm2_packed)
                post_mels = [packed[:, s:s + L]
                             for s, L in zip(starts, lengths)]
                wavs = WRm.generate_many(
                    self.vocoder.params, post_mels, self.vocoder.config,
                    torch.Generator(device=self.device).manual_seed(seed),
                    fast_math=self.vocoder_precision == "bf16",
                    device=self.device, packed=self._vocoder_packed)

        trg = os.path.splitext(os.path.basename(str(target)))[0]

        def finish(src_wav):
            src, wav = src_wav
            audio_out = Audio(wav, sr=sr, sr_org=ae_cfg.spectrogram.sr)
            audio_out.preprocess(*outprocess, **outprocess_args)
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                name = os.path.splitext(os.path.basename(src))[0]
                audio_out.save(os.path.join(save_dir, f"{name}_to_{trg}.wav"))
            return audio_out

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(finish, zip(sources, wavs)))

    def convert_multiple(self, sources, targets,
                         match_method: str = "all_combinations",
                         bidirectional: bool = False, **convert_params):
        """One :meth:`convert` per (source, target) pair:
        ``"all_combinations"`` crosses every source with every target,
        ``"align"`` zips them; ``bidirectional`` also converts each target
        into each source.  A target may be a learned mean-speaker name (not
        with ``bidirectional``)."""
        sources = retrieve_file_paths(sources)
        target_args = [targets] if isinstance(targets, str) else list(targets)
        resolved = []
        for t in target_args:
            if t in self.speakers:
                if bidirectional:
                    raise ValueError("bidirectional conversion cannot source "
                                     "from a mean speaker embedding")
                resolved.append(t)
            else:
                resolved.extend(retrieve_file_paths(t))
        if match_method == "align":
            if len(sources) != len(resolved):
                raise ValueError(f"match_method='align' needs as many "
                                 f"sources as targets, got {len(sources)} "
                                 f"and {len(resolved)}")
            matches = list(zip(sources, resolved))
        elif match_method == "all_combinations":
            matches = list(product(sources, resolved))
        else:
            raise ValueError(f"unknown match_method {match_method!r}")
        audio_objects = [self.convert(s, t, **convert_params)
                         for s, t in matches]
        if bidirectional:
            audio_objects.extend(self.convert_multiple(
                resolved, sources, match_method, **convert_params))
        return audio_objects

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
        rebuilt afterwards (:meth:`_pack_weights`), so ``convert`` runs with
        them; the speaker encoder packs its weights per call.  The
        auto-encoder's ``source_examples`` / ``target_examples`` are
        converted after each epoch with that epoch's weights."""
        from autovc_tpu_torch import train as train_mod
        if model_type not in ("auto_encoder", "speaker_encoder", "vocoder"):
            raise ValueError(f"'{model_type}' is not a supported model_type")
        self.setup_logging()
        info = train_mod.train_model(self, model_type, data_path, **kwargs)
        self._pack_weights(model_type)
        return info

    def setup_logging(self, **params) -> MetricsLogger:
        if self.logger is None:
            self.logger = MetricsLogger(
                self.config.wandb,
                run_config={"config": "autovc_tpu_torch"}, **params)
        return self.logger

    # the reference's name (voice_converter.py:418), kept as an alias
    setup_wandb = setup_logging

    def save(self, model_type: str, model_name: str, save_dir=None) -> str:
        """Write one model as a v2 ``.ckpt`` (readable by both packages)."""
        model: LoadedModel = {"auto_encoder": self.AE,
                              "speaker_encoder": self.SE,
                              "vocoder": self.vocoder}[model_type]
        path = save_model(model, model_name, save_dir)
        if self.logger is not None:
            self.logger.log_artifact(path, model_name, model_type)
        return path

    def close(self):
        """Finish the logger's run and drop the logger."""
        if self.logger is not None:
            self.logger.finish()
            self.logger = None
