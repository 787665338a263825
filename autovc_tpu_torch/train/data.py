"""Training data (counterpart of ``autovc_tpu/train/data.py``'s
``AutoEncoderDataset``, ``SpeakerEncoderDataset`` and ``VocoderDataset``).

Host-side numpy, with the JAX package's random draws (``default_rng(seed)``)
and drop rules, so the same files give the same batches in both packages.
AutoVC: mel chunks and one embedding per file, the embedding from the
mean-speaker registry when the filename matches a speaker's name, else
from ``embed_utterance`` on ``device``.  Speaker encoder: each speaker's
host-mel partials, drawn into (speakers, utterances, frames, mels) GE2E
blocks.  WaveRNN: random aligned windows of mel frames and waveform
samples.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from autovc_tpu_torch.audio import Audio, dsp
from autovc_tpu_torch.config import (AutoEncoderConfig, MelConfig,
                                     SpeakerEncoderConfig, WaveRNNConfig)
from autovc_tpu_torch.utils import (close_progbar, progbar,
                                    retrieve_file_paths)


class AutoEncoderDataset:
    """(mel chunk, speaker embedding) pairs for AutoVC training."""

    def __init__(self, data_path, speaker_encoder=None,
                 speaker_encoder_params=None, speakers=None,
                 data_path_excluded=(), use_mean_speaker_embedding=True,
                 one_hot: bool = False, cut: bool = True,
                 cfg: AutoEncoderConfig = AutoEncoderConfig(),
                 preprocess=("normalize_volume",),
                 preprocess_args={"target_dBFS": -20}, verbose=True,
                 device=None):
        """
        Args:
          speaker_encoder: SE params tree for the ``embed_utterance``
            fallback; ``speaker_encoder_params`` its config.
          speakers: mean-speaker registry dict (name -> embedding).
          device: where ``embed_utterance`` runs (None: the GPU, or raise).
        """
        from autovc_tpu_torch.audio import io as audio_io
        from autovc_tpu_torch.models import speaker_encoder as SEm

        se_cfg = speaker_encoder_params or SpeakerEncoderConfig()
        speakers = speakers or {}
        wav_files = retrieve_file_paths(data_path,
                                        excluded=list(data_path_excluded))
        self.wav_files = wav_files
        mels: List[np.ndarray] = []
        embeds: List[np.ndarray] = []
        if verbose:
            print("Creating mel spectrograms and embeddings...")
            progbar(0, len(wav_files))
        for i, f in enumerate(wav_files):
            audio = Audio(f, sr=cfg.spectrogram.sr)
            audio.preprocess(*preprocess, **preprocess_args)

            emb = None
            if one_hot:
                emb = np.zeros(cfg.dim_emb, np.float32)
                emb[i % cfg.dim_emb] = 1.0
            elif use_mean_speaker_embedding:
                for name, e in speakers.items():
                    if name in f:
                        emb = np.asarray(e, np.float32)
                        break
            if emb is None:
                if speaker_encoder is None:
                    raise ValueError(
                        f"no mean-speaker match for '{f}' and no "
                        "speaker_encoder given to embed it")
                wav16 = audio_io.resample(audio.wav, audio.sr,
                                          se_cfg.spectrogram.sr)
                emb = SEm.embed_utterance(speaker_encoder, wav16, se_cfg,
                                          device)

            if cut:
                chunks, _ = dsp.mel_spec_auto_encoder_sliced(
                    audio.wav, cfg.spectrogram)
                mels.extend(list(chunks))
                embeds.extend([emb] * len(chunks))
            else:
                mels.append(dsp.mel_spec_auto_encoder(audio.wav,
                                                      cfg.spectrogram))
                embeds.append(emb)
            if verbose:
                progbar(i + 1, len(wav_files))
        if verbose:
            close_progbar()

        self.cut = cut
        self.mels = mels
        self.embeds = embeds

    def __len__(self):
        return len(self.mels)

    def batches(self, batch_size: int = 16, shuffle: bool = True,
                seed: int = 0, drop_last: bool | None = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (mel (B, n_mels, T), embedding (B, emb)) float32 batches.

        With ``cut=True`` all chunks share T and the ragged final batch is
        dropped by default; with ``cut=False`` unequal-length mels are
        zero-padded to the longest in the batch."""
        n = len(self.mels)
        drop_last = self.cut if drop_last is None else drop_last
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = n - (n % batch_size) if (drop_last and n >= batch_size) else n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            ms = [self.mels[i] for i in idx]
            T = max(m.shape[-1] for m in ms)
            ms = [np.pad(m, ((0, 0), (0, T - m.shape[-1]))) for m in ms]
            yield (np.stack(ms).astype(np.float32),
                   np.stack([self.embeds[i] for i in idx]).astype(np.float32))

    def epoch_steps(self, batch_size: int = 16) -> int:
        n = len(self.mels)
        return (n // batch_size if self.cut and n >= batch_size
                else -(-n // batch_size))


class SpeakerEncoderDataset:
    """speaker -> list of fixed-length mel partials, batched as
    (speakers, utterances, frames, mels) GE2E blocks."""

    def __init__(self, data_path: Dict[str, Sequence[str]],
                 data_path_excluded=(), cut: bool = True,
                 cfg: SpeakerEncoderConfig = SpeakerEncoderConfig(),
                 preprocess=("normalize_volume",),
                 preprocess_args={"target_dBFS": -20}, verbose=True):
        """``data_path``: dict speaker name -> path or list of paths."""
        self.speaker_names = list(data_path.keys())
        self.datasets: List[List[np.ndarray]] = []
        for name in self.speaker_names:
            paths = data_path[name]
            if isinstance(paths, (str, bytes)):
                paths = [paths]
            files = []
            for p in paths:
                files.extend(retrieve_file_paths(
                    p, excluded=list(data_path_excluded)))
            partials: List[np.ndarray] = []
            if verbose:
                print(f"Speaker '{name}': {len(files)} files")
            for f in files:
                audio = Audio(f, sr=cfg.spectrogram.sr)
                audio.preprocess(*preprocess, **preprocess_args)
                if cut:
                    frames, _, _ = dsp.mel_spec_speaker_encoder_sliced(
                        audio.wav, cfg.spectrogram)
                    partials.extend(list(frames))
                else:
                    partials.append(dsp.mel_spec_speaker_encoder(
                        audio.wav, cfg.spectrogram))
            self.datasets.append(partials)
        if verbose:
            print("Dataset sizes:", [len(d) for d in self.datasets])

    def __len__(self):
        return max(len(d) for d in self.datasets)

    def batches(self, utterances_per_speaker: int = 8, n_batches: int = 8,
                seed: int = 0) -> Iterator[np.ndarray]:
        """Yield (S, U, frames, mels) float32 blocks, U partials a speaker
        drawn by ``default_rng(seed)``, with replacement (the ``j % len``
        wrap) where a speaker has fewer."""
        rng = np.random.default_rng(seed)
        S = len(self.datasets)
        for _ in range(n_batches):
            block = np.stack([
                np.stack([d[j % len(d)] for j in
                          rng.permutation(max(len(d),
                                              utterances_per_speaker))
                          [:utterances_per_speaker]])
                for d in self.datasets])
            assert block.shape[:2] == (S, utterances_per_speaker)
            yield block.astype(np.float32)


class VocoderDataset:
    """(x_in, y_target, mel) triplets for WaveRNN teacher-forced training:
    random aligned windows of ``seq_frames`` mel frames and the matching
    ``seq_frames * hop`` samples, the mel window pad-extended by ``pad``
    frames a side for the valid MelResNet convolution
    (``autovc_tpu/train/data.py:188-242``)."""

    def __init__(self, data_path, data_path_excluded=(),
                 mel_cfg: MelConfig | None = None,
                 vocoder_cfg: WaveRNNConfig | None = None,
                 preprocess=("normalize_volume",),
                 preprocess_args={"target_dBFS": -20}, verbose=True):
        self.mel_cfg = mel_cfg or MelConfig()
        self.cfg = vocoder_cfg or WaveRNNConfig()
        files = retrieve_file_paths(data_path,
                                    excluded=list(data_path_excluded))
        self.wavs: List[np.ndarray] = []
        self.mels: List[np.ndarray] = []
        for f in files:
            audio = Audio(f, sr=self.mel_cfg.sr)
            audio.preprocess(*preprocess, **preprocess_args)
            self.wavs.append(audio.wav)
            self.mels.append(dsp.mel_spec_auto_encoder(audio.wav,
                                                       self.mel_cfg))
        if verbose:
            print(f"Vocoder dataset: {len(files)} files")

    def batches(self, batch_size: int = 8, seq_frames: int = 9,
                n_batches: int = 50, seed: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield up to ``n_batches`` float32 batches (x_in (B, T), y (B, T),
        mel (B, n_mels, seq_frames + 2 * pad)), T = seq_frames * hop; y is
        x_in one sample ahead.  A draw from a file too short for the window
        is skipped (the batch is then smaller), as in the JAX package."""
        rng = np.random.default_rng(seed)
        hop, pad = self.cfg.hop_length, self.cfg.pad
        F = seq_frames + 2 * pad
        for _ in range(n_batches):
            xs, ys, ms = [], [], []
            for _ in range(batch_size):
                i = rng.integers(len(self.wavs))
                mel, wav = self.mels[i], self.wavs[i]
                max_start = mel.shape[-1] - F - 1
                if max_start <= 0:
                    continue
                s = int(rng.integers(0, max_start))
                ms.append(mel[:, s:s + F])
                w0 = (s + pad) * hop
                seg = wav[w0:w0 + seq_frames * hop + 1]
                seg = np.pad(seg, (0, seq_frames * hop + 1 - len(seg)))
                xs.append(seg[:-1])
                ys.append(seg[1:])
            if xs:
                yield (np.stack(xs).astype(np.float32),
                       np.stack(ys).astype(np.float32),
                       np.stack(ms).astype(np.float32))
