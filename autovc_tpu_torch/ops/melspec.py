"""Device mel front-ends (counterpart of ``autovc_tpu/ops/melspec.py``).

Same numerics as the numpy golden :mod:`autovc_tpu_torch.audio.dsp`
(librosa semantics: centre/reflect padding, periodic Hann zero-padded to
``n_fft``, slaney mel): the auto-encoder path is amplitude mel -> dB ->
[0, 1], the speaker-encoder path a power mel.  The STFT is ``torch.stft``
(cuFFT on the GPU) — the JAX package's DFT-as-matmul form is a TPU
layout choice, not part of the function.  int16 input is PCM16,
dequantised on the device as ``x / 32767``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import MelConfig, SpeakerMelConfig
from autovc_tpu_torch.utils import resolve_device


@functools.lru_cache(maxsize=8)
def _window(n_fft: int, win_length: int) -> np.ndarray:
    return dsp.padded_window(n_fft, win_length).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_fb(sr: int, n_fft: int, n_mels: int, fmin: float) -> np.ndarray:
    """(n_bins, n_mels) float32 filterbank, numpy (cached per geometry)."""
    return np.ascontiguousarray(
        dsp.mel_filterbank(sr, n_fft, n_mels, fmin=fmin).T.astype(np.float32))


def _dequantise(wav: torch.Tensor) -> torch.Tensor:
    if wav.dtype == torch.int16:
        return wav.float() / 32767.0
    return wav.float()


def _stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int,
                    win_length: int) -> torch.Tensor:
    """|STFT| as (n_frames, n_bins) float32."""
    window = torch.from_numpy(_window(n_fft, win_length)).to(wav.device)
    spec = torch.stft(wav, n_fft, hop_length=hop, win_length=n_fft,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    return spec.abs().T


def mel_spec_auto_encoder(wav: torch.Tensor,
                          cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Auto-encoder mel: (n_samples,) -> (n_mels, n_frames) in [0, 1]."""
    mag = _stft_magnitude(_dequantise(wav), cfg.n_fft, cfg.hop_length,
                          cfg.window_length)
    fb = torch.from_numpy(_mel_fb(cfg.sr, cfg.n_fft, cfg.n_mels,
                                  cfg.fmin)).to(mag.device)
    mel = torch.matmul(mag, fb)                            # (T, n_mels)
    db = 20.0 * torch.log10(torch.clamp(mel, min=1e-5))
    return torch.clamp((db + 100.0) / 100.0, 0.0, 1.0).T


def _slice_mel(wav: torch.Tensor, cfg: MelConfig, starts, n: int):
    """AE mel of ``wav`` cut into (len(starts), n_mels, n) chunks."""
    mel = mel_spec_auto_encoder(wav, cfg)
    return torch.stack([mel[:, s:s + n] for s in starts])


def mel_spec_auto_encoder_sliced(wav: np.ndarray,
                                 cfg: MelConfig = MelConfig(),
                                 overlap: float = 0.5,
                                 min_pad_coverage: float = 0.75,
                                 pcm16: bool = False, device=None):
    """``cut=True`` AE mel path: (n_chunks, n_mels, N) chunks on ``device``
    (None: the GPU, or raise; ``"cpu"`` on request) plus the mel slices.
    The slice index math is the host's (:func:`dsp.compute_partial_slices`);
    only the wav goes to the device, as int16 PCM when ``pcm16`` (the
    serving paths' choice; the JAX function's default is False too)."""
    wav_slices, mel_slices = dsp.compute_partial_slices(
        len(wav), cfg.sr,
        partial_utterance_n_frames=cfg.partial_utterance_n_frames,
        min_pad_coverage=min_pad_coverage, overlap=overlap,
        mel_window_step=cfg.mel_window_step)
    wav = dsp.pad_for_slices(np.asarray(wav), wav_slices)
    if pcm16:
        wav = pcm16_quantise(wav)
    starts = tuple(int(s.start) for s in mel_slices)
    device = resolve_device(device)
    chunks = _slice_mel(torch.from_numpy(np.ascontiguousarray(wav)).to(device),
                        cfg, starts, cfg.partial_utterance_n_frames)
    return chunks, mel_slices


def pcm16_quantise(wav: np.ndarray) -> np.ndarray:
    """float wav -> int16 PCM, rounding as the JAX package does."""
    return np.clip(np.round(np.asarray(wav, np.float64) * 32767.0),
                   -32767, 32767).astype(np.int16)


def mel_spec_speaker_encoder(wav: torch.Tensor,
                             cfg: SpeakerMelConfig = SpeakerMelConfig()
                             ) -> torch.Tensor:
    """Speaker-encoder power mel: (n_samples,) -> (n_frames, n_mels)."""
    mag = _stft_magnitude(_dequantise(wav), cfg.n_fft, cfg.hop_length,
                          cfg.n_fft)
    fb = torch.from_numpy(_mel_fb(cfg.sr, cfg.n_fft, cfg.n_mels,
                                  0.0)).to(mag.device)
    return torch.matmul(mag * mag, fb)
