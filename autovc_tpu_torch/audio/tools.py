"""Host-side audio tools used by the conversion pipeline.

Copies of ``normalize_volume`` and ``remove_noise`` from
``autovc_tpu/audio/tools.py`` (the two tools ``ConvertConfig`` names), plus
the registry :class:`autovc_tpu_torch.audio.Audio` dispatches through.  They
run on the host in numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage as _ndimage

from autovc_tpu_torch.audio import dsp


def normalize_volume(wav, target_dBFS=-30, increase_only=False,
                     decrease_only=False):
    """Scale audio to a target dBFS (tools.py:257-282)."""
    if increase_only and decrease_only:
        raise ValueError("Both increase_only and decrease_only are set")
    dBFS_change = target_dBFS - 10 * np.log10(np.mean(wav ** 2) + 1e-12)
    if (dBFS_change < 0 and increase_only) or (dBFS_change > 0 and decrease_only):
        return wav
    return wav * (10 ** (dBFS_change / 20))


def remove_noise(wav, sr, n_fft=1024, hop_length=256, noise_quantile=0.1,
                 gate_below_db=6.0, smooth_freq_bins=5, smooth_time_frames=3,
                 **_ignored):
    """Stationary spectral-gating noise reduction.

    Estimates a per-frequency noise floor from the quietest
    ``noise_quantile`` frames, builds a soft gain mask that attenuates bins
    within ``gate_below_db`` of the floor, smooths the mask over time and
    frequency, and resynthesises by overlap-add ISTFT.
    """
    import scipy.fft as _sfft
    wav = np.asarray(wav, dtype=np.float32)
    if len(wav) < n_fft:
        return wav
    window = dsp.padded_window(n_fft, n_fft).astype(np.float32)
    frames = dsp.frame_signal(wav, n_fft, hop_length, center=True)
    spec = _sfft.rfft(frames * window, axis=-1, workers=-1)  # (T, F)
    mag = np.abs(spec)

    frame_energy = mag.sum(axis=1)
    k = max(1, int(len(frame_energy) * noise_quantile))
    quiet = np.argsort(frame_energy)[:k]
    noise_floor = mag[quiet].mean(axis=0) + 1e-12          # (F,)

    snr_db = 20 * np.log10((mag + 1e-12) / noise_floor)
    gain = np.clip(snr_db / gate_below_db, 0.0, 1.0)
    gain = _ndimage.uniform_filter(
        gain, size=(smooth_time_frames, smooth_freq_bins))

    out_frames = _sfft.irfft(spec * gain, n=n_fft, axis=-1,
                             workers=-1) * window
    # overlap-add: frame t's block r (of n_fft//hop blocks of hop samples)
    # lands at (t + r) * hop
    T = len(frames)
    out = np.zeros(T * hop_length + n_fft, np.float32)
    wsum = np.zeros_like(out)
    w2 = window ** 2
    if n_fft % hop_length == 0:
        R = n_fft // hop_length
        for r in range(R):
            blk = out_frames[:, r * hop_length:(r + 1) * hop_length]
            out[r * hop_length: (r + T) * hop_length] += blk.ravel()
            wsum[r * hop_length: (r + T) * hop_length] += np.tile(
                w2[r * hop_length:(r + 1) * hop_length], T)
    else:
        idx = (np.arange(T)[:, None] * hop_length
               + np.arange(n_fft)[None, :]).ravel()
        np.add.at(out, idx, out_frames.ravel())
        np.add.at(wsum, idx, np.broadcast_to(w2, (T, n_fft)).ravel())
    out = out / np.maximum(wsum, 1e-8)
    out = out[n_fft // 2: n_fft // 2 + len(wav)]
    return out.astype(np.float32)


# Preprocessing-pipeline registry: which kwargs each tool accepts.
PIPELINE_FUNCS = {
    "normalize_volume": (normalize_volume,
                         {"target_dBFS", "increase_only", "decrease_only"}),
    "remove_noise": (remove_noise,
                     {"sr", "n_fft", "hop_length", "noise_quantile",
                      "gate_below_db", "smooth_freq_bins",
                      "smooth_time_frames"}),
}
