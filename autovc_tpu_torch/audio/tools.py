"""Host-side audio tools (counterpart of ``autovc_tpu/audio/tools.py``).

Copies of the JAX package's seven tools, in numpy on the host, as there:

* ``create_silence_mask`` / ``trim_long_silences``: the energy VAD (the
  default; ``docs/VAD_DEVIATION.md``) or, with ``backend="webrtc"``, the
  reference's WebRTC VAD, which needs the optional ``webrtcvad`` wheel
  and raises without it; the same windowing, moving-average smoothing,
  binary dilation and repeat expansion;
* ``normalize_volume`` (dBFS) and ``remove_noise`` (spectral gating);
* ``split_audio`` / ``combine_audio`` / ``rename_files``;

and the registry :class:`autovc_tpu_torch.audio.Audio` dispatches
through, with the JAX registry's names and keyword sets.  Where the JAX
``create_silence_mask`` asserts its window length and rate, this one
raises ``ValueError``.
"""
from __future__ import annotations

import math
import os
import shutil

import numpy as np
import scipy.ndimage as _ndimage

from autovc_tpu_torch.audio import dsp, io
from autovc_tpu_torch.utils import retrieve_file_paths

INT16_MAX = (2 ** 15) - 1
_VAD_SRS = (8000, 16000, 32000, 48000)


def _moving_average(array: np.ndarray, width: int) -> np.ndarray:
    padded = np.concatenate(
        [np.zeros((width - 1) // 2), array, np.zeros(width // 2)])
    csum = np.cumsum(padded, dtype=np.float64)
    csum[width:] = csum[width:] - csum[:-width]
    return csum[width - 1:] / width


def webrtc_available() -> bool:
    """True when the optional ``webrtcvad`` wheel is importable."""
    try:
        import webrtcvad  # noqa: F401
        return True
    except ImportError:
        return False


def _webrtc_voice_flags(wav: np.ndarray, sr: int,
                        samples_per_window: int) -> np.ndarray:
    """Per-window speech flags from the WebRTC GMM VAD, the reference's
    decision path (tools.py:69-80: ``webrtcvad.Vad(mode=3)`` over 16-bit
    mono PCM windows).  Optional dependency."""
    try:
        import webrtcvad
    except ImportError as e:
        raise ImportError(
            "create_silence_mask(backend='webrtc') needs the optional "
            "'webrtcvad' wheel (pip install webrtcvad); the default "
            "backend='energy' has no native dependency") from e
    pcm = (np.round(wav * INT16_MAX)).astype("<i2").tobytes()
    vad = webrtcvad.Vad(mode=3)
    return np.array([
        vad.is_speech(pcm[ws * 2:(ws + samples_per_window) * 2],
                      sample_rate=sr)
        for ws in range(0, len(wav), samples_per_window)], dtype=float)


def create_silence_mask(wav, sr, vad_window_length=20,
                        vad_moving_average_width=8, vad_max_silence_length=2,
                        energy_threshold_db=-40.0, backend="energy"):
    """(wav trimmed to a multiple of the window, boolean speech mask);
    ``False`` marks silence (tools.py:25-95).  Per-window voice flags are
    smoothed with a moving average, rounded, dilated and expanded back to
    sample resolution.

    ``backend``: "energy" (default): a window is speech when its RMS is
    above ``energy_threshold_db`` relative to the recording's
    95th-percentile window RMS (``docs/VAD_DEVIATION.md``); "webrtc": the
    reference's ``Vad(mode=3)`` decisions (optional ``webrtcvad`` wheel).
    """
    if vad_window_length not in (10, 20, 30):
        raise ValueError(f"vad_window_length must be 10, 20 or 30 ms, got "
                         f"{vad_window_length}")
    if sr not in _VAD_SRS:
        raise ValueError(f"VAD expects sr in {_VAD_SRS} (resample first); "
                         f"got {sr}")

    samples_per_window = (vad_window_length * sr) // 1000
    wav = wav[: len(wav) - (len(wav) % samples_per_window)]

    if backend == "webrtc":
        voice_flags = _webrtc_voice_flags(wav, sr, samples_per_window)
    elif backend == "energy":
        frames = wav.reshape(-1, samples_per_window).astype(np.float64)
        rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
        ref = np.percentile(rms, 95) + 1e-12
        voice_flags = (20 * np.log10(rms / ref)
                       > energy_threshold_db).astype(float)
    else:
        raise ValueError(f"backend must be 'energy' or 'webrtc', "
                         f"got {backend!r}")

    audio_mask = _moving_average(voice_flags, vad_moving_average_width)
    audio_mask = np.round(audio_mask).astype(bool)
    audio_mask = _ndimage.binary_dilation(
        audio_mask, np.ones(vad_max_silence_length + 1))
    audio_mask = np.repeat(audio_mask, samples_per_window)
    return wav, audio_mask


def trim_long_silences(wav, sr, **kwargs):
    """Drop silent samples using :func:`create_silence_mask`
    (tools.py:97-118)."""
    wav, audio_mask = create_silence_mask(wav, sr, **kwargs)
    return wav[audio_mask]


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


def split_audio(wav, sr, save_name=None, save_dir="data/splitted_wavs/",
                allowed_pause=2, remove_silence=False, max_len=10,
                fixed_length=None, **kwargs):
    """Split audio at long pauses (or fixed intervals) (tools.py:120-212).
    Files go to ``save_dir.strip('/')/<save_name>_<i>.wav`` as in the JAX
    package (which makes an absolute ``save_dir`` relative)."""
    if fixed_length is not None:
        n_frames = fixed_length * sr
        total = len(wav)
        split_masks = [np.arange(i, i + n_frames)
                       for i in range(0, total, n_frames)
                       if i + n_frames < total]
    else:
        wav, audio_mask = create_silence_mask(wav, sr, **kwargs)
        voiced = np.where(audio_mask)[0]
        if voiced.size == 0:
            return []
        groups = np.split(voiced, np.where(np.diff(voiced) != 1)[0] + 1)
        allowed_pause_samples = allowed_pause * sr
        split_masks = [groups[0]]
        for split in groups[1:]:
            new_len = (len(split) + len(split_masks[-1])) / sr
            if (split[-1] - split_masks[-1][-1] <= allowed_pause_samples
                    and new_len <= max_len):
                prev = split_masks.pop()
                if remove_silence:
                    split_masks.append(np.concatenate([prev, split]))
                else:
                    gap = np.arange(prev[-1] + 1, split[0])
                    split_masks.append(np.concatenate([prev, gap, split]))
            else:
                split_masks.append(split)

    filename = None
    if save_name is not None:
        filename = os.path.split(save_name)[-1]
        filename += "" if filename.endswith(".wav") else ".wav"
        os.makedirs(save_dir, exist_ok=True)

    wavs = []
    width = 1 + int(math.log10(max(len(split_masks), 1)))
    for i, split in enumerate(split_masks):
        wavs.append(wav[split])
        if filename is not None:
            fname = filename.replace(".wav", f"_{str(i + 1).zfill(width)}.wav")
            io.save_wav(f"{save_dir.strip('/')}/{fname}", wavs[-1], sr)
    return wavs


def combine_audio(audio_file_paths, excluded_audio_file_paths=(), sr=16000,
                  save_name=None):
    """Concatenate several audio files or arrays at a common sr
    (tools.py:214-255)."""
    is_array = isinstance(audio_file_paths[0], np.ndarray)
    if not is_array:
        audio_file_paths = retrieve_file_paths(
            audio_file_paths, excluded=list(excluded_audio_file_paths))
    parts = []
    for item in audio_file_paths:
        if not is_array:
            item, _ = io.load_wav(item, sr=sr)
        parts.append(np.asarray(item))
    combined = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    if save_name is not None:
        save_name += "" if save_name.endswith(".wav") else ".wav"
        io.save_wav(save_name, combined, int(sr))
    return combined


def rename_files(dir_path, new_dir_path, new_file_name, save_filenames=False):
    """Copy a directory of files to sequentially numbered names
    (tools.py:305-338)."""
    files = sorted(os.listdir(dir_path))
    os.makedirs(new_dir_path, exist_ok=True)
    log = "previous_name\t new_name \n"
    width = 1 + int(math.log10(max(len(files), 1)))
    for i, f in enumerate(files):
        save_name = os.path.join(new_dir_path, new_file_name)
        save_name += "" if save_name.endswith(".wav") else ".wav"
        fname = save_name.replace(".wav", f"_{str(i + 1).zfill(width)}.wav")
        log += f"{os.path.join(dir_path, f)}\t {fname} \n"
        shutil.copy(os.path.join(dir_path, f), fname)
    if save_filenames:
        with open(os.path.join(new_dir_path, "filenames.txt"), "w") as fh:
            fh.write(log.replace("\\", "/"))


# Preprocessing-pipeline registry: which kwargs each tool accepts.
PIPELINE_FUNCS = {
    "trim_long_silences": (trim_long_silences,
                           {"sr", "vad_window_length",
                            "vad_moving_average_width",
                            "vad_max_silence_length", "energy_threshold_db",
                            "backend"}),
    "normalize_volume": (normalize_volume,
                         {"target_dBFS", "increase_only", "decrease_only"}),
    "remove_noise": (remove_noise,
                     {"sr", "n_fft", "hop_length", "noise_quantile",
                      "gate_below_db", "smooth_freq_bins",
                      "smooth_time_frames"}),
}
