"""Spectrogram DSP: librosa-compatible STFT / mel pipelines, from first principles.

The reference computes two mel front-ends with librosa
(``autovc/audio/spectrogram.py``):

* auto-encoder path (spectrogram.py:62-142): ``stft`` (n_fft 2048, hop 275,
  win 1100, centre/reflect, periodic hann) -> **amplitude** mel (80 mels,
  fmin 40, slaney filterbank) -> ``amp_to_db`` (20*log10, 1e-5 floor) ->
  [0, 1] normalisation against -100 dB.
* speaker-encoder path (spectrogram.py:144-219): **power** mel (40 mels,
  25 ms window / 10 ms hop at 16 kHz, fmin 0), float32, transposed to
  (frames, mels), no dB / no normalisation.

A copy of ``autovc_tpu/audio/dsp.py`` without its native C++ hook: the
numpy golden reference and the host-side slice index math.  The device
front-end lives in :mod:`autovc_tpu_torch.ops.melspec`.
"""
from __future__ import annotations

import numpy as np

from autovc_tpu_torch.config import MelConfig, SpeakerMelConfig

# ---------------------------------------------------------------------------
# Window / framing / STFT
# ---------------------------------------------------------------------------


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic ("fftbins") Hann window, identical to
    ``scipy.signal.get_window('hann', n, fftbins=True)`` used by librosa."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(n_fft: int, win_length: int, dtype=np.float64) -> np.ndarray:
    """Hann window of ``win_length`` zero-padded symmetrically to ``n_fft``
    (librosa ``util.pad_center`` semantics: extra sample goes on the right)."""
    w = hann_window(win_length, dtype)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def frame_signal(y: np.ndarray, n_fft: int, hop_length: int,
                 center: bool = True) -> np.ndarray:
    """Slice ``y`` into overlapping frames of ``n_fft`` samples.

    With ``center=True`` the signal is reflect-padded by ``n_fft // 2`` on both
    sides first (librosa default), so frame ``t`` is centred on sample
    ``t * hop_length``.  Returns shape (n_frames, n_fft).
    """
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    return y[idx]


def stft_magnitude(y: np.ndarray, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True) -> np.ndarray:
    """|STFT| with librosa semantics.  Returns (1 + n_fft//2, n_frames)."""
    frames = frame_signal(np.asarray(y, dtype=np.float64), n_fft, hop_length,
                          center)
    window = padded_window(n_fft, win_length)
    spec = np.fft.rfft(frames * window, axis=-1)
    return np.abs(spec).T


# ---------------------------------------------------------------------------
# Mel filterbank (slaney scale + slaney area normalisation, htk=False)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    with np.errstate(divide="ignore", invalid="ignore"):
        mel = np.where(log_region,
                       _MIN_LOG_MEL + np.log(np.maximum(f, 1e-12)
                                             / _MIN_LOG_HZ) / _LOGSTEP,
                       mel)
    return mel


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    f = np.where(log_region,
                 _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)),
                 f)
    return f


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Triangular slaney-normalised mel filterbank, (n_mels, 1 + n_fft//2).

    Matches ``librosa.filters.mel(sr, n_fft, n_mels=.., fmin=.., htk=False,
    norm='slaney')``.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    mel_f = mel_to_hz(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalisation.
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights


# ---------------------------------------------------------------------------
# dB / normalisation helpers (spectrogram.py:14-60)
# ---------------------------------------------------------------------------


def amp_to_db(amplitude: np.ndarray) -> np.ndarray:
    """20*log10 with a 1e-5 amplitude floor (spectrogram.py:54-56)."""
    return 20.0 * np.log10(np.maximum(1e-5, amplitude))


def db_to_amp(db: np.ndarray) -> np.ndarray:
    return np.power(10.0, db * 0.05)


def normalize_spec(spec: np.ndarray, min_level_db: float = -100.0) -> np.ndarray:
    """Map [min_level_db, 0] dB to [0, 1], clipped (spectrogram.py:14-32)."""
    return np.clip((spec - min_level_db) / -min_level_db, 0.0, 1.0)


def denormalize_spec(spec: np.ndarray, min_level_db: float = -100.0) -> np.ndarray:
    """Inverse of :func:`normalize_spec` (spectrogram.py:34-52).

    NOTE: the reference implementation adds ``min_level_db`` back incorrectly
    (it computes ``clip(x,0,1) * -min + min`` which maps 1 -> 0 and 0 -> -100
    — actually correct).  We mirror it exactly.
    """
    return np.clip(spec, 0.0, 1.0) * -min_level_db + min_level_db


# ---------------------------------------------------------------------------
# Front-ends
# ---------------------------------------------------------------------------


def mel_spec_auto_encoder(wav: np.ndarray,
                          cfg: MelConfig = MelConfig()) -> np.ndarray:
    """Auto-encoder mel: amplitude mel -> dB -> [0,1].  (n_mels, n_frames).

    Mirrors ``mel_spec_auto_encoder`` (spectrogram.py:62-142) without the
    slicing concern — use :func:`compute_partial_slices` + the ``_sliced``
    variants for the ``cut=True`` behaviour.
    """
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.window_length)
    fb = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, fmin=cfg.fmin)
    mel = fb @ mag            # amplitude mel: S=|stft| passed to melspectrogram
    return normalize_spec(amp_to_db(mel)).astype(np.float32)


def mel_spec_speaker_encoder(wav: np.ndarray,
                             cfg: SpeakerMelConfig = SpeakerMelConfig()
                             ) -> np.ndarray:
    """Speaker-encoder mel: power mel, (n_frames, n_mels) float32.

    Mirrors ``mel_spec_speaker_encoder`` (spectrogram.py:144-219): librosa
    ``melspectrogram(wav, sr, n_fft, hop)`` squares the magnitude
    (power=2.0 default) and uses fmin=0, win_length=n_fft.
    """
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.n_fft)
    fb = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels)
    mel = fb @ (mag ** 2)
    return mel.astype(np.float32).T


def compute_partial_slices(n_samples: int, sr: int,
                           partial_utterance_n_frames: int = 160,
                           min_pad_coverage: float = 0.75,
                           overlap: float = 0.5,
                           mel_window_step: float = 10.0):
    """Aligned overlapping wav/mel windows (spectrogram.py:248-311).

    Returns (wav_slices, mel_slices) as lists of ``slice``.  The last window is
    kept only if it covers >= ``min_pad_coverage`` of a full window (unless it
    is the only one).  The returned ranges may index past the waveform; pad
    the wav with zeros up to ``wav_slices[-1].stop`` before slicing.
    """
    assert 0 <= overlap < 1
    assert 0 < min_pad_coverage <= 1

    samples_per_frame = int(sr * mel_window_step / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = max(int(np.round(partial_utterance_n_frames * (1 - overlap))), 1)

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - partial_utterance_n_frames + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + partial_utterance_n_frames])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last = wav_slices[-1]
    coverage = (n_samples - last.start) / (last.stop - last.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        mel_slices, wav_slices = mel_slices[:-1], wav_slices[:-1]
    return wav_slices, mel_slices


def pad_for_slices(wav: np.ndarray, wav_slices) -> np.ndarray:
    """Zero-pad ``wav`` so the last slice is fully covered."""
    stop = wav_slices[-1].stop
    if stop >= len(wav):
        wav = np.pad(wav, (0, stop - len(wav)))
    return wav


def mel_spec_auto_encoder_sliced(wav: np.ndarray,
                                 cfg: MelConfig = MelConfig(),
                                 overlap: float = 0.5,
                                 min_pad_coverage: float = 0.75):
    """``cut=True`` auto-encoder path: returns (mel_chunks, n_chunks) where
    ``mel_chunks`` is a (n_chunks, n_mels, partial_frames) float32 array."""
    wav_slices, mel_slices = compute_partial_slices(
        len(wav), cfg.sr,
        partial_utterance_n_frames=cfg.partial_utterance_n_frames,
        min_pad_coverage=min_pad_coverage, overlap=overlap,
        mel_window_step=cfg.mel_window_step)
    wav = pad_for_slices(wav, wav_slices)
    mel = mel_spec_auto_encoder(wav, cfg)
    return np.stack([mel[:, s] for s in mel_slices]), mel_slices
