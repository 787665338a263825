"""ctypes binding and on-demand build of the native host mel core
(counterpart of ``autovc_tpu/native/__init__.py``).

``melspec.cc`` (the port's copy of the JAX package's) is compiled by
``g++`` with the JAX package's flags at first use, into
``build/native/`` at the repository root, keyed by a digest of the
source, the flags and the machine (``-march=native`` code runs only where
it was built), and loaded with ``ctypes``.  Nothing builds at import.
The host mels of :mod:`autovc_tpu_torch.audio.dsp` go through it
(``dsp.USE_NATIVE``): the ``cut=False`` mel, the speaker encoder's
partials and training precompute.

Deviation from the JAX package, which falls back to numpy quietly when
the build fails: a failed build raises, with the compiler's log.  Both
machines the port runs on have ``g++``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import MelConfig, SpeakerMelConfig

SOURCE = Path(__file__).resolve().parent / "melspec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where this machine's build of the source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    u = os.uname()
    h.update(f"{u.nodename} {u.machine}".encode())
    return BUILD_DIR / f"libautovc_dsp-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native mel core needs g++: {e}") from None
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if this machine has no build of
    the source; a failed build raises."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.autovc_mel_spectrogram.restype = ctypes.c_int64
            lib.autovc_mel_spectrogram.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.autovc_amp_to_db_normalize.restype = None
            lib.autovc_amp_to_db_normalize.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (the JAX API); a failed
    build raises rather than answer False."""
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _mel(wav: np.ndarray, n_fft: int, hop: int, win_length: int, power: int,
         fb: np.ndarray, n_threads: int = 0) -> np.ndarray:
    lib = get_lib()
    wav = np.ascontiguousarray(wav, np.float32)
    fb = np.ascontiguousarray(fb, np.float32)
    n_frames = 1 + (len(wav) + 2 * (n_fft // 2) - n_fft) // hop
    out = np.empty((n_frames, fb.shape[0]), np.float32)
    written = lib.autovc_mel_spectrogram(
        _fptr(wav), len(wav), n_fft, hop, win_length, power, _fptr(fb),
        fb.shape[0], _fptr(out), n_threads)
    if written != n_frames:
        raise RuntimeError(f"the native mel core wrote {written} frames of "
                           f"{n_frames}")
    return out


def mel_spec_auto_encoder(wav: np.ndarray, cfg: MelConfig = MelConfig(),
                          n_threads: int = 0) -> np.ndarray:
    """Native AE mel: amplitude mel -> dB -> [0, 1], (n_mels, n_frames).
    ``n_threads`` 0: one thread a core."""
    fb = dsp.mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, fmin=cfg.fmin)
    out = _mel(wav, cfg.n_fft, cfg.hop_length, cfg.window_length, 1, fb,
               n_threads)
    get_lib().autovc_amp_to_db_normalize(_fptr(out), out.size)
    return out.T.copy()


def mel_spec_speaker_encoder(wav: np.ndarray,
                             cfg: SpeakerMelConfig = SpeakerMelConfig(),
                             n_threads: int = 0) -> np.ndarray:
    """Native SE mel: power mel, (n_frames, n_mels).  ``n_threads`` as
    for :func:`mel_spec_auto_encoder`."""
    fb = dsp.mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels)
    return _mel(wav, cfg.n_fft, cfg.hop_length, cfg.n_fft, 2, fb, n_threads)
