"""The port's audio tools (``autovc_tpu_torch/audio/tools.py``) and
``Audio.preprocess`` against the JAX package's, on the same seeded numpy
input: every output array equal, every file written equal byte for byte,
and ``backend="webrtc"`` refused alike without the optional wheel."""
import os
import sys

import numpy as np
import pytest

from autovc_tpu.audio import Audio as JAudio
from autovc_tpu.audio import io as jio
from autovc_tpu.audio import tools as jtools
from autovc_tpu_torch.audio import Audio as TAudio
from autovc_tpu_torch.audio import tools as ttools


def _speech(sr, seed, layout=((1.0, True), (3.0, False), (1.2, True),
                              (0.5, False), (0.8, True))):
    """Voiced bursts (a harmonic tone) and silences (faint noise), each
    (seconds, voiced)."""
    rng = np.random.default_rng(seed)
    parts = []
    for seconds, voiced in layout:
        n = int(seconds * sr)
        t = np.arange(n) / sr
        if voiced:
            tone = sum(np.sin(2 * np.pi * k * 170.0 * t) / k
                       for k in (1, 2, 3))
            parts.append(0.3 * tone + 0.01 * rng.standard_normal(n))
        else:
            parts.append(1e-4 * rng.standard_normal(n))
    return np.concatenate(parts).astype(np.float32)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _write_sources(io, n=3, sr=16000):
    os.makedirs("src/skip", exist_ok=True)
    for k in range(n):
        io.save_wav(f"src/u{k}.wav", _speech(sr, k, ((0.4 + 0.1 * k, True),)),
                    sr)
    io.save_wav("src/skip/x.wav", _speech(sr, 9, ((0.3, True),)), sr)


# Each case runs in a fresh working directory with one package's tools
# (``t``), ``Audio`` class and ``io``; it returns arrays and, where the tool
# writes files, the files.
CASES = {
    "create_silence_mask": lambda t, A, io: t.create_silence_mask(
        _speech(16000, 0), 16000),
    "create_silence_mask_48k_window30": lambda t, A, io: t.create_silence_mask(
        _speech(48000, 1), 48000, vad_window_length=30,
        vad_moving_average_width=4, vad_max_silence_length=1,
        energy_threshold_db=-30.0),
    "trim_long_silences": lambda t, A, io: t.trim_long_silences(
        _speech(16000, 2), 16000),
    "split_audio_at_pauses": lambda t, A, io: (
        t.split_audio(_speech(16000, 3), 16000, save_name="utt",
                      save_dir="split/", allowed_pause=2),
        _files("split")),
    "split_audio_remove_silence": lambda t, A, io: (
        t.split_audio(_speech(16000, 4), 16000, save_name="utt.wav",
                      save_dir="split", allowed_pause=4, max_len=20,
                      remove_silence=True),
        _files("split")),
    "split_audio_fixed_length": lambda t, A, io: (
        t.split_audio(_speech(16000, 5), 16000, save_name="utt",
                      save_dir="split", fixed_length=1),
        _files("split")),
    "combine_audio_arrays": lambda t, A, io: t.combine_audio(
        [_speech(16000, 6, ((0.3, True),)), _speech(16000, 7, ((0.2, False),))]),
    "combine_audio_files": lambda t, A, io: (
        _write_sources(io),
        t.combine_audio("src", excluded_audio_file_paths=["src/skip"],
                        sr=22050, save_name="combined"),
        _files("."))[1:],
    "rename_files": lambda t, A, io: (
        _write_sources(io),
        t.rename_files("src/skip", "renamed", "speaker", save_filenames=True),
        os.remove("src/skip/x.wav"), os.rmdir("src/skip"),
        t.rename_files("src", "renamed_all", "utt.wav"),
        _files("renamed"), _files("renamed_all"))[5:],
    "preprocess_trim_snaps_22050_to_16000": lambda t, A, io: (
        lambda a: (a.wav, a.sr))(A(_speech(22050, 8), sr_org=22050).preprocess(
            "normalize_volume", "trim_long_silences", target_dBFS=-20)),
    "preprocess_trim_snaps_44100_to_48000": lambda t, A, io: (
        lambda a: (a.wav, a.sr))(A(_speech(44100, 9), sr_org=44100).preprocess(
            "trim_long_silences", "remove_noise", None,
            vad_window_length=10, energy_threshold_db=-35.0)),
}


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_matches_the_jax_one(case, tmp_path, monkeypatch):
    out = {}
    for pkg, t, A, io in (("jax", jtools, JAudio, jio),
                          ("torch", ttools, TAudio, ttools.io)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        out[pkg] = CASES[case](t, A, io)
    assert _equal(out["torch"], out["jax"])
    flat = out["torch"]
    while isinstance(flat, (list, tuple)) and flat:
        flat = flat[0]
    assert flat is not None and (not isinstance(flat, np.ndarray)
                                 or flat.size > 0)


def test_trim_removes_the_long_silence():
    """At 16 kHz both silences (3 s and 0.5 s) go and the 3 s of voiced
    bursts stay: the output is 3 s within 0.1 s short or 0.2 s long (the
    smoothing may take an edge window of a burst, the dilation adds up to
    ``vad_max_silence_length`` windows a side)."""
    wav = _speech(16000, 10)
    out = TAudio(wav, sr_org=16000).preprocess("trim_long_silences").wav
    assert 2.9 * 16000 <= len(out) <= 3.2 * 16000


def test_webrtc_backend_needs_the_wheel_in_both(monkeypatch):
    monkeypatch.setitem(sys.modules, "webrtcvad", None)
    wav = _speech(16000, 11, ((0.5, True),))
    for t, A in ((jtools, JAudio), (ttools, TAudio)):
        assert t.webrtc_available() is False
        with pytest.raises(ImportError, match="webrtcvad"):
            t.create_silence_mask(wav, 16000, backend="webrtc")
        with pytest.raises(ImportError, match="webrtcvad"):
            A(wav, sr_org=16000).preprocess("trim_long_silences",
                                            backend="webrtc")
