"""The port's native host mel core (``autovc_tpu_torch.native``, its own
copy of ``melspec.cc``) against the JAX package's core and against the
port's numpy mels, on seeded synthetic wavs (the sample wavs are absent).

Both cores are built here from one source text with the same ``g++``
flags on the same machine, so they agree bitwise; the numpy bars are
``tests/test_native.py``'s (AE rtol 1e-3 / atol 1e-4, SE rtol 2e-3 /
atol 1e-5 of the largest value)."""
import os

import numpy as np
import pytest

from autovc_tpu import native as jnative
from autovc_tpu.audio import dsp as jdsp
from autovc_tpu_torch import native
from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import MelConfig, SpeakerMelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(k * phase) / k for k in range(1, 5))
    return (0.2 * tone + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


def _numpy(fn, wav):
    """The port's host mel on its numpy path."""
    use = dsp.USE_NATIVE
    dsp.USE_NATIVE = False
    try:
        return fn(wav)
    finally:
        dsp.USE_NATIVE = use


def test_native_mels_equal_the_jax_core_bitwise():
    assert jnative.available(), "the JAX package's core did not build"
    ae = _wav(3.0, 22050, 0)
    se = _wav(2.0, 16000, 1)
    np.testing.assert_array_equal(native.mel_spec_auto_encoder(ae),
                                  jnative.mel_spec_auto_encoder(ae))
    np.testing.assert_array_equal(native.mel_spec_speaker_encoder(se),
                                  jnative.mel_spec_speaker_encoder(se))


def test_native_mels_match_numpy():
    ae = _wav(3.0, 22050, 2)
    ref = _numpy(dsp.mel_spec_auto_encoder, ae)
    out = native.mel_spec_auto_encoder(ae)
    assert out.shape == ref.shape == (80, 241)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)
    se = _wav(2.0, 16000, 3)
    ref = _numpy(dsp.mel_spec_speaker_encoder, se)
    out = native.mel_spec_speaker_encoder(se)
    assert out.shape == ref.shape == (201, 40)
    np.testing.assert_allclose(out, ref, rtol=2e-3,
                               atol=1e-5 * float(ref.max()))


def test_host_mels_take_the_core_above_one_window():
    """``dsp``'s host mels are the core's for a wav of at least n_fft
    samples and numpy's below it, as the JAX hook does."""
    wav = _wav(1.0, 22050, 4)
    np.testing.assert_array_equal(dsp.mel_spec_auto_encoder(wav),
                                  native.mel_spec_auto_encoder(wav))
    se = _wav(1.0, 16000, 5)
    np.testing.assert_array_equal(dsp.mel_spec_speaker_encoder(se),
                                  native.mel_spec_speaker_encoder(se))
    short = wav[:MelConfig().n_fft - 1]
    np.testing.assert_array_equal(dsp.mel_spec_auto_encoder(short),
                                  _numpy(dsp.mel_spec_auto_encoder, short))
    np.testing.assert_array_equal(dsp.mel_spec_auto_encoder(short),
                                  jdsp.mel_spec_auto_encoder(short))


def test_native_short_input():
    out = native.mel_spec_auto_encoder(np.zeros(100, np.float32))
    assert out.shape == (80, 1) and np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, jnative.mel_spec_auto_encoder(np.zeros(100, np.float32)))


def test_native_threads_agree_bitwise():
    wav = _wav(2.0, 22050, 6)
    np.testing.assert_array_equal(
        native.mel_spec_auto_encoder(wav, n_threads=1),
        native.mel_spec_auto_encoder(wav, n_threads=4))
    se = _wav(2.0, 16000, 7)
    np.testing.assert_array_equal(
        native.mel_spec_speaker_encoder(se, n_threads=1),
        native.mel_spec_speaker_encoder(se, n_threads=4))


@pytest.mark.parametrize("seconds", [0.3, 2.45])
def test_sliced_native_equals_jax(seconds):
    wav = _wav(seconds, 16000, 8)
    cfg = SpeakerMelConfig()
    out = dsp.mel_spec_speaker_encoder_sliced(wav, cfg, use_native=True)
    ref = jdsp.mel_spec_speaker_encoder_sliced(wav, cfg, use_native=True)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:]
    plain = _numpy(lambda w: dsp.mel_spec_speaker_encoder_sliced(w, cfg),
                   wav)[0]
    np.testing.assert_allclose(out[0], plain, rtol=2e-3,
                               atol=1e-5 * float(plain.max()))


def test_library_builds_under_build():
    native.get_lib()
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert str(so).startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith(".so")]


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """A source that does not compile raises from ``get_lib`` and from the
    host mel that needs it: no quiet numpy fallback."""
    bad = tmp_path / "melspec.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on melspec.cc"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="error"):
        dsp.mel_spec_auto_encoder(_wav(0.5, 22050, 9))
    assert not list((tmp_path / "build").glob("*.so"))
