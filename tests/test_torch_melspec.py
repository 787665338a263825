"""CPU parity of the port's mel front-ends (autovc_tpu_torch.ops.melspec)
and its copy of the host DSP (audio/dsp.py) against the JAX package: the
device AE and SE mels from PCM16 input (rtol 1e-3), and the cut=True chunk
slicing with equal chunk starts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.audio import dsp as jdsp
from autovc_tpu.config import MelConfig, SpeakerMelConfig
from autovc_tpu.ops import melspec as JM
from autovc_tpu_torch.audio import dsp as tdsp
from autovc_tpu_torch.ops import melspec as TM

# the AE mel is normalised dB in [0, 1] and the SE mel a power spectrum;
# torch.stft and the JAX DFT-as-matmul differ only in f32 sum order
RTOL = 1e-3


def _wav(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.5 * t)) * t)
    return (0.3 * tone + 0.02 * rng.standard_normal(len(t))).astype(
        np.float32)


def test_ae_mel_parity():
    w16 = TM.pcm16_quantise(_wav(1.3, 22050, 0))
    ref = np.asarray(JM.mel_spec_auto_encoder(jnp.asarray(w16)))
    out = TM.mel_spec_auto_encoder(torch.from_numpy(w16)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-5)


def test_se_mel_parity():
    w16 = TM.pcm16_quantise(_wav(1.0, 16000, 1))
    cfg = SpeakerMelConfig()
    ref = np.asarray(JM.mel_spec_speaker_encoder(jnp.asarray(w16), cfg))
    out = TM.mel_spec_speaker_encoder(torch.from_numpy(w16)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("seconds,overlap", [(0.7, 0.5), (6.5, 0.5),
                                             (9.0, 0.25)])
def test_sliced_chunks_parity(seconds, overlap):
    wav = _wav(seconds, 22050, 2)
    cfg = MelConfig()
    ref, ref_slices = JM.mel_spec_auto_encoder_sliced(wav, cfg,
                                                      overlap=overlap,
                                                      pcm16=True)
    out, slices = TM.mel_spec_auto_encoder_sliced(wav, cfg, overlap=overlap,
                                                  pcm16=True, device="cpu")
    assert [s.start for s in slices] == [s.start for s in ref_slices]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)


def test_sliced_chunks_parity_at_the_defaults():
    """Both functions called with their defaults (no PCM16 re-quantisation
    in either) give the same chunks."""
    wav = _wav(2.3, 22050, 4)
    ref, ref_slices = JM.mel_spec_auto_encoder_sliced(wav)
    out, slices = TM.mel_spec_auto_encoder_sliced(wav, device="cpu")
    assert [s.start for s in slices] == [s.start for s in ref_slices]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)
    # the float path is not the PCM16 one: a re-quantised call differs
    pcm, _ = TM.mel_spec_auto_encoder_sliced(wav, pcm16=True, device="cpu")
    assert float((pcm - out).abs().max()) > 0


@pytest.mark.parametrize("n", [0, 1, 274, 275, 22050, 88200, 529200])
def test_slice_index_math_equal(n):
    for kw in ({"partial_utterance_n_frames": 400, "overlap": 0.5,
                "mel_window_step": 12.5},
               {"partial_utterance_n_frames": 160, "mel_window_step": 10.0}):
        sr = 22050 if kw["mel_window_step"] == 12.5 else 16000
        assert (tdsp.compute_partial_slices(n, sr, **kw)
                == jdsp.compute_partial_slices(n, sr, **kw))


def test_host_golden_equal():
    np.testing.assert_array_equal(tdsp.mel_filterbank(22050, 2048, 80, 40.0),
                                  jdsp.mel_filterbank(22050, 2048, 80, 40.0))
    np.testing.assert_array_equal(tdsp.padded_window(2048, 1100),
                                  jdsp.padded_window(2048, 1100))
    wav = _wav(0.5, 22050, 3)
    ref = jdsp.stft_magnitude(wav, 2048, 275, 1100)
    np.testing.assert_allclose(tdsp.stft_magnitude(wav, 2048, 275, 1100),
                               ref, rtol=1e-12, atol=1e-12)
