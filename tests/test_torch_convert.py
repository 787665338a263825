"""The whole slice on CPU: the port's ``VoiceConverter(device="cpu").convert``
against the JAX functions of the accelerator chain it mirrors, f32.

On the CPU the JAX ``VoiceConverter.convert`` takes its host-mel speaker
path and XLA vocoder scan, not the device chain, so the reference is built
from the JAX device-chain functions: ``embed_utterances(..., device=True)``,
``ops.melspec.mel_spec_auto_encoder_sliced`` (PCM16),
``autoencoder.batch_forward`` in f32 and ``wavernn.generate(...,
backend="pallas", interpret=True, fast_math=False)``.  Both sides load the
same .ckpt files written by the JAX package, and the port's sampling noise
is the JAX draw.  Bars: embedding MSE < 1e-8, post-mel MSE < 1e-6,
waveform atol 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu import models as JM
from autovc_tpu.audio import io as jio
from autovc_tpu.audio import tools as jtools
from autovc_tpu.config import ConverterConfig as JConv
from autovc_tpu.models import autoencoder as JAE
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.models import wavernn as JW
from autovc_tpu.ops import melspec as JMEL
from autovc_tpu_torch import Audio, VoiceConverter
from autovc_tpu_torch.config import ConverterConfig as TConv
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.ops import melspec as TMEL
from autovc_tpu_torch.ops import wavernn_kernels as WK

SR = 22050
VOC = {"rnn_dims": 64, "fc_dims": 64,
       "generate": {"target": 1375, "overlap": 550}}
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
    return (0.2 * tone * env + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    jcfg = JConv().with_overrides(vocoder=VOC)
    paths, models = {}, {}
    for i, (name, sub) in enumerate((("auto_encoder", jcfg.auto_encoder),
                                     ("speaker_encoder", jcfg.speaker_encoder),
                                     ("vocoder", jcfg.vocoder))):
        models[name] = JM.load_model(name, config=sub, seed=i, verbose=False)
        paths[name] = JM.save_model(models[name], f"{name}.ckpt", d)
    src, trg = _wav(1.0, 140.0, 0), _wav(1.2, 210.0, 1)

    # --- JAX reference: the device chain's functions --------------------
    src_p = np.asarray(jtools.normalize_volume(src, target_dBFS=-20),
                       np.float32)
    trg_p = np.asarray(jtools.normalize_volume(trg, target_dBFS=-20),
                       np.float32)
    se = models["speaker_encoder"]
    c_src, c_trg = JSE.embed_utterances(
        se.params, [jio.resample(w, SR, 16000) for w in (src_p, trg_p)],
        se.config, device=True)
    ae_cfg = models["auto_encoder"].config
    chunks, _ = JMEL.mel_spec_auto_encoder_sliced(src_p, ae_cfg.spectrogram,
                                                  overlap=0.5, pcm16=True)
    post = JAE.batch_forward_jit(models["auto_encoder"].params, chunks,
                                 jnp.asarray(c_src[None]),
                                 jnp.asarray(c_trg[None]), ae_cfg, 0.5, "f32")
    key = jax.random.PRNGKey(SEED)
    wav = JW.generate(models["vocoder"].params, np.asarray(post)[None],
                      models["vocoder"].config, key=key, backend="pallas",
                      interpret=True, fast_math=False, target=1375,
                      overlap=550)
    ref_wav = np.clip(np.round(wav * 32767.0), -32767, 32767) / 32767.0

    # --- the port, one convert on the CPU with the JAX noise --------------
    vc = VoiceConverter(paths["auto_encoder"], paths["speaker_encoder"],
                        paths["vocoder"], config=TConv().with_overrides(
                            vocoder=VOC), device="cpu", verbose=False)
    mp = pytest.MonkeyPatch()

    def draw(steps, rows, pick_dim, generator, device):
        k1, k2 = jax.random.split(key)
        u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                                maxval=1.0 - 1e-5)
        u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                                maxval=1.0 - 1e-5)
        return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
                torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))

    mp.setattr(WK, "draw_noise", draw)
    vc.stage_times = {}
    try:
        out = vc.convert(Audio(src.copy(), sr_org=SR),
                         Audio(trg.copy(), sr_org=SR), outprocess=(),
                         save_name=False, seed=SEED)
    finally:
        mp.undo()
    stage_times, vc.stage_times = vc.stage_times, None
    return dict(vc=vc, src_p=src_p, trg_p=trg_p, c_src=c_src, c_trg=c_trg,
                post=np.asarray(post), ref_wav=ref_wav, out=out,
                stage_times=stage_times)


def test_slice_embeddings(slice_run):
    vc = slice_run["vc"]
    for wav, ref in ((slice_run["src_p"], slice_run["c_src"]),
                     (slice_run["trg_p"], slice_run["c_trg"])):
        emb = vc._embed(Audio(wav, sr_org=SR))
        assert np.mean((emb - ref) ** 2) < 1e-8


def test_slice_post_mel(slice_run):
    vc = slice_run["vc"]
    chunks, _ = TMEL.mel_spec_auto_encoder_sliced(
        slice_run["src_p"], vc.AE.config.spectrogram, overlap=0.5)
    post = TAE.batch_forward(vc.AE.params, chunks,
                             torch.from_numpy(slice_run["c_src"][None]),
                             torch.from_numpy(slice_run["c_trg"][None]),
                             vc.AE.config, 0.5, "f32")
    assert post.shape == slice_run["post"].shape
    assert np.mean((post.numpy() - slice_run["post"]) ** 2) < 1e-6


def test_slice_waveform(slice_run):
    out, ref = slice_run["out"], slice_run["ref_wav"]
    assert out.sr == SR
    assert out.wav.shape == ref.shape == ((400 - 1) * 275,)
    assert np.all(np.isfinite(out.wav))
    assert np.sqrt(np.mean(out.wav ** 2)) > 1e-4
    np.testing.assert_allclose(out.wav, ref, atol=1e-3, rtol=0)


def test_slice_stage_times(slice_run):
    """With ``stage_times`` set, convert records every stage's wall."""
    times = slice_run["stage_times"]
    assert set(times) == {"preprocess", "embed_source", "embed_target", "mel",
                          "autoencoder", "vocoder", "download", "outprocess"}
    assert all(t >= 0.0 for t in times.values())
