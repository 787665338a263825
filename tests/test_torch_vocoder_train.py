"""CPU parity of the port's WaveRNN vocoder training against the JAX
package: the loss and every gradient leaf (``up_convs`` included) and the
BatchNorm statistics after a train-mode pass, the MOL loss and the RAW /
mu-law loss, the dataset's batches, a 3-step trajectory of
``make_vocoder_step``, checkpoints across the two packages, and
``VoiceConverter(device="cpu").train(..., model_type="vocoder")``.

The model is the tiny config of ``tests/test_gru_train_pallas.py`` (res
blocks 2, rnn / fc 16, compute 8, res_out 16; B 2, F 8).  Parameters come
from the JAX ``init`` through the weight bridge and data from numpy seeds.
The JAX side runs its scan branch (``fast_kernels=False``), which the JAX
kernel test holds to its Pallas branch at rtol/atol 3e-4."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.config import OptimizerConfig as JOCfg
from autovc_tpu.config import WaveRNNConfig as JWCfg
from autovc_tpu.models import wavernn as JWR
from autovc_tpu.ops import mol as JMOL
from autovc_tpu.train import data as JD
from autovc_tpu.train import loop as JL
from autovc_tpu.train import schedules as JS
from autovc_tpu.utils import checkpoint as JCK
from autovc_tpu_torch.audio import io as TIO
from autovc_tpu_torch.config import ConverterConfig
from autovc_tpu_torch.config import OptimizerConfig as TOCfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.ops import mol as TMOL
from autovc_tpu_torch.ops import wavernn_kernels as TWK
from autovc_tpu_torch.train import data as TD
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params

TINY = dict(res_blocks=2, rnn_dims=16, fc_dims=16, compute_dims=8,
            res_out_dims=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, F=8, seed=2):
    rng = np.random.default_rng(seed)
    T = (F - 2 * cfg.pad) * cfg.total_scale
    mels = rng.random((B, 80, F), dtype=np.float32)
    x = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    return x, np.roll(x, -1, 1), mels


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_loss_and_grads_match_jax(mode):
    """f32: loss rtol 1e-5, every gradient leaf rtol/atol 3e-4, the
    ``up_convs`` gradients nonzero; the BatchNorm running statistics after
    the pass equal to the JAX tree's.  RAW trains in the mu-law companded
    domain."""
    over = dict(TINY, mode=mode, generate={"mu_law": mode == "RAW"})
    jcfg, tcfg = JWCfg().with_overrides(**over), TWCfg().with_overrides(**over)
    jp = JWR.init(jax.random.PRNGKey(0), jcfg)
    x, y, mels = _batch(jcfg)
    (ref, new_jp), ref_g = jax.value_and_grad(
        lambda p: JWR.loss(p, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(mels), jcfg, train=True,
                           fast_kernels=False), has_aux=True)(jp)
    tp = from_jax_params(jp)
    loss, grads = TL.vocoder_loss_and_grads(tp, x, y, mels, tcfg, "f32")
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    for name, a, b in zip(_paths(jp), grads, jax.tree_util.tree_leaves(ref_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4, err_msg=name)
        if "up_convs" in name:
            assert float(a.abs().max()) > 1e-4, name
    for name, a, b in zip(_paths(jp), tree_leaves(tp),
                          jax.tree_util.tree_leaves(new_jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_upsample_conv_chain_matches_jax():
    """pad 1 < J = 2 takes the sample-rate conv chain, not the banded
    kernel: both outputs, and the ``up_convs`` gradients of a scalar of
    them, against the JAX ``upsample`` in train mode (rtol/atol 3e-4)."""
    over = dict(TINY, pad=1)
    jcfg, tcfg = JWCfg().with_overrides(**over), TWCfg().with_overrides(**over)
    jp = JWR.init(jax.random.PRNGKey(6), jcfg)["upsample"]
    _, _, mels = _batch(jcfg, seed=6)

    def scalar(m, a, lib):
        return lib.sum(lib.sin(m)) + lib.sum(lib.cos(a))

    def jax_fn(p):
        m, a, _ = JWR.upsample(p, jnp.asarray(mels), jcfg, train=True)
        return scalar(m, a, jnp), (m, a)

    (_, refs), ref_g = jax.value_and_grad(jax_fn, has_aux=True)(jp)
    tp = from_jax_params(jp)
    for w in tp["up_convs"]:
        w.requires_grad_(True)
    outs = TWR.upsample(tp, torch.from_numpy(mels), tcfg, train=True)
    scalar(*outs, torch).backward()
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=3e-4, atol=3e-4)
    for w, g in zip(tp["up_convs"], ref_g["up_convs"]):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g), rtol=3e-4,
                                   atol=3e-4)


def test_mol_loss_matches_jax():
    """Random logits and targets, with targets at and beyond the +-0.999
    edges and narrow mixtures whose bin mass falls under 1e-5 (the pdf
    fallback): the loss and its gradient."""
    rng = np.random.default_rng(4)
    y_hat = rng.standard_normal((3, 50, 30)).astype(np.float32)
    y_hat[0, :, 20:] = -9.0                       # narrow: the pdf fallback
    y = rng.uniform(-1, 1, (3, 50, 1)).astype(np.float32)
    y[1, :10] = 1.0
    y[1, 10:20] = -1.0
    y[2, :5] = 0.9995
    ref, ref_g = jax.value_and_grad(JMOL.discretized_mix_logistic_loss)(
        jnp.asarray(y_hat), jnp.asarray(y))
    t = torch.from_numpy(y_hat).requires_grad_(True)
    loss = TMOL.discretized_mix_logistic_loss(t, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    # the narrow mixtures' log-scale gradients reach ~12: atol relative to
    # the largest, for f32 sums taken in another order
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(t.grad.numpy(), ref_g, rtol=1e-4,
                               atol=1e-5 * np.abs(ref_g).max())


def test_encode_mu_law_matches_jax():
    x = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_allclose(
        TWR.encode_mu_law(torch.from_numpy(x), 512).numpy(),
        np.asarray(JWR.encode_mu_law(jnp.asarray(x), 512)), rtol=1e-6,
        atol=1e-6)


def _synthetic_wavs(tmp_path, n, seconds=1.0, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        wav = np.sin(2 * np.pi * (120.0 + 60.0 * i) * t) * (0.2 + 0.1 * i)
        TIO.save_wav(str(tmp_path / f"voc{i}.wav"), wav.astype(np.float32),
                     sr)
    return str(tmp_path)


def test_dataset_batches_match_jax(tmp_path):
    """Same files and seed: the same windows, in the same order, with the
    too-short file's draws skipped."""
    path = _synthetic_wavs(tmp_path, 3)
    TIO.save_wav(str(tmp_path / "short.wav"),
                 np.zeros(2000, np.float32), 22050)
    jds = JD.VocoderDataset(path, verbose=False)
    tds = TD.VocoderDataset(path, verbose=False)
    jb = list(jds.batches(4, seq_frames=3, n_batches=5, seed=3))
    tb = list(tds.batches(4, seq_frames=3, n_batches=5, seed=3))
    assert len(tb) == len(jb) == 5
    for a, b in zip(tb, jb):
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-6)


def test_trajectory_matches_make_vocoder_step():
    """3 f32 steps (clip 4, Adam at 1e-3) from the same init and batches:
    losses within rtol 1e-4 of ``make_vocoder_step(..., precision="f32")``
    and falling."""
    jcfg, tcfg = JWCfg().with_overrides(**TINY), TWCfg().with_overrides(**TINY)
    jp = JWR.init(jax.random.PRNGKey(1), jcfg)
    oc = dict(lr=1e-3, lr_scheduler="constant", grad_clip_norm=4.0)
    jtx = JS.make_optimizer(JOCfg(**oc), 1)
    ttx = TS.make_optimizer(TOCfg(**oc), 1)
    jstep = JL.make_vocoder_step(jcfg, jtx, precision="f32")
    tstep = TL.make_vocoder_step(tcfg, ttx, precision="f32")
    tp = from_jax_params(jp)
    jstate, tstate = jtx.init(jp), ttx.init(tree_leaves(tp))
    jl, tl = [], []
    for i in range(3):
        x, y, mels = _batch(jcfg, seed=10 + i)
        jp, jstate, jaux = jstep(jp, jstate, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(mels))
        tp, tstate, taux = tstep(tp, tstate, x, y, mels)
        jl.append(float(jaux["loss"]))
        tl.append(float(taux["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_resume_from_a_jax_checkpoint(tmp_path):
    """``train_vocoder(resume=True)`` restores a JAX-written checkpoint's
    step, parameters and Adam state (count, mu, nu: the optax chain's)."""
    jcfg, tcfg = JWCfg().with_overrides(**TINY), TWCfg().with_overrides(**TINY)
    jp = JWR.init(jax.random.PRNGKey(2), jcfg)
    tx = JS.make_optimizer(JOCfg(lr=1e-4, lr_scheduler="constant",
                                 grad_clip_norm=4.0), 1)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, jp)
    _, state = tx.update(grads, tx.init(jp), jp)
    JCK.save_checkpoint(str(tmp_path / "voc.ckpt"),
                        {"step": 5, "params": jp, "opt_state": state})
    adam = next(s for s in state if hasattr(s, "mu"))
    fresh = from_jax_params(JWR.init(jax.random.PRNGKey(3), jcfg))
    params, info = TL.train_vocoder(fresh, None, tcfg, n_epochs=0,
                                    save_dir=str(tmp_path), resume=True,
                                    verbose=False)
    assert info["step"] == 5 and info["opt_state"]["count"] == 1
    for a, b in zip(tree_leaves(params) + info["opt_state"]["mu"]
                    + info["opt_state"]["nu"],
                    jax.tree_util.tree_leaves((jp, adam.mu, adam.nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_voice_converter_trains_vocoder_on_cpu(tmp_path):
    """Two steps of 2 x 3 frames: a ``.ckpt`` the JAX package reads, a
    resume that continues the step count and the Adam state, and the
    sampling loop's packed weights rebuilt from the trained weights."""
    from autovc_tpu_torch import VoiceConverter
    data = tmp_path / "wavs"
    data.mkdir()
    path = _synthetic_wavs(data, 2)
    cfg = ConverterConfig().with_overrides(vocoder=TINY)
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
    before = vc._vocoder_packed
    records = []
    vc.logger = type("Cap", (), {"log": lambda self, m, step=None:
                                 records.append(m)})()
    kw = dict(model_type="vocoder", n_epochs=1, steps_per_epoch=2,
              batch_size=2, seq_frames=3, log_freq=1, model_name="voc.ckpt",
              save_dir=str(tmp_path / "ckpt"))
    info = vc.train(path, **kw)
    assert info["step"] == vc.vocoder.step == len(records) == 2
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    blob = JCK.load_checkpoint(str(tmp_path / "ckpt" / "voc.ckpt"))
    assert blob["step"] == 2
    for a, b in zip(jax.tree_util.tree_leaves(blob["params"]),
                    tree_leaves(vc.vocoder.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    packed = TWK.pack_weights(vc.vocoder.params, vc.vocoder.config, False)
    for k, v in packed.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(vc._vocoder_packed[k], v, rtol=0,
                                       atol=0)
    assert not torch.equal(before["w_hh1"], vc._vocoder_packed["w_hh1"])
    info = vc.train(path, resume=True, **kw)
    assert info["step"] == 4 and info["opt_state"]["count"] == 4
    assert os.path.isfile(tmp_path / "ckpt" / "voc.ckpt")
