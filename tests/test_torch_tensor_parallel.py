"""Tensor-parallel training of the port over a ("data", "model") mesh on
the CPU: four gloo ranks, a (2, 2) mesh started by the port's launcher in
subprocesses (the pytest process never joins a process group), run
``tests/torch_tp_worker.py`` on their shards of seeded full trees and
their data index's rows of seeded global batches.  Held here:

  * every leaf's shard (``sharding.shard_leaf``, ``shard_params``) at
    M = 2 and M = 4 against the ``addressable_shards`` of the JAX
    ``NamedSharding`` on the 8-device CPU mesh, (4, 2) and (2, 4): equal;
  * the column-parallel ``linear`` and ``conv1d`` and the tensor-parallel
    LSTM stack, BLSTM and GRU pair against the unsharded op: outputs and
    gradients within 1e-6 of each one's largest magnitude (at least 1);
  * the three sharded steps against the JAX references of
    ``tests/test_torch_parallel_dp.py`` on the global batch, f32: loss
    and ``grad_norm`` rel 1e-4, parameters after one Adam step atol
    3 * lr, gradients rtol 2e-3 / atol 1e-3 (``tests/test_parallel.py``'s
    bars for its (4, 2) step);
  * a 2-step ``train_autoencoder`` on the mesh against the
    single-process loop, its checkpoint one full tree that the JAX reader
    loads; one step of the speaker-encoder and vocoder loops likewise;
  * ``convert(parallel="chunks" | "ring")`` over a local (2, 2) mesh
    against the default path.

Widths as in the data-parallel test: the generator at ``dim_pre`` 64 /
``dim_neck`` 8 on 32 frames, the TINY vocoder, the speaker encoder at
full width on 24 frames."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autovc_tpu.config import AutoEncoderConfig as JCfg
from autovc_tpu.config import SpeakerEncoderConfig as JSCfg
from autovc_tpu.config import WaveRNNConfig as JWCfg
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.models import wavernn as JWR
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.parallel import sharding as jshd
from autovc_tpu.parallel import steps as jsteps
from autovc_tpu.train import loop as JL
from autovc_tpu.utils import checkpoint as JCK
from autovc_tpu_torch.config import AutoEncoderConfig as TCfg
from autovc_tpu_torch.config import SpeakerEncoderConfig as TSCfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.ops import conv as TC
from autovc_tpu_torch.ops import gru_train_kernels as TGT
from autovc_tpu_torch.ops import lstm_train_kernels as TLT
from autovc_tpu_torch.ops import rnn as TR
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import tree_clone, tree_leaves
from autovc_tpu_torch.utils import launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_dp_worker import ArrayDataset  # noqa: E402
from torch_tp_worker import BlockDataset, VocoderDataset  # noqa: E402

SMALL_AE = dict(dim_pre=64, dim_neck=8)
TINY_VOC = dict(res_blocks=2, rnn_dims=16, fc_dims=16, compute_dims=8,
                res_out_dims=16)
LR = 1e-4
LOOP_LR = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tx():
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _unit_rows(rng, B, dim=256):
    c = rng.standard_normal((B, dim)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _op_inputs(rng):
    """Each op's full parameters (paths the rule table shards), input
    (B = 4 rows) and output cotangent."""
    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    return {
        "linear": {"params": {"proj": TC.init_linear(_gen(10), 12, 8)},
                   "x": arr(4, 5, 12), "w": arr(4, 5, 8)},
        "conv1d": {"params": {"convs": [{"conv": TC.init_conv1d(
                       _gen(11), 6, 8, 5)}]},
                   "x": arr(4, 6, 9), "w": arr(4, 8, 9)},
        "lstm": {"params": TR.init_lstm_stack(_gen(12), 8, 16, 2),
                 "x": arr(4, 6, 8), "w": arr(4, 6, 16)},
        "blstm": {"params": TR.init_bilstm_stack(_gen(13), 8, 8, 2),
                  "x": arr(4, 6, 8), "w": arr(4, 6, 16)},
        "gru": {"params": [TR.init_gru_layer(_gen(14), 8, 16),
                           TR.init_gru_layer(_gen(15), 16, 16)],
                "x": arr(4, 6, 8), "w": arr(4, 2, 6, 16)},
    }


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The inputs, the JAX parameters and the four ranks' results."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    tae = TAE.init(_gen(0), TCfg().with_overrides(**SMALL_AE))
    tvoc = TWR.init(_gen(1), TWCfg().with_overrides(**TINY_VOC))
    tse = TSE.init(_gen(2), TSCfg())
    jwcfg = JWCfg().with_overrides(**TINY_VOC)
    F = 2 + 2 * jwcfg.pad
    T = (F - 2 * jwcfg.pad) * jwcfg.total_scale
    x_in = rng.uniform(-1, 1, (4, T)).astype(np.float32)
    inputs = {
        "lr": LR,
        "ops": _op_inputs(rng),
        "ae": {"cfg": SMALL_AE, "params": tae,
               "x": rng.random((4, 80, 32), dtype=np.float32),
               "c": _unit_rows(rng, 4)},
        "voc": {"cfg": TINY_VOC, "params": tvoc,
                "x_in": x_in, "y": np.roll(x_in, -1, 1),
                "mels": rng.random((4, 80, F), dtype=np.float32)},
        "se": {"params": tse,
               "block": rng.random((8, 3, 24, 40), dtype=np.float32)},
        "loop": {"params": tae,
                 "x": rng.random((8, 80, 32), dtype=np.float32),
                 "c": _unit_rows(rng, 8), "batch_size": 4,
                 "lr": LOOP_LR},
    }
    torch.save(inputs, str(d / "inputs.pt"))
    res = launcher.launch_local_multiprocess(
        os.path.join(REPO, "tests", "torch_tp_worker.py"), 4,
        args=[str(d)], device="cpu", timeout=300)
    assert all(rc == 0 for rc, _ in res), [out[-3000:] for _, out in res]
    ranks = [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return dict(dir=d, inputs=inputs, ranks=ranks, jwcfg=jwcfg,
                jae=_jax_tree(tae), jvoc=_jax_tree(tvoc),
                jse=_jax_tree(tse), tae=tae, tvoc=tvoc, tse=tse)


def _hold_grads(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=1e-3)


def _hold_params(got, ref, lr=LR):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3 * lr,
                                   rtol=0)


def _trees():
    return {"generator": (TAE.init(_gen(0), TCfg().with_overrides(
                **SMALL_AE)), TAE.init(_gen(0), TCfg())),
            "vocoder": (TWR.init(_gen(1), TWCfg().with_overrides(
                **TINY_VOC)), TWR.init(_gen(1), TWCfg())),
            "speaker encoder": (TSE.init(_gen(2), TSCfg()),)}


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_shards_equal_the_jax_named_sharding(shape):
    """Every leaf's block at each model index, by ``shard_leaf`` and by
    ``shard_params`` on a local mesh of the same shape, equals the data
    of the JAX ``NamedSharding``'s shard on the device at that index."""
    D, M = shape
    jmesh = jshd.make_mesh(shape, ("data", "model"))
    tmesh = shd.make_mesh(shape, ("data", "model"), devices=[CPU] * (D * M))
    where = {dev: divmod(i, M) for i, dev in
             enumerate(np.asarray(jmesh.devices).reshape(-1))}
    sharded_leaves = 0
    for name, trees in _trees().items():
        for tree in trees:
            jtree = _jax_tree(tree)
            specs = shd.spec_leaves(shd.param_shardings(tree, tmesh), tree)
            placed = jax.tree_util.tree_leaves(jshd.shard_params(jtree,
                                                                 jmesh))
            local = [tree_leaves(t) for t in shd.shard_params(tree, tmesh)]
            for i, (leaf, spec, arr) in enumerate(zip(tree_leaves(tree),
                                                      specs, placed)):
                assert tuple(arr.sharding.spec) == spec, (name, i)
                sharded_leaves += "model" in spec
                for s in arr.addressable_shards:
                    d, m = where[s.device]
                    block = shd.shard_leaf(leaf, spec, m, M).numpy()
                    np.testing.assert_array_equal(block, np.asarray(s.data))
                    np.testing.assert_array_equal(
                        local[d * M + m][i].numpy(), block)
    assert sharded_leaves > 60


def test_ranks_form_the_mesh_groups_without_jax(tp):
    """Rank d * 2 + m: model group {2d, 2d + 1}, data group {m, m + 2}."""
    for r, out in enumerate(tp["ranks"]):
        d, m = divmod(r, 2)
        assert out["rank"] == r and out["shape"] == {"data": 2, "model": 2}
        assert out["groups"] == [[m, m + 2], [2 * d, 2 * d + 1]]
        assert out["foreign"] == []


def _reference_op(name, full):
    p = tree_clone(full["params"])
    leaves = tree_leaves(p)
    x = full["x"].clone().requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    if name == "linear":
        y = TC.linear(p["proj"], x)
    elif name == "conv1d":
        y = TC.conv1d(p["convs"][0]["conv"], x, 2)
    elif name == "lstm":
        y = TLT.lstm_stack_train(p, x)[0]
    elif name == "blstm":
        y = TR.bilstm_stack(p, x)
    else:
        xp1 = torch.matmul(x.transpose(0, 1), p[0]["w_ih"]) + p[0]["b_ih"]
        y = torch.stack(TGT.gru_pair(
            xp1, p[1]["b_ih"].expand(xp1.shape), p[1]["w_ih"],
            p[0]["w_hh"], p[0]["b_hh"], p[1]["w_hh"], p[1]["b_hh"],
            "f32")).permute(2, 0, 1, 3)
    gx, *gw = torch.autograd.grad(torch.sum(y * full["w"]), [x] + leaves)
    return y.detach(), gx, gw


def _near(a, b):
    b = b.detach().numpy()
    assert np.abs(a.numpy() - b).max() <= 1e-6 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("name", ["linear", "conv1d", "lstm", "blstm",
                                  "gru"])
def test_tensor_parallel_op_equals_the_unsharded_op(tp, name):
    full = tp["inputs"]["ops"][name]
    y, gx, gw = _reference_op(name, full)
    for r, out in enumerate(tp["ranks"]):
        got = out["ops"][name]
        d = r // 2
        _near(got["y"], y[2 * d:2 * d + 2])
        _near(got["gx"], gx[2 * d:2 * d + 2])
        assert len(got["gw"]) == len(gw)
        for a, b in zip(got["gw"], gw):
            _near(a, b)


def test_ae_step_matches_jax_single_device(tp):
    ae = tp["inputs"]["ae"]
    jcfg = JCfg().with_overrides(**SMALL_AE)
    tx = _tx()
    step = JL.make_ae_step(jcfg, tx, 0.999, precision="f32",
                           with_grads=True)
    jp, _, je, aux = step(tp["jae"], tx.init(tp["jae"]), tp["jae"],
                          jnp.asarray(ae["x"]), jnp.asarray(ae["c"]))
    for out in tp["ranks"]:
        got = out["ae"]
        for k in ("loss", "loss_recon", "loss_recon0", "loss_content",
                  "grad_norm"):
            assert got["aux"][k] == pytest.approx(float(aux[k]), rel=1e-4), k
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(aux["grads"]))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))
        _hold_params(got["ema"], jax.tree_util.tree_leaves(je))
    first = tp["ranks"][0]["ae"]["params"]
    for out in tp["ranks"][1:]:
        assert all(torch.equal(u, v)
                   for u, v in zip(first, out["ae"]["params"]))


def test_vocoder_step_matches_jax_single_device(tp):
    voc = tp["inputs"]["voc"]
    jcfg = tp["jwcfg"]
    tx = _tx()
    step = JL.make_vocoder_step(jcfg, tx, precision="f32")
    batch = [jnp.asarray(voc[k]) for k in ("x_in", "y", "mels")]
    jp, _, aux = step(tp["jvoc"], tx.init(tp["jvoc"]), *batch)
    with JPREC.compute("f32"):
        grads = jax.jit(jax.grad(lambda p: JWR.loss(
            p, *batch, jcfg, train=True, fast_kernels=False)[0]))(tp["jvoc"])
    for out in tp["ranks"]:
        got = out["voc"]
        assert got["loss"] == pytest.approx(float(aux["loss"]), rel=1e-4)
        assert got["grad_norm"] == pytest.approx(float(aux["grad_norm"]),
                                                 rel=1e-4)
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(grads))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))


def test_se_step_matches_jax_sharded_step(tp):
    """The global GE2E: the JAX sharded step over the 8-device mesh against
    the (2, 2) mesh's two data rows of four speakers."""
    block = tp["inputs"]["se"]["block"]
    tx = _tx()
    mesh = jshd.make_mesh()
    step = jsteps.make_sharded_se_step(JSCfg(), tx, mesh, tp["jse"],
                                       precision="f32")
    jp, _, aux = step(jshd.shard_params(tp["jse"], mesh),
                      tx.init(tp["jse"]), jsteps.shard_batch(block, mesh))
    with JPREC.compute("f32"):
        grads = jax.jit(jax.grad(lambda p: JSE.batch_ge2e_loss(
            p, jnp.asarray(block), fast_kernels=False)))(tp["jse"])
    grads = dict(grads, similarity_weight=grads["similarity_weight"] * 0.01,
                 similarity_bias=grads["similarity_bias"] * 0.01)
    for out in tp["ranks"]:
        got = out["se"]
        assert got["loss"] == pytest.approx(float(aux["loss"]), rel=1e-4)
        assert got["grad_norm"] == pytest.approx(float(aux["grad_norm"]),
                                                 rel=1e-4)
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(grads))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))


class _ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))


def test_train_autoencoder_mesh_equals_single_process(tp):
    """Two steps of ``train_autoencoder`` on the (2, 2) mesh against the
    single-process loop; rank 0 alone logs, runs ``on_epoch_end`` (with
    the full tree) and writes one full-tree checkpoint, which the JAX
    reader loads."""
    lp = tp["inputs"]["loop"]
    logger = _ListLogger()
    params, _, info = TL.train_autoencoder(
        tree_clone(tp["tae"]), ArrayDataset(lp["x"], lp["c"]),
        TCfg().with_overrides(**SMALL_AE), n_epochs=1,
        batch_size=lp["batch_size"], log_freq=1, save_freq=1,
        model_name="", logger=logger, verbose=False,
        opt_overrides={"lr": LOOP_LR}, precision="f32")
    full = [tuple(t.shape) for t in tree_leaves(params)]
    ranks = [out["loop"] for out in tp["ranks"]]
    for out in ranks:
        assert out["step"] == info["step"] == 2
        assert [tuple(t.shape) for t in out["params"]] == full
        # the bars of the data-parallel loop test: Adam moves a weight by
        # up to ~lr a step whatever its gradient's size; the BatchNorm
        # statistics are sums that round differently over the ranks
        for g, r in zip(out["params"], tree_leaves(params)):
            r = r.numpy()
            bar = max(6 * LOOP_LR, 1e-4 * np.abs(r).max())
            assert np.abs(g.numpy() - r).max() <= bar
        for g, r in zip(out["mu"], info["opt_state"]["mu"]):
            assert g.shape == r.shape
    assert [r["step"] for r in ranks[0]["records"]] == [1, 2]
    for a, b in zip(ranks[0]["records"], logger.records):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    assert ranks[0]["epochs"] == [full]
    assert all(out["records"] == [] and out["epochs"] == []
               for out in ranks[1:])
    saved = os.listdir(tp["dir"] / "ckpt")
    assert len(saved) == 1, saved
    blob = JCK.load_checkpoint(str(tp["dir"] / "ckpt" / saved[0]))
    assert int(blob["step"]) == 2
    leaves = jax.tree_util.tree_leaves(blob["params"])
    assert [tuple(np.shape(a)) for a in leaves] == full
    for a, b in zip(leaves, ranks[0]["params"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(jax.tree_util.tree_leaves(blob["ema_params"])) == len(full)


def test_se_and_vocoder_loops_on_the_mesh_equal_one_process(tp):
    se, voc = tp["inputs"]["se"], tp["inputs"]["voc"]
    sp, _ = TL.train_speaker_encoder(
        tree_clone(tp["tse"]), BlockDataset(se["block"]), TSCfg(),
        n_epochs=1, steps_per_epoch=1, model_name="", verbose=False)
    vp, _ = TL.train_vocoder(
        tree_clone(tp["tvoc"]), VocoderDataset(
            (voc["x_in"], voc["y"], voc["mels"])),
        TWCfg().with_overrides(**TINY_VOC), n_epochs=1, steps_per_epoch=1,
        batch_size=4, lr=LR, model_name="", verbose=False)
    lr_se = TSCfg().optimizer.lr
    for out in tp["ranks"]:
        assert out["se_loop"]["step"] == out["voc_loop"]["step"] == 1
        _hold_params(out["se_loop"]["params"], [
            t.numpy() for t in tree_leaves(sp)], lr_se)
        _hold_params(out["voc_loop"]["params"], [
            t.numpy() for t in tree_leaves(vp)])


@pytest.mark.parametrize("parallel", ["chunks", "ring"])
def test_convert_over_a_local_model_mesh_equals_the_default(parallel,
                                                            monkeypatch):
    """``convert(parallel=)`` on a local (2, 2) mesh splits over the data
    axis with the generator whole, as the JAX paths do.  At the mel the
    vocoder gets (atol 1e-5): the chunks path equals the default path; the
    ring, over the host mel trimmed to a multiple of the data axis, equals
    ``autoencoder.infer`` of that mel (the ``cut=False`` generator)."""
    from autovc_tpu_torch import Audio, ConverterConfig, VoiceConverter
    from autovc_tpu_torch.audio import dsp
    cfg = ConverterConfig().with_overrides(
        auto_encoder=dict(SMALL_AE, spectrogram={
            "partial_utterance_n_frames": 32}),
        vocoder=dict(TINY_VOC, generate={"target": 1375}))
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False,
                        ae_precision="f32", vocoder_precision="f32")
    seen = []
    real = TWR._generate_program

    def tap(params, mel, *a):
        seen.append(mel[0].clone())
        return real(params, mel, *a)

    monkeypatch.setattr(TWR, "_generate_program", tap)
    rng = np.random.default_rng(5)
    t = np.arange(int(0.9 * 22050)) / 22050
    src = (0.3 * np.sin(2 * np.pi * 180 * t)
           + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    mesh = shd.make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)

    def convert(**kw):
        return vc.convert(Audio(src.copy(), sr_org=22050),
                          Audio(src.copy(), sr_org=22050), save_name=False,
                          preprocess=(), outprocess=(), seed=3, **kw).wav

    got = convert(parallel=parallel, mesh=mesh)
    assert np.isfinite(got).all()
    if parallel == "chunks":
        ref = convert()
        assert got.shape == ref.shape
        np.testing.assert_allclose(seen[0].numpy(), seen[1].numpy(),
                                   rtol=0, atol=1e-5)
        return
    mel = dsp.mel_spec_auto_encoder(src, vc.AE.config.spectrogram)
    Tn = mel.shape[-1] // 2 * 2
    c = torch.from_numpy(vc._embed(Audio(src.copy(), sr_org=22050))[None])
    one = TAE.infer(vc.AE.params, torch.from_numpy(np.ascontiguousarray(
        mel[None, :, :Tn], np.float32)), c, c, vc.AE.config)[0]
    assert seen[0].shape == (80, Tn)
    np.testing.assert_allclose(seen[0].numpy(), one.numpy(), rtol=0,
                               atol=1e-5)
