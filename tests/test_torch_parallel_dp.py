"""Data-parallel training of the port over ``torch.distributed`` on the
CPU: two gloo ranks, started by the port's launcher in subprocesses (the
pytest process never joins a process group), run
``tests/torch_dp_worker.py`` on their halves of seeded global batches, and
the results are held here against

  * ``conv.batchnorm1d`` on the concatenated batch (sync BatchNorm:
    output, running statistics and gradients within 1e-6 of each one's
    largest magnitude (at least 1): the global sums round differently from
    the one-process means, by a few ulps of the f32 values);
  * the JAX single-device steps ``make_ae_step`` and
    ``make_vocoder_step`` and the JAX ``make_sharded_se_step`` (on the
    8-device CPU mesh) on the global batch, f32: loss rel 1e-4, parameters
    after one Adam step atol 3 * lr, gradients rtol 2e-3 / atol 1e-3;
  * the single-process ``train_autoencoder`` on the same global batches
    (2 steps), with only rank 0 writing files, logging and running
    ``on_epoch_end``,

plus ``supervise``'s restarts.  Widths are small: the generator at
``dim_pre`` 64 / ``dim_neck`` 8 on 32 frames, the vocoder at the TINY
config of ``tests/test_torch_vocoder_train.py``, the speaker encoder at
full width on 24 frames."""
import os
import subprocess
import sys
import textwrap

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
from autovc_tpu_torch.config import AutoEncoderConfig as TCfg
from autovc_tpu_torch.config import SpeakerEncoderConfig as TSCfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.ops import conv as TC
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.utils import checkpoint as TCK
from autovc_tpu_torch.utils import tree_clone, tree_leaves
from autovc_tpu_torch.utils import launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_AE = dict(dim_pre=64, dim_neck=8)
TINY_VOC = dict(res_blocks=2, rnn_dims=16, fc_dims=16, compute_dims=8,
                res_out_dims=16)
LR = 1e-4
LOOP_LR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tx():
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))


def _jax_tree(tree):
    """A port parameter tree (fresh, seeded: the JAX ``init`` layout) as
    the JAX functions take it."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _unit_rows(rng, B, dim=256):
    c = rng.standard_normal((B, dim)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The inputs, the JAX parameters, and the two ranks' results (one
    intra-op thread each)."""
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    tae = TAE.init(torch.Generator().manual_seed(0),
                   TCfg().with_overrides(**SMALL_AE))
    tvoc = TWR.init(torch.Generator().manual_seed(1),
                    TWCfg().with_overrides(**TINY_VOC))
    tse = TSE.init(torch.Generator().manual_seed(2), TSCfg())
    jae, jvoc, jse = (_jax_tree(t) for t in (tae, tvoc, tse))
    jwcfg = JWCfg().with_overrides(**TINY_VOC)
    F = 2 + 2 * jwcfg.pad
    T = (F - 2 * jwcfg.pad) * jwcfg.total_scale
    x_in = rng.uniform(-1, 1, (4, T)).astype(np.float32)
    inputs = {
        "lr": LR,
        "bn": {"x": torch.from_numpy(
                   (2.0 + rng.standard_normal((4, 5, 7))).astype(np.float32)),
               "w": torch.from_numpy(
                   rng.standard_normal((4, 5, 7)).astype(np.float32)),
               "scale": torch.from_numpy(
                   (rng.random(5) + 0.5).astype(np.float32)),
               "bias": torch.from_numpy(
                   rng.standard_normal(5).astype(np.float32)),
               "mean": torch.zeros(5), "var": torch.ones(5)},
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
        os.path.join(REPO, "tests", "torch_dp_worker.py"), 2,
        args=[str(d)], device="cpu", timeout=240)
    assert all(rc == 0 for rc, _ in res), [out[-3000:] for _, out in res]
    ranks = [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return dict(dir=d, inputs=inputs, ranks=ranks, jae=jae, jvoc=jvoc,
                jse=jse, jwcfg=jwcfg, tae=tae)


def _hold_grads(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=1e-3)


def _hold_params(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3 * LR,
                                   rtol=0)


def test_ranks_form_one_group_without_jax(dp):
    """Two ranks on the CPU, each on a mesh of both; no JAX module in
    either process."""
    for r, out in enumerate(dp["ranks"]):
        assert out["rank"] == r and out["world"] == 2
        assert out["mesh_devices"] == ["cpu", "cpu"]
        assert out["foreign"] == []


def test_sync_batchnorm_equals_the_concatenated_batch(dp):
    bn = dp["inputs"]["bn"]
    p = {k: bn[k].clone() for k in ("scale", "bias", "mean", "var")}
    x = bn["x"].clone().requires_grad_(True)
    p["scale"].requires_grad_(True)
    p["bias"].requires_grad_(True)
    y = TC.batchnorm1d(p, x, train=True)
    gx, gs, gb = torch.autograd.grad(torch.sum(y * bn["w"]),
                                     [x, p["scale"], p["bias"]])
    for r, out in enumerate(dp["ranks"]):
        got = out["bn"]
        rows = slice(2 * r, 2 * r + 2)
        for a, b in ((got["y"], y[rows]), (got["gx"], gx[rows]),
                     (got["gs"], gs), (got["gb"], gb),
                     (got["mean"], p["mean"]), (got["var"], p["var"])):
            b = b.detach().numpy()
            bar = 1e-6 * max(1.0, float(np.abs(b).max()))
            assert np.abs(a.numpy() - b).max() <= bar


def test_ae_step_matches_jax_single_device(dp):
    ae = dp["inputs"]["ae"]
    jcfg = JCfg().with_overrides(**SMALL_AE)
    tx = _tx()
    step = JL.make_ae_step(jcfg, tx, 0.999, precision="f32",
                           with_grads=True)
    jp, _, _, aux = step(dp["jae"], tx.init(dp["jae"]), dp["jae"],
                         jnp.asarray(ae["x"]), jnp.asarray(ae["c"]))
    for out in dp["ranks"]:
        got = out["ae"]
        for k in ("loss", "loss_recon", "loss_recon0", "loss_content",
                  "grad_norm"):
            assert got["aux"][k] == pytest.approx(float(aux[k]), rel=1e-4), k
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(aux["grads"]))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))
    a, b = (out["ae"]["params"] for out in dp["ranks"])
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_vocoder_step_matches_jax_single_device(dp):
    voc = dp["inputs"]["voc"]
    jcfg = dp["jwcfg"]
    tx = _tx()
    step = JL.make_vocoder_step(jcfg, tx, precision="f32")
    batch = [jnp.asarray(voc[k]) for k in ("x_in", "y", "mels")]
    jp, _, aux = step(dp["jvoc"], tx.init(dp["jvoc"]), *batch)
    with JPREC.compute("f32"):
        grads = jax.jit(jax.grad(lambda p: JWR.loss(
            p, *batch, jcfg, train=True, fast_kernels=False)[0]))(dp["jvoc"])
    for out in dp["ranks"]:
        got = out["voc"]
        assert got["loss"] == pytest.approx(float(aux["loss"]), rel=1e-4)
        assert got["grad_norm"] == pytest.approx(float(aux["grad_norm"]),
                                                 rel=1e-4)
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(grads))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))


def test_se_step_matches_jax_sharded_step(dp):
    """The global GE2E: the JAX sharded step over the 8-device mesh (one
    speaker a device) against two ranks of four speakers."""
    block = dp["inputs"]["se"]["block"]
    cfg = JSCfg()
    tx = _tx()
    mesh = jshd.make_mesh()
    step = jsteps.make_sharded_se_step(cfg, tx, mesh, dp["jse"],
                                       precision="f32")
    jp, _, aux = step(jshd.shard_params(dp["jse"], mesh),
                      tx.init(dp["jse"]), jsteps.shard_batch(block, mesh))
    with JPREC.compute("f32"):
        grads = jax.jit(jax.grad(lambda p: JSE.batch_ge2e_loss(
            p, jnp.asarray(block), fast_kernels=False)))(dp["jse"])
    grads = dict(grads, similarity_weight=grads["similarity_weight"] * 0.01,
                 similarity_bias=grads["similarity_bias"] * 0.01)
    for out in dp["ranks"]:
        got = out["se"]
        assert got["loss"] == pytest.approx(float(aux["loss"]), rel=1e-4)
        assert got["grad_norm"] == pytest.approx(float(aux["grad_norm"]),
                                                 rel=1e-4)
        _hold_grads(got["grads"], jax.tree_util.tree_leaves(grads))
        _hold_params(got["params"], jax.tree_util.tree_leaves(jp))


def _leaf_paths(tree, path=""):
    """'a/b/0/c' paths of a tree's tensor leaves, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{path}/{i}")]
    return [path.lstrip("/")] if isinstance(tree, torch.Tensor) else []


class _ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))


def test_train_autoencoder_mesh_equals_single_process(dp):
    """Two steps of ``train_autoencoder(mesh=)`` against the
    single-process loop on the same global batches; only rank 0 logs,
    saves and runs ``on_epoch_end``."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_worker import ArrayDataset
    lp = dp["inputs"]["loop"]
    logger, epochs = _ListLogger(), []
    params, _, info = TL.train_autoencoder(
        tree_clone(dp["tae"]), ArrayDataset(lp["x"], lp["c"]),
        TCfg().with_overrides(**SMALL_AE), n_epochs=1,
        batch_size=lp["batch_size"], log_freq=1, save_freq=1,
        model_name="", logger=logger, verbose=False,
        on_epoch_end=lambda e, p: epochs.append(e),
        opt_overrides={"lr": LOOP_LR}, precision="f32")
    main, other = (out["loop"] for out in dp["ranks"])
    assert main["step"] == other["step"] == info["step"] == 2
    # Adam moves a weight by up to ~lr a step whatever the size of its
    # gradient, so rounding-level gradient differences move weights by up
    # to 2 lr a step: at LOOP_LR the weights stay within the steps' bar of
    # 3 lr a step.  The BatchNorm running statistics are E[x^2] - E[x]^2
    # of sums that round differently over two ranks (the sync BatchNorm
    # test), carried through the layers: held within 1e-4 of each leaf's
    # largest value.
    for path, g, r in zip(_leaf_paths(params), main["params"],
                          tree_leaves(params)):
        if path.endswith(("bn/mean", "bn/var")):
            r = r.numpy()
            assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max(), \
                path
        else:
            np.testing.assert_allclose(g.numpy(), r.numpy(),
                                       atol=6 * LOOP_LR, rtol=0,
                                       err_msg=path)
    assert [r["step"] for r in main["records"]] == [1, 2]
    for a, b in zip(main["records"], logger.records):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    assert main["epochs"] == epochs == [1]
    assert other["records"] == [] and other["epochs"] == []
    saved = os.listdir(dp["dir"] / "ckpt")
    assert len(saved) == 1, saved
    blob = TCK.load_checkpoint(str(dp["dir"] / "ckpt" / saved[0]))
    assert int(blob["step"]) == 2


def test_make_mesh_of_a_hand_made_group_keeps_to_the_card(tmp_path):
    """A process group set up without ``initialize_distributed`` (gloo by
    hand): ``make_mesh()`` puts the rank on the current CUDA device, and
    with no card raises rather than train on the CPU."""
    script = tmp_path / "hand_group.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch, torch.distributed as dist
        from autovc_tpu_torch.parallel import sharding as shd
        dist.init_process_group(
            "gloo", init_method="tcp://localhost:{launcher.free_port()}",
            world_size=1, rank=0)
        try:
            print("MESH", [str(d) for d in shd.make_mesh().devices])
        except RuntimeError as e:
            print("REFUSED", e)
        dist.destroy_process_group()
    """))
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-3000:]
    if torch.cuda.is_available():
        assert f"MESH ['cuda:{torch.cuda.current_device()}']" in res.stdout
    else:
        assert "REFUSED no CUDA device" in res.stdout, res.stdout
        assert "initialize_distributed" in res.stdout


def test_supervise_restarts_a_script_that_fails_once(tmp_path):
    marker = tmp_path / "failed_once"
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(3)
    """))
    assert launcher.supervise([sys.executable, str(script)],
                              max_restarts=2, verbose=False) == 1
    with pytest.raises(RuntimeError, match="not retryable"):
        marker.unlink()
        launcher.supervise([sys.executable, str(script)], verbose=False,
                           retry_on=(1,))
    with pytest.raises(RuntimeError, match="failed 2 times"):
        launcher.supervise([sys.executable, "-c", "raise SystemExit(2)"],
                           max_restarts=1, verbose=False)


def test_launcher_kills_ranks_past_the_timeout(tmp_path):
    """A rank that outlives the timeout is killed (negative return
    code), with its output kept."""
    script = tmp_path / "sleeper.py"
    script.write_text("import time\nprint('up', flush=True)\n"
                      "time.sleep(60)\n")
    res = launcher.launch_local_multiprocess(str(script), 1, device="cpu",
                                             timeout=1.5)
    (rc, out), = res
    assert rc < 0 and "up" in out
