"""CPU parity of the port's AutoVC generator training against the JAX
package: train-mode BatchNorm, the bf16 conv, BLSTM and inference-stack
roundings, the three-term loss and its gradients, the optimizer chain
against optax, the schedules, the step's loss trajectory, the EMA, the
dataset's batches, the checkpoint writer (read by the JAX package), exact
resume, and ``VoiceConverter(device="cpu").train``.

Parameters come from the JAX ``init`` through the weight bridge and data
from numpy seeds, so both sides see the same numbers.  Parameters are never
compared element by element after several Adam steps: Adam turns gradient
noise near zero into +-lr."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autovc_tpu.config import AutoEncoderConfig as JCfg
from autovc_tpu.config import SpeakerEncoderConfig as JSCfg
from autovc_tpu.models import autoencoder as JAE
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.ops import conv as JC
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.ops import rnn as JR
from autovc_tpu.train import data as JD
from autovc_tpu.train import loop as JL
from autovc_tpu.train import schedules as JS
from autovc_tpu.utils import checkpoint as JCK
from autovc_tpu_torch.audio import io as TIO
from autovc_tpu_torch.config import AutoEncoderConfig as TCfg
from autovc_tpu_torch.config import ConverterConfig, OptimizerConfig
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.ops import conv as TC
from autovc_tpu_torch.ops import lstm_kernels as TLK
from autovc_tpu_torch.train import data as TD
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import checkpoint as TCK
from autovc_tpu_torch.utils import tree_clone, tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return JAE.init(jax.random.PRNGKey(0), JCfg())


def _batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 80, T), dtype=np.float32)
    c = rng.standard_normal((B, 256)).astype(np.float32)
    return x, c / np.linalg.norm(c, axis=1, keepdims=True)


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_batchnorm_train_matches_jax():
    rng = np.random.default_rng(0)
    x = (2.0 + rng.standard_normal((3, 5, 7))).astype(np.float32)
    jp = {"scale": jnp.asarray(rng.random(5) + 0.5, jnp.float32),
          "bias": jnp.asarray(rng.standard_normal(5), jnp.float32),
          "mean": jnp.asarray(rng.standard_normal(5), jnp.float32),
          "var": jnp.asarray(rng.random(5) + 0.5, jnp.float32)}
    ref, new = JC.batchnorm1d(jp, jnp.asarray(x), train=True)
    tp = from_jax_params(jp)
    out = TC.batchnorm1d(tp, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):       # updated in place, momentum 0.1
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(new[k]),
                                   rtol=1e-6, atol=1e-6)
    # eval mode reads the running statistics
    ref, _ = JC.batchnorm1d(new, jnp.asarray(x), train=False)
    np.testing.assert_allclose(TC.batchnorm1d(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_conv_rounds_output_like_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 30)).astype(np.float32)
    jp = JC.init_conv1d(jax.random.PRNGKey(3), 24, 16, 5)
    with JPREC.compute("bf16"):
        ref = JC.conv1d(jp, jnp.asarray(x), padding=2)
    out = TC.conv1d(from_jax_params(jp), torch.from_numpy(x), 2, "bf16")
    # both round the f32-accumulated sum to bf16 before the bias: equal up
    # to one bf16 step where the two sums round to neighbours
    diff = np.abs(out.numpy() - np.asarray(ref))
    assert diff.max() <= 2.0 ** -8 * np.abs(np.asarray(ref)).max()
    assert np.mean(diff == 0.0) > 0.9


def test_bf16_ae_forward_matches_jax(jax_params):
    """Eval-mode bf16 forward at 2 rows against the JAX bf16 forward, with
    lstm1's recurrent product rounded to bf16 as the JAX scan rounds it.
    Bars: post-mel MSE < 2e-6 (measured 1.08e-6; 1.11e-6 when lstm1 ran in
    f32, whose deviation this mean hides: see the stack test below) and
    codes atol 2e-3 (measured 2.6e-4)."""
    x, c = _batch(2, 64, seed=2)
    with JPREC.compute("bf16"):
        _, ref, ref_codes, _ = JAE.forward(jax_params, jnp.asarray(x),
                                           jnp.asarray(c), jnp.asarray(c),
                                           JCfg())
    _, post, codes = TAE.forward(from_jax_params(jax_params),
                                 torch.from_numpy(x), torch.from_numpy(c),
                                 torch.from_numpy(c), TCfg(), "bf16")
    assert float(np.mean((post.numpy() - np.asarray(ref)) ** 2)) < 2e-6
    np.testing.assert_allclose(codes.numpy(), np.asarray(ref_codes),
                               atol=2e-3)


@pytest.mark.parametrize("name,L,I,H,B,T", [("speaker_encoder", 3, 40, 256,
                                             3, 160),
                                            ("lstm1", 1, 320, 512, 2, 64)])
def test_bf16_scan_stacks_match_jax(name, L, I, H, B, T):
    """The stacks the JAX package runs as bf16 scans at inference (H >= 256,
    >= 2 rows), through ``lstm_stack_rec`` (kernels 2/3's plain version on
    the CPU) against the JAX scans under bf16.  Bar: mean |err| < 6e-6
    (measured 2.9e-6 for both; the f32 recurrence these stacks ran before
    gives 1.7e-5 and 1.2e-4)."""
    jp = JR.init_lstm_stack(jax.random.PRNGKey(5), I, H, L)
    x = (0.5 * np.random.default_rng(6).standard_normal((B, T, I))).astype(
        np.float32)
    scan = JR.lstm_stack_skewed if name == "speaker_encoder" else JR.lstm_stack
    with JPREC.compute("bf16"):
        ref = np.asarray(scan(jp, jnp.asarray(x))[0])
    out = TLK.lstm_stack_rec(from_jax_params(jp), torch.from_numpy(x), "bf16")
    assert float(np.abs(out.numpy() - ref).mean()) < 6e-6


def test_bf16_speaker_embedding_matches_jax():
    """The bf16 speaker embedding of one utterance from 3 partials (the
    forward, then the mean and L2 norm of ``embed_utterances``) against the
    JAX bf16 forward's.  Bar: MSE < 2e-9 (measured 4.2e-10 and 7.1e-10 on
    two seeds; an f32 recurrence gives 5.8e-9 and 5.9e-9)."""
    sp = JSE.init(jax.random.PRNGKey(1), JSCfg())
    u = np.random.default_rng(3).random((3, 160, 40), dtype=np.float32)
    with JPREC.compute("bf16"):
        ref = np.asarray(JSE.forward(sp, jnp.asarray(u))).mean(axis=0)
    out = TSE.forward(from_jax_params(sp), torch.from_numpy(u),
                      "bf16").numpy().mean(axis=0)
    ref, out = ref / np.linalg.norm(ref), out / np.linalg.norm(out)
    assert float(np.mean((out - ref) ** 2)) < 2e-9


@pytest.mark.parametrize("lambd,bar", [(1.0, 1e-2), (0.0, 2e-4)])
def test_ae_loss_and_grads_match_jax(jax_params, lambd, bar):
    """Full width, B=2, T=64, f32: the loss terms (rtol 1e-5) and every
    gradient leaf (within ``bar`` of its max |ref|).  The content term's
    gradient passes two encoder runs' ReLUs, where a 1e-6 perturbation of
    the input moves JAX's own gradients by ~3e-2 of their max: the two
    implementations differ there by ~2e-3 (bar 1e-2), and by ~3e-5 without
    that term (bar 2e-4).  The conv biases before a batch-norm have an
    analytically zero gradient: both sides' must be rounding noise."""
    x, c = _batch(2, 64)
    loss = functools.partial(JAE.loss, lambd=lambd)
    (_, (aux, _)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                   static_argnums=3)(
        jax_params, jnp.asarray(x), jnp.asarray(c), JCfg())
    tp = from_jax_params(jax_params)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    total, taux = TAE.loss(tp, torch.from_numpy(x), torch.from_numpy(c),
                           TCfg(), lambd=lambd)
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    for k in aux:
        np.testing.assert_allclose(float(taux[k].detach()), float(aux[k]),
                                   rtol=1e-5)
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    noise = 1e-5 * max(np.abs(r).max() for r in ref)
    for path, a, r in zip(_paths(jax_params), got, ref):
        a = np.zeros_like(r) if a is None else a.numpy()
        if path.endswith("['conv']['b']"):
            assert max(np.abs(a).max(), np.abs(r).max()) <= noise, path
        else:
            assert np.abs(a - r).max() <= bar * np.abs(r).max(), path


def test_optimizer_matches_optax():
    """clip -> Adam -> weight decay -> -lr(count) on identical gradients,
    with the clip both triggered and not, over 4 updates (1e-6)."""
    cfg = OptimizerConfig(lr=3e-3, lr_scheduler="exponential", gamma=0.5,
                          grad_clip_norm=1.0, weight_decay=0.01)
    rng = np.random.default_rng(4)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    tx = JS.make_optimizer(cfg, steps_per_epoch=2)
    jstate = tx.init(params)
    jparams = [jnp.asarray(p) for p in params]
    mine = TS.make_optimizer(cfg, steps_per_epoch=2)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = mine.init(tparams)
    for step, scale in enumerate((0.1, 5.0, 0.2, 3.0)):
        grads = [(scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for p in params]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = mine.step(tparams, [torch.from_numpy(g) for g in grads],
                         tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(g) for g in grads])), rtol=1e-6)
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert tstate["count"] == 4


@pytest.mark.parametrize("kind", ["exponential", "noam", "constant"])
def test_schedules_match_jax(kind):
    cfg = OptimizerConfig(lr=1e-3, lr_scheduler=kind, n_warmup_steps=16)
    jsched = JS.make_schedule(cfg, steps_per_epoch=5, dim_model=80)
    tsched = TS.make_schedule(cfg, steps_per_epoch=5, dim_model=80)
    for step in (0, 1, 4, 5, 12, 16, 40, 400):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6)


# Adam moves every weight by ~lr whatever the size of its gradient, so the
# two sides' rounding-level gradient differences (on the content term's
# ReLU kinks, see above) reach the loss in proportion to lr: at lr 1e-4 the
# f32 trajectories part by ~4e-3 at step 4, at 1e-5 by ~5e-4.
_LR = 1e-5


def _trajectory_jax(cfg, jp, x, c, precision, n):
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(_LR))
    step = JL.make_ae_step(cfg, tx, ema_decay=0.9999, precision=precision)
    state, ema, losses = tx.init(jp), jp, []
    for _ in range(n):
        jp, state, ema, aux = step(jp, state, ema, x, c)
        losses.append(float(aux["loss"]))
    return np.asarray(losses)


def _trajectory_torch(cfg, jp, x, c, precision, n):
    tx = TS.Optimizer(lambda count: _LR, 0.9, 0.999, 1e-8, 1.0)
    params = from_jax_params(jp)
    step = TL.make_ae_step(cfg, tx, 0.9999, precision)
    state, ema, losses = tx.init(tree_leaves(params)), tree_clone(params), []
    for _ in range(n):
        params, state, ema, aux = step(params, state, ema, x, c)
        losses.append(float(aux["loss"]))
    return np.asarray(losses)


@pytest.fixture(scope="module")
def trajectories(jax_params):
    """4 steps of each step function on one batch (B=2, T=64), f32 and
    bf16, from the same init."""
    x, c = _batch(2, 64, seed=5)
    out = {}
    for prec in ("f32", "bf16"):
        out["jax", prec] = _trajectory_jax(JCfg(), jax_params, x, c, prec, 4)
        out["torch", prec] = _trajectory_torch(TCfg(), jax_params, x, c,
                                               prec, 4)
    return out


def test_f32_trajectory_matches_make_ae_step(trajectories):
    """rtol 1e-3 over four steps (they part by ~5e-4 at step 4, see
    ``_LR``)."""
    np.testing.assert_allclose(trajectories["torch", "f32"],
                               trajectories["jax", "f32"], rtol=1e-3)
    assert trajectories["torch", "f32"][-1] < trajectories["torch", "f32"][0]


def test_bf16_trajectory_tracks_f32_and_jax(trajectories):
    bf16 = trajectories["torch", "bf16"]
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, trajectories["torch", "f32"], rtol=0.05)
    np.testing.assert_allclose(bf16, trajectories["jax", "bf16"], rtol=0.05)
    assert not np.array_equal(bf16, trajectories["torch", "f32"])


def test_ema_covers_batchnorm_statistics(jax_params):
    x, c = _batch(2, 32, seed=6)
    params = from_jax_params(jax_params)
    before = tree_clone(params)
    ema = tree_clone(params)
    tx = TS.Optimizer(lambda count: 1e-3, 0.9, 0.999, 1e-8, 1.0)
    params, _, ema, aux = TL.make_ae_step(TCfg(), tx, 0.9, "f32")(
        params, tx.init(tree_leaves(params)), ema, x, c)
    assert set(aux) >= {"loss", "loss_recon", "loss_content", "grad_norm"}
    for b, p, e in zip(tree_leaves(before), tree_leaves(params),
                       tree_leaves(ema)):
        torch.testing.assert_close(e, 0.9 * b + 0.1 * p, rtol=1e-6,
                                   atol=1e-7)
    bn = params["encoder"]["convs"][0]["bn"]
    bn0 = before["encoder"]["convs"][0]["bn"]
    # the forward and the encoder re-run each moved the running stats
    assert not torch.equal(bn["mean"], bn0["mean"])
    assert not torch.equal(ema["encoder"]["convs"][0]["bn"]["var"], bn0["var"])


def _synthetic_wavs(tmp_path, n, seconds=1.6, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        f0 = 110.0 + 40.0 * i
        wav = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
        TIO.save_wav(str(tmp_path / f"spk{i % 2}_{i}.wav"),
                     (0.2 * wav).astype(np.float32), sr)
    return str(tmp_path)


def test_dataset_batches_match_jax(tmp_path):
    """Same files, same registry: the same mel chunks, embeddings and
    batch order (default_rng(seed) shuffle, drop-last)."""
    from autovc_tpu.config import SpeakerEncoderConfig
    from autovc_tpu.models import speaker_encoder as JSE
    from autovc_tpu_torch.config import SpeakerEncoderConfig as TSECfg
    path = _synthetic_wavs(tmp_path, 3)
    speakers = {"spk0": np.full(256, 0.0625, np.float32)}
    se = JSE.init(jax.random.PRNGKey(1), SpeakerEncoderConfig())
    small = dict(spectrogram={"partial_utterance_n_frames": 32})
    jds = JD.AutoEncoderDataset(path, speaker_encoder=se,
                                speakers=speakers, verbose=False,
                                cfg=JCfg().with_overrides(**small))
    tds = TD.AutoEncoderDataset(path, speaker_encoder=from_jax_params(se),
                                speaker_encoder_params=TSECfg(),
                                speakers=speakers, verbose=False,
                                cfg=TCfg().with_overrides(**small),
                                device="cpu")
    assert len(tds) == len(jds) and tds.epoch_steps(4) == jds.epoch_steps(4)
    for (jx, jc), (tx, tc) in zip(jds.batches(4, seed=2),
                                  tds.batches(4, seed=2)):
        np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc, jc, atol=1e-4)
    assert len(list(tds.batches(4, seed=2))) == tds.epoch_steps(4)


def test_port_checkpoint_loads_in_jax(tmp_path, jax_params):
    params = from_jax_params(jax_params)
    opt = TS.make_optimizer(OptimizerConfig(), 1).init(tree_leaves(params))
    payload = {"step": 7, "params": params, "opt_state": opt,
               "extra": {"bf16": torch.arange(4, dtype=torch.bfloat16)}}
    path = str(tmp_path / "m.ckpt")
    TCK.save_checkpoint(path, payload)
    blob = JCK.load_checkpoint(path)
    assert blob["step"] == 7 and blob["opt_state"]["count"] == 0
    for a, b in zip(jax.tree_util.tree_leaves(blob["params"]),
                    jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(blob["extra"]["bf16"], np.float32), np.arange(4))
    assert TCK.latest_checkpoint(str(tmp_path)) == path
    # and the port reads its own file back
    back = TCK.load_checkpoint(path)
    assert back["extra"]["bf16"].dtype == torch.bfloat16


class _ArrayDataset:
    """Fixed synthetic batches for the loop tests."""

    def __init__(self, n=4, T=32, seed=0):
        self.x, self.c = _batch(n, T, seed)

    def batches(self, batch_size, shuffle=True, seed=0):
        order = np.random.default_rng(seed).permutation(len(self.x))
        for s in range(0, len(self.x), batch_size):
            idx = order[s:s + batch_size]
            yield self.x[idx], self.c[idx]

    def epoch_steps(self, batch_size):
        return len(self.x) // batch_size


def test_exact_resume(tmp_path, jax_params):
    """A run resumed from its checkpoint continues exactly as the same
    state stepped on without the round trip."""
    cfg = TCfg().with_overrides(optimizer={"lr": 1e-4})
    ds = _ArrayDataset(n=2)
    kw = dict(batch_size=2, model_name="m.ckpt", save_dir=str(tmp_path),
              verbose=False, precision="f32")
    params, ema, info = TL.train_autoencoder(from_jax_params(jax_params), ds,
                                             cfg, n_epochs=1, **kw)
    assert info["step"] == 1
    resumed, r_ema, r_info = TL.train_autoencoder(
        from_jax_params(jax_params), ds, cfg, n_epochs=1, resume=True, **kw)
    assert r_info["step"] == 2 and r_info["opt_state"]["count"] == 2
    tx = TS.make_optimizer(cfg.optimizer, ds.epoch_steps(2))
    step = TL.make_ae_step(cfg, tx, cfg.learn.ema_decay, "f32")
    state = info["opt_state"]
    for x, c in ds.batches(2, seed=1):
        params, state, ema, _ = step(params, state, ema, x, c)
    for a, b in zip(tree_leaves(resumed) + tree_leaves(r_ema)
                    + r_info["opt_state"]["nu"],
                    tree_leaves(params) + tree_leaves(ema) + state["nu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_voice_converter_trains_on_cpu(tmp_path):
    from autovc_tpu_torch import VoiceConverter
    path = _synthetic_wavs(tmp_path, 1, seconds=0.8)
    cfg = ConverterConfig().with_overrides(
        auto_encoder={"spectrogram": {"partial_utterance_n_frames": 32}},
        vocoder={"rnn_dims": 32, "fc_dims": 32})
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
    records = []
    vc.logger = type("Cap", (), {"log": lambda self, m, step=None:
                                 records.append(m)})()
    info = vc.train(path, model_type="auto_encoder", n_epochs=2,
                    batch_size=2, log_freq=1, model_name="ae.ckpt",
                    save_dir=str(tmp_path / "ckpt"), precision="f32")
    with pytest.raises(ValueError, match="model_type"):
        vc.train(path, model_type="wavenet")
    assert info["step"] == vc.AE.step == len(records) > 0
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    assert "ema_params" in vc.AE.extras
    assert os.path.isfile(tmp_path / "ckpt" / "ae.ckpt")
    for a, b in zip(vc._lstm2_packed,
                    TLK.pack(vc.AE.params["decoder"]["lstm2"], "f32")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    vc.logger = None
    saved = vc.save("auto_encoder", "saved.ckpt", str(tmp_path))
    blob = JCK.load_checkpoint(saved)
    assert blob["step"] == vc.AE.step and "ema_params" in blob
