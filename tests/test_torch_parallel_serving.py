"""The port's mesh, rule table and multi-device serving paths on the CPU,
against the JAX package on its forced 8-device CPU mesh: the port's mesh
positions are all ``cpu`` (a repeated position stands in for a device).

  * ``param_shardings``: the JAX spec of every leaf path, on a (4, 2)
    ("data", "model") mesh and a data-only one;
  * the ring (``ring_lstm_layer`` forward and reverse,
    ``ring_bilstm_stack``, ``ring_autovc_infer``) against the JAX ring at
    2 and 4 positions, f32 atol 1e-5; an unaligned T raises;
  * ``chunk_sharded_convert``, 3 valid rows padded to 4, against JAX's
    (atol 1e-5);
  * ``StagePipeline`` against sequential calls, its in-flight bound,
    ``split_devices``, and ``conversion_pipeline`` end to end against
    JAX's (the SMALL vocoder of ``tests/test_torch_batch_serving.py``, the
    JAX kernel's noise handed over through ``wavernn_kernels.draw_noise``);
  * ``VoiceConverter(device="cpu")``: ``convert(parallel="chunks")``
    against the default path at the mel, ``parallel="ring"`` (a finite
    wav of its length), ``convert_batch(parallel="pipeline")`` against
    ``convert`` of each wav, and the refusals.

The generator runs at ``dim_pre`` 64 / ``dim_neck`` 8 on chunks of 32
frames; parameters come from the port's seeded ``init`` (the JAX layout)
and go to the JAX functions as arrays."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.config import AutoEncoderConfig as JCfg
from autovc_tpu.config import WaveRNNConfig as JWCfg
from autovc_tpu.models import wavernn as JWR
from autovc_tpu.parallel import pipeline as jpipe
from autovc_tpu.parallel import ring as jring
from autovc_tpu.parallel import sharding as jshd
from autovc_tpu.parallel import steps as jsteps
from autovc_tpu.voice_converter import VoiceConverter as JVC
from autovc_tpu_torch import Audio, VoiceConverter
from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import AutoEncoderConfig as TCfg
from autovc_tpu_torch.config import ConverterConfig as TConv
from autovc_tpu_torch.config import SpeakerEncoderConfig as TSCfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.models import wavernn as TW
from autovc_tpu_torch.ops import rnn as TR
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.parallel import pipeline as tpipe
from autovc_tpu_torch.parallel import ring as tring
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.parallel import steps as tsteps
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import tree_leaves

CPU = torch.device("cpu")
SR = 22050
N = 32
SMALL_AE = dict(dim_pre=64, dim_neck=8)
SMALL_VOC = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=16,
                 res_blocks=2, upsample_factors=(2, 2), hop_length=4)
VOC = dict(SMALL_VOC, generate={"target": 16, "overlap": 8,
                                "auto_target": False})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _mesh(n):
    return shd.make_mesh(devices=[CPU] * n)


def _jmesh(n):
    return jshd.make_mesh(devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def ae():
    """The small generator, in both packages' forms."""
    tp = TAE.init(torch.Generator().manual_seed(0),
                  TCfg().with_overrides(**SMALL_AE))
    return dict(tp=tp, jp=_jax_tree(tp), tcfg=TCfg().with_overrides(
        **SMALL_AE), jcfg=JCfg().with_overrides(**SMALL_AE))


# ---------------------------------------------------------------------------
# (a) the mesh and the rule table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        (None, ("data",))])
def test_param_shardings_equal_jax_specs(shape, axes):
    """Every leaf path of the three models gets JAX's spec."""
    tmesh = shd.make_mesh(shape, axes, devices=[CPU] * 8)
    jmesh = jshd.make_mesh(shape, axes)
    assert tmesh.shape == dict(jmesh.shape)
    gen = torch.Generator().manual_seed(0)
    for tree in (TAE.init(gen), TSE.init(gen, TSCfg()), TW.init(gen)):
        got = jax.tree_util.tree_leaves(
            shd.param_shardings(tree, tmesh), is_leaf=lambda x: isinstance(
                x, tuple))
        want = jax.tree_util.tree_leaves(jshd.param_shardings(
            jax.tree_util.tree_map(lambda t: t.numpy(), tree), jmesh))
        assert len(got) == len(want)
        assert got == [tuple(w.spec) for w in want]
        if shape is None:
            assert set(got) == {()}
    assert shd.replicated(tmesh) == tuple(jshd.replicated(jmesh).spec)
    assert shd.batch_sharding(tmesh) == tuple(
        jshd.batch_sharding(jmesh).spec)


def test_make_mesh_positions_and_refusals(monkeypatch):
    mesh = shd.make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.local_devices == (CPU,) * 8 and mesh.rank is None
    one = _mesh(3)
    assert one.shape == {"data": 3} and not one.distributed
    with pytest.raises(AssertionError):
        shd.make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shd.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.split_devices()
    # one replica a device: positions on one device share it
    tree = {"w": torch.ones(2)}
    reps = shd.shard_params(tree, one)
    assert len(reps) == 3 and all(r["w"] is tree["w"] for r in reps)


def test_tensor_parallel_raises_naming_roadmap(ae):
    """The calls that a 'model' axis used to refuse, on a local (1, 2)
    ("data", "model") mesh: ``shard_params`` gives each position the JAX
    ``NamedSharding``'s shards; the sharded steps refuse a local mesh of
    several positions as on a data mesh (the ranks must be launched);
    the chunk-sharded convert and the ring run over the data axis with the
    parameters whole, equal to a one-position mesh."""
    mesh = shd.make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    jmesh = jshd.make_mesh((1, 2), ("data", "model"),
                           devices=jax.devices()[:2])
    local = [tree_leaves(t) for t in shd.shard_params(ae["tp"], mesh)]
    placed = jax.tree_util.tree_leaves(jshd.shard_params(ae["jp"], jmesh))
    assert len(placed) == len(local[0])
    split = 0
    for i, arr in enumerate(placed):
        for s in arr.addressable_shards:
            m = list(jmesh.devices.reshape(-1)).index(s.device)
            np.testing.assert_array_equal(local[m][i].numpy(),
                                          np.asarray(s.data))
        split += local[0][i].shape != arr.shape
    assert split > 30
    tx = TS.Optimizer(lambda c: 1e-3, 0.9, 0.999, 1e-8, 1.0)
    for call in (lambda: tsteps.make_sharded_ae_step(ae["tcfg"], tx, 0.9,
                                                     mesh),
                 lambda: tsteps.make_sharded_se_step(TSCfg(), tx, mesh),
                 lambda: tsteps.make_sharded_vocoder_step(TWCfg(), tx,
                                                          mesh)):
        with pytest.raises(ValueError, match="one process per mesh position"):
            call()
    chunks = torch.rand(2, 80, N, generator=torch.Generator().manual_seed(3))
    c = torch.nn.functional.normalize(torch.ones(1, 256), dim=-1)
    got, ref = (tsteps.chunk_sharded_convert(ae["tp"], chunks, c, c, 2,
                                             ae["tcfg"], mesh=m)
                for m in (mesh, _mesh(1)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    layer = TR.init_lstm_layer(torch.Generator().manual_seed(4), 4, 8)
    x = torch.rand(1, 4, 4, generator=torch.Generator().manual_seed(5))
    outs, _ = tring.ring_lstm_layer(layer, x, mesh)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               TR.lstm_layer(layer, x)[0].numpy(), rtol=0,
                               atol=1e-6)


def test_steps_refuse_a_local_mesh_and_batches_split(ae):
    """The data-parallel steps run one process a position: a local mesh of
    several positions is refused.  ``shard_batch`` on a local mesh gives
    each position its rows; ``pad_batch_to`` is JAX's."""
    tx = TS.Optimizer(lambda c: 1e-3, 0.9, 0.999, 1e-8, 1.0)
    with pytest.raises(ValueError, match="one process per mesh position"):
        tsteps.make_sharded_ae_step(ae["tcfg"], tx, 0.9, _mesh(2))
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    parts = tsteps.shard_batch(x, _mesh(3))
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(),
                                           x[4:].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        tsteps.shard_batch(x, _mesh(4))
    for size in (6, 8):
        got, n = tsteps.pad_batch_to(x, size)
        want, m = jsteps.pad_batch_to(x, size)
        np.testing.assert_array_equal(got, want)
        assert n == m == 6


# ---------------------------------------------------------------------------
# (b) the ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("reverse", [False, True])
def test_ring_lstm_layer_matches_jax(n, reverse):
    B, T, I, H = 2, 32, 12, 8
    tp = TR.init_lstm_layer(torch.Generator().manual_seed(n), I, H)
    x = np.random.default_rng(n).standard_normal((B, T, I)).astype(
        np.float32)
    ys, (h, c) = tring.ring_lstm_layer(tp, torch.from_numpy(x), _mesh(n),
                                       reverse=reverse)
    assert len(ys) == n and all(y.shape == (B, T // n, H) for y in ys)
    jys, (jh, jc) = jring.ring_lstm_layer(_jax_tree(tp), jnp.asarray(x),
                                          _jmesh(n), reverse=reverse)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(jys),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    ref, (rh, _) = TR.lstm_layer(tp, torch.from_numpy(x).flip(1)
                                 if reverse else torch.from_numpy(x))
    ref = ref.flip(1) if reverse else ref
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), ref.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_bilstm_stack_matches_jax(n):
    B, T, I, H = 2, 40, 12, 8
    tp = TR.init_bilstm_stack(torch.Generator().manual_seed(7), I, H, 2)
    x = np.random.default_rng(7).standard_normal((B, T, I)).astype(
        np.float32)
    out = tring.ring_bilstm_stack(tp, torch.from_numpy(x), _mesh(n))
    ref = jring.ring_bilstm_stack(_jax_tree(tp), jnp.asarray(x), _jmesh(n))
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        torch.cat(out, 1).numpy(),
        TR.bilstm_stack(tp, torch.from_numpy(x)).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_autovc_infer_matches_jax(ae, n):
    """The whole generator time-sharded: equal to the JAX ring and to the
    port's one-device ``infer`` (atol 1e-5); an unaligned T raises in
    both packages."""
    rng = np.random.default_rng(n)
    x = rng.random((1, 80, 64), dtype=np.float32)
    c_org = rng.standard_normal((1, 256)).astype(np.float32)
    c_trg = rng.standard_normal((1, 256)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, c_org, c_trg)]
    out = tring.ring_autovc_infer(ae["tp"], *args, ae["tcfg"], _mesh(n))
    ref = jring.ring_autovc_infer(ae["jp"], *map(jnp.asarray, (x, c_org,
                                                               c_trg)),
                                  ae["jcfg"], _jmesh(n))
    assert out.shape == (1, 80, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    one = TAE.infer(ae["tp"], *args, ae["tcfg"])
    np.testing.assert_allclose(out.numpy(), one.numpy(), rtol=0, atol=1e-5)
    bad = x[:, :, :63]
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_autovc_infer(ae["tp"], torch.from_numpy(bad), *args[1:],
                                ae["tcfg"], _mesh(n))
    with pytest.raises(ValueError, match="divisible"):
        jring.ring_autovc_infer(ae["jp"], jnp.asarray(bad),
                                jnp.asarray(c_org), jnp.asarray(c_trg),
                                ae["jcfg"], _jmesh(n))


# ---------------------------------------------------------------------------
# (c) chunk-sharded conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_chunk_sharded_convert_matches_jax(ae, n):
    """3 valid chunk rows padded to 4: the padded-timeline merge equals
    JAX's (4 devices, atol 1e-5), and its first N + 2 * step frames the
    port's one-device ``batch_forward``."""
    rng = np.random.default_rng(2)
    chunks = rng.random((3, 80, N), dtype=np.float32)
    padded = np.concatenate([chunks, np.zeros((1, 80, N), np.float32)])
    c = rng.standard_normal((1, 256)).astype(np.float32)
    got = tsteps.chunk_sharded_convert(
        ae["tp"], torch.from_numpy(padded), torch.from_numpy(c),
        torch.from_numpy(c), 3, ae["tcfg"], 0.5, mesh=_mesh(n))
    jm = _jmesh(4)
    ref = jsteps.chunk_sharded_convert(
        ae["jp"], jsteps.shard_batch(padded, jm), jnp.asarray(c),
        jnp.asarray(c), jnp.int32(3), ae["jcfg"], 0.5)
    assert got.shape == ref.shape == (80, N + 3 * N // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    local = TAE.batch_forward(ae["tp"], torch.from_numpy(chunks),
                              torch.from_numpy(c), torch.from_numpy(c),
                              ae["tcfg"], 0.5)
    np.testing.assert_allclose(got[:, :N + N].numpy(), local.numpy(),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        tsteps.chunk_sharded_convert(
            ae["tp"], torch.from_numpy(chunks), torch.from_numpy(c),
            torch.from_numpy(c), 3, ae["tcfg"], mesh=_mesh(2))


# ---------------------------------------------------------------------------
# (d) the stage pipeline
# ---------------------------------------------------------------------------


class _Collected:
    """A last-stage result that records when ``run`` collects it."""

    def __init__(self, value, log):
        self.value, self.log = value, log

    def cpu(self):
        return self

    def numpy(self):
        self.log.append(("collect", self.value))
        return np.asarray(self.value)


@pytest.mark.parametrize("max_inflight", [2, 3])
def test_stage_pipeline_order_and_inflight_bound(max_inflight):
    w1 = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    w2 = torch.randn(16, 4, generator=torch.Generator().manual_seed(1))
    groups = tpipe.split_devices([CPU] * 2, 2)
    pipe = tpipe.StagePipeline([(lambda w, x: torch.tanh(x @ w), w1),
                                (lambda w, x: x @ w, w2)], groups)
    xs = [torch.randn(3, 8, generator=torch.Generator().manual_seed(i))
          for i in range(5)]
    outs = pipe.run(xs, max_inflight=max_inflight)
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, (torch.tanh(x @ w1) @ w2).numpy(),
                                   rtol=1e-6)
    log = []
    pipe = tpipe.StagePipeline(
        [(lambda p, i: log.append(("queue", i)) or i, None),
         (lambda p, i: _Collected(i, log), None)], groups)
    assert [int(o) for o in pipe.run(range(7), max_inflight)] == list(
        range(7))
    pending = 0
    for kind, _ in log:
        pending += 1 if kind == "queue" else -1
        assert 0 <= pending <= max_inflight
    with pytest.raises(AssertionError):
        pipe.run(range(3), max_inflight=1)


@pytest.mark.parametrize("n,stages", [(8, 2), (5, 2), (5, 3), (2, 2)])
def test_split_devices_disjoint_and_complete(n, stages):
    """Contiguous groups of positions, as JAX's over as many devices."""
    positions = [torch.device("cpu")] * n
    groups = tpipe.split_devices(positions, stages)
    jgroups = jpipe.split_devices(jax.devices()[:n], stages)
    assert [len(g) for g in groups] == [len(g) for g in jgroups]
    assert sum(groups, []) == positions and all(groups)
    with pytest.raises(AssertionError):
        tpipe.split_devices(positions[:1], 2)


def _jax_noise(key, steps, rows, pick_dim):
    """The JAX kernel's noise draw from ``key`` (wavernn_pallas.py)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                            maxval=1.0 - 1e-5)
    u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                            maxval=1.0 - 1e-5)
    return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
            torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))


def test_conversion_pipeline_matches_jax(ae, monkeypatch):
    """Two utterances of two chunks through the two stages, f32: the JAX
    pipeline's vocoder stage on the kernel it runs on a TPU (interpreted),
    each utterance's noise from its key ``PRNGKey(seed + i)``; the port's
    sampling loop gets the same noise.  The port's stage ends in int16
    PCM: the JAX waveform goes through the same rounding and clipping,
    and the two agree within 3 PCM steps (atol 1e-4)."""
    tw = TW.init(torch.Generator().manual_seed(3),
                 TWCfg().with_overrides(**VOC))
    jwcfg = JWCfg().with_overrides(**VOC)
    rng = np.random.default_rng(5)
    items = []
    for seed in (11, 12):
        c = rng.standard_normal((1, 256)).astype(np.float32)
        items.append((rng.random((2, 80, N), dtype=np.float32),
                      c / np.linalg.norm(c), seed))
    c_trg = items[0][1]

    real = JWR._generate_program
    monkeypatch.setattr(JWR, "resolve_backend", lambda *a, **k: "pallas")
    monkeypatch.setattr(JWR, "_generate_program",
                        lambda *a: real(*a[:-1], True))
    jp = jpipe.conversion_pipeline(ae["jp"], _jax_tree(tw), ae["jcfg"],
                                   jwcfg, devices=jax.devices()[:2],
                                   ae_precision="f32", fast_math=False)
    ref = jp.run([(jnp.asarray(ch), jnp.asarray(c), jnp.asarray(c_trg),
                   jax.random.PRNGKey(seed)) for ch, c, seed in items])

    keys = [jax.random.PRNGKey(seed) for _, _, seed in items]
    monkeypatch.setattr(WK, "draw_noise", lambda steps, rows, pick, g, d:
                        _jax_noise(keys.pop(0), steps, rows, pick))
    tp = tpipe.conversion_pipeline(ae["tp"], tw, ae["tcfg"], TWCfg().
                                   with_overrides(**VOC), [CPU] * 2,
                                   ae_precision="f32", fast_math=False)
    got = tp.run([(torch.from_numpy(ch), torch.from_numpy(c),
                   torch.from_numpy(c_trg), seed) for ch, c, seed in items])
    assert not keys
    for g, r, (ch, _, _) in zip(got, ref, items):
        assert g.dtype == np.int16
        assert g.shape == r.shape == ((N + (len(ch) - 1) * N // 2 - 1) * 4,)
        r = np.clip(np.round(np.asarray(r, np.float64) * 32767.0), -32767,
                    32767)
        np.testing.assert_allclose(g / 32767.0, r / 32767.0, rtol=0,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# (e) the converter's multi-device paths
# ---------------------------------------------------------------------------


def _wav(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    return (0.2 * tone + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.fixture(scope="module")
def vc():
    cfg = TConv().with_overrides(
        vocoder=VOC, auto_encoder=dict(
            SMALL_AE, spectrogram={"partial_utterance_n_frames": N}))
    return VoiceConverter(config=cfg, device="cpu", verbose=False,
                          ae_precision="f32", vocoder_precision="f32")


def _mel_tap(monkeypatch):
    """The mels ``convert`` hands its vocoder program."""
    seen = []
    real = TW._generate_program

    def tap(params, mel, *a):
        seen.append(mel[0].clone())
        return real(params, mel, *a)

    monkeypatch.setattr(TW, "_generate_program", tap)
    return seen


@pytest.mark.parametrize("n", [2, 3])
def test_convert_parallel_chunks_equals_default_at_the_mel(vc, monkeypatch,
                                                           n):
    """The same PCM16 mel chunks, split over the positions (padded to a
    multiple of n): the merged mel equals the default path's (atol 1e-5)
    and the waveform has its length."""
    seen = _mel_tap(monkeypatch)
    src, trg = _wav(0.9, 140.0, 1), _wav(0.6, 200.0, 2)
    base = vc.convert(Audio(src, sr_org=SR), Audio(trg, sr_org=SR),
                      save_name=False, outprocess=(), seed=3)
    par = vc.convert(Audio(src, sr_org=SR), Audio(trg, sr_org=SR),
                     save_name=False, outprocess=(), seed=3,
                     parallel="chunks", mesh=_mesh(n))
    assert len(seen) == 2 and seen[0].shape == seen[1].shape
    np.testing.assert_allclose(seen[1].numpy(), seen[0].numpy(), rtol=0,
                               atol=1e-5)
    assert par.wav.shape == base.wav.shape
    assert np.all(np.isfinite(par.wav))


def test_convert_parallel_ring_runs(vc, monkeypatch):
    """The unchunked host mel trimmed to a multiple of the mesh size,
    time-sharded: equal at the mel to the port's ``infer`` of the same
    trimmed mel (atol 1e-5), a finite wav of (frames - 1) * hop."""
    seen = _mel_tap(monkeypatch)
    src, trg = _wav(0.9, 140.0, 1), _wav(0.6, 200.0, 2)
    out = vc.convert(Audio(src, sr_org=SR), Audio(trg, sr_org=SR),
                     save_name=False, preprocess=(), outprocess=(), seed=0,
                     parallel="ring", mesh=_mesh(4))
    cfg = vc.AE.config
    frames = dsp.mel_spec_auto_encoder(src, cfg.spectrogram).shape[-1]
    Tn = frames // 4 * 4
    assert seen[0].shape == (80, Tn)
    assert out.wav.shape == ((Tn - 1) * vc.vocoder.config.hop_length,)
    assert np.all(np.isfinite(out.wav))
    mel = torch.from_numpy(np.asarray(dsp.mel_spec_auto_encoder(
        src, cfg.spectrogram)[None, :, :Tn], np.float32))
    c_src = torch.from_numpy(vc._embed(Audio(src, sr_org=SR))[None])
    c_trg = torch.from_numpy(vc._embed(Audio(trg, sr_org=SR))[None])
    one = TAE.infer(vc.AE.params, mel, c_src, c_trg, cfg)[0]
    np.testing.assert_allclose(seen[0].numpy(), one.numpy(), rtol=0,
                               atol=1e-5)


def test_convert_parallel_refusals(vc):
    """JAX's ValueErrors, with the JAX package's messages (an unknown
    ``parallel``, ``"chunks"`` without ``cut``, ``"ring"`` with
    ``pad_to_seconds``, an unknown ``convert_batch`` strategy), a mesh of
    the wrong type; and a mesh with a model axis, which converts."""
    wav = _wav(0.5, 150.0, 4)
    jax_source = inspect.getsource(JVC.convert) + inspect.getsource(
        JVC.convert_batch)

    def convert(**kw):
        return vc.convert(Audio(wav, sr_org=SR), Audio(wav, sr_org=SR),
                          save_name=False, **kw)

    for call, kw, fragment in (
            (convert, dict(parallel="nope"),
             "parallel must be None, 'chunks' or 'ring', "),
            (convert, dict(parallel="chunks", cut=False, mesh=_mesh(2)),
             "parallel='chunks' shards the chunk axis; it "),
            (convert, dict(parallel="ring", pad_to_seconds=1.0,
                           mesh=_mesh(2)),
             "pad_to_seconds trims by chunk geometry and "),
            (lambda **kw: vc.convert_batch([], "x", **kw),
             dict(parallel="ring"), "parallel must be None or 'pipeline', ")):
        with pytest.raises(ValueError) as err:
            call(**kw)
        assert str(err.value).startswith(fragment) and fragment in jax_source
    with pytest.raises(TypeError, match="Mesh"):
        convert(parallel="chunks", mesh="data")
    out = convert(parallel="chunks", mesh=shd.make_mesh(
        (1, 2), ("data", "model"), devices=[CPU] * 2))
    assert out.wav.shape == convert().wav.shape
    assert np.all(np.isfinite(out.wav))


def _pinned(steps, rows, pick_dim, generator, device):
    """The same noise on every row and call, one Gumbel lane a step raised
    by 1e3 (``tests/test_torch_batch_serving.py``'s row-invariant pin)."""
    g = torch.Generator().manual_seed(11)
    u1 = torch.rand((steps, 1, pick_dim), generator=g) * (1 - 2e-5) + 1e-5
    gumbel = -torch.log(-torch.log(u1))
    lane = torch.randint(0, pick_dim, (steps, 1, 1), generator=g)
    gumbel = gumbel.scatter(-1, lane, 1e3)
    u2 = torch.rand((steps, 1), generator=g) * (1 - 2e-5) + 1e-5
    logistic = torch.log(u2) - torch.log(1.0 - u2)
    return (gumbel.expand(steps, rows, pick_dim).contiguous(),
            logistic.expand(steps, rows).contiguous())


def test_convert_batch_pipeline_equals_convert(vc, tmp_path, monkeypatch):
    """Under row-invariant pinned noise each utterance of the pipelined
    ``convert_batch`` equals ``convert`` of its wav (atol 1e-3, as the
    default ``convert_batch``'s hold) and is as long as the default
    ``convert_batch``'s."""
    from autovc_tpu_torch.audio import io
    monkeypatch.setattr(WK, "draw_noise", _pinned)
    paths = []
    for k, (sec, f0) in enumerate(((0.7, 140.0), (0.45, 180.0))):
        paths.append(str(tmp_path / f"s{k}.wav"))
        io.save_wav(paths[-1], _wav(sec, f0, k), SR)
    target = str(tmp_path / "t.wav")
    io.save_wav(target, _wav(0.6, 210.0, 9), SR)
    pipe = vc.convert_batch(paths, target, outprocess=(), seed=4,
                            parallel="pipeline", devices=[CPU] * 2)
    base = vc.convert_batch(paths, target, outprocess=(), seed=4)
    assert len(pipe) == len(base) == 2
    for i, (p, b, src) in enumerate(zip(pipe, base, paths)):
        one = vc.convert(src, target, outprocess=(), save_name=False,
                         seed=4 + i)
        assert p.wav.shape == b.wav.shape == one.wav.shape
        np.testing.assert_allclose(p.wav, one.wav, rtol=0, atol=1e-3)
