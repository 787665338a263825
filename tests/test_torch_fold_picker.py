"""The fold-length picker (``autovc_tpu_torch.models.wavernn``:
``auto_fold_target``, ``_sampling_wall_model``, ``_us_per_step``) against
the JAX package's (``autovc_tpu/models/wavernn.py:323-419``).

  (a)-(c) the two packages' functions equal under either package's table
          (each table set in the other module with ``monkeypatch``);
  (d)     the single-generate pricing (``cfg`` given, no ``cap``): one pass
          at the fold rows' bucket, by hand; picks in the ladder, the
          picked wall monotone in length;
  (e)     the picks that ``generate``, ``generate_many`` (``cap=64``),
          ``VoiceConverter._fused_convert`` and the pipeline's vocoder
          stage hand on;
  (f)     ``generate(target=None)`` bit-equal to ``generate`` at the pick;
  (g)     ``generate`` against the JAX chain at a ladder geometry of more
          than 64 fold rows (the multi-pass regime of kernel 1 on the card),
          f32, atol 1e-4 (``tests/test_torch_wavernn.py``'s bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.config import WaveRNNConfig as JCfg
from autovc_tpu.models import wavernn as JW
from autovc_tpu_torch import Audio, ConverterConfig, VoiceConverter
from autovc_tpu_torch.config import WaveRNNConfig as TCfg
from autovc_tpu_torch.models import wavernn as TW
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.parallel import pipeline as tpipe
from autovc_tpu_torch.utils.bridge import from_jax_params

SR = 22050
# total_len in samples: 0 and 1, then seconds of audio
LENGTHS = [0, 1] + [int(s * SR) for s in (0.5, 1, 3, 7, 20, 60, 300, 600)]
CAPS = [64, 128, None]
# a narrow vocoder at the default hop (total_scale 275), so that every
# ladder length is a fold geometry the sampling loop takes
TINY = dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16,
            res_blocks=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_picker(lengths=LENGTHS, caps=CAPS):
    for cap in caps:
        for n in lengths:
            assert TW.auto_fold_target(n, 550, cap=cap) == \
                JW.auto_fold_target(n, 550, cap=cap), (n, cap)
            for t in TW._TARGET_LADDER:
                got = TW._sampling_wall_model(n, t, 550, cap=cap)
                want = JW._sampling_wall_model(n, t, 550, cap=cap)
                assert abs(got - want) <= 1e-9 * abs(want), (n, t, cap)


@pytest.mark.parametrize("table", ["jax", "h100"])
def test_picker_equals_jax_under_one_table(monkeypatch, table):
    """(a) the JAX (TPU) table set in the port; (b) the port's H100 table
    set in the JAX module: picks equal, walls to 1e-9 relative, at cap
    64, 128 and none (no ``cfg``)."""
    assert TW._TARGET_LADDER == JW._TARGET_LADDER
    assert TW._ROW_BUCKETS == JW._ROW_BUCKETS
    assert TW._MAX_SLAB_ROWS == JW._MAX_SLAB_ROWS == 64
    if table == "jax":
        monkeypatch.setattr(TW, "_ROWS_US", JW._ROWS_US)
    else:
        monkeypatch.setattr(JW, "_ROWS_US", TW._ROWS_US)
    _assert_same_picker()


@pytest.mark.parametrize("table", ["jax", "h100"])
def test_us_per_step_equals_jax(monkeypatch, table):
    """(c) interpolation inside the table and linear extrapolation beyond
    its last row count, at every row count 1-300."""
    if table == "jax":
        monkeypatch.setattr(TW, "_ROWS_US", JW._ROWS_US)
    else:
        monkeypatch.setattr(JW, "_ROWS_US", TW._ROWS_US)
    for rows in range(1, 301):
        assert TW._us_per_step(rows) == pytest.approx(
            JW._us_per_step(rows), rel=1e-12, abs=0), rows


def test_h100_table_is_measured_and_rising():
    """The table covers 8-384 rows (the 24 s wav's shortest fold, 286
    folds in a 288-row bucket, priced inside it): each end of the
    segments of equal passes and row padding, and 384 for the slope
    beyond; it costs more a step with more rows, so fewer rows never cost
    more."""
    rows = [r for r, _ in TW._ROWS_US]
    assert rows == [8, 16, 24, 32, 48, 64, 72, 96, 104, 128, 136, 144, 152,
                    192, 200, 256, 264, 320, 384]
    us = [u for _, u in TW._ROWS_US]
    assert all(u > 0 for u in us)
    assert us == sorted(us)


def _by_hand(n, target, overlap=550):
    """seq x the table's time a step at the fold rows' bucket, read from
    ``_ROWS_US`` (interpolated between its two neighbours)."""
    folds = TW._fold_count(n, target, overlap)
    b = TW._row_bucket(folds)
    table = dict(TW._ROWS_US)
    if b in table:
        us = table[b]
    else:
        lo = max(r for r in table if r < b)
        hi = min(r for r in table if r > b)
        us = table[lo] + (table[hi] - table[lo]) * (b - lo) / (hi - lo)
    return (target + 2 * overlap) * us, folds, b


def test_single_generate_prices_one_pass():
    """(d) with ``cfg`` and no ``cap``: one pass at ``_row_bucket(folds)``,
    checked by hand at the 4 s, 10 s and 24 s conversions' lengths (399,
    799 and 1999 mel frames of 275 samples); every pick is in the ladder
    and the picked wall never falls as the audio grows."""
    cfg = TCfg()
    checked = set()
    for frames in (399, 799, 1999):
        n = frames * 275
        for t in TW._TARGET_LADDER:
            want, folds, b = _by_hand(n, t)
            assert TW._sampling_wall_model(n, t, 550, cfg) == \
                pytest.approx(want, rel=1e-12)
            checked.add(b > 64)
    assert checked == {False, True}      # buckets inside and beyond 64
    prev = 0.0
    for n in range(0, 700 * SR, 2749):
        t = TW.auto_fold_target(n, 550, cfg)
        assert t in TW._TARGET_LADDER
        wall = TW._sampling_wall_model(n, t, 550, cfg)
        assert wall >= prev - 1e-9 * wall, n
        prev = wall


# the picker itself, for the expected values of the spied tests
PICK = TW.auto_fold_target


def _spy(monkeypatch, module, name, record, result=None):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs) if result is None else result(
            *args, **kwargs)
        record.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, spy)


def _tiny_params():
    return from_jax_params(JW.init(jax.random.PRNGKey(0),
                                   JCfg().with_overrides(**TINY)))


def _mel(frames, seed):
    return np.random.default_rng(seed).random((80, frames),
                                              dtype=np.float32)


def _zeros_program(params, mel, generator, cfg, target, overlap, *args):
    return torch.zeros((mel.shape[-1] - 1) * cfg.hop_length)


def test_generate_and_generate_many_hand_on_the_pick(monkeypatch):
    """(e) ``generate`` prices one pass (``cfg``), ``generate_many`` the
    64-row slab tiling of the pooled folds (``cap=_MAX_SLAB_ROWS``, no
    ``cfg``); each hands its pick to its program."""
    cfg = TCfg().with_overrides(**TINY)
    params = _tiny_params()
    picks, progs = [], []
    _spy(monkeypatch, TW, "auto_fold_target", picks)
    _spy(monkeypatch, TW, "_generate_program", progs, _zeros_program)
    for frames in (60, 400, 800):
        TW.generate(params, _mel(frames, frames), cfg, device="cpu")
        (n, overlap, c), kw, t = picks.pop()
        assert (n, overlap, c, kw) == ((frames - 1) * 275, 550, cfg, {})
        assert progs.pop()[0][4] == t == PICK(n, 550, cfg)

    many = []
    _spy(monkeypatch, TW, "_generate_many_program", many,
         lambda params, mels, g, cfg, target, *a: torch.zeros(
             sum((m.shape[-1] - 1) * cfg.hop_length for m in mels),
             dtype=torch.int16))
    mels = [_mel(f, f) for f in (400, 800, 2000, 200)]
    TW.generate_many(params, mels, cfg, device="cpu")
    (n, overlap), kw, t = picks.pop()
    assert n == sum((f - 1) * 275 for f in (400, 800, 2000, 200))
    assert (overlap, kw) == (550, {"cap": TW._MAX_SLAB_ROWS})
    assert many.pop()[0][4] == t == PICK(n, 550, cap=64)
    # a pinned target, or auto_target off, bypasses the picker
    TW.generate(params, _mel(60, 1), cfg, target=2750, device="cpu")
    TW.generate(params, _mel(60, 1), cfg.with_overrides(
        generate={"auto_target": False}), device="cpu")
    assert not picks
    assert [p[0][4] for p in progs] == [2750, 11000]


@pytest.fixture(scope="module")
def converter():
    cfg = ConverterConfig().with_overrides(
        vocoder=TINY, auto_encoder={"spectrogram": {
            "partial_utterance_n_frames": 64}})
    return VoiceConverter(config=cfg, device="cpu", verbose=False)


def test_fused_convert_and_pipeline_hand_on_the_pick(monkeypatch, converter):
    """(e) ``convert``'s fused path and the pipeline's vocoder stage price
    the merged mel's samples as one pass (``cfg``) and run their program
    at that pick."""
    vc = converter
    picks, progs = [], []
    _spy(monkeypatch, TW, "auto_fold_target", picks)
    _spy(monkeypatch, TW, "_generate_program", progs, _zeros_program)
    t = np.arange(int(1.5 * SR)) / SR
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    out = vc.convert(Audio(wav, sr_org=SR), Audio(wav.copy(), sr_org=SR),
                     save_name=False, outprocess=())
    (n, overlap, c), kw, pick = picks.pop()
    assert (overlap, c, kw) == (550, vc.vocoder.config, {})
    assert n == len(out.wav) and n % 275 == 0
    assert progs.pop()[0][4] == pick == PICK(n, 550, vc.vocoder.config)

    pipe = tpipe.conversion_pipeline(
        vc.AE.params, vc.vocoder.params, vc.AE.config, vc.vocoder.config,
        [torch.device("cpu")] * 2, ae_precision="f32", fast_math=False)
    mel = torch.from_numpy(_mel(800, 3))
    pcm = pipe.stages[1]((mel, 0))
    (n, overlap, c), kw, pick = picks.pop()
    assert (n, overlap, c, kw) == (799 * 275, 550, vc.vocoder.config, {})
    assert progs.pop()[0][4] == pick
    assert pcm.shape == (n,) and pcm.dtype == torch.int16


def test_generate_at_the_pick_is_bit_equal():
    """(f) ``generate(target=None)`` takes the pick and nothing else: the
    same generator seed gives the same samples, bit for bit, as the pick
    pinned."""
    cfg = TCfg().with_overrides(**TINY)
    params = _tiny_params()
    mel = _mel(12, 4)
    pick = TW.auto_fold_target(11 * 275, 550, cfg)
    auto = TW.generate(params, mel, cfg, torch.Generator().manual_seed(9),
                       fast_math=False, device="cpu")
    pinned = TW.generate(params, mel, cfg, torch.Generator().manual_seed(9),
                         target=pick, fast_math=False, device="cpu")
    assert auto.shape == (11 * 275,)
    assert np.array_equal(auto, pinned)


def test_generate_matches_jax_beyond_one_slab(monkeypatch):
    """(g) target 1375 / overlap 550 over 452 mel frames: 65 folds in a
    72-row bucket, one sampling pass of 2475 steps on both sides (the JAX
    pallas branch, interpreted), the JAX noise handed to the port."""
    kw = dict(TINY, rnn_dims=32, fc_dims=32)
    jcfg, tcfg = JCfg().with_overrides(**kw), TCfg().with_overrides(**kw)
    jp = JW.init(jax.random.PRNGKey(0), jcfg)
    mel = _mel(452, 6)[None]
    assert TW._fold_count(451 * 275, 1375, 550) == 65
    key = jax.random.PRNGKey(3)
    ref = JW.generate(jp, mel, jcfg, key=key, batched=True, target=1375,
                      overlap=550, fast_math=False, backend="pallas",
                      interpret=True)
    k1, k2 = jax.random.split(key)

    def draw(steps, rows, pick_dim, generator, device):
        assert (steps, rows) == (2475, 72)
        u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                                maxval=1.0 - 1e-5)
        u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                                maxval=1.0 - 1e-5)
        return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
                torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))

    monkeypatch.setattr(WK, "draw_noise", draw)
    out = TW.generate(from_jax_params(jp), mel, tcfg, batched=True,
                      target=1375, overlap=550, fast_math=False,
                      device="cpu")
    assert out.shape == ref.shape == (451 * 275,)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
