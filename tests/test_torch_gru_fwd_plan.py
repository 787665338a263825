"""Kernel 4's launch plan and layer-skewed schedule
(``gru_train_kernels.gru_fwd_plan`` / ``gru_fwd_schedule``), on the CPU.

Kernel 4, the GRU pair's training forward (``csrc/gru_train.cu``), runs
round s = 0 .. T: layer 1 at step s and layer 2 at step s - 1, every
product operand (h1, h2) read from the two-slot ring that round s - 1
wrote.  Here a plain-PyTorch replay of that schedule, reading its operands
only from the ring slots the schedule names, is held against
``gru_pair_fwd_plain`` and the JAX package's ``gru_pair`` (the Pallas
kernel in interpret mode), so an off-by-one in the skew shows here without
the card.  The kernel itself runs only on the card
(``tests/test_torch_kernels_on_card.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import gru_train_pallas as JGP
from autovc_tpu.ops import precision as JPREC
from autovc_tpu_torch.ops import gru_train_kernels as GT
from autovc_tpu_torch.ops import precision as PREC

H100_SMS = 132


def _weights(H, mats=2, units=8):
    """A block's 3 gate columns of its units of each matrix, pitch H + 32,
    bf16."""
    return mats * 3 * units * (H + 32) * 2


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("H", [48, 64, 128, 512, 1024])
@pytest.mark.parametrize("B", [1, 8, 16, 17, 33, 64, 65])
def test_every_unit_of_both_layers_once_and_fits(sms, bf16, H, B):
    plan = GT.gru_fwd_plan(B, H, bf16, sms)
    owned = {1: [], 2: []}
    for layer, j0, nu in plan.block_units(H):
        assert 1 <= nu <= plan.units
        owned[layer] += range(j0, j0 + nu)
    assert owned[1] == list(range(H)) and owned[2] == list(range(H))
    assert plan.blocks <= sms and plan.units % 8 == 0
    assert plan.split == (2 * -(-H // 8) <= sms)
    assert plan.smem_bytes <= GT.SMEM_MAX == 232448
    assert plan.items <= GT.MAX_PAIRS
    assert plan.groups * plan.rows >= B > (plan.groups - 1) * plan.rows
    tile = 16 if bf16 else 8
    mpad = -(-plan.rows // tile) * tile
    assert mpad <= GT.MAX_ROWS
    layers, mats = (1, 2) if plan.split else (2, 3)
    assert plan.items * GT.THREADS >= layers * mpad * plan.units
    # the partial tiles: one a warp (bf16), or one per K half and matrix
    tiles = 8 if bf16 else 2 * mats
    parts = tiles * mpad * 3 * plan.units * 4
    assert plan.smem_bytes == plan.resident_bytes + parts + (
        0 if bf16 else (8 * H + 8 * 3 * 8) * 4)
    if bf16:
        assert plan.m_tiles * 16 == mpad
        assert plan.route == ("mma_smem" if _weights(H, mats, plan.units)
                              + parts <= GT.SMEM_MAX else "mma_l2")
        if plan.route == "mma_smem":
            assert plan.resident_bytes == _weights(H, mats, plan.units)
    else:
        assert plan.route == "fma" and plan.resident_bytes == 0


@pytest.mark.parametrize("H", [8, 24, 100, 520])
def test_h_not_a_multiple_of_16_raises(H):
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            GT.gru_fwd_plan(8, H, bf16, H100_SMS)


@pytest.mark.parametrize("name,B,H,bf16,route,blocks,m_tiles,groups", [
    # the smoke run's geometries (the vocoder's 8 x 2475 in both dtypes,
    # the JAX bench's 32 x 1375), one row, ragged 17 / 33 rows, four
    # M-tiles and two row groups
    ("vocoder_bf16", 8, 512, True, "mma_smem", 128, 1, 1),
    ("vocoder_f32", 8, 512, False, "fma", 128, 0, 1),
    ("bench_32", 32, 512, True, "mma_smem", 128, 2, 1),
    ("one_row", 1, 64, True, "mma_smem", 16, 1, 1),
    ("ragged_17", 17, 128, True, "mma_smem", 32, 2, 1),
    ("ragged_33", 33, 128, True, "mma_smem", 32, 3, 1),
    ("four_m_tiles", 64, 64, True, "mma_smem", 16, 4, 1),
    ("two_groups", 65, 64, True, "mma_smem", 16, 3, 2)])
def test_plans_at_the_main_geometries(name, B, H, bf16, route, blocks,
                                      m_tiles, groups):
    plan = GT.gru_fwd_plan(B, H, bf16, H100_SMS)
    assert (plan.route, plan.split, plan.units, plan.blocks, plan.m_tiles,
            plan.groups) == (route, True, 8, blocks, m_tiles, groups)
    assert plan.rows == -(-B // groups)
    if bf16:
        # a layer-2 block holds W_ih2x and W_hh2 columns, then the 8
        # warps' partial tiles (mpad, 3 gates x 8 units) f32
        assert plan.resident_bytes == _weights(H)
        assert plan.smem_bytes == _weights(H) + 8 * 16 * m_tiles * 24 * 4


def test_wide_pairs_share_blocks_between_layers():
    # 2 x 128 blocks of 8 units do not fit 132 SMs: a block holds both
    # layers (three matrices)
    plan = GT.gru_fwd_plan(16, 1024, True, H100_SMS)
    assert not plan.split and plan.blocks == 128 and plan.units == 8
    assert plan.route == "mma_smem"
    assert plan.resident_bytes == _weights(1024, mats=3)
    # at 114 SMs blocks of 16 units, whose columns no longer fit
    wide = GT.gru_fwd_plan(16, 1024, True, 114)
    assert wide.route == "mma_l2" and wide.units == 16 and wide.blocks == 64
    # 8 rows at H = 512 on 114 SMs: 128 one-layer blocks do not fit
    assert not GT.gru_fwd_plan(8, 512, True, 114).split


@pytest.mark.parametrize("T", [1, 2, 3, 7])
def test_schedule_finishes_each_step_once_with_t_barriers(T):
    rounds = GT.gru_fwd_schedule(T)
    assert [r.s for r in rounds] == list(range(T + 1))
    assert sum(r.barrier for r in rounds) == T and not rounds[-1].barrier
    for key in ("layer1_step", "layer2_step"):
        steps = [getattr(r, key) for r in rounds
                 if getattr(r, key) is not None]
        assert steps == list(range(T))
    written = {}                   # (entry, slot) -> the round that wrote it
    for r in rounds:
        assert r.write_slot == r.s % 2
        for matrix, entry, slot in r.reads:
            # every read names the slot round s - 1 wrote, with the entry
            # of the step the product needs
            assert slot != r.write_slot
            assert written[entry, slot] == r.s - 1, (r.s, matrix)
        # layer 1 needs h1_{t-1} (none at t = 0); layer 2 h1_t and h2_{t-1}
        assert (("whh1", "h1", (r.s + 1) % 2) in r.reads) == (
            r.layer1_step is not None and r.layer1_step > 0)
        assert (("wih2x", "h1", (r.s + 1) % 2) in r.reads) == (
            r.layer2_step is not None)
        assert (("whh2", "h2", (r.s + 1) % 2) in r.reads) == (
            r.layer2_step is not None and r.layer2_step > 0)
        if r.layer1_step is not None:
            written["h1", r.write_slot] = r.s
        if r.layer2_step is not None:
            written["h2", r.write_slot] = r.s


def test_schedule_needs_a_step():
    with pytest.raises(ValueError):
        GT.gru_fwd_schedule(0)


def _replay(xp1, base2, whh1, wih2x, whh2, bhh1, bhh2):
    """Kernel 4 on its schedule in PyTorch: each round's products read
    their operands only from the ring, and only entries written in the
    round before; the cell arithmetic is ``gru_pair_fwd_plain``'s."""
    T, B, H3 = xp1.shape
    H = H3 // 3
    op = PREC.round_bf16 if whh1.dtype == torch.bfloat16 else (lambda a: a)
    w = {"whh1": whh1.float().T, "wih2x": wih2x.float().T,
         "whh2": whh2.float().T}                                # (H, 3H)
    ring = [{}, {}]                   # slot -> entry -> (round, operand)
    h = [torch.zeros(B, H), torch.zeros(B, H)]
    hs = torch.empty(2, T, B, H)
    acts = torch.empty(2, T, B, 4 * H, dtype=whh1.dtype)
    zero = torch.zeros(B, 3 * H)
    for rd in GT.gru_fwd_schedule(T):
        prod = {}
        for matrix, entry, slot in rd.reads:
            written, v = ring[slot][entry]
            assert written == rd.s - 1, (rd.s, matrix, slot)
            prod[matrix] = torch.matmul(v, w[matrix])
        writes = {}
        if rd.layer1_step is not None:
            t = rd.layer1_step
            h[0], a = GT._cell(xp1[t], prod.get("whh1", zero) + bhh1, h[0])
            hs[0, t], acts[0, t] = h[0], a.to(whh1.dtype)
            writes["h1"] = op(h[0])
        if rd.layer2_step is not None:
            t = rd.layer2_step
            xp2 = base2[t] + prod["wih2x"]
            h[1], a = GT._cell(xp2, prod.get("whh2", zero) + bhh2, h[1])
            hs[1, t], acts[1, t] = h[1], a.to(whh1.dtype)
            writes["h2"] = op(h[1])
        ring[rd.write_slot] = {e: (rd.s, v) for e, v in writes.items()}
    return hs, acts


def _inputs(B, T, H, seed):
    """xp1, base2 (T, B, 3H), wih2x, whh1, bhh1, whh2, bhh2: the JAX
    argument order, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (0.4 * rng.standard_normal(s)).astype(np.float32)

    return (f(T, B, 3 * H), f(T, B, 3 * H), f(H, 3 * H), f(H, 3 * H),
            f(3 * H), f(H, 3 * H), f(3 * H))


def _packed(args, dtype):
    """``args`` as ``gru_pair_fwd_plain`` takes them."""
    xp1, base2, wih2x, whh1, bhh1, whh2, bhh2 = map(torch.from_numpy, args)
    return (xp1, base2, *GT.pack_fwd(whh1, wih2x, whh2, dtype), bhh1, bhh2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(2, 9, 16), (3, 1, 16), (1, 2, 32),
                                   (5, 6, 48)])
def test_replay_equals_plain(B, T, H, dtype):
    """The schedule computes exactly the plain forward: 1e-6 of max |ref|
    (the same operations in the same order)."""
    packed = _packed(_inputs(B, T, H, seed=B * 10 + T), dtype)
    got = _replay(*packed)
    want = GT.gru_pair_fwd_plain(*packed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("B,T,H", [(2, 5, 16), (3, 1, 16), (1, 2, 16)])
def test_replay_matches_the_jax_kernel(B, T, H):
    """h1 and h2 against the JAX ``gru_pair`` (the Pallas kernel in
    interpret mode), f32, at the CPU parity tests' forward bar (rtol /
    atol 1e-5)."""
    args = _inputs(B, T, H, seed=B + 7 * T)
    hs, _ = _replay(*_packed(args, torch.float32))
    want = JGP.gru_pair(*map(jnp.asarray, args), interpret=True)
    for a, b in zip(hs, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_replay_matches_the_jax_kernel():
    """bf16 at a tiny size: the JAX kernel under the bf16 policy rounds
    the same operands (h1, h2, the weights) but sums in another order, so
    the bar is 2e-2 of max |ref|, as the other bf16 parity tests."""
    args = _inputs(2, 6, 32, seed=11)
    hs, _ = _replay(*_packed(args, torch.bfloat16))
    with JPREC.compute("bf16"):
        want = JGP.gru_pair(*map(jnp.asarray, args), interpret=True)
    for a, b in zip(hs, want):
        b = np.asarray(b, np.float32)
        assert np.abs(a.numpy() - b).max() <= 2e-2 * np.abs(b).max()
