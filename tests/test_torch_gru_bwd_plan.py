"""Kernel 5's launch plan and layer-skewed schedule
(``gru_train_kernels.gru_bwd_plan`` / ``gru_bwd_schedule``), on the CPU.

Kernel 5 (a), the GRU pair's reverse-time chain (``csrc/gru_train.cu``),
runs round s = 0 .. T: layer 2 at step T - 1 - s and layer 1 at T - s,
every product operand (dxp2, dhp1, dhp2) read from the two-slot ring that
round s - 1 wrote.  Here a plain-PyTorch replay of that schedule, reading
its operands only from the ring slots the schedule names, is held against
``gru_pair_bwd_plain`` and the JAX package's ``_gru_pair_bwd`` (through
``jax.vjp`` of the Pallas kernel in interpret mode), so an off-by-one in
the skew shows here without the card.  The kernel itself runs only on the
card (``tests/test_torch_kernels_on_card.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import gru_train_pallas as JGP
from autovc_tpu_torch.ops import gru_train_kernels as GT
from autovc_tpu_torch.ops import precision as PREC

H100_SMS = 132


def _weights(H, mats=2, units=8):
    """A block's rows of its matrices, pitch 3H + 32, bf16."""
    return mats * units * (3 * H + 32) * 2


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,H", [(1, 16), (8, 512), (32, 512), (13, 512),
                                 (8, 256), (33, 64), (65, 512), (200, 512),
                                 (8, 1024), (8, 2048), (3, 80)])
def test_every_unit_of_both_layers_once_and_fits(sms, bf16, B, H):
    plan = GT.gru_bwd_plan(B, H, bf16, sms)
    owned = {1: [], 2: []}
    for layer, j0, nu in plan.block_units(H):
        assert 1 <= nu <= plan.units
        owned[layer] += range(j0, j0 + nu)
    assert owned[1] == list(range(H)) and owned[2] == list(range(H))
    assert plan.blocks <= sms and plan.units % 8 == 0
    assert plan.smem_bytes <= GT.SMEM_MAX == 232448
    assert plan.pairs <= GT.MAX_PAIRS
    assert plan.groups * plan.rows >= B > (plan.groups - 1) * plan.rows
    tile = 16 if bf16 else 8
    mpad = -(-plan.rows // tile) * tile
    assert mpad <= GT.MAX_ROWS
    layers = 1 if plan.split else 2
    assert plan.pairs * GT.THREADS >= layers * mpad * plan.units
    if bf16:
        assert plan.m_tiles * 16 == mpad


@pytest.mark.parametrize("B,H", [(8, 512), (32, 512), (1, 16), (48, 256)])
def test_f32_always_takes_fma(B, H):
    plan = GT.gru_bwd_plan(B, H, False, H100_SMS)
    assert plan.route == "fma" and plan.resident_bytes == 0
    assert plan.m_tiles == 0
    # one staged 8-row f32 operand and the warp sums, then the two K
    # halves' partial sums
    mpad = -(-plan.rows // 8) * 8
    assert plan.smem_bytes == (8 * 3 * H + 8 * 8) * 4 + 2 * mpad * 8 * 4


@pytest.mark.parametrize("H", [8, 24, 100, 520])
def test_h_not_a_multiple_of_16_raises(H):
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            GT.gru_bwd_plan(8, H, bf16, H100_SMS)


@pytest.mark.parametrize("name,B,H,bf16,route,blocks,m_tiles", [
    # the smoke run's geometries (the vocoder's 8 x 2475 in both dtypes,
    # the JAX bench's 32 x 1375), a ragged batch and H = 256
    ("vocoder_bf16", 8, 512, True, "mma_smem", 128, 1),
    ("vocoder_f32", 8, 512, False, "fma", 128, 0),
    ("bench_32", 32, 512, True, "mma_smem", 128, 2),
    ("ragged_13", 13, 512, True, "mma_smem", 128, 1),
    ("h256", 8, 256, True, "mma_smem", 64, 1)])
def test_plans_at_the_main_geometries(name, B, H, bf16, route, blocks,
                                      m_tiles):
    plan = GT.gru_bwd_plan(B, H, bf16, H100_SMS)
    assert (plan.route, plan.split, plan.units, plan.blocks, plan.m_tiles,
            plan.groups, plan.rows) == (route, True, 8, blocks, m_tiles, 1,
                                        B)
    if bf16:
        # a layer-1 block holds W_ih2x and W_hh1 rows, then the 8 warps'
        # partial tiles (mpad, 8 units) f32
        assert plan.resident_bytes == _weights(H)
        assert plan.smem_bytes == _weights(H) + 8 * 16 * m_tiles * 8 * 4


def test_wide_pairs_share_blocks_between_layers():
    # 2 x 128 blocks of 8 units do not fit 132 SMs: a block holds both
    # layers (three matrices)
    plan = GT.gru_bwd_plan(16, 1024, True, H100_SMS)
    assert not plan.split and plan.blocks == 128
    assert plan.resident_bytes == _weights(1024, mats=3)
    wide = GT.gru_bwd_plan(8, 2048, True, H100_SMS)
    assert wide.route == "mma_l2" and wide.units == 16


@pytest.mark.parametrize("T", [1, 2, 3, 7])
def test_schedule_finishes_each_step_once_with_t_barriers(T):
    rounds = GT.gru_bwd_schedule(T)
    assert [r.s for r in rounds] == list(range(T + 1))
    assert sum(r.barrier for r in rounds) == T and not rounds[-1].barrier
    for key in ("layer2_step", "layer1_step"):
        steps = [getattr(r, key) for r in rounds
                 if getattr(r, key) is not None]
        assert steps == list(range(T - 1, -1, -1))
    for r in rounds:
        assert r.write_slot == r.s % 2
        assert all(slot != r.write_slot for _, slot in r.reads)


def _replay(acts, hs, dh1s, dh2s, whh1, wih2x, whh2):
    """Kernel 5 on its schedule in PyTorch: each round's products read
    their operands only from the ring, and only entries written in the
    round before; the gate arithmetic is ``gru_pair_bwd_plain``'s."""
    _, T, B, H = hs.shape
    op = PREC.round_bf16 if whh1.dtype == torch.bfloat16 else (lambda a: a)
    w = dict(zip(GT.ENTRIES, (m.float().T for m in (wih2x, whh1, whh2))))
    ring = [{}, {}]                   # slot -> entry -> (round, operand)
    carry = [torch.zeros(B, H), torch.zeros(B, H)]   # dh z of layers 1, 2
    dxp = [torch.empty(T, B, 3 * H), torch.empty(T, B, 3 * H)]
    zero = torch.zeros(B, H)
    for rd in GT.gru_bwd_schedule(T):
        prod = {}
        for entry, slot in rd.reads:
            written, v = ring[slot][entry]
            assert written == rd.s - 1, (rd.s, entry, slot)
            prod[entry] = torch.matmul(v, w[entry])
        writes = {}
        for l, t in ((1, rd.layer2_step), (0, rd.layer1_step)):
            if t is None:
                continue
            rec = "dhp2" if l else "dhp1"
            c = carry[l] + prod[rec] if rec in prod else carry[l]
            dh = (dh2s if l else dh1s)[t] + c
            if l == 0:
                dh = dh + prod["dxp2"]
            dx, dhp = GT._gate_grads(acts[l, t], hs[l, t - 1] if t else zero,
                                     dh)
            dxp[l][t] = dx
            carry[l] = dh * acts[l, t, :, H:2 * H].float()
            writes[rec] = op(dhp)
            if l:
                writes["dxp2"] = op(dx)
        ring[rd.write_slot] = {e: (rd.s, v) for e, v in writes.items()}
    return (dxp[0], dxp[1],
            *GT.gru_weight_grads(acts, hs, dxp[0], dxp[1], op))


def _inputs(B, T, H, seed):
    """xp1, base2 (T, B, 3H), wih2x, whh1, bhh1, whh2, bhh2 (the JAX
    argument order) and cotangents dh1s, dh2s, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.4):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    args = (f(T, B, 3 * H), f(T, B, 3 * H), f(H, 3 * H), f(H, 3 * H),
            f(3 * H), f(H, 3 * H), f(3 * H))
    return args, (f(T, B, H, scale=1.0), f(T, B, H, scale=1.0))


def _saved(args, dtype):
    xp1, base2, wih2x, whh1, bhh1, whh2, bhh2 = map(torch.from_numpy, args)
    wf = GT.pack_fwd(whh1, wih2x, whh2, dtype)
    hs, acts = GT.gru_pair_fwd_plain(xp1, base2, *wf, bhh1, bhh2)
    return (acts, hs), GT.pack_bwd(whh1, wih2x, whh2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(2, 9, 16), (3, 1, 16), (1, 2, 32),
                                   (5, 6, 48)])
def test_replay_equals_plain(B, T, H, dtype):
    """The schedule computes exactly the plain backward: 1e-6 of max
    |ref| (the same operations in the same order)."""
    args, cts = _inputs(B, T, H, seed=B * 10 + T)
    saved, wb = _saved(args, dtype)
    cts = tuple(map(torch.from_numpy, cts))
    got = _replay(*saved, *cts, *wb)
    want = GT.gru_pair_bwd_plain(*saved, *cts, *wb)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("B,T,H", [(2, 5, 16), (3, 1, 16), (1, 2, 16)])
def test_replay_matches_the_jax_kernel(B, T, H):
    """Against the JAX VJP of the Pallas kernel (interpret mode), f32, at
    the CPU parity tests' tolerance (rtol / atol 2e-4)."""
    args, cts = _inputs(B, T, H, seed=B + 7 * T)
    saved, wb = _saved(args, torch.float32)
    got = _replay(*saved, *map(torch.from_numpy, cts), *wb)
    _, vjp = jax.vjp(lambda *a: JGP.gru_pair(*a, interpret=True),
                     *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cts)))
    # JAX's order: xp1, base2, wih2x, whh1, bhh1, whh2, bhh2
    for name, a, b in zip(("dxp1", "dbase2", "dwih2x", "dwhh1", "dbhh1",
                           "dwhh2", "dbhh2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
