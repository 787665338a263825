"""Kernel 2's launch plan and layer-skewed rounds
(``lstm_kernels.small_plan`` / ``small_schedule``), on the CPU.

Kernel 2, the LSTM stack at 8 rows or fewer (``csrc/lstm_stack.cu``), runs
round s = 0 .. T + L - 2: layer l at step t = s - l where that step
exists, its products reading h from the two-slot ring that round s - 1
wrote.  Here the plan's ownership and shared-memory budget are checked at
every geometry the kernel takes on the main path (and at 114 SMs), each
round's live layers against the JAX kernel's mask, the ring's slots
symbolically, and a plain-PyTorch replay of the rounds, reading its
operands only from the ring slots they name, against ``lstm_stack_plain``
and the JAX package's ``lstm_stack_pallas`` (the Pallas kernel in
interpret mode), so an off-by-one in the skew shows here without the card.
The kernel itself runs only on the card
(``tests/test_torch_kernels_on_card.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import lstm_pallas as LP
from autovc_tpu.ops import rnn as JR
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.utils.bridge import from_jax_params

H100_SMS = 132

# (name, layers, hidden, rows): decoder lstm2 at 1-8 rows (one chunk to
# eight), the speaker encoder's stack and decoder lstm1 at 2-8 rows (kernel
# 2's under the bf16 policy from 2 rows), the on-card tests' widths
GEOMETRIES = ([("lstm2", 2, 1024, b) for b in range(1, 9)]
              + [("speaker_encoder", 3, 256, b) for b in range(2, 9)]
              + [("lstm1", 1, 512, b) for b in range(2, 9)]
              + [(f"h{h}_l{l}", l, h, b) for h in (64, 128) for l in (1, 2, 3)
                 for b in (1, 2, 5, 8)])


def _weights(mats, H, units=8):
    """A block's 4 x units rows of ``mats`` matrices in A-fragment order,
    K rounded up to 32, bf16."""
    return mats * 4 * units * -(-H // 32) * 32 * 2


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name,L,H,B", GEOMETRIES)
def test_plan_fits_and_every_unit_has_one_owner(name, L, H, B, bf16, sms):
    plan = LK.small_plan(B, H, L, bf16, sms)
    owned = {layer: [] for layer in range(L)}
    for layer, j0, nu in plan.block_units(H, L):
        assert 1 <= nu <= plan.units
        owned[layer] += range(j0, j0 + nu)
    assert all(owned[layer] == list(range(H)) for layer in range(L))
    assert plan.blocks <= sms and plan.rows == B
    assert plan.units % 8 == 0 and plan.units <= LK.SMALL_MAX_UNITS
    assert plan.split == (L > 1 and L * -(-H // 8) <= sms)
    assert plan.smem_bytes <= LK.SMEM_MAX == 232448
    layers = 1 if plan.split else L
    mats = (2 if L > 1 else 1) if plan.split else 2 * L - 1
    c = layers * 8 * plan.units * 4
    if bf16:
        # the resident rows (or none), the 8 warps' partial tiles, c
        state = 8 * 32 * plan.units * 4 + c
        fits = _weights(mats, H, plan.units) + state <= LK.SMEM_MAX
        assert plan.route == ("mma_smem" if fits else "mma_l2")
        assert plan.resident_bytes == (_weights(mats, H, plan.units)
                                       if fits else 0)
        assert plan.smem_bytes == plan.resident_bytes + state
    else:
        # two staged 8-row operands and the warp sums, the gate sums, c
        assert plan.route == "fma" and plan.resident_bytes == 0
        assert plan.smem_bytes == (2 * 8 * H + 8 * 32 + layers * 8 * 4
                                   * plan.units) * 4 + c


@pytest.mark.parametrize("B,H,L,bf16,sms,route,split,units,blocks,smem", [
    # lstm2 on an H100 SXM: both layers a block, 3 x 32 resident rows
    (1, 1024, 2, True, 132, "mma_smem", False, 8, 128, 196608 + 8192 + 512),
    (8, 1024, 2, True, 132, "mma_smem", False, 8, 128, 196608 + 8192 + 512),
    # ... at 114 SMs 16 units a block, whose rows no longer fit
    (1, 1024, 2, True, 114, "mma_l2", False, 16, 64, 16384 + 1024),
    # the speaker encoder: each layer its own 32 blocks
    (5, 256, 3, True, 132, "mma_smem", True, 8, 96, 32768 + 8192 + 256),
    (8, 512, 1, True, 132, "mma_smem", False, 8, 64, 32768 + 8192 + 256),
    # parity mode: the f32 route
    (2, 1024, 2, False, 132, "fma", False, 8, 128,
     (2 * 8 * 1024 + 256 + 2 * 8 * 32) * 4 + 512),
    # three layers at 1024 do not fit resident; H = 1072 takes 16 units
    (2, 1024, 3, True, 132, "mma_l2", False, 8, 128, 8192 + 768),
    (3, 1072, 1, True, 132, "mma_smem", False, 16, 67,
     64 * 1088 * 2 + 16384 + 512)])
def test_plans_at_the_main_geometries(B, H, L, bf16, sms, route, split, units,
                                      blocks, smem):
    plan = LK.small_plan(B, H, L, bf16, sms)
    assert (plan.route, plan.split, plan.units, plan.blocks,
            plan.smem_bytes) == (route, split, units, blocks, smem)


@pytest.mark.parametrize("B,H,L", [(0, 64, 2), (9, 64, 2), (1, 72, 2),
                                   (1, 8, 1), (1, 64, 0), (1, 2112 + 16, 1)])
def test_geometries_kernel_2_does_not_take_raise(B, H, L):
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            LK.small_plan(B, H, L, bf16, H100_SMS)


def _live(s, T, L):
    """The JAX kernel's live mask (``lstm_pallas.py:_kernel``): layer l
    advances in round s iff 0 <= s - l < T."""
    return [l for l in range(L) if 0 <= s - l < T]


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("T", [1, 2, 5])
@pytest.mark.parametrize("H,sms", [(64, 132), (64, 10), (256, 132)])
def test_each_round_runs_the_live_layers_once(T, L, H, sms):
    """Every round's jobs (a block's owned layers that are live: the
    kernel's lmin .. lmax) cover each unit of each live layer exactly once,
    and the schedule's steps are the JAX mask's."""
    plan = LK.small_plan(3, H, L, True, sms)
    rounds = LK.small_schedule(T, L)
    assert [rd.s for rd in rounds] == list(range(T + L - 1))
    for rd in rounds:
        live = _live(rd.s, T, L)
        assert [l for l, _ in rd.steps] == live
        assert all(t == rd.s - l for l, t in rd.steps)
        cells = [(layer, j) for layer, j0, nu in plan.block_units(H, L)
                 if max(0, rd.s - T + 1) <= layer <= min(L - 1, rd.s)
                 for j in range(j0, j0 + nu)]
        assert sorted(cells) == [(l, j) for l in live for j in range(H)]
    # every step of every layer runs once
    for l in range(L):
        assert [t for rd in rounds for ll, t in rd.steps if ll == l] == \
            list(range(T))


@pytest.mark.parametrize("L", [1, 2, 3, 5])
@pytest.mark.parametrize("T", [1, 2, 3, 7])
def test_no_round_reads_a_slot_written_in_that_round(T, L):
    """A symbolic replay of the ring: each read names the slot and entry
    that round s - 1 wrote, holding the step the product needs (W_hh: the
    layer's own h at t - 1; W_ih: the layer below's at t), never the slot
    round s writes; a barrier follows every round but the last."""
    rounds = LK.small_schedule(T, L)
    assert sum(rd.barrier for rd in rounds) == T + L - 2
    assert not rounds[-1].barrier
    written = {}           # (slot, entry layer) -> (round, step)
    for rd in rounds:
        assert rd.write_slot == rd.s % 2
        for l, mat, entry, slot in rd.reads:
            t = rd.s - l
            assert slot != rd.write_slot
            assert written[slot, entry] == (rd.s - 1,
                                            t - 1 if mat == "whh" else t)
            assert entry == (l if mat == "whh" else l - 1)
        # W_hh only past t = 0 (h_{-1} = 0), W_ih from layer 1 on
        for l, t in rd.steps:
            mats = {mat for ll, mat, _, _ in rd.reads if ll == l}
            assert mats == ({"whh"} if t > 0 else set()) | (
                {"wih"} if l > 0 else set())
        for l, t in rd.steps:
            written[rd.write_slot, l] = (rd.s, t)


def _replay(xp0, whh, wih, bias):
    """Kernel 2's rounds in PyTorch: each product reads its operand only
    from the ring, and only an entry written in the round before; the cell
    arithmetic and operand rounding are ``lstm_stack_plain``'s."""
    T, B, _ = xp0.shape
    L, _, H = whh.shape
    op = PREC.round_bf16 if whh.dtype == torch.bfloat16 else (lambda a: a)
    ring = [{}, {}]                     # slot -> entry -> (round, h operand)
    c = [None] * L
    ys = torch.empty(T, B, H)
    for rd in LK.small_schedule(T, L):
        got = {}
        for l, mat, entry, slot in rd.reads:
            written, v = ring[slot][entry]
            assert written == rd.s - 1
            w = whh[l] if mat == "whh" else wih[l - 1]
            got[l, mat] = torch.matmul(v, w.float().T)
        writes = {}
        for l, t in rd.steps:
            gates = (xp0[t] if l == 0 else got[l, "wih"] + bias[l - 1])
            if t > 0:
                gates = gates + got[l, "whh"]
            ai, af, ag, ao = gates.chunk(4, dim=-1)
            c_old = c[l] if t > 0 else torch.zeros(B, H)
            c[l] = (torch.sigmoid(af) * c_old
                    + torch.sigmoid(ai) * torch.tanh(ag))
            h = torch.sigmoid(ao) * torch.tanh(c[l])
            writes[l] = (rd.s, op(h))
            if l == L - 1:
                ys[t] = h
        ring[rd.write_slot].update(writes)
    return ys


def _case(L, B, T, I, H, seed):
    rng = np.random.default_rng(seed)
    params = JR.init_lstm_stack(jax.random.PRNGKey(seed), I, H, L)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,T", [(1, 1, 6), (2, 3, 9), (3, 8, 7)])
def test_replay_matches_the_plain_version(L, B, T, dtype):
    params, x = _case(L, B, T, 8, 16, L * 10 + B)
    p = from_jax_params(params)
    xp0 = LK.hoist_xp0(p[0], torch.from_numpy(x), "f32")
    packed = LK.pack_stack(p, dtype)
    torch.testing.assert_close(_replay(xp0, *packed),
                               LK.lstm_stack_plain(xp0, *packed),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("L,B,T", [(2, 1, 11), (3, 5, 8)])
def test_replay_matches_the_jax_kernel(L, B, T):
    params, x = _case(L, B, T, 8, 16, 7 * L + B)
    ref = LP.lstm_stack_pallas(params, jnp.asarray(x), interpret=True)
    p = from_jax_params(params)
    xp0 = LK.hoist_xp0(p[0], torch.from_numpy(x), "f32")
    out = _replay(xp0, *LK.pack_stack(p, torch.float32)).transpose(0, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
