"""Kernel 1's launch plan and step schedule
(``wavernn_kernels.wr_plan`` / ``wr_schedule``), on the CPU.

Kernel 1, the WaveRNN sampling loop (``csrc/wavernn_sample.cu``), runs a
step as four stages on two roles of blocks (A: the pick of the previous
sample and GRU1; B: GRU2; C: fc1; D: fc2), each published through a
two-slot ring in L2 and one monotonic arrival counter, with the h
products a stage early and pre_I a step ahead.  Where the pick is over
fc3's classes themselves (RAW) and fc3 does not fit in shared memory, A's
pick is split by class: each R1 block takes its slice of the classes and
publishes each row's best as an epoch-tagged key (one more exchange,
counter "cs"), and every R1 block merges the keys.  Here

  * the plan gives every unit one owner, counts each counter's producers
    from the blocks' roles and fits the card's shared memory at any row
    count;
  * a symbolic run of the schedule shows that every ring read finds the
    step it names in its slot, after the counter epoch that publishes it,
    and that no slot is overwritten before its readers are done;
  * a plain-PyTorch replay of the schedule, reading its operands only
    from the ring slots the schedule names (each tagged with the step that
    wrote it), is held against ``sample_rows_plain`` (1e-6) and the JAX
    package's ``generate_rows_pallas(..., interpret=True)`` (1e-4), so a
    wrong slot or a misplaced stage shows here without the card.

The kernel itself runs only on the card
(``tests/test_torch_kernels_on_card.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.config import WaveRNNConfig as JCfg
from autovc_tpu.models import wavernn as JW
from autovc_tpu.ops import wavernn_pallas as JWP
from autovc_tpu_torch.config import WaveRNNConfig as TCfg
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.ops.mol import LOG_SCALE_MIN
from autovc_tpu_torch.utils.bridge import from_jax_params

H100_SMS = 132
# the SMALL config of tests/test_torch_wavernn.py
SMALL = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=16,
             res_blocks=2, upsample_factors=(2, 2), hop_length=4)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B", [1, 3, 16, 48, 64, 120, 200, 1000, 2000])
@pytest.mark.parametrize("dims", [64, 128, 512])
def test_every_unit_one_owner_and_fits(sms, bf16, B, dims):
    rd = fc = dims
    plan = WK.wr_plan(B, rd, fc, 30, bf16, sms, pick_dim=10)
    owners = {k: [] for k in ("gru1", "gru2", "fc1", "fc2")}
    roles = plan.block_roles(rd, fc)
    assert len(roles) == plan.blocks == 2 * plan.gru_blocks <= sms
    for role, (j0, nu), (c0, nf) in roles:
        assert 1 <= nu <= plan.units and 0 <= nf <= plan.fc_units
        gru, dense = ("gru1", "fc1") if role == "R1" else ("gru2", "fc2")
        owners[gru] += range(j0, j0 + nu)
        owners[dense] += range(c0, c0 + nf)
    assert owners["gru1"] == owners["gru2"] == list(range(rd))
    assert owners["fc1"] == owners["fc2"] == list(range(fc))
    # each counter's producers, from the roles: c1 every R1 block, c2
    # every R2 block, c3 / c4 the R1 / R2 blocks that own fc columns, the
    # prologue's every block (the kernel's wait targets an epoch)
    arrive = {"c1": lambda ro, nf: ro == "R1", "c2": lambda ro, nf: ro == "R2",
              "c3": lambda ro, nf: ro == "R1" and nf > 0,
              "c4": lambda ro, nf: ro == "R2" and nf > 0,
              "pro": lambda ro, nf: True}
    # a pick of 10 of 30 classes (MOL) is never split: no block owns a
    # class slice, and "cs" has no producers
    assert WK.COUNTERS[-1] == "cs" and plan.slice_classes == 0
    assert plan.producers == tuple(
        sum(arrive[c](ro, nf) for ro, _, (_, nf) in roles)
        for c in WK.COUNTERS[:-1]) + (0,)
    # powers of two from 8: the kernel's index math is shifts
    for n in (plan.units, plan.fc_units):
        assert n >= 8 and n & (n - 1) == 0
    # the rows: passes of at most 64, padded to the row tile
    assert plan.passes * plan.rows >= B > (plan.passes - 1) * plan.rows
    tile = 16 if bf16 else 8
    assert plan.mpad % tile == 0 and plan.rows <= plan.mpad <= WK.MAX_ROWS
    assert plan.mpad - plan.rows < tile
    assert plan.m_tiles == (plan.mpad // 16 if bf16 else 0)
    # the budget, recomputed from the plan's own choices
    assert plan.smem_bytes == WK.wr_smem_bytes(
        B, rd, fc, 30, 10, plan.units, plan.fc_units, plan.mpad, bf16,
        plan.route == "mma_smem", plan.fc3_resident, plan.pre_smem,
        plan.noise_smem, plan.state_smem) <= WK.SMEM_MAX == 232448
    # where the weights come from
    if bf16:
        assert plan.route in ("mma_smem", "mma_l2")
    else:
        assert plan.route == "fma" and plan.resident_bytes == 0
        assert not plan.fc3_resident
    assert ("gru" in plan.from_l2) == (plan.route != "mma_smem")
    assert ("fc3" in plan.from_l2) == (not plan.fc3_resident)
    assert ("pre_I" in plan.from_l2) == (not plan.pre_smem)
    assert ("state" in plan.from_l2) == (not plan.state_smem)
    # the per-row state leaves shared memory only where it does not fit
    if not plan.state_smem:
        assert B * (7 * plan.units + plan.fc_units + 1) * 4 > \
            WK.SMEM_MAX - plan.smem_bytes


@pytest.mark.parametrize("name,B,bf16,route,m_tiles,pre_smem,fc3", [
    # the main path's row buckets: 16 (a 4 s wav's 10 folds), 48 (a 24 s
    # wav's 48: pre_I prefetched, fc3 read from L2), and 64 (pre_I read
    # from L2); the f32 parity route
    ("4s_16_rows", 16, True, "mma_smem", 1, True, True),
    ("24s_48_rows", 48, True, "mma_smem", 3, True, False),
    ("bucket_64", 64, True, "mma_smem", 4, False, True),
    ("f32_8_rows", 8, False, "fma", 0, True, False)])
def test_plans_at_the_main_geometries(name, B, bf16, route, m_tiles,
                                      pre_smem, fc3):
    plan = WK.wr_plan(B, 512, 512, 30, bf16, H100_SMS, pick_dim=10)
    assert (plan.route, plan.units, plan.fc_units, plan.gru_blocks,
            plan.blocks, plan.passes, plan.rows, plan.m_tiles,
            plan.pre_smem, plan.noise_smem, plan.fc3_resident,
            plan.state_smem, plan.producers, plan.slice_classes) == (
        route, 8, 8, 64, 128, 1, B, m_tiles, pre_smem, True, fc3, True,
        (64, 64, 64, 64, 128, 0), 0)
    # bf16: every R1 block holds its W_ih1, W_hh1 rows (24 each), 8 fc1
    # rows and, where it fits, all of fc3 (30 rows), pitch 512 + 32
    assert plan.resident_bytes == (
        (2 * 24 + 8 + 30 * fc3) * (512 + 32) * 2 if bf16 else 0)


def test_wide_or_many_classes_take_l2():
    # RAW with 9 bits: fc3 (512 x 544 bf16) cannot stay whole in each R1
    # block, so the pick is split by class: each holds its 8 fc3 rows and
    # their Gumbel lanes, and nothing of fc3 or the noise comes from L2
    raw = WK.wr_plan(16, 512, 512, 512, True, H100_SMS)
    assert raw.route == "mma_smem" and not raw.fc3_resident
    assert raw.slice_classes == 8 and raw.noise_smem
    assert raw.from_l2 == ()
    # rd = 1024 on 132 SMs: 16 units a block, the rows from L2 at 64 rows
    wide = WK.wr_plan(64, 1024, 1024, 30, True, H100_SMS, pick_dim=10)
    assert wide.units == 16 and wide.blocks == 128
    assert wide.route == "mma_l2"
    # 78 SMs: 16 units a block (64 blocks), so pre_I at 48 rows from L2
    small = WK.wr_plan(48, 512, 512, 30, True, 78, pick_dim=10)
    assert small.units == 16 and small.blocks == 64
    assert small.route == "mma_smem" and not small.pre_smem


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("B", [16, 32, 64, 128])
@pytest.mark.parametrize("bits,owners", [(9, 64), (8, 32)])
def test_split_pick_plans(bits, owners, B, sms):
    """RAW with 9 and 8 bits in bf16 (fc3 of 512 or 256 rows does not fit
    beside the GRU and fc rows): the pick is split by class.  Every class
    has one owner among the R1 blocks, in order; "cs"'s producers are the
    owners (64 R1 blocks of 8 classes in RAW-9 on 132 SMs, 32 in RAW-8;
    16 classes a block where 78 SMs give 32 R1 blocks); shared memory
    fits; nothing of fc3 or the noise is read from L2, and pre_I and the
    noise are prefetched as in MOL's plan at the same rows."""
    n = 2 ** bits
    plan = WK.wr_plan(B, 512, 512, n, True, sms)
    mol = WK.wr_plan(B, 512, 512, 30, True, sms, pick_dim=10)
    assert plan.slice_classes == 8 * max(1, -(-n // 8) // plan.gru_blocks)
    slices = plan.class_slices(n)
    assert len(slices) == plan.gru_blocks
    owned = [c for k0, nk in slices for c in range(k0, k0 + nk)]
    assert owned == list(range(n))
    assert all(nk in (0, plan.slice_classes) for _, nk in slices)
    assert plan.producers[:5] == mol.producers[:5]
    assert plan.producers[5] == sum(nk > 0 for _, nk in slices)
    if sms == H100_SMS:
        assert (plan.slice_classes, plan.producers[5]) == (8, owners)
    assert plan.smem_bytes == WK.wr_smem_bytes(
        B, 512, 512, n, n, plan.units, plan.fc_units, plan.mpad, True,
        plan.route == "mma_smem", False, plan.pre_smem, plan.noise_smem,
        plan.state_smem, plan.slice_classes) <= WK.SMEM_MAX
    assert not plan.fc3_resident
    assert "fc3" not in plan.from_l2 and "noise" not in plan.from_l2
    assert (plan.route, plan.passes, plan.pre_smem, plan.noise_smem,
            plan.state_smem) == (mol.route, mol.passes, mol.pre_smem,
                                 mol.noise_smem, mol.state_smem)
    # the resident rows: the GRU and fc rows, and the slice of fc3
    assert plan.resident_bytes == mol.resident_bytes - (
        30 * (512 + 32) * 2 if mol.fc3_resident else 0) + \
        plan.slice_classes * (512 + 32) * 2


@pytest.mark.parametrize("B", [16, 64, 128])
def test_small_raw_f32_and_mol_keep_the_whole_pick(B):
    """The split pick only where it is needed: RAW with 4 bits (16 fc3
    rows fit, resident), f32 at RAW-9 (the parity route), and MOL at any
    width keep every R1 block's own pick over all classes."""
    raw4 = WK.wr_plan(B, 512, 512, 16, True, H100_SMS)
    assert raw4.slice_classes == 0 and raw4.fc3_resident
    assert raw4.producers[5] == 0
    f32 = WK.wr_plan(B, 512, 512, 512, False, H100_SMS)
    assert f32.slice_classes == 0 and f32.route == "fma"
    for dims in (512, 1024):
        assert WK.wr_plan(B, dims, dims, 30, True, H100_SMS,
                          pick_dim=10).slice_classes == 0
    # the epoch field over the value's 32 bits and the 9-bit class
    assert WK.split_epochs(512) == 2 ** 23 - 1
    assert WK.split_epochs(256) == 2 ** 24 - 1


@pytest.mark.parametrize("B,sms,passes", [
    (128, 132, 2), (832, 132, 13), (2000, 132, 32), (420, 114, 7),
    (100000, 78, 1563)])
def test_long_audio_keeps_the_state_in_l2(B, sms, passes):
    """Long audio gives many fold rows (``models/wavernn.py:_row_bucket``
    has no cap): from some hundreds of rows the blocks' per-row state
    (260 B a row at 8 units) no longer fits beside the resident weights,
    and the plan moves it to L2 rather than give up; 128 rows still keep
    it in shared memory.  Passes stay the fewest, 64 rows at most."""
    plan = WK.wr_plan(B, 512, 512, 30, True, sms, pick_dim=10)
    assert plan.passes == passes == -(-B // 64)
    assert plan.route == "mma_smem"
    assert plan.state_smem == (B == 128)
    assert ("state" in plan.from_l2) == (B != 128)


@pytest.mark.parametrize("rd,fc", [(8, 64), (64, 24), (100, 128)])
def test_dims_not_a_multiple_of_16_raise(rd, fc):
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            WK.wr_plan(8, rd, fc, 30, bf16, H100_SMS)


# ---------------------------------------------------------------------------
# (b) the schedule, symbolically
# ---------------------------------------------------------------------------

# the counters every block of a role bumps (c3 / c4 only the blocks that
# own fc columns)
EVERY_BLOCK = {"R1": ("pro", "c1"), "R2": ("pro", "c2")}


def _arrivals(stages):
    """For each stage, its role's arrivals at or after it, (counter,
    epoch) in order: the first publishes the stage's writes; a later one
    that every block of the role makes ends its reads."""
    out, pending = [None] * len(stages), {"R1": [], "R2": []}
    for i in range(len(stages) - 1, -1, -1):
        st = stages[i]
        if st.arrives is not None:
            pending[st.role] = [(st.arrives, 1 if st.arrives == "pro"
                                 else st.step + 1)] + pending[st.role]
        out[i] = pending[st.role]
    return out


def _check_schedule(stages, steps, picks):
    """Every ring read of ``stages`` finds the step it names in its slot,
    after the counter epoch that publishes it; no slot is overwritten
    before its readers are done; every stage of every step runs once (the
    stages named ``picks`` take each step's sample)."""
    arrivals = _arrivals(stages)
    acquired = {"R1": {}, "R2": {}}   # counter -> epoch waited for
    ring = {}       # (buffer, slot) -> (step, published at, readers' ends)
    done = {k: [] for k in ("A", "B", "C", "D", "pre", "hh1", "hh2")
            + picks}
    for st, later in zip(stages, arrivals):
        pub = later[0] if later else None
        ends = [a for a in later if a[0] in EVERY_BLOCK[st.role]]
        have = acquired[st.role]
        for counter, epoch in st.waits:
            have[counter] = max(have.get(counter, 0), epoch)
        for buf, step in st.reads:
            written, (counter, epoch), _ = ring[(buf, step % 2)]
            assert written == step, (st, buf)
            # published: the writer's arrival, waited for by this role
            assert have.get(counter, 0) >= epoch, (st, buf, counter)
            ring[(buf, step % 2)][2].append(ends)
        for buf, step in st.writes:
            old = ring.get((buf, step % 2))
            if old is not None:
                # every block that read the slot's last value has arrived
                # after its read at an epoch this role has waited for
                assert old[0] == step - 2, (st, buf)
                for ends in old[2]:
                    assert any(have.get(c, 0) >= e for c, e in ends), \
                        (st, buf, ends)
            ring[(buf, step % 2)] = (step, pub, [])
        done[st.name if st.name in done else "pre"].append(st.step)
    # every stage of every step once, the samples of every step once
    for name in ("A", "B", "C", "D") + picks:
        assert done[name] == list(range(steps)), name
    assert sorted(done["pre"]) == [0] + list(range(steps))
    assert done["hh1"] == done["hh2"] == list(range(steps - 1))


@pytest.mark.parametrize("steps", [1, 2, 3, 7])
def test_schedule_reads_published_slots_only(steps):
    stages = WK.wr_schedule(steps)
    _check_schedule(stages, steps, ("pick",))
    # four exchanges a step on the critical path: c1 .. c4
    assert sorted({st.arrives for st in stages} - {None}) == \
        ["c1", "c2", "c3", "c4", "pro"]


@pytest.mark.parametrize("steps", [1, 2, 3, 7])
def test_split_schedule_reads_published_slots_only(steps):
    """The split pick: each step's sample is a slice stage (the owners of
    class slices write their candidates, arrive on cs) and a merge (every
    R1 block reads them after cs); one exchange more than MOL's four."""
    stages = WK.wr_schedule(steps, split=True)
    _check_schedule(stages, steps, ("slice", "merge"))
    assert sorted({st.arrives for st in stages} - {None}) == \
        ["c1", "c2", "c3", "c4", "cs", "pro"]
    order = [(st.name, st.step) for st in stages]
    for t in range(steps):
        # the slice reads x4 after c4, the merge its candidates after cs,
        # then stage A of the next step (or the end) follows at once
        assert order.index(("slice", t)) + 1 == order.index(("merge", t))
        if t + 1 < steps:
            assert order.index(("merge", t)) + 1 == order.index(("A", t + 1))
    for st in stages:
        if st.name == "merge":
            assert st.waits == (("cs", st.step + 1),)
            assert st.reads == (("cand", st.step),)


def test_h_products_a_stage_early_and_pre_i_a_step_ahead():
    stages = WK.wr_schedule(5)
    order = [(st.name, st.step) for st in stages]
    for t in range(4):
        # h1_t W_hh1 is taken before C of step t, h2_t W_hh2 before D,
        # both long before step t + 1 needs them; pre_I of step t + 1
        # before B of step t; the pick of step t inside stage A of t + 1
        assert order.index(("hh1", t)) < order.index(("C", t))
        assert order.index(("hh2", t)) < order.index(("D", t))
        assert order.index(("pre", t + 1)) < order.index(("B", t))
        assert order.index(("pick", t)) + 1 == order.index(("A", t + 1))


# ---------------------------------------------------------------------------
# (b) the schedule, replayed in PyTorch
# ---------------------------------------------------------------------------

def _order(v):
    """``wr_order``: a float32's order as an int64, larger for larger
    values (-0 as +0)."""
    v = torch.where(v == 0, torch.zeros_like(v), v)
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)


def _slice_pick(scores, slice_classes, epoch, word):
    """``wr_slice`` of every class slice of ``scores`` (B, n_classes: the
    logits plus the Gumbel lanes) at step ``epoch`` - 1: each slice takes
    each row's best of its classes (the largest value, the lowest class
    among equal ones, NaN and -inf never) and puts its key (epoch, value
    order, inverted class) into the row's word by atomicMax; returns the
    words that ``word`` (B,) becomes."""
    n = scores.shape[1]
    cbits = (n - 1).bit_length()
    for k0 in range(0, n, slice_classes):
        part = scores[:, k0:k0 + slice_classes]
        part = torch.where(torch.isnan(part), float("-inf"), part)
        best = part.max(dim=1).values
        first = (part == best[:, None]).int().argmax(dim=1)   # lowest
        key = (epoch << (32 + cbits)) | (_order(best) << cbits) | \
            ((1 << cbits) - 1 - (k0 + first))
        word = torch.where(best > float("-inf"), torch.maximum(word, key),
                           word)
    return word


def _merge(word, epoch, n_classes):
    """``wr_merge``: each row's class from its word, ``n_classes`` - 1
    where it holds an older epoch (no slice saw a number)."""
    cbits = (n_classes - 1).bit_length()
    mask = (1 << cbits) - 1
    return torch.where(word >> (32 + cbits) == epoch, mask - (word & mask),
                       n_classes - 1)


def _replay(inp, gumbel, logistic, slice_classes=0):
    """Kernel 1 on :func:`wr_schedule` in PyTorch: every operand read only
    from the ring slot the schedule names, each slot tagged with the step
    that wrote it; per-block values (the h products, the GRU states, the
    samples) kept apart by role.  The arithmetic is
    ``sample_rows_plain``'s; with ``slice_classes`` the schedule's pick is
    split (:func:`_slice_pick`, :func:`_merge`, the candidate words in the
    ring's two slots)."""
    B, S = inp.rows, inp.ktab.shape[1]
    W, rd = inp.ktab.shape[0], inp.w_x.shape[0]
    op = PREC.round_bf16 if inp.w_ih1.dtype == torch.bfloat16 \
        else (lambda a: a)
    w = {k: getattr(inp, k).float().T for k in
         ("w_ih1", "w_hh1", "w_ih2", "w_hh2", "w_fc1", "w_fc2", "w_fc3")}

    def dot(a, name):
        return torch.matmul(op(a), w[name])

    def gru(h, xp, hp):
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        return (1.0 - z) * torch.tanh(xn + r * hn) + z * h

    ring = {}

    def read(buf, step):
        written, v = ring[(buf, step % 2)]
        assert written == step, (buf, step, written)
        return v

    zeros = inp.mf.new_zeros
    r1 = {"hh": zeros(B, 3 * rd), "h": zeros(B, rd), "x": zeros(B, 1)}
    r2 = {"hh": zeros(B, 3 * rd), "h": zeros(B, rd)}
    rows = torch.arange(B)
    out = zeros(B, inp.steps)
    words = [torch.zeros(B, dtype=torch.int64) for _ in range(2)]
    for st in WK.wr_schedule(inp.steps, split=slice_classes > 0):
        t = st.step
        q, p = t // S, t % S
        if st.name == "slice":
            logits = dot(read("x4", t), "w_fc3") + inp.b_fc3
            words[t % 2] = _slice_pick(logits + gumbel[t], slice_classes,
                                       t + 1, words[t % 2])
            ring[("cand", t % 2)] = (t, words[t % 2])
        elif st.name == "merge":
            pick = _merge(read("cand", t), t + 1, inp.n_classes)
            sample = 2.0 * pick.float() / (inp.n_classes - 1.0) - 1.0
            out[:, t] = sample
            r1["x"] = sample[:, None]
        elif st.name == "pre":
            pre = inp.base[:, q]
            for k in range(W):
                pre = pre + inp.mf[:, q + k] * inp.ktab[k, p]
            ring[("pre", t % 2)] = (t, pre)
        elif st.name == "pick":
            logits = dot(read("x4", t), "w_fc3") + inp.b_fc3
            pick = torch.argmax(logits[:, :inp.pick_dim] + gumbel[t], dim=-1)
            if inp.raw_mode:
                sample = 2.0 * pick.float() / (inp.n_classes - 1.0) - 1.0
            else:
                means = logits[rows, inp.nr_mix + pick]
                log_scales = torch.clamp(
                    logits[rows, 2 * inp.nr_mix + pick], min=LOG_SCALE_MIN)
                sample = torch.clamp(
                    means + torch.exp(log_scales) * logistic[t], -1.0, 1.0)
            out[:, t] = sample
            r1["x"] = sample[:, None]
        elif st.name == "A":
            xI = r1["x"] * inp.w_x[None, :] + read("pre", t)
            r1["h"] = gru(r1["h"], dot(xI, "w_ih1") + inp.b_ih1,
                          r1["hh"] + inp.b_hh1)
            x1 = xI + r1["h"]
            for buf, v in (("h1", r1["h"]), ("x1", x1), ("x1f", x1)):
                ring[(buf, t % 2)] = (t, v)
        elif st.name == "B":
            r2["h"] = gru(r2["h"], dot(read("x1", t), "w_ih2")
                          + inp.pre_r2[:, q], r2["hh"] + inp.b_hh2)
            ring[("h2", t % 2)] = (t, r2["h"])
            ring[("x2", t % 2)] = (t, read("x1f", t) + r2["h"])
        elif st.name == "hh1":
            r1["hh"] = dot(read("h1", t), "w_hh1")
        elif st.name == "hh2":
            r2["hh"] = dot(read("h2", t), "w_hh2")
        elif st.name == "C":
            ring[("x3", t % 2)] = (t, torch.relu(
                dot(read("x2", t), "w_fc1") + inp.pre_f1[:, q]))
        elif st.name == "D":
            ring[("x4", t % 2)] = (t, torch.relu(
                dot(read("x3", t), "w_fc2") + inp.pre_f2[:, q]))
    return out


def _setup(mode="MOL", **over):
    kw = dict(SMALL, mode=mode, **over)
    jcfg, tcfg = JCfg().with_overrides(**kw), TCfg().with_overrides(**kw)
    params = JW.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, from_jax_params(params)


def _rows(B=3, fpf=10, J=2, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((B, fpf + 2 * J, 80), dtype=np.float32),
            rng.random((B, fpf, 16), dtype=np.float32))


def _jax_noise(key, steps, rows, pick_dim):
    """The JAX kernel's noise draw (wavernn_pallas.py:237-242)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                            maxval=1.0 - 1e-5)
    u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                            maxval=1.0 - 1e-5)
    return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
            torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("mode,extra", [("MOL", {}), ("RAW", {"bits": 4})])
def test_replay_equals_plain(fast_math, mode, extra):
    """The schedule computes exactly the plain loop (the same operations
    in the same order): atol 1e-6, f32 and bf16 operands."""
    _, tcfg, _, tp = _setup(mode, **extra)
    mel_rows, aux_rows = (torch.from_numpy(r) for r in _rows())
    inp = WK.prepare_rows(tp, mel_rows, aux_rows, tcfg, fast_math)
    gum, lgs = WK.draw_noise(inp.steps, inp.rows, inp.pick_dim,
                             torch.Generator().manual_seed(3), "cpu")
    got = _replay(inp, gum, lgs)
    want = WK.sample_rows_plain(inp, gum, lgs)
    assert got.shape == want.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("bits,slice_classes", [(4, 8), (6, 8), (6, 16)])
def test_replay_on_the_split_schedule_equals_plain(fast_math, bits,
                                                   slice_classes):
    """RAW on the split pick's schedule (2, 8 and 4 class slices): the
    slices' keys and the merge give exactly the plain loop's argmax, so
    the samples equal ``sample_rows_plain``'s (atol 1e-6)."""
    _, tcfg, _, tp = _setup("RAW", bits=bits)
    mel_rows, aux_rows = (torch.from_numpy(r) for r in _rows())
    inp = WK.prepare_rows(tp, mel_rows, aux_rows, tcfg, fast_math)
    gum, lgs = WK.draw_noise(inp.steps, inp.rows, inp.pick_dim,
                             torch.Generator().manual_seed(5), "cpu")
    got = _replay(inp, gum, lgs, slice_classes)
    want = WK.sample_rows_plain(inp, gum, lgs)
    assert got.shape == want.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_split_merge_equals_argmax_over_all_classes():
    """The split pick's keys and merge over 64 slices of 8 classes against
    ``torch.argmax`` over all 512: random rows; ties put across two slices
    (and within one) go to the lowest class, -0 ties +0; a NaN lane never
    wins; a row of NaN or -inf gives the last class (``wr_pick``'s rule);
    a stale word of an older epoch loses whatever it holds."""
    n, epoch = 512, 5
    scores = torch.randn(12, n, generator=torch.Generator().manual_seed(0))
    top = scores.max() + 1.0
    scores[0, [7, 8]] = top          # a tie across slices 0 and 1
    scores[1, [300, 100]] = top      # across slices 12 and 37
    scores[2, [17, 18]] = top        # within slice 2
    scores[3] = -1.0
    scores[3, 3], scores[3, 200] = 0.0, -0.0   # +0 and -0 tie
    scores[4] = -1.0
    scores[4, 3], scores[4, 200] = -0.0, 0.0
    scores[5, 40] = float("nan")     # NaN beside numbers
    scores[5, 41] = top
    scores[6] = float("nan")
    scores[7] = float("-inf")
    scores[8, :256] = float("nan")
    scores[8, 256:] = float("-inf")
    scores[9, n - 1] = top           # the last class, finitely
    want = torch.argmax(torch.nan_to_num(scores, nan=float("-inf"),
                                         neginf=float("-inf")), dim=1)
    want[[6, 7, 8]] = n - 1
    assert want[:6].tolist() == [7, 100, 17, 3, 3, 41]
    stale = (epoch - 2 << 41) | (0xFFFFFFFF << 9)   # the largest value
    word = _slice_pick(scores, 8, epoch,
                       torch.full((12,), stale, dtype=torch.int64))
    assert torch.equal(_merge(word, epoch, n), want)
    # the same with the slices arriving in any order: the word is their
    # atomicMax, whatever the order
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(1))
    word2 = torch.full((12,), stale, dtype=torch.int64)
    for k in perm.tolist():
        part = torch.full_like(scores, float("-inf"))
        part[:, k * 8:(k + 1) * 8] = scores[:, k * 8:(k + 1) * 8]
        word2 = _slice_pick(part, 8, epoch, word2)
    assert torch.equal(word2, word)


@pytest.mark.parametrize("mode,extra,seed", [("MOL", {}, 42),
                                             ("RAW", {"bits": 4}, 7)])
def test_replay_matches_the_jax_kernel(mode, extra, seed):
    """Against ``generate_rows_pallas(..., fast_math=False,
    interpret=True)`` with the JAX kernel's own noise: atol 1e-4, the CPU
    parity tests' tolerance."""
    jcfg, tcfg, jp, tp = _setup(mode, **extra)
    mel_rows, aux_rows = _rows()
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JWP.generate_rows_pallas(
        jp, jnp.asarray(mel_rows), jnp.asarray(aux_rows), key, jcfg,
        fast_math=False, interpret=True))
    inp = WK.prepare_rows(tp, torch.from_numpy(mel_rows),
                          torch.from_numpy(aux_rows), tcfg, False)
    gum, lgs = _jax_noise(key, inp.steps, inp.rows, inp.pick_dim)
    got = _replay(inp, gum, lgs)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
