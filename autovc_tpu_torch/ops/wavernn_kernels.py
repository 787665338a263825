"""WaveRNN sampling loop: kernel 1, its plain version and the noise draw.

Counterpart of ``autovc_tpu/ops/wavernn_pallas.py:generate_rows_pallas``.
:func:`generate_rows` takes frame-rate conditioning for B fold rows —
mel rows (B, fpf + 2J, feat) with J zero-filled margin frames, MelResNet
rows (B, fpf, res_out) — and samples (B, fpf * total_scale) waveform rows:

  * the frame-rate input projections (``wavernn_pallas.py:211-229``) are
    plain f32 matmuls here;
  * the noise is pre-drawn by :func:`draw_noise` (Gumbel noise for
    ``pick_dim`` lanes, one logistic value per step and row, the draw order
    of ``wavernn.py:619-625``), with a ``torch.Generator`` on the device;
  * the loop itself — banded upsample, two GRUs, fc1..fc3, sampling and
    feedback — is kernel ``wavernn_sample_launch`` of
    ``csrc/wavernn_sample.cu`` for CUDA tensors, and
    :func:`sample_rows_plain`, the same arithmetic in PyTorch, for CPU
    tensors.

The kernel's launch plan (:func:`wr_plan`: block roles, rows a pass,
which weights stay in shared memory, whether the pick is split by class)
and its step schedule
(:func:`wr_schedule`: which stage reads which ring slot after which
counter epoch) are plain Python, tested on the CPU
(``tests/test_torch_wr_plan.py``).

``fast_math=True`` follows ``wavernn_pallas.py:189,229,246``: bf16 weights,
the frame features ``base``/``pre_r2``/``pre_f1``/``pre_f2`` and the noise
rounded to bf16, activations rounded to bf16 only as matmul operands, f32
accumulation, state and sampling math.  ``mf`` stays f32.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops.mol import LOG_SCALE_MIN
from autovc_tpu_torch.utils import profiling

MAX_TAPS = 9  # kMaxTaps of csrc/wavernn_sample.cu: W = 2J + 1 <= 9

SAMPLE = _build.Kernel(
    "wavernn_sample.cu", "wavernn_sample_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


@dataclass
class RowsInputs:
    """Everything the sampling loop reads, in the kernel's layouts."""
    mf: torch.Tensor       # (B, fpf + 2J, rd) f32
    base: torch.Tensor     # (B, fpf, rd) f32
    pre_r2: torch.Tensor   # (B, fpf, 3rd)
    pre_f1: torch.Tensor   # (B, fpf, fc)
    pre_f2: torch.Tensor   # (B, fpf, fc)
    ktab: torch.Tensor     # (W, S) f32: ktab[w, p] = K[2J - w, p]
    w_x: torch.Tensor      # (rd,) f32
    w_ih1: torch.Tensor    # (3rd, rd) weights are (out, in), f32 or bf16
    w_hh1: torch.Tensor    # (3rd, rd)
    w_ih2: torch.Tensor    # (3rd, rd)
    w_hh2: torch.Tensor    # (3rd, rd)
    w_fc1: torch.Tensor    # (fc, rd)
    w_fc2: torch.Tensor    # (fc, fc)
    w_fc3: torch.Tensor    # (n_classes, fc)
    b_ih1: torch.Tensor    # (3rd,) f32
    b_hh1: torch.Tensor
    b_hh2: torch.Tensor
    b_fc3: torch.Tensor    # (n_classes,)
    n_classes: int
    nr_mix: int
    pick_dim: int
    raw_mode: bool

    @property
    def rows(self) -> int:
        return self.mf.shape[0]

    @property
    def fpf(self) -> int:
        return self.base.shape[1]

    @property
    def steps(self) -> int:
        return self.fpf * self.ktab.shape[1]


def pack_weights(params, cfg, fast_math: bool) -> Dict[str, Any]:
    """The loop's weights in kernel layout: every :class:`RowsInputs`
    field that does not depend on the mel.  Built once per model and
    precision (``VoiceConverter`` does it at construction and again after
    vocoder training)."""
    from autovc_tpu_torch.models.wavernn import _composite_upsample_kernel
    rd, fc = cfg.rnn_dims, cfg.fc_dims
    n_classes = cfg.n_classes
    raw_mode = cfg.mode == "RAW"
    nr_mix = n_classes // 3
    cdt = torch.bfloat16 if fast_math else torch.float32
    f32 = torch.float32
    with torch.no_grad():
        K, _ = _composite_upsample_kernel(params["upsample"]["up_convs"],
                                          cfg.upsample_factors)
    wI = params["I"]["w"]                      # (rd, 1 + feat + aux)

    def weight(w):
        return w.to(cdt).contiguous()

    return dict(
        ktab=K.flip(0).to(wI.device, f32).contiguous(),
        w_x=wI[:, 0].to(f32).contiguous(),
        w_ih1=weight(params["rnn1"]["w_ih"].T),
        w_hh1=weight(params["rnn1"]["w_hh"].T),
        w_ih2=weight(params["rnn2"]["w_ih"][:rd].T),
        w_hh2=weight(params["rnn2"]["w_hh"].T),
        w_fc1=weight(params["fc1"]["w"][:, :rd]),
        w_fc2=weight(params["fc2"]["w"][:, :fc]),
        w_fc3=weight(params["fc3"]["w"]),
        b_ih1=params["rnn1"]["b_ih"].to(f32).contiguous(),
        b_hh1=params["rnn1"]["b_hh"].to(f32).contiguous(),
        b_hh2=params["rnn2"]["b_hh"].to(f32).contiguous(),
        b_fc3=params["fc3"]["b"].to(f32).contiguous(),
        n_classes=n_classes, nr_mix=nr_mix,
        pick_dim=n_classes if raw_mode else nr_mix, raw_mode=raw_mode)


def prepare_rows(params, mel_rows: torch.Tensor, aux_rows: torch.Tensor,
                 cfg, fast_math: bool,
                 packed: Dict[str, Any] | None = None) -> RowsInputs:
    """Frame-rate projections (``wavernn_pallas.py:182-263``) beside the
    kernel-layout weights ``packed`` (:func:`pack_weights`, built here when
    not given)."""
    if packed is None:
        packed = pack_weights(params, cfg, fast_math)
    feat = mel_rows.shape[-1]
    rd, fc, d = cfg.rnn_dims, cfg.fc_dims, cfg.aux_dims
    fpf = mel_rows.shape[1] - (packed["ktab"].shape[0] - 1)
    aux_rows = aux_rows[:, :fpf]
    a1, a2, a3, a4 = (aux_rows[..., i * d:(i + 1) * d] for i in range(4))
    wI = params["I"]["w"]                      # (rd, 1 + feat + aux)
    w_ih2 = params["rnn2"]["w_ih"]             # (rd + aux, 3rd)
    w_fc1 = params["fc1"]["w"]                 # (fc, rd + aux)
    w_fc2 = params["fc2"]["w"]                 # (fc, fc + aux)

    def frame_feature(x):
        x = x.float().contiguous()
        return PREC.round_bf16(x) if fast_math else x

    return RowsInputs(
        mf=torch.matmul(mel_rows, wI[:, 1:1 + feat].T).float().contiguous(),
        base=frame_feature(torch.matmul(a1, wI[:, 1 + feat:].T)
                           + params["I"]["b"]),
        pre_r2=frame_feature(torch.matmul(a2, w_ih2[rd:])
                             + params["rnn2"]["b_ih"]),
        pre_f1=frame_feature(torch.matmul(a3, w_fc1[:, rd:].T)
                             + params["fc1"]["b"]),
        pre_f2=frame_feature(torch.matmul(a4, w_fc2[:, fc:].T)
                             + params["fc2"]["b"]),
        **packed)


def draw_noise(steps: int, rows: int, pick_dim: int,
               generator: torch.Generator | None, device):
    """Sampling noise for ``steps`` x ``rows``: Gumbel (steps, rows,
    pick_dim) and logistic (steps, rows), from uniforms in
    [1e-5, 1 - 1e-5), drawn in that order (``wavernn.py:619-625``)."""
    lo, span = 1e-5, 1.0 - 2e-5
    u1 = torch.rand((steps, rows, pick_dim), generator=generator,
                    device=device) * span + lo
    gumbel = -torch.log(-torch.log(u1))
    u2 = torch.rand((steps, rows), generator=generator,
                    device=device) * span + lo
    logistic = torch.log(u2) - torch.log(1.0 - u2)
    return gumbel, logistic


def plain_weights(inp: RowsInputs) -> Dict[str, torch.Tensor]:
    """The loop's weights as f32 (in, out) matrices for :func:`plain_step`."""
    return {k: getattr(inp, k).float().T for k in
            ("w_ih1", "w_hh1", "w_ih2", "w_hh2", "w_fc1", "w_fc2", "w_fc3")}


def plain_step(inp: RowsInputs, w: Dict[str, torch.Tensor], x, h1, h2,
               base, mfw, kcol, pre_r2, pre_f1, pre_f2, gumbel_t,
               logistic_t):
    """One step of the kernel's loop in PyTorch: the previous sample ``x``
    (B, 1), the GRU states, the step's frame inputs (``base``, ``pre_*``:
    (B, .) rows of frame q; ``mfw[k]`` the mel projection of frame q + k;
    ``kcol[k]`` = ``ktab[k, p]``) and noise -> (sample (B,), h1, h2)."""
    bf16 = inp.w_ih1.dtype == torch.bfloat16

    def dot(a, name):
        return torch.matmul(PREC.round_bf16(a) if bf16 else a, w[name])

    def gru(h, xp, w_hh, b_hh):
        hp = dot(h, w_hh) + b_hh
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h

    nr_mix = inp.nr_mix
    pre_I = base
    for k in range(len(mfw)):
        pre_I = pre_I + mfw[k] * kcol[k]
    xI = x * inp.w_x[None, :] + pre_I
    h1 = gru(h1, dot(xI, "w_ih1") + inp.b_ih1, "w_hh1", inp.b_hh1)
    x1 = xI + h1
    h2 = gru(h2, dot(x1, "w_ih2") + pre_r2, "w_hh2", inp.b_hh2)
    x2 = x1 + h2
    x3 = torch.relu(dot(x2, "w_fc1") + pre_f1)
    x4 = torch.relu(dot(x3, "w_fc2") + pre_f2)
    logits = dot(x4, "w_fc3") + inp.b_fc3
    # torch.argmax returns the first maximal index, as jnp.argmax
    pick = torch.argmax(logits[:, :inp.pick_dim] + gumbel_t, dim=-1)
    if inp.raw_mode:
        sample = 2.0 * pick.float() / (inp.n_classes - 1.0) - 1.0
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        means = logits[rows, nr_mix + pick]
        log_scales = torch.clamp(logits[rows, 2 * nr_mix + pick],
                                 min=LOG_SCALE_MIN)
        sample = torch.clamp(means + torch.exp(log_scales) * logistic_t,
                             -1.0, 1.0)
    return sample, h1, h2


def sample_rows_plain(inp: RowsInputs, gumbel: torch.Tensor,
                      logistic: torch.Tensor) -> torch.Tensor:
    """The kernel's loop in PyTorch (the CPU path and the kernel's
    oracle): (B, steps) samples, one :func:`plain_step` a step."""
    B, S = inp.rows, inp.ktab.shape[1]
    W = inp.ktab.shape[0]
    rd = inp.w_x.shape[0]
    w = plain_weights(inp)
    x = inp.mf.new_zeros(B, 1)
    h1 = inp.mf.new_zeros(B, rd)
    h2 = inp.mf.new_zeros(B, rd)
    out = []
    for q in range(inp.fpf):
        mfw = [inp.mf[:, q + k] for k in range(W)]
        for p in range(S):
            t = q * S + p
            sample, h1, h2 = plain_step(
                inp, w, x, h1, h2, inp.base[:, q], mfw, inp.ktab[:, p],
                inp.pre_r2[:, q], inp.pre_f1[:, q], inp.pre_f2[:, q],
                gumbel[t], logistic[t])
            out.append(sample)
            x = sample[:, None]
    return torch.stack(out, dim=1)


# Kernel 1's launch geometry (csrc/wavernn_sample.cu): 256 threads (8
# warps) a block, rows staged a pass at a time, at most 4 M-tiles of 16
# (bf16) or row tiles of 8 (f32), bf16 rows of pitch K + 32 in shared
# memory, an H100's opt-in shared memory per block.
THREADS, WARPS, ROW_TILE_F32, PITCH_PAD = 256, 8, 8, 32
MAX_ROWS, MAX_ITEMS, SMEM_MAX = 64, 4, 232448
# the arrival counters: one a stage, then the prologue's barrier, then the
# class slices' candidates (the split pick's exchange; no producers else)
COUNTERS = ("c1", "c2", "c3", "c4", "pro", "cs")
# the counter of the rows x steps that a launch samples on the split pick
SPLIT_ROW_STEPS = "k1.split_row_steps"


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _kparts(nt: int) -> int:
    """K parts of a bf16 product over ``nt`` n-tiles: 8 warps as (group
    of up to 4 n-tiles, K part)."""
    groups = -(-nt // 4)
    return 1 if groups >= WARPS else WARPS // groups


def wr_spill_floats(B: int, units: int, fc_units: int) -> int:
    """A block's per-row state in floats (``wr_spill_floats`` of the
    source): the h product, the GRU state, the frame's pre_r2 and pre_f
    slices, the samples."""
    return B * (7 * units + fc_units + 1)


def wr_smem_bytes(B: int, rd: int, fc: int, n_classes: int, pick_dim: int,
                  units: int, fc_units: int, mpad: int, bf16: bool,
                  resident: bool, fc3_resident: bool, pre_smem: bool,
                  noise_smem: bool, state_smem: bool,
                  slice_classes: int = 0) -> int:
    """The kernel's shared memory a block (``wr_smem`` of the source):
    resident GRU rows (W_ih, W_hh of the block's units), fc rows and fc3
    (or, on the split pick, the ``slice_classes`` fc3 rows of the block's
    class slice); the pass's staged operand (f32 only: bf16 products read
    theirs from L2); the products' K parts (the split pick's slice keeps
    its logits in registers); where ``state_smem``, the per-row state (the
    h product, the block's GRU state); pre_I and the noise of a step when
    prefetched (on the split pick the slice's Gumbel lanes); the samples
    (per-row state); the f32 warp sums; the block's biases; its slices of
    the frame's pre_r2 and pre_f (per-row state)."""
    maxk, n3 = max(rd, fc), -(-n_classes // 8) * 8
    Bs = B if state_smem else 0
    parts = max((_kparts(n // 8) if bf16 else 1) * mpad * n * 4
                for n in (3 * units, fc_units) + (() if slice_classes
                                                  else (n3,)))
    w3_rows = slice_classes or (n_classes if fc3_resident else 0)
    return sum((
        _up16(2 * 3 * units * (rd + PITCH_PAD) * 2) if resident else 0,
        _up16(fc_units * (maxk + PITCH_PAD) * 2) if resident else 0,
        _up16(w3_rows * (fc + PITCH_PAD) * 2),
        0 if bf16 else _up16(mpad * maxk * 4), _up16(parts),
        _up16(Bs * 3 * units * 4), _up16(Bs * units * 4),
        _up16(B * rd * 4) if pre_smem else 0,
        _up16(B * (slice_classes or pick_dim + 1) * 4) if noise_smem
        else 0,
        _up16(Bs * 4), WARPS * ROW_TILE_F32 * 4,
        _up16((6 * units + n_classes) * 4),
        _up16(Bs * (3 * units + fc_units) * 4)))


@dataclass(frozen=True)
class WrPlan:
    """How kernel 1 covers B rows at (rd, fc).

    ``gru_blocks`` R1 blocks each own ``units`` hidden units of GRU1 and
    ``fc_units`` columns of fc1; as many R2 blocks own the same units of
    GRU2 (and those columns of pre_I) and columns of fc2.  ``route``:
    "mma_smem" (bf16 tensor-core products, the block's GRU and fc rows
    resident in shared memory), "mma_l2" (the same, the rows read from L2)
    or "fma" (f32, from L2).  ``fc3_resident``: every R1 block holds fc3;
    ``pre_smem`` / ``noise_smem``: pre_I and the noise of the next step
    are prefetched into shared memory (else read from L2 in stage A);
    ``state_smem``: each block's per-row state is in shared memory (else
    in its part of an L2 scratch).  Each stage takes the rows ``passes``
    times, ``rows`` at a time (``mpad`` padded: ``m_tiles`` 16-row tiles
    in bf16).  ``producers``: the blocks that bump each of
    :data:`COUNTERS` once an epoch (the wait targets a step).
    ``slice_classes``: 0 where every R1 block takes fc3 and the pick over
    all classes itself; else the split pick: R1 block b holds fc3 rows
    [b * slice_classes, (b + 1) * slice_classes) in shared memory, takes
    each row's best of those classes and publishes it (counter "cs"), and
    every R1 block merges the candidates (``noise_smem`` then prefetches
    the slice's Gumbel lanes)."""
    route: str
    units: int
    fc_units: int
    gru_blocks: int
    blocks: int
    rows: int
    passes: int
    mpad: int
    m_tiles: int
    fc3_resident: bool
    pre_smem: bool
    noise_smem: bool
    state_smem: bool
    producers: tuple
    resident_bytes: int
    smem_bytes: int
    slice_classes: int = 0

    @property
    def from_l2(self) -> tuple:
        """The weights and inputs a step reads from L2 rather than shared
        memory."""
        out = () if self.route == "mma_smem" else ("gru", "fc1", "fc2")
        return out + (() if self.fc3_resident or self.slice_classes
                      else ("fc3",)) + \
            (() if self.pre_smem else ("pre_I",)) + \
            (() if self.noise_smem else ("noise",)) + \
            (() if self.state_smem else ("state",))

    def block_roles(self, rd: int, fc: int) -> list:
        """(role, (first GRU unit, units), (first fc column, columns)) of
        each block: R1 (GRU1, fc1) first, then R2 (GRU2, fc2), as the
        kernel's ``wr_role`` assigns them (its launch checks that every
        unit and column has one owner and that ``producers`` counts the
        blocks that arrive on each counter)."""
        out = []
        for b in range(self.blocks):
            i = b % self.gru_blocks
            j0, c0 = i * self.units, i * self.fc_units
            out.append(("R1" if b < self.gru_blocks else "R2",
                        (j0, min(self.units, rd - j0)),
                        (c0, max(0, min(self.fc_units, fc - c0)))))
        return out

    def class_slices(self, n_classes: int) -> list:
        """(first class, classes) of each R1 block's slice of the split
        pick, as the kernel's ``wr_role`` assigns them ((.., 0) for a
        block that owns none, and for every block without the split)."""
        k = self.slice_classes
        return [(b * k, max(0, min(k, n_classes - b * k)) if k else 0)
                for b in range(self.gru_blocks)]


def wr_plan(B: int, rd: int, fc: int, n_classes: int, bf16: bool,
            sms: int, pick_dim: Optional[int] = None) -> WrPlan:
    """Kernel 1's plan for ``sms`` streaming multiprocessors: GRU1 and
    GRU2 on their own blocks of 8 units (16, 32, ... where 2 x rd / 8
    blocks do not fit the card), fc1 / fc2 columns spread over them; then
    the fewest passes over the rows (at most 64 a pass), and for those the
    first of these that fits: the GRU and fc rows resident, then from L2;
    under each, the per-row state in shared memory, then in L2 (which
    fits any B); under each, pre_I and the noise prefetched, then pre_I
    from L2, then both; under each, fc3 resident, then from L2.
    ``pick_dim`` defaults to ``n_classes`` (RAW), the larger noise.

    By shape alone, bf16 only: where the pick is over the classes
    themselves (RAW: ``pick_dim == n_classes``, no mean or scale columns)
    and fc3's rows do not fit in shared memory beside the block's GRU and
    fc rows, the pick is split by class (``slice_classes``: 8 classes an
    R1 block, 16, 32, ... where there are more than 8 a block)."""
    if rd % 16 or fc % 16 or rd < 16 or fc < 16 or B < 1 or sms < 2 \
            or n_classes < 1:
        raise ValueError(f"bad sampling geometry: B={B}, rd={rd}, fc={fc}, "
                         f"n_classes={n_classes}, sms={sms} (rd, fc % 16 "
                         f"== 0)")
    pick = n_classes if pick_dim is None else pick_dim

    def pow2(n):   # the least power of two >= n: index math in shifts
        return 1 << (n - 1).bit_length()

    units = 8 * pow2(-(-(-(-rd // 8)) // (sms // 2)))
    g = -(-rd // units)
    fc_units = 8 * pow2(-(-(-(-fc // 8)) // g))
    gru_fc_rows = _up16(2 * 3 * units * (rd + PITCH_PAD) * 2) + \
        _up16(fc_units * (max(rd, fc) + PITCH_PAD) * 2)
    split = bf16 and pick == n_classes and \
        gru_fc_rows + _up16(n_classes * (fc + PITCH_PAD) * 2) > SMEM_MAX
    slices = 8 * pow2(-(-(-(-n_classes // 8)) // g)) if split else 0
    tile = 16 if bf16 else ROW_TILE_F32
    # (GRU and fc rows, fc3, pre_I, noise in shared memory), best first:
    # pre_I (B x rd f32, read by every R1 block on the critical path) is
    # worth more than fc3 resident (30 rows)
    prefetch = [(True, True), (False, True), (False, False)]
    routes = [(True, state, fc3) + p for state in (True, False)
              for p in prefetch
              for fc3 in ((False,) if split else (True, False))] \
        if bf16 else []
    routes += [(False, state, False) + p for state in (True, False)
               for p in prefetch]
    nfc = -(-fc // fc_units)       # the blocks of a role that own fc columns
    for passes in range(-(-B // MAX_ROWS), B + 1):
        rows = -(-B // passes)
        if -(-B // rows) != passes:
            continue
        mpad = -(-rows // tile) * tile
        if mpad * max(units, fc_units) > MAX_ITEMS * THREADS:
            continue    # an epilogue thread takes at most 4 items
        for res, state, fc3, pre, noise in routes:
            smem = wr_smem_bytes(B, rd, fc, n_classes, pick, units,
                                 fc_units, mpad, bf16, res, fc3, pre, noise,
                                 state, slices)
            if smem > SMEM_MAX:
                continue
            resident = (gru_fc_rows if res else 0) + _up16(
                (slices or (n_classes if fc3 else 0)) * (fc + PITCH_PAD)
                * 2)
            return WrPlan(
                route="fma" if not bf16 else
                "mma_smem" if res else "mma_l2",
                units=units, fc_units=fc_units, gru_blocks=g, blocks=2 * g,
                rows=rows, passes=passes, mpad=mpad,
                m_tiles=mpad // 16 if bf16 else 0, fc3_resident=fc3,
                pre_smem=pre, noise_smem=noise, state_smem=state,
                producers=(g, g, nfc, nfc, 2 * g,
                           -(-n_classes // slices) if slices else 0),
                resident_bytes=resident, smem_bytes=smem,
                slice_classes=slices)
    raise ValueError(f"kernel 1 does not fit B={B}, rd={rd}, fc={fc}, "
                     f"n_classes={n_classes} in shared memory")


def split_epochs(n_classes: int) -> int:
    """The most steps a split-pick launch takes: a candidate word holds
    the epoch (the step + 1) above the value's 32 order bits and the
    inverted class, so that a stale word loses to any of the step's."""
    return (1 << (32 - (n_classes - 1).bit_length())) - 1


def device_plan(inp: RowsInputs, dev) -> WrPlan:
    """:func:`wr_plan` for ``inp`` on CUDA device ``dev``."""
    return wr_plan(inp.rows, inp.w_x.shape[0], inp.w_fc1.shape[0],
                   inp.n_classes, inp.w_ih1.dtype == torch.bfloat16,
                   torch.cuda.get_device_properties(dev).multi_processor_count,
                   inp.pick_dim)


@dataclass(frozen=True)
class WrStage:
    """One stage of kernel 1's step schedule, in its role's program order.

    ``waits``: (counter, epoch) the role waits for first (epoch e: every
    producer of step e - 1 arrived); ``reads`` / ``writes``: (buffer,
    step) of ring values, each in slot ``step % 2``; ``arrives``: the
    counter the stage's producers bump after it, at epoch step + 1.
    ``local``: what the stage keeps in its block (the h products, the
    samples)."""
    name: str
    step: int
    role: str
    waits: tuple
    reads: tuple
    writes: tuple
    arrives: Optional[str]


def wr_schedule(steps: int, split: bool = False) -> list:
    """Kernel 1's stages over ``steps`` steps, in an order that respects
    every wait: the prologue's pre_I of step 0 (all blocks then meet at a
    barrier, counter "pro"), then per step t
      pick(t - 1)  R1: fc3 and the pick of step t - 1's sample (t > 0)
                   (``split``: slice(t - 1), the owners of class slices:
                   fc3 of their classes, each row's best of them -> cand
                   (arrive cs); merge(t - 1), every R1 block: each row's
                   sample from the candidates)
      A(t)         R1: xI, GRU1 -> h1, x1, x1f      (arrive c1)
      pre(t + 1)   R2: its pre_I slice of step t + 1
      B(t)         R2: GRU2 -> h2, x2               (arrive c2)
      hh1(t)       R1: h1_t W_hh1 for step t + 1
      C(t)         R1: fc1 -> x3                    (arrive c3)
      hh2(t)       R2: h2_t W_hh2 for step t + 1
      D(t)         R2: fc2 -> x4                    (arrive c4)
    and the last sample's pick(steps - 1)."""
    if steps < 1:
        raise ValueError(f"kernel 1 needs steps >= 1, not {steps}")
    S = WrStage

    def pick(t):   # the stages that take step t's sample
        if not split:
            return [S("pick", t, "R1", (("c4", t + 1),), (("x4", t),), (),
                      None)]
        return [S("slice", t, "R1", (("c4", t + 1),), (("x4", t),),
                  (("cand", t),), "cs"),
                S("merge", t, "R1", (("cs", t + 1),), (("cand", t),), (),
                  None)]

    out = [S("pre", 0, "R2", (), (), (("pre", 0),), "pro"),
           S("prologue", 0, "R1", (), (), (), "pro")]
    for t in range(steps):
        e, last = t + 1, t + 1 == steps
        if t > 0:
            out += pick(t - 1)
        first = (("pro", 1),) if t == 0 else ()
        out.append(S("A", t, "R1", first, (("pre", t),),
                     (("h1", t), ("x1", t), ("x1f", t)), "c1"))
        if not last:
            out.append(S("pre", t + 1, "R2", first, (),
                         (("pre", t + 1),), None))
        out.append(S("B", t, "R2", first + (("c1", e),),
                     (("x1", t), ("x1f", t)), (("h2", t), ("x2", t)), "c2"))
        if not last:
            out.append(S("hh1", t, "R1", (("c1", e),), (("h1", t),), (),
                         None))
        out.append(S("C", t, "R1", (("c2", e),), (("x2", t),),
                     (("x3", t),), "c3"))
        if not last:
            out.append(S("hh2", t, "R2", (("c2", e),), (("h2", t),), (),
                         None))
        out.append(S("D", t, "R2", (("c3", e),), (("x3", t),),
                     (("x4", t),), "c4"))
    return out + pick(steps - 1)


def launch(inp: RowsInputs, gumbel: torch.Tensor,
           logistic: torch.Tensor) -> torch.Tensor:
    """Launch kernel 1 on CUDA tensors (checked here), on the device's
    :func:`wr_plan`: (B, steps)."""
    B, steps = inp.rows, inp.steps
    rd, fc = inp.w_x.shape[0], inp.w_fc1.shape[0]
    if rd % 16 or fc % 16:
        raise ValueError(f"the sampling kernel needs rnn_dims and fc_dims "
                         f"divisible by 16, got {rd}, {fc}")
    if inp.ktab.shape[0] > MAX_TAPS:
        raise ValueError(f"the sampling kernel takes at most {MAX_TAPS} "
                         f"upsample taps, got {inp.ktab.shape[0]}")
    if tuple(gumbel.shape) != (steps, B, inp.pick_dim) \
            or tuple(logistic.shape) != (steps, B):
        raise ValueError("noise shapes do not match the rows")
    wdt = inp.w_ih1.dtype
    weights = (inp.w_ih1, inp.w_hh1, inp.w_ih2, inp.w_hh2, inp.w_fc1,
               inp.w_fc2, inp.w_fc3)
    if wdt not in (torch.float32, torch.bfloat16) or any(
            w.dtype != wdt for w in weights):
        raise ValueError("weights must all be f32 or all bf16")
    dev = inp.mf.device
    plan = device_plan(inp, dev)
    if plan.slice_classes and steps > split_epochs(inp.n_classes):
        raise ValueError(f"the split pick takes at most "
                         f"{split_epochs(inp.n_classes)} steps (its "
                         f"candidates carry the step), got {steps}")
    out = torch.empty(B, steps, device=dev)
    state = torch.empty(4 * B * rd, device=dev)       # pre_I, x1: 2 slots
    ring = torch.empty(2 * B * (4 * rd + 2 * fc), device=dev, dtype=wdt)
    bar = torch.zeros(len(COUNTERS), dtype=torch.int32, device=dev)
    spill = torch.empty(1 if plan.state_smem else plan.blocks
                        * wr_spill_floats(B, plan.units, plan.fc_units),
                        device=dev)
    # the split pick's candidate words: (2 slots, B), epoch-tagged
    keys = torch.zeros(2 * B if plan.slice_classes else 1,
                       dtype=torch.int64, device=dev)
    tensors = (inp.mf, inp.base, inp.pre_r2, inp.pre_f1, inp.pre_f2,
               inp.ktab, inp.w_x) + weights + (
        inp.b_ih1, inp.b_hh1, inp.b_hh2, inp.b_fc3, gumbel, logistic,
        out, state, ring, bar, spill, keys)
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"kernel input {i} is not a contiguous tensor "
                             f"on {dev}")
        if t.dtype not in (torch.float32, wdt, torch.int32, torch.int64):
            raise ValueError(f"kernel input {i} has dtype {t.dtype}")
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints = (ctypes.c_int * 27)(
        B, inp.fpf, inp.ktab.shape[1], inp.ktab.shape[0], rd, fc,
        inp.n_classes, inp.nr_mix, inp.pick_dim, int(inp.raw_mode),
        plan.units, plan.fc_units, plan.rows, plan.passes,
        int(plan.route == "mma_smem"), int(plan.fc3_resident),
        int(plan.pre_smem), int(plan.noise_smem), int(plan.state_smem),
        plan.slice_classes, *plan.producers, plan.smem_bytes)
    with torch.cuda.device(dev):      # the C side launches on the current device
        SAMPLE(ctypes.cast(ptrs, ctypes.c_void_p),
               ctypes.cast(ints, ctypes.c_void_p),
               int(wdt == torch.bfloat16),
               torch.cuda.current_stream(dev).cuda_stream)
    if plan.slice_classes:
        profiling.count(SPLIT_ROW_STEPS, B * steps)
    return out


def sample_rows(inp: RowsInputs, gumbel: torch.Tensor,
                logistic: torch.Tensor) -> torch.Tensor:
    """Kernel 1 for CUDA tensors, the plain loop for CPU tensors."""
    if inp.mf.device.type == "cuda":
        return launch(inp, gumbel, logistic)
    if inp.mf.device.type == "cpu":
        return sample_rows_plain(inp, gumbel, logistic)
    raise ValueError(f"unsupported device {inp.mf.device}")


def generate_rows(params, mel_rows: torch.Tensor, aux_rows: torch.Tensor,
                  cfg, fast_math: bool = True,
                  generator: torch.Generator | None = None,
                  packed: Dict[str, Any] | None = None) -> torch.Tensor:
    """Sample (B, fpf * total_scale) waveform rows from frame-rate
    conditioning (the JAX ``generate_rows_pallas`` contract); ``packed``
    as for :func:`prepare_rows`."""
    inp = prepare_rows(params, mel_rows, aux_rows, cfg, fast_math, packed)
    gumbel, logistic = draw_noise(inp.steps, inp.rows, inp.pick_dim,
                                  generator, mel_rows.device)
    if fast_math:
        gumbel, logistic = PREC.round_bf16(gumbel), PREC.round_bf16(logistic)
    return sample_rows(inp, gumbel.contiguous(), logistic.contiguous())
