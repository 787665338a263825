"""Decoder LSTM-stack inference: kernels 2 and 3 and their plain version.

Counterpart of ``autovc_tpu/ops/lstm_pallas.py``:

  * :func:`lstm_stack_latency` replaces ``lstm_stack_pallas`` (<= 8 rows,
    the single-utterance decoder lstm2): kernel ``lstm_stack_skewed_launch``
    of ``csrc/lstm_stack.cu``, layer-skewed tensor-core rounds with the rows
    on the N side of one ``mma.sync`` tile, on the launch plan of
    :func:`small_plan` and the rounds of :func:`small_schedule`;
  * :func:`lstm_stack_stream` replaces ``lstm_stack_stream`` (> 8 rows):
    kernel ``lstm_stack_stream_launch``, the layer-skewed tensor-core
    routine of ``csrc/lstm_fwd.cuh`` that kernel 6 shares, on the launch
    plan of :func:`fwd_plan`, at any depth.

Both take a uniform-H stack (the JAX param layout) and x (B, T, I) and
return the last layer's outputs (B, T, H).  :func:`lstm_stack_rec` sends
the stacks that the JAX package runs as scans at inference (the speaker
encoder's 3 x 256, decoder lstm1) through the same two kernels when the
scan's gate (``PREC.rec_dtype``) makes their recurrence bf16, which
cuDNN's fused recurrence cannot round.  The layer-0 projection over all
T plus both biases is hoisted (a plain matmul, as ``_hoist_xp0`` in the JAX
package); layers >= 1 add ``b_ih + b_hh`` inside the recurrence.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes
:func:`lstm_stack_plain`, the same arithmetic in PyTorch — the CPU path and
the kernels' oracle.  Compute dtype: bf16 weights and operands when the
policy is bf16 and H >= 256, at every row count; f32 otherwise
(:func:`autovc_tpu_torch.ops.precision.lstm_kernel_dtype`).  Unlike the
JAX package, which sends the f32 2 x 1024 stack back to its XLA scan when
it does not fit the TPU's VMEM, the port runs the kernels in f32 too.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R

LATENCY_MAX_ROWS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
SKEWED = _build.Kernel("lstm_stack.cu", "lstm_stack_skewed_launch",
                       [_P] * 7 + [_I] * 9 + [_P])
STREAM = _build.Kernel("lstm_stack.cu", "lstm_stack_stream_launch",
                       [_P] * 7 + [_I] * 9 + [_P])

# The layer-skewed forward's geometry (csrc/lstm_fwd.cuh): 8 warps a
# block, at most 64 rows (4 16-row M-tiles) a row group, resident weight
# rows of pitch H + 32 values, partial-sum rows of pitch 4 units + 8, the
# f32 route's 8-row stage, an H100's opt-in shared memory per block.
WARPS, MAX_ROWS, PITCH_PAD, SUMS_PAD, ROW_TILE_F32 = 8, 64, 32, 8, 8
SMEM_MAX = 232448


@dataclass(frozen=True)
class FwdPlan:
    """How the layer-skewed forward (kernels 3 and 6) covers an (L, B, H)
    stack.

    ``route``: "mma_smem" (bf16 tensor-core product, the block's weight
    rows resident in shared memory), "mma_l2" (the same product, weights
    read from L2: they do not fit) or "fma" (f32).  A block owns ``units``
    hidden units of every layer; ``rows`` rows go through the product at
    once (``m_tiles`` 16-row tiles in bf16), ``groups`` times over the
    batch."""
    route: str
    units: int
    blocks: int
    rows: int
    groups: int
    m_tiles: int
    resident_bytes: int
    smem_bytes: int


def fwd_plan(B: int, H: int, L: int, bf16: bool, sms: int) -> FwdPlan:
    """The forward's plan for ``sms`` streaming multiprocessors: the
    fewest row groups that fit, resident weights where they fit beside the
    partial sums and the carried c."""
    if H % 16 or L < 1 or B < 1:
        raise ValueError(f"bad LSTM geometry: L={L}, B={B}, H={H} (H % 16 "
                         f"== 0)")
    units = 8 * -(-H // (8 * sms))
    tile = 16 if bf16 else ROW_TILE_F32
    weights = (2 * L - 1) * 4 * units * (H + PITCH_PAD) * 2
    groups = -(-B // MAX_ROWS)
    while True:
        rows = -(-B // groups)
        mpad = -(-rows // tile) * tile
        # partial sums of each warp's 16-row tile (bf16) or the gate sums
        # (f32), then the carried c, all f32
        sums = (WARPS * 16 * (4 * units + SUMS_PAD) if bf16
                else L * mpad * 4 * units)
        state = (sums + L * mpad * units) * 4
        if not bf16:
            route, base = "fma", (2 * ROW_TILE_F32 * H
                                  + WARPS * 4 * ROW_TILE_F32) * 4
        elif weights + state <= SMEM_MAX:
            route, base = "mma_smem", weights
        else:
            route, base = "mma_l2", 0
        if base + state <= SMEM_MAX:
            break
        if rows == 1:
            raise ValueError(f"the forward does not fit L={L}, H={H} in "
                             f"shared memory")
        groups += 1
    return FwdPlan(route=route, units=units, blocks=-(-H // units),
                   rows=rows, groups=groups,
                   m_tiles=mpad // 16 if bf16 else 0,
                   resident_bytes=base if route == "mma_smem" else 0,
                   smem_bytes=base + state)


def device_plan(B: int, H: int, L: int, bf16: bool, dev) -> FwdPlan:
    """:func:`fwd_plan` for the SM count of CUDA device ``dev``."""
    return fwd_plan(B, H, L, bf16,
                    torch.cuda.get_device_properties(dev).multi_processor_count)


# Kernel 2's geometry (csrc/lstm_stack.cu): at most 16 units (two 8-unit
# column groups) a block; its partial tiles take 32 f32 a unit and warp,
# its c 8 rows x units f32 a layer.
SMALL_MAX_UNITS = 16


@dataclass(frozen=True)
class SmallPlan:
    """How kernel 2 covers an (L, B <= 8, H) stack.

    ``route``: "mma_smem" (bf16 tensor-core product, the block's weight
    rows resident in shared memory), "mma_l2" (the same product, weights
    read from L2: they do not fit) or "fma" (f32).  ``split``: a block
    owns ``units`` hidden units of one layer (layer 0's blocks first),
    else of every layer.  All ``rows`` go through the product at once (the
    N = 8 side of one ``mma.sync`` tile), on the rounds of
    :func:`small_schedule`."""
    route: str
    split: bool
    units: int
    blocks: int
    rows: int
    resident_bytes: int
    smem_bytes: int

    def block_units(self, H: int, L: int) -> list[tuple[int, int, int]]:
        """(layer, first unit, units) of each block's layers."""
        per = self.blocks // (L if self.split else 1)
        out = []
        for b in range(self.blocks):
            j0 = b % per * self.units
            nu = min(self.units, H - j0)
            layers = (b // per,) if self.split else range(L)
            out += [(layer, j0, nu) for layer in layers]
        return out


def small_plan(B: int, H: int, L: int, bf16: bool, sms: int) -> SmallPlan:
    """Kernel 2's plan for ``sms`` streaming multiprocessors: each layer its
    own blocks of 8 units where every layer's fit on the card, else blocks
    of every layer; resident weight rows where they fit beside the partial
    tiles and the carried c.  Takes 1-8 rows, any depth, H % 16 == 0 up to
    16 units a block (H <= 2112 at 132 SMs)."""
    if H % 16 or H < 16 or L < 1 or not 1 <= B <= LATENCY_MAX_ROWS:
        raise ValueError(f"bad LSTM geometry for kernel 2: L={L}, B={B}, "
                         f"H={H} (1 <= B <= {LATENCY_MAX_ROWS}, H % 16 == 0)")
    split = L > 1 and L * -(-H // 8) <= sms
    units = 8 if split else 8 * -(-H // (8 * sms))
    if units > SMALL_MAX_UNITS:
        raise ValueError(f"H={H} needs {units} units a block at {sms} SMs: "
                         f"kernel 2 takes at most {SMALL_MAX_UNITS}")
    layers = 1 if split else L
    mats = (2 if L > 1 else 1) if split else 2 * L - 1
    c = layers * LATENCY_MAX_ROWS * units * 4
    if bf16:
        # the block's 4 x units rows of each matrix in A-fragment order, K
        # rounded up to whole 32-value chunks; the warps' partial tiles
        weights = mats * 4 * units * -(-H // 32) * 32 * 2
        state = WARPS * 32 * units * 4 + c
        route = "mma_smem" if weights + state <= SMEM_MAX else "mma_l2"
        base = weights if route == "mma_smem" else 0
    else:
        # two staged 8-row operands and the warp sums, then the gate sums
        route, base = "fma", 0
        state = (2 * LATENCY_MAX_ROWS * H + WARPS * 32
                 + layers * LATENCY_MAX_ROWS * 4 * units) * 4 + c
    if base + state > SMEM_MAX:
        raise ValueError(f"kernel 2 does not fit L={L}, H={H} in shared "
                         f"memory")
    return SmallPlan(route=route, split=split, units=units,
                     blocks=(L if split else 1) * -(-H // units), rows=B,
                     resident_bytes=base, smem_bytes=base + state)


def device_small_plan(B: int, H: int, L: int, bf16: bool, dev) -> SmallPlan:
    """:func:`small_plan` for the SM count of CUDA device ``dev``."""
    return small_plan(
        B, H, L, bf16,
        torch.cuda.get_device_properties(dev).multi_processor_count)


@dataclass(frozen=True)
class SmallRound:
    """Round ``s`` of kernel 2: the (layer, step) pairs it runs, the ring
    entries their products read as (layer, matrix, entry layer, slot), the
    slot it writes, and whether a grid barrier follows."""
    s: int
    steps: tuple
    reads: tuple
    write_slot: int
    barrier: bool


def small_schedule(T: int, L: int) -> list[SmallRound]:
    """The T + L - 1 layer-skewed rounds of kernel 2 (the JAX ``_kernel``'s):
    round s runs layer l at step t = s - l where 0 <= t < T; its W_hh
    product (t > 0) reads the layer's own h_{t-1} and its W_ih product
    (l > 0) the layer below's h_t, both from the ring slot round s - 1
    wrote; a barrier after every round but the last."""
    if T < 1 or L < 1:
        raise ValueError(f"kernel 2 needs T >= 1 and L >= 1, not {T}, {L}")
    rounds = []
    for s in range(T + L - 1):
        steps = tuple((l, s - l) for l in range(L) if 0 <= s - l < T)
        read = (s + 1) % 2
        reads = []
        for l, t in steps:
            if t > 0:
                reads.append((l, "whh", l, read))
            if l > 0:
                reads.append((l, "wih", l - 1, read))
        rounds.append(SmallRound(s=s, steps=steps, reads=tuple(reads),
                                 write_slot=s % 2, barrier=s < T + L - 2))
    return rounds


def pack_stack(params: Sequence, dtype: torch.dtype):
    """Kernel weight layout: W_hh (L, 4H, H) and W_ih of layers >= 1
    (L-1, 4H, H), both transposed to (out, in) and cast to ``dtype``;
    bias (L-1, 4H) = b_ih + b_hh of layers >= 1 in f32."""
    H = params[0]["w_hh"].shape[0]
    for p in params[1:]:
        if tuple(p["w_ih"].shape) != (H, 4 * H) or p["w_hh"].shape[0] != H:
            raise ValueError("the LSTM-stack kernels need a uniform hidden "
                             "size")
    whh = torch.stack([p["w_hh"].T for p in params]).to(dtype).contiguous()
    if len(params) > 1:
        wih = torch.stack([p["w_ih"].T for p in params[1:]]).to(
            dtype).contiguous()
        bias = torch.stack([(p["b_ih"] + p["b_hh"]).float()
                            for p in params[1:]]).contiguous()
    else:
        wih = whh[:0]
        bias = whh.new_zeros((0, 4 * H), dtype=torch.float32)
    return whh, wih, bias


def pack(params: Sequence, mode: str):
    """:func:`pack_stack` at the kernels' compute dtype for policy
    ``mode``; built once per model (``VoiceConverter`` does it at
    construction) and passed to the kernels as ``packed``."""
    H = params[0]["w_hh"].shape[0]
    return pack_stack(params, PREC.lstm_kernel_dtype(mode, H))


def hoist_xp0(params0, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Layer-0 gate pre-activations over all T, time-major (T, B, 4H)."""
    xp = PREC.dot(x, params0["w_ih"], mode) + params0["b_ih"] + params0["b_hh"]
    return xp.transpose(0, 1).contiguous().float()


def lstm_stack_plain(xp0: torch.Tensor, whh: torch.Tensor, wih: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The kernels' function in PyTorch: (T, B, 4H) layer-0 pre-activations
    and packed weights -> the last layer's h, (T, B, H).  bf16 weights mean
    bf16-rounded operands with f32 accumulation, as in the kernels."""
    T, B, H4 = xp0.shape
    H = H4 // 4
    L = whh.shape[0]
    bf16 = whh.dtype == torch.bfloat16
    whh_t = [w.float().T for w in whh]
    wih_t = [w.float().T for w in wih]

    def op(a):
        return PREC.round_bf16(a) if bf16 else a

    h = [xp0.new_zeros(B, H) for _ in range(L)]
    c = [xp0.new_zeros(B, H) for _ in range(L)]
    ys = []
    for t in range(T):
        for l in range(L):
            inp = (xp0[t] if l == 0
                   else torch.matmul(op(h[l - 1]), wih_t[l - 1]) + bias[l - 1])
            gates = inp + torch.matmul(op(h[l]), whh_t[l])
            ai, af, ag, ao = gates.chunk(4, dim=-1)
            c[l] = torch.sigmoid(af) * c[l] + torch.sigmoid(ai) * torch.tanh(ag)
            h[l] = torch.sigmoid(ao) * torch.tanh(c[l])
        ys.append(h[L - 1])
    return torch.stack(ys)


def _run(kernel: _build.Kernel, params: Sequence, x: torch.Tensor,
         mode: str, packed) -> torch.Tensor:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, I), got {tuple(x.shape)}")
    xp0 = hoist_xp0(params[0], x.float(), mode)
    whh, wih, bias = packed if packed is not None else pack(params, mode)
    if x.device.type == "cpu":
        ys = lstm_stack_plain(xp0, whh, wih, bias)
    elif x.device.type == "cuda":
        ys = launch(kernel, xp0, whh, wih, bias)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return ys.transpose(0, 1)


def launch(kernel: _build.Kernel, xp0: torch.Tensor, whh: torch.Tensor,
           wih: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch kernel 2 (``SKEWED``, on the device's :func:`small_plan`) or 3
    (``STREAM``, on its :func:`fwd_plan`) on CUDA tensors (checked here)."""
    T, B, H4 = xp0.shape
    L, _, H = whh.shape
    tensors = (xp0, whh, wih, bias)
    if H4 != 4 * H or H % 16:
        raise ValueError(f"bad LSTM geometry: 4H={H4}, H={H} (the kernels "
                         f"split H in two 8-aligned halves: H % 16 == 0)")
    if whh.dtype not in (torch.float32, torch.bfloat16) or wih.dtype != whh.dtype:
        raise ValueError("weights must be f32 or bf16, both of one dtype")
    if xp0.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("xp0 and bias must be float32")
    if tuple(wih.shape) != (L - 1, 4 * H, H) or tuple(bias.shape) != (L - 1, 4 * H):
        raise ValueError("wih/bias shapes do not match the stack")
    dev = xp0.device
    _build.check_inputs(tensors, dev)
    bf16 = whh.dtype == torch.bfloat16
    out = torch.empty(T, B, H, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    wih_ptr = wih.data_ptr() if wih.numel() else whh.data_ptr()
    bias_ptr = bias.data_ptr() if bias.numel() else xp0.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel is STREAM:
        plan = device_plan(B, H, L, bf16, dev)
        layout = (plan.units, plan.rows)
    else:
        plan = device_small_plan(B, H, L, bf16, dev)
        layout = (plan.units, int(plan.split))
    ring = torch.empty(2, L, B, H, device=dev, dtype=whh.dtype)
    with torch.cuda.device(dev):      # the C side launches on the current device
        kernel(xp0.data_ptr(), whh.data_ptr(), wih_ptr, bias_ptr,
               out.data_ptr(), ring.data_ptr(), bar.data_ptr(), T, B, H, L,
               *layout, int(plan.route == "mma_smem"), plan.smem_bytes,
               int(bf16), stream)
    return out


def lstm_stack_latency(params: Sequence, x: torch.Tensor,
                       mode: str = "f32", packed=None) -> torch.Tensor:
    """Kernel 2: uniform-H LSTM stack inference at <= 8 rows (the JAX
    ``lstm_stack_pallas`` contract): (B, T, I) -> (B, T, H).  ``packed``:
    ``pack(params, mode)``, built per call when None."""
    if x.shape[0] > LATENCY_MAX_ROWS:
        raise ValueError(f"lstm_stack_latency takes at most "
                         f"{LATENCY_MAX_ROWS} rows, got {x.shape[0]}; use "
                         f"lstm_stack_stream")
    return _run(SKEWED, params, x, mode, packed)


def lstm_stack_stream(params: Sequence, x: torch.Tensor,
                      mode: str = "f32", packed=None) -> torch.Tensor:
    """Kernel 3: the same stack at serving row counts (the JAX
    ``lstm_stack_stream`` contract): (B, T, I) -> (B, T, H)."""
    return _run(STREAM, params, x, mode, packed)


def lstm_stack_rec(params: Sequence, x: torch.Tensor,
                   mode: str = "f32") -> torch.Tensor:
    """A uniform-H stack that the JAX package runs as a scan, at inference:
    (B, T, I) -> the last layer's outputs (B, T, H).  The recurrence's
    compute dtype is the scan's gate, ``PREC.rec_dtype(mode, B, H)``: in
    bf16 it runs kernel 2 (<= 8 rows) or kernel 3 (more) on CUDA and their
    plain version on the CPU, with the layer-0 projection hoisted under
    the policy; in f32 it runs ``torch.lstm`` (:func:`rnn.lstm_stack`), the
    same f32 function."""
    H = params[0]["w_hh"].shape[0]
    dtype = PREC.rec_dtype(mode, x.shape[0], H)
    if dtype == torch.float32:
        return R.lstm_stack(params, x)[0]
    kernel = SKEWED if x.shape[0] <= LATENCY_MAX_ROWS else STREAM
    return _run(kernel, params, x, mode, pack_stack(params, dtype))
