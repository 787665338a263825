"""LSTM-stack training: kernels 6 and 7 and their plain versions.

Counterpart of ``autovc_tpu/ops/lstm_train_pallas.py``.
:func:`lstm_stack_train` runs a uniform-H L-layer stack with zero initial
states and returns ``(ys (B, T, H), (h_fin, c_fin))``, differentiable in
``x`` and every weight and bias.  The layer-0 projection over all T (plus
both biases) is hoisted with ``PREC.dot`` outside the kernels and autograd
differentiates it, as in the JAX package.  The recurrence is a
``torch.autograd.Function`` (:class:`StackTrain`):

  * on a CUDA tensor its forward launches kernel 6
    (``lstm_train_fwd_launch`` of ``csrc/lstm_train.cu``: the layer-skewed
    routine of ``csrc/lstm_fwd.cuh``, shared with kernel 3, on the launch
    plan of :func:`lstm_kernels.fwd_plan`) and its backward
    kernel 7 (``lstm_train_bwd_launch``: the reverse-time recurrence on the
    launch plan of :func:`bwd_plan`, then the hand-written dW / db
    products), or raises;
  * on a CPU tensor it runs :func:`lstm_train_fwd_plain` and
    :func:`lstm_train_bwd_plain`, the same arithmetic in PyTorch (the CPU
    path and the kernels' oracle).

Compute dtype: ``PREC.lstm_kernel_dtype(mode, H)``, the JAX ``_cdt`` gate
(bf16 under the bf16 policy when H >= 256, else f32), under both policies:
the JAX package sends the f32 stack back to its scan only because it does
not fit the TPU's VMEM.  bf16 rounding points are the JAX kernels': the
matmul operands (h, y of the layer below, da) and the weights are rounded
to bf16 with f32 accumulation, the saved i, f, g, o activations are stored
in bf16, and h, c, the dc chain and db stay f32.

Saved state (time-major): ``hs`` and ``cs`` (L, T, B, H) f32 — the JAX
kernel's ``h || c`` stream — and ``acts`` (L, T, B, 4H) in the compute
dtype.  The weights change every step, so they are packed per call.

Geometry on the card: H % 16 == 0, and at most :data:`MAX_LAYERS` layers
(kernel 7 carries each layer's dc / dh in registers).  A deeper stack is
refused before kernel 6 launches, not half-way through a step.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.parallel import tensor as TP

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD = _build.Kernel("lstm_train.cu", "lstm_train_fwd_launch",
                    [_P] * 10 + [_I] * 9 + [_P])
BWD = _build.Kernel("lstm_train.cu", "lstm_train_bwd_launch",
                    [_P] * 14 + [_I] * 9 + [_P])


def pack_fwd(whh: torch.Tensor, wih: torch.Tensor, dtype: torch.dtype):
    """Kernel 6's weights: W_hh (L, 4H, H) and W_ih of layers >= 1
    (L-1, 4H, H), transposed to (out, in) and cast to ``dtype``."""
    return (whh.transpose(1, 2).to(dtype).contiguous(),
            wih.transpose(1, 2).to(dtype).contiguous())


def pack_bwd(whh: torch.Tensor, wih: torch.Tensor, dtype: torch.dtype):
    """Kernel 7's weights: the param layout (in, 4H), cast to ``dtype``
    (row j holds unit j's 4H weights, the row the backward reads)."""
    return whh.to(dtype).contiguous(), wih.to(dtype).contiguous()


def _op(bf16: bool):
    return PREC.round_bf16 if bf16 else (lambda a: a)


def lstm_train_fwd_plain(xp0: torch.Tensor, whh: torch.Tensor,
                         wih: torch.Tensor, bias: torch.Tensor):
    """Kernel 6's function in PyTorch.  ``xp0`` (T, B, 4H) f32, weights as
    :func:`pack_fwd` gives them, ``bias`` (L-1, 4H) f32.  Returns ``ys``
    (T, B, H), ``h_fin``, ``c_fin`` (B, H), and the saved ``hs``, ``cs``
    (L, T, B, H) f32 and ``acts`` (L, T, B, 4H) in the weights' dtype.
    Differentiable by autograd in f32 (the oracle of the plain
    backward)."""
    T, B, H4 = xp0.shape
    H = H4 // 4
    L = whh.shape[0]
    op = _op(whh.dtype == torch.bfloat16)
    whh_t = [w.float().T for w in whh]
    wih_t = [w.float().T for w in wih]
    h = [xp0.new_zeros(B, H) for _ in range(L)]
    c = [xp0.new_zeros(B, H) for _ in range(L)]
    hs, cs, acts = [[] for _ in range(L)], [[] for _ in range(L)], \
        [[] for _ in range(L)]
    for t in range(T):
        for l in range(L):
            inp = (xp0[t] if l == 0
                   else torch.matmul(op(h[l - 1]), wih_t[l - 1]) + bias[l - 1])
            gates = inp + torch.matmul(op(h[l]), whh_t[l])
            ai, af, ag, ao = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(ai), torch.sigmoid(af), torch.sigmoid(ao)
            g = torch.tanh(ag)
            c[l] = f * c[l] + i * g
            h[l] = o * torch.tanh(c[l])
            hs[l].append(h[l])
            cs[l].append(c[l])
            acts[l].append(torch.cat([i, f, g, o], dim=-1).to(whh.dtype))
    ys = torch.stack(hs[L - 1])
    hs = torch.stack([torch.stack(v) for v in hs])
    cs = torch.stack([torch.stack(v) for v in cs])
    acts = torch.stack([torch.stack(v) for v in acts])
    return ys, h[L - 1], c[L - 1], hs, cs, acts


def lstm_train_bwd_plain(acts: torch.Tensor, hs: torch.Tensor,
                         cs: torch.Tensor, dys: torch.Tensor,
                         dh_fin: torch.Tensor, dc_fin: torch.Tensor,
                         whh: torch.Tensor, wih: torch.Tensor):
    """Kernel 7's function in PyTorch, the arithmetic of
    ``lstm_train_pallas._bwd_kernel`` (``ops/rnn._lstm_core_bwd``): the saved
    state of :func:`lstm_train_fwd_plain`, cotangents ``dys`` (T, B, H),
    ``dh_fin``/``dc_fin`` (B, H), weights as :func:`pack_bwd` gives them.
    Returns ``dxp0`` (T, B, 4H), ``dwhh`` (L, H, 4H), ``dwih`` (L-1, H, 4H)
    and ``db`` (L, 4H): every layer's gate-derivative sum (entry 0 is
    layer 0's, whose biases live in xp0)."""
    L, T, B, H = hs.shape
    bf16 = whh.dtype == torch.bfloat16
    op = _op(bf16)
    whh_t = [w.float().T for w in whh]          # (4H, H)
    wih_t = [w.float().T for w in wih]
    dh = [torch.zeros_like(dh_fin) for _ in range(L)]
    dc = [torch.zeros_like(dc_fin) for _ in range(L)]
    dh[L - 1], dc[L - 1] = dh_fin, dc_fin
    das = torch.empty(L, T, B, 4 * H, dtype=hs.dtype, device=hs.device)
    for t in range(T - 1, -1, -1):
        dh_below = None
        for l in range(L - 1, -1, -1):
            i, f, g, o = acts[l, t].float().chunk(4, dim=-1)
            c_t = cs[l, t]
            c_p = cs[l, t - 1] if t > 0 else torch.zeros_like(c_t)
            d = dh[l]
            if l == L - 1:
                d = d + dys[t]
            if dh_below is not None:
                d = d + dh_below
            tc = torch.tanh(c_t)
            da_o = d * tc * o * (1.0 - o)
            dcl = dc[l] + d * o * (1.0 - tc * tc)
            da_i = dcl * g * i * (1.0 - i)
            da_g = dcl * i * (1.0 - g * g)
            da_f = dcl * c_p * f * (1.0 - f)
            da = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
            das[l, t] = da
            dh[l] = torch.matmul(op(da), whh_t[l])
            dc[l] = dcl * f
            dh_below = torch.matmul(op(da), wih_t[l - 1]) if l > 0 else None
    # weight gradients: h_{t-1} (zero at t = 0) and the layer below's
    # output, contracted with da over all (t, b)
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    dwhh = torch.einsum("ltbh,ltbk->lhk", op(h_prev), op(das))
    dwih = torch.einsum("ltbh,ltbk->lhk", op(hs[:-1]), op(das[1:]))
    return das[0], dwhh, dwih, das.sum(dim=(1, 2))


def fwd_launch(xp0: torch.Tensor, whh: torch.Tensor, wih: torch.Tensor,
               bias: torch.Tensor):
    """Kernel 6 on CUDA tensors (checked here), on the device's
    :func:`lstm_kernels.fwd_plan`; the same results as
    :func:`lstm_train_fwd_plain`."""
    T, B, H4 = xp0.shape
    L, _, H = whh.shape
    if H4 != 4 * H or H % 16:
        raise ValueError(f"bad LSTM geometry: 4H={H4}, H={H} (the kernels "
                         f"split H in two 8-aligned halves: H % 16 == 0)")
    if (whh.dtype not in (torch.float32, torch.bfloat16)
            or wih.dtype != whh.dtype):
        raise ValueError("weights must be f32 or bf16, both of one dtype")
    if xp0.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("xp0 and bias must be float32")
    if (tuple(wih.shape) != (L - 1, 4 * H, H)
            or tuple(bias.shape) != (L - 1, 4 * H)):
        raise ValueError("wih/bias shapes do not match the stack")
    dev = xp0.device
    _build.check_inputs((xp0, whh, wih, bias), dev)
    ys = torch.empty(T, B, H, device=dev)
    hs = torch.empty(L, T, B, H, device=dev)
    cs = torch.empty(L, T, B, H, device=dev)
    acts = torch.empty(L, T, B, 4 * H, device=dev, dtype=whh.dtype)
    ring = torch.empty(2, L, B, H, device=dev, dtype=whh.dtype)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    bf16 = whh.dtype == torch.bfloat16
    plan = LK.device_plan(B, H, L, bf16, dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        FWD(xp0.data_ptr(), whh.data_ptr(),
            wih.data_ptr() if wih.numel() else whh.data_ptr(),
            bias.data_ptr() if bias.numel() else xp0.data_ptr(),
            ys.data_ptr(), hs.data_ptr(), cs.data_ptr(), acts.data_ptr(),
            ring.data_ptr(), bar.data_ptr(), T, B, H, L, plan.units,
            plan.rows, int(plan.route == "mma_smem"), plan.smem_bytes,
            int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    return (ys, hs[L - 1, T - 1].clone(), cs[L - 1, T - 1].clone(), hs, cs,
            acts)


# Kernel 7's launch geometry (csrc/lstm_train.cu, kernel 7 (a)): 256
# threads a block, at most 4 (row, unit) pairs a thread and 4 layers of
# carried state, resident weight rows of pitch 4H + 32 values, an H100's
# opt-in shared memory per block.
THREADS, MAX_PAIRS, MAX_LAYERS, PITCH_PAD = 256, 4, 4, 32
WARPS, SPLIT, ROW_TILE_F32 = 8, 2, 8
SMEM_MAX = 232448


@dataclass(frozen=True)
class BwdPlan:
    """How kernel 7's recurrence covers an (L, B, H) stack.

    ``route``: "mma_smem" (bf16 tensor-core product, the block's weight
    rows resident in shared memory), "mma_l2" (the same product, weights
    read from L2: they do not fit) or "fma" (f32).  A block owns ``units``
    hidden units; ``rows`` rows go through the product at once
    (``m_tiles`` 16-row tiles in bf16), ``groups`` times over the batch."""
    route: str
    units: int
    blocks: int
    rows: int
    groups: int
    m_tiles: int
    pairs: int             # (row, unit) pairs a thread owns
    resident_bytes: int
    smem_bytes: int


def check_depth(L: int) -> None:
    """Raise unless kernel 7 can carry ``L`` layers' state."""
    if L > MAX_LAYERS:
        raise ValueError(f"kernel 7 carries at most {MAX_LAYERS} layers' "
                         f"state, not {L}")


def bwd_plan(B: int, H: int, L: int, bf16: bool, sms: int) -> BwdPlan:
    """Kernel 7's plan for ``sms`` streaming multiprocessors: the fewest
    row groups whose state fits, resident weights where they fit beside
    the partial sums."""
    if H % 16 or L < 1 or B < 1:
        raise ValueError(f"bad LSTM geometry: L={L}, B={B}, H={H}")
    check_depth(L)
    units = 8 * -(-H // (8 * sms))
    tile = 16 if bf16 else ROW_TILE_F32
    nparts = WARPS if bf16 else SPLIT
    weights = (2 * L - 1) * units * (4 * H + PITCH_PAD) * 2
    cap = MAX_PAIRS * THREADS // units // tile * tile
    if cap < 1:
        raise ValueError(f"H={H} needs {units} units a block: too many for "
                         f"kernel 7's pairs")
    groups = -(-B // cap)
    while True:
        rows = -(-B // groups)
        mpad = -(-rows // tile) * tile
        parts = nparts * 2 * mpad * units * 4
        if not bf16:
            route, base = "fma", (ROW_TILE_F32 * 4 * H + WARPS * 2
                                  * ROW_TILE_F32) * 4
        elif weights + parts <= SMEM_MAX:
            route, base = "mma_smem", weights
        else:
            route, base = "mma_l2", 0
        if base + parts <= SMEM_MAX:
            break
        if rows == 1:
            raise ValueError(f"kernel 7 does not fit H={H} in shared memory")
        groups += 1
    return BwdPlan(route=route, units=units, blocks=-(-H // units), rows=rows,
                   groups=groups, m_tiles=mpad // 16 if bf16 else 0,
                   pairs=-(-mpad * units // THREADS),
                   resident_bytes=base if route == "mma_smem" else 0,
                   smem_bytes=base + parts)


def bwd_launch(acts: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
               dys: torch.Tensor, dh_fin: torch.Tensor, dc_fin: torch.Tensor,
               whh: torch.Tensor, wih: torch.Tensor):
    """Kernel 7 on CUDA tensors (checked here), on the device's
    :func:`bwd_plan`; the same results as :func:`lstm_train_bwd_plain`."""
    L, T, B, H = hs.shape
    if H % 16 or tuple(whh.shape) != (L, H, 4 * H) \
            or tuple(wih.shape) != (L - 1, H, 4 * H):
        raise ValueError("weights do not match the saved state (H % 16 == "
                         "0, whh (L, H, 4H), wih (L-1, H, 4H))")
    if acts.dtype != whh.dtype or wih.dtype != whh.dtype \
            or whh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("acts and weights must share one dtype, f32 or "
                         "bf16")
    for t, shape in ((acts, (L, T, B, 4 * H)), (cs, (L, T, B, H)),
                     (dys, (T, B, H)), (dh_fin, (B, H)), (dc_fin, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    for t in (hs, cs, dys, dh_fin, dc_fin):
        if t.dtype != torch.float32:
            raise ValueError("saved h, c and the cotangents must be float32")
    dev = hs.device
    _build.check_inputs((acts, hs, cs, dys, dh_fin, dc_fin, whh, wih), dev)
    bf16 = whh.dtype == torch.bfloat16
    plan = bwd_plan(B, H, L, bf16,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    da = torch.empty(L, T, B, 4 * H, device=dev)
    ring = torch.empty(2, L, B, 4 * H, device=dev, dtype=whh.dtype)
    dwhh = torch.empty(L, H, 4 * H, device=dev)
    dwih = torch.empty(L - 1, H, 4 * H, device=dev)
    db = torch.empty(L, 4 * H, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        BWD(acts.data_ptr(), hs.data_ptr(), cs.data_ptr(), dys.data_ptr(),
            dh_fin.data_ptr(), dc_fin.data_ptr(), whh.data_ptr(),
            wih.data_ptr() if wih.numel() else whh.data_ptr(),
            da.data_ptr(), ring.data_ptr(), dwhh.data_ptr(),
            dwih.data_ptr() if dwih.numel() else dwhh.data_ptr(),
            db.data_ptr(), bar.data_ptr(), T, B, H, L, plan.units, plan.rows,
            int(plan.route == "mma_smem"), plan.smem_bytes, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    return da[0], dwhh, dwih, db


class StackTrain(torch.autograd.Function):
    """The recurrence of :func:`lstm_stack_train`: kernel 6 forward and
    kernel 7 backward on CUDA, the plain versions on the CPU.

    Inputs: ``xp0`` (T, B, 4H) f32, ``whh`` (L, H, 4H), ``wih``
    (L-1, H, 4H), ``bias`` (L-1, 4H) (f32 params, stacked outside so
    autograd routes their gradients back to the per-layer params) and the
    compute dtype.  Outputs: ``ys`` (T, B, H), ``h_fin``, ``c_fin``."""

    @staticmethod
    def forward(ctx, xp0, whh, wih, bias, dtype):
        wf = pack_fwd(whh, wih, dtype)
        if xp0.device.type == "cuda":
            check_depth(whh.shape[0])
            ys, h_fin, c_fin, hs, cs, acts = fwd_launch(
                xp0.contiguous(), *wf, bias.contiguous())
        elif xp0.device.type == "cpu":
            ys, h_fin, c_fin, hs, cs, acts = lstm_train_fwd_plain(
                xp0, *wf, bias)
        else:
            raise ValueError(f"unsupported device {xp0.device}")
        ctx.save_for_backward(hs, cs, acts, whh, wih)
        ctx.dtype = dtype
        return ys, h_fin, c_fin

    @staticmethod
    def backward(ctx, dys, dh_fin, dc_fin):
        hs, cs, acts, whh, wih = ctx.saved_tensors
        _, _, B, H = hs.shape
        zero = hs.new_zeros(B, H)
        dys = torch.zeros_like(hs[0]) if dys is None else dys.contiguous()
        dh_fin = zero if dh_fin is None else dh_fin.contiguous()
        dc_fin = zero if dc_fin is None else dc_fin.contiguous()
        wb = pack_bwd(whh, wih, ctx.dtype)
        run = bwd_launch if hs.device.type == "cuda" else lstm_train_bwd_plain
        dxp0, dwhh, dwih, db = run(acts, hs, cs, dys, dh_fin, dc_fin, *wb)
        # the bias input covers layers >= 1: layer 0's biases are folded
        # into xp0, so their gradient flows through dxp0
        return dxp0, dwhh, dwih, db[1:], None


def lstm_stack_train(params: Sequence, x: torch.Tensor, mode: str = "f32",
                     model=None):
    """Training LSTM stack (uniform H; layers >= 1 take H-dim inputs):
    x (B, T, I) -> (ys (B, T, H), (h_fin, c_fin)) with zero initial
    states, as ``lstm_train_pallas.lstm_stack_train``.  ``mode`` is the
    precision policy ("f32" or "bf16").  ``model`` (a
    ``parallel.tensor.ModelAxis``) whose shards hold the weights: the same
    function as ``rnn.lstm_stack_tp``'s per-step tensor-parallel loop,
    not kernels 6/7."""
    H = params[0]["w_hh"].shape[0]
    if TP.of(model, params[0]["w_hh"]) is not None:
        return R.lstm_stack_tp(params, x, mode,
                               PREC.lstm_kernel_dtype(mode, H), model)
    for p in params[1:]:
        if tuple(p["w_ih"].shape) != (H, 4 * H) or p["w_hh"].shape[0] != H:
            raise ValueError("lstm_stack_train needs a uniform hidden size")
    xp0 = (PREC.dot(x.transpose(0, 1), params[0]["w_ih"], mode)
           + params[0]["b_ih"] + params[0]["b_hh"])          # (T, B, 4H)
    whh = torch.stack([p["w_hh"] for p in params])
    if len(params) > 1:
        wih = torch.stack([p["w_ih"] for p in params[1:]])
        bias = torch.stack([p["b_ih"] + p["b_hh"] for p in params[1:]])
    else:
        wih = whh.new_zeros(0, H, 4 * H)
        bias = whh.new_zeros(0, 4 * H)
    ys, h_fin, c_fin = StackTrain.apply(
        xp0, whh, wih, bias, PREC.lstm_kernel_dtype(mode, H))
    return ys.transpose(0, 1), (h_fin, c_fin)
