"""WaveRNN GRU-pair training: kernels 4 and 5 and their plain versions.

Counterpart of ``autovc_tpu/ops/gru_train_pallas.py``.  :func:`gru_pair`
keeps the JAX contract: time-major hoisted projections ``xp1`` and
``base2`` (T, B, 3H) in, ``(h1s, h2s)`` (T, B, H) out, with

    h1_t = GRU(h1_{t-1}; xp1_t)                    hp1 = h1_{t-1} W_hh1 + b_hh1
    h2_t = GRU(h2_{t-1}; base2_t + h1_t W_ih2x)    hp2 = h2_{t-1} W_hh2 + b_hh2

(PyTorch gate semantics, ``b_hh`` inside the reset product; zero initial
states), differentiable in all seven inputs.  The pair is a
``torch.autograd.Function`` (:class:`GruPair`):

  * on a CUDA tensor its forward launches kernel 4
    (``gru_train_fwd_launch`` of ``csrc/gru_train.cu``) and its backward
    kernel 5 (``gru_train_bwd_launch``: the reverse-time chain, then the
    hand-written dW / db products), or raises;
  * on a CPU tensor it runs :func:`gru_pair_fwd_plain` and
    :func:`gru_pair_bwd_plain`, the same arithmetic in PyTorch (the CPU path
    and the kernels' oracle).

Compute dtype: ``PREC.rec_dtype(mode, B, H)``, the gate of the JAX scan
(bf16 under the bf16 policy when H >= 256 and B >= 2, else f32).  The JAX
kernel rounds to bf16 under the bf16 policy at any H and row count; the
port follows the scan's gate on purpose, so that the kernel and the scan
it replaces compute one function.  In bf16 the rounding points are the JAX
kernel's: the weights, and h1, h2, dhp, dxp as matmul operands, with f32
accumulation; the saved r, z, n, hn stored in bf16; h, the dh chain and db
in f32; the dW products from bf16 operands with f32 accumulation.

Saved state (time-major): ``hs`` (2, T, B, H) f32 — h1 and h2, which are
also the outputs — and ``acts`` (2, T, B, 4H) in the compute dtype: r, z,
n, hn of each layer (hn = h_{t-1} W_hn + b_hn).  The weights change every
step, so they are packed per call.
"""
from __future__ import annotations

import ctypes

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD = _build.Kernel("gru_train.cu", "gru_train_fwd_launch",
                    [_P] * 11 + [_I] * 4 + [_P])
BWD = _build.Kernel("gru_train.cu", "gru_train_bwd_launch",
                    [_P] * 19 + [_I] * 4 + [_P])


def pack_fwd(whh1: torch.Tensor, wih2x: torch.Tensor, whh2: torch.Tensor,
             dtype: torch.dtype):
    """Kernel 4's weights: W_hh1, W_ih2x, W_hh2 (H, 3H) transposed to
    (3H, H) and cast to ``dtype``."""
    return tuple(w.T.to(dtype).contiguous() for w in (whh1, wih2x, whh2))


def pack_bwd(whh1: torch.Tensor, wih2x: torch.Tensor, whh2: torch.Tensor,
             dtype: torch.dtype):
    """Kernel 5's weights: the param layout (H, 3H) cast to ``dtype`` (row j
    holds unit j's 3H weights, the row the backward reads)."""
    return tuple(w.to(dtype).contiguous() for w in (whh1, wih2x, whh2))


def _op(bf16: bool):
    return PREC.round_bf16 if bf16 else (lambda a: a)


def _cell(xp, hp, h):
    """One GRU step from its pre-activations: (h, [r, z, n, hn])."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, torch.cat([r, z, n, hn], dim=-1)


def gru_pair_fwd_plain(xp1: torch.Tensor, base2: torch.Tensor,
                       whh1: torch.Tensor, wih2x: torch.Tensor,
                       whh2: torch.Tensor, bhh1: torch.Tensor,
                       bhh2: torch.Tensor):
    """Kernel 4's function in PyTorch: ``xp1``, ``base2`` (T, B, 3H) f32,
    weights as :func:`pack_fwd` gives them, ``bhh1``, ``bhh2`` (3H,) f32.
    Returns the saved ``hs`` (2, T, B, H) f32 and ``acts`` (2, T, B, 4H) in
    the weights' dtype.  Differentiable by autograd in f32 (the oracle of
    the plain backward)."""
    T, B, H3 = xp1.shape
    H = H3 // 3
    op = _op(whh1.dtype == torch.bfloat16)
    w1, wx, w2 = (w.float().T for w in (whh1, wih2x, whh2))    # (H, 3H)
    h1 = h2 = xp1.new_zeros(B, H)
    hs, acts = [[], []], [[], []]
    for t in range(T):
        h1, a1 = _cell(xp1[t], torch.matmul(op(h1), w1) + bhh1, h1)
        xp2 = base2[t] + torch.matmul(op(h1), wx)
        h2, a2 = _cell(xp2, torch.matmul(op(h2), w2) + bhh2, h2)
        for l, (h, a) in enumerate(((h1, a1), (h2, a2))):
            hs[l].append(h)
            acts[l].append(a.to(whh1.dtype))
    return (torch.stack([torch.stack(v) for v in hs]),
            torch.stack([torch.stack(v) for v in acts]))


def _gate_grads(acts_t, h_prev, dh):
    """Gate derivatives of one layer at one step (``_bwd_kernel:275-292``):
    (dxp, dhp) (B, 3H), dhp being dxp with the n lane times r."""
    r, z, n, hn = acts_t.float().chunk(4, dim=-1)
    da_n = dh * (1.0 - z) * (1.0 - n * n)
    da_z = dh * (h_prev - n) * z * (1.0 - z)
    da_r = da_n * hn * r * (1.0 - r)
    return (torch.cat([da_r, da_z, da_n], dim=-1),
            torch.cat([da_r, da_z, da_n * r], dim=-1))


def _with_reset(dxp: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """dhp from dxp and the saved r: the n lane times r."""
    H = acts.shape[-1] // 4
    return torch.cat([dxp[..., :2 * H],
                      dxp[..., 2 * H:] * acts[..., :H].float()], dim=-1)


def gru_pair_bwd_plain(acts: torch.Tensor, hs: torch.Tensor,
                       dh1s: torch.Tensor, dh2s: torch.Tensor,
                       whh1: torch.Tensor, wih2x: torch.Tensor,
                       whh2: torch.Tensor):
    """Kernel 5's function in PyTorch: the saved state of
    :func:`gru_pair_fwd_plain`, cotangents ``dh1s``, ``dh2s`` (T, B, H),
    weights as :func:`pack_bwd` gives them.  Returns the JAX VJP's order:
    ``dxp1``, ``dbase2`` (T, B, 3H), ``dwih2x``, ``dwhh1``, ``dbhh1``,
    ``dwhh2``, ``dbhh2``."""
    _, T, B, H = hs.shape
    op = _op(whh1.dtype == torch.bfloat16)
    w1t, wxt, w2t = (w.float().T for w in (whh1, wih2x, whh2))  # (3H, H)
    dh1c = torch.zeros_like(dh1s[0])
    dh2c = torch.zeros_like(dh2s[0])
    dxp1 = torch.empty(T, B, 3 * H, dtype=hs.dtype, device=hs.device)
    dxp2 = torch.empty_like(dxp1)
    zero = torch.zeros_like(dh1c)
    for t in range(T - 1, -1, -1):
        h1p, h2p = (hs[0, t - 1], hs[1, t - 1]) if t > 0 else (zero, zero)
        dh2 = dh2s[t] + dh2c
        dxp2[t], dhp2 = _gate_grads(acts[1, t], h2p, dh2)
        z2 = acts[1, t, :, H:2 * H].float()
        dh2c = dh2 * z2 + torch.matmul(op(dhp2), w2t)
        # layer 1's dh takes dxp2 W_ih2x^T of the same step
        dh1 = dh1s[t] + dh1c + torch.matmul(op(dxp2[t]), wxt)
        dxp1[t], dhp1 = _gate_grads(acts[0, t], h1p, dh1)
        z1 = acts[0, t, :, H:2 * H].float()
        dh1c = dh1 * z1 + torch.matmul(op(dhp1), w1t)
    # weight gradients over all (t, b): h_{t-1} (zero at t = 0) against dhp,
    # h1_t against dxp2
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    dhp1 = _with_reset(dxp1, acts[0])
    dhp2 = _with_reset(dxp2, acts[1])
    dw = "tbh,tbk->hk"
    return (dxp1, dxp2, torch.einsum(dw, op(hs[0]), op(dxp2)),
            torch.einsum(dw, op(h_prev[0]), op(dhp1)), dhp1.sum(dim=(0, 1)),
            torch.einsum(dw, op(h_prev[1]), op(dhp2)), dhp2.sum(dim=(0, 1)))


def _check_geometry(H: int, dtype: torch.dtype) -> None:
    if H % 16:
        raise ValueError(f"unsupported GRU hidden size H={H}: kernels 4/5 "
                         f"split H and 3H in two 8-aligned halves (H % 16 "
                         f"== 0)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("weights must be f32 or bf16")


def fwd_launch(xp1: torch.Tensor, base2: torch.Tensor, whh1: torch.Tensor,
               wih2x: torch.Tensor, whh2: torch.Tensor, bhh1: torch.Tensor,
               bhh2: torch.Tensor):
    """Kernel 4 on CUDA tensors (checked here); the same results as
    :func:`gru_pair_fwd_plain`."""
    T, B, H3 = xp1.shape
    H = H3 // 3
    _check_geometry(H, whh1.dtype)
    if tuple(base2.shape) != (T, B, 3 * H) or H3 != 3 * H:
        raise ValueError("xp1 and base2 must both be (T, B, 3H)")
    for w in (whh1, wih2x, whh2):
        if tuple(w.shape) != (3 * H, H) or w.dtype != whh1.dtype:
            raise ValueError("weights must be (3H, H), all of one dtype")
    for t in (xp1, base2, bhh1, bhh2):
        if t.dtype != torch.float32:
            raise ValueError("xp1, base2 and the biases must be float32")
    dev = xp1.device
    _build.check_inputs((xp1, base2, whh1, wih2x, whh2, bhh1, bhh2), dev)
    hs = torch.empty(2, T, B, H, device=dev)
    acts = torch.empty(2, T, B, 4 * H, device=dev, dtype=whh1.dtype)
    hp2 = torch.empty(B, 3 * H, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        FWD(xp1.data_ptr(), base2.data_ptr(), whh1.data_ptr(),
            wih2x.data_ptr(), whh2.data_ptr(), bhh1.data_ptr(),
            bhh2.data_ptr(), hs.data_ptr(), acts.data_ptr(), hp2.data_ptr(),
            bar.data_ptr(), T, B, H, int(whh1.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    return hs, acts


def bwd_launch(acts: torch.Tensor, hs: torch.Tensor, dh1s: torch.Tensor,
               dh2s: torch.Tensor, whh1: torch.Tensor, wih2x: torch.Tensor,
               whh2: torch.Tensor):
    """Kernel 5 on CUDA tensors (checked here); the same results as
    :func:`gru_pair_bwd_plain`."""
    _, T, B, H = hs.shape
    _check_geometry(H, whh1.dtype)
    for w in (whh1, wih2x, whh2):
        if tuple(w.shape) != (H, 3 * H) or w.dtype != whh1.dtype:
            raise ValueError("weights must be (H, 3H), all of one dtype")
    if tuple(hs.shape) != (2, T, B, H) or acts.dtype != whh1.dtype \
            or tuple(acts.shape) != (2, T, B, 4 * H):
        raise ValueError("saved state must be hs (2, T, B, H) f32 and acts "
                         "(2, T, B, 4H) in the weights' dtype")
    for t in (hs, dh1s, dh2s):
        if t.dtype != torch.float32:
            raise ValueError("saved h and the cotangents must be float32")
    for t in (dh1s, dh2s):
        if tuple(t.shape) != (T, B, H):
            raise ValueError(f"cotangents must be (T, B, H), got "
                             f"{tuple(t.shape)}")
    dev = hs.device
    _build.check_inputs((acts, hs, dh1s, dh2s, whh1, wih2x, whh2), dev)
    dxp1 = torch.empty(T, B, 3 * H, device=dev)
    dxp2 = torch.empty(T, B, 3 * H, device=dev)
    dw = [torch.empty(H, 3 * H, device=dev) for _ in range(3)]
    db = [torch.empty(3 * H, device=dev) for _ in range(2)]
    dhp = [torch.empty(B, 3 * H, device=dev) for _ in range(2)]
    dhc = [torch.empty(B, H, device=dev) for _ in range(2)]
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        BWD(acts.data_ptr(), hs.data_ptr(), dh1s.data_ptr(), dh2s.data_ptr(),
            whh1.data_ptr(), wih2x.data_ptr(), whh2.data_ptr(),
            dxp1.data_ptr(), dxp2.data_ptr(),
            *(t.data_ptr() for t in (*dw, *db, *dhp, *dhc)),
            bar.data_ptr(), T, B, H, int(whh1.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    dwhh1, dwih2x, dwhh2 = dw
    return dxp1, dxp2, dwih2x, dwhh1, db[0], dwhh2, db[1]


class GruPair(torch.autograd.Function):
    """:func:`gru_pair`'s recurrence: kernel 4 forward and kernel 5
    backward on CUDA, the plain versions on the CPU.  Inputs: the seven
    tensors of :func:`gru_pair` (f32 params) and the compute dtype;
    outputs ``h1s``, ``h2s`` (T, B, H)."""

    @staticmethod
    def forward(ctx, xp1, base2, wih2x, whh1, bhh1, whh2, bhh2, dtype):
        wf = pack_fwd(whh1, wih2x, whh2, dtype)
        bias = (bhh1.float().contiguous(), bhh2.float().contiguous())
        if xp1.device.type == "cuda":
            hs, acts = fwd_launch(xp1.contiguous(), base2.contiguous(), *wf,
                                  *bias)
        elif xp1.device.type == "cpu":
            hs, acts = gru_pair_fwd_plain(xp1, base2, *wf, *bias)
        else:
            raise ValueError(f"unsupported device {xp1.device}")
        ctx.save_for_backward(hs, acts, whh1, wih2x, whh2)
        ctx.dtype = dtype
        return hs[0].clone(), hs[1].clone()

    @staticmethod
    def backward(ctx, dh1s, dh2s):
        hs, acts, whh1, wih2x, whh2 = ctx.saved_tensors
        dh1s = torch.zeros_like(hs[0]) if dh1s is None else dh1s.contiguous()
        dh2s = torch.zeros_like(hs[1]) if dh2s is None else dh2s.contiguous()
        wb = pack_bwd(whh1, wih2x, whh2, ctx.dtype)
        run = bwd_launch if hs.device.type == "cuda" else gru_pair_bwd_plain
        return (*run(acts, hs, dh1s, dh2s, *wb), None)


def gru_pair(xp1: torch.Tensor, base2: torch.Tensor, wih2x: torch.Tensor,
             whh1: torch.Tensor, bhh1: torch.Tensor, whh2: torch.Tensor,
             bhh2: torch.Tensor, mode: str = "f32"):
    """Fused teacher-forced GRU pair, time-major: ``xp1``/``base2`` (T, B,
    3H) f32 hoisted projections (input biases folded in), weights (H, 3H),
    ``bhh`` (3H,) -> ``(h1s, h2s)``, each (T, B, H) f32.  ``mode`` is the
    precision policy ("f32" or "bf16"); the JAX function reads it from its
    context."""
    B, H = xp1.shape[1], whh1.shape[0]
    return GruPair.apply(xp1, base2, wih2x, whh1, bhh1, whh2, bhh2,
                         PREC.rec_dtype(mode, B, H))
