"""Decoder LSTM-stack inference: kernels 2 and 3 and their plain version.

Counterpart of ``autovc_tpu/ops/lstm_pallas.py``:

  * :func:`lstm_stack_latency` replaces ``lstm_stack_pallas`` (<= 8 rows,
    the single-utterance decoder lstm2): kernel ``lstm_stack_skewed_launch``
    of ``csrc/lstm_stack.cu``, layer-skewed rounds;
  * :func:`lstm_stack_stream` replaces ``lstm_stack_stream`` (> 8 rows):
    kernel ``lstm_stack_stream_launch``, all layers at one timestep a round.

Both take a uniform-H stack (the JAX param layout) and x (B, T, I) and
return the last layer's outputs (B, T, H).  The layer-0 projection over all
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
from typing import Sequence

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC

LATENCY_MAX_ROWS = 8

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
SKEWED = _build.Kernel("lstm_stack.cu", "lstm_stack_skewed_launch", _ARGS)
STREAM = _build.Kernel("lstm_stack.cu", "lstm_stack_stream_launch", _ARGS)


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
    """Launch one of the two kernels on CUDA tensors (checked here)."""
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
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("all kernel inputs must be contiguous tensors "
                             "on one CUDA device")
    out = torch.empty(T, B, H, device=dev)
    h = torch.empty(2, L, B, H, device=dev)
    c = torch.empty(L, B, H, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    wih_ptr = wih.data_ptr() if wih.numel() else whh.data_ptr()
    bias_ptr = bias.data_ptr() if bias.numel() else xp0.data_ptr()
    with torch.cuda.device(dev):      # the C side launches on the current device
        kernel(xp0.data_ptr(), whh.data_ptr(), wih_ptr, bias_ptr,
               out.data_ptr(), h.data_ptr(), c.data_ptr(), bar.data_ptr(),
               T, B, H, L, int(whh.dtype == torch.bfloat16),
               torch.cuda.current_stream(dev).cuda_stream)
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
