"""Matmul/conv precision policy (counterpart of ``autovc_tpu/ops/precision.py``).

Two modes, passed explicitly to the functions that use them:

  * ``"f32"``: exact float32.  On the GPU both TF32 switches are off
    (:func:`exact_f32`): cuBLAS matmuls AND cuDNN convolutions, which
    default to TF32.
  * ``"bf16"``: bf16 operands, float32 accumulation; parameters, BatchNorm
    statistics and recurrent state stay float32.

``"auto"`` resolves to bf16 on the GPU and to f32 on the CPU, as the JAX
package resolves it to bf16 on its accelerator and f32 elsewhere.

Under bf16 a convolution's output is rounded to bf16 before its bias, as
the JAX bf16 conv's is.  The plain recurrences of
:mod:`autovc_tpu_torch.ops.rnn` (encoder BLSTM, decoder lstm1 at
inference, speaker encoder) run their recurrent products in exact float32
in both modes — strictly more accurate than the bf16 contract; the BLSTM
rounds its input projections' operands under bf16, as the JAX package
does.  The decoder LSTM kernels (lstm2 at inference, lstm1 and lstm2 in
training) follow the JAX kernels' gate: bf16 under the bf16 policy when
H >= ``REC_BF16_MIN_HIDDEN``, at every row count (the deliberate deviation
of ``autovc_tpu/ops/precision.py:85-94``: no ``REC_BF16_MIN_ROWS``
clause).
"""
from __future__ import annotations

import torch

VALID_MODES = ("f32", "bf16")

REC_BF16_MIN_HIDDEN = 256
REC_BF16_MIN_ROWS = 2


def resolve(mode: str, device) -> str:
    """Resolve ``"auto"`` for ``device``: bf16 on CUDA, f32 on the CPU."""
    if mode == "auto":
        return "bf16" if torch.device(device).type == "cuda" else "f32"
    if mode not in VALID_MODES:
        raise ValueError(f"precision {mode!r} not in "
                         f"{VALID_MODES + ('auto',)}")
    return mode


def exact_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions, so ``"f32"`` is
    float32 on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to the nearest bf16 value, kept as float32."""
    return x.to(torch.bfloat16).float()


def operands(mode: str, *xs: torch.Tensor):
    """Round matmul/conv operands per policy.  A bf16-rounded operand pair
    multiplied in exact f32 IS the bf16-operand / f32-accumulate contract
    (every product of two bf16 values is exact in f32), with an f32
    result, as ``preferred_element_type=float32`` gives in JAX."""
    if mode == "bf16":
        return tuple(round_bf16(x) for x in xs)
    return xs


def dot(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """Policy-routed matmul: f32, or bf16 operands with f32 accumulation."""
    a, b = operands(mode, a, b)
    return torch.matmul(a, b)


def lstm_kernel_dtype(mode: str, hidden: int) -> torch.dtype:
    """Compute dtype of the decoder LSTM-stack kernels
    (``lstm_pallas.py:124,243-245``, ``lstm_train_pallas.py:329-333``):
    bf16 under the bf16 policy when
    H >= REC_BF16_MIN_HIDDEN, at every row count; else f32."""
    if mode == "bf16" and hidden >= REC_BF16_MIN_HIDDEN:
        return torch.bfloat16
    return torch.float32
