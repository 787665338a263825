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
the JAX bf16 conv's is.  Recurrent products follow the JAX package's two
gates:

  * :func:`rec_dtype`, the scans' gate (``precision._rec_use_bf16``): bf16
    under the bf16 policy when H >= ``REC_BF16_MIN_HIDDEN`` and the batch
    has at least ``REC_BF16_MIN_ROWS`` rows, else f32.  It sets the compute
    dtype of the speaker encoder's stack and decoder lstm1 at inference
    under the bf16 policy (kernels 2/3 on the GPU; the f32 policy keeps
    ``torch.lstm``, the same f32 function) and of the GRU-pair training
    kernels 4/5.  The encoder BLSTM (H = 32) stays on ``torch.lstm`` in
    f32, with bf16-rounded input projections under bf16, as in the JAX
    package.
  * :func:`lstm_kernel_dtype`, the JAX LSTM kernels' gate: bf16 under the
    bf16 policy when H >= ``REC_BF16_MIN_HIDDEN``, at every row count (the
    deliberate deviation of ``autovc_tpu/ops/precision.py:85-94``: no
    ``REC_BF16_MIN_ROWS`` clause).  It sets decoder lstm2 at inference and
    both decoder stacks in training.
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


def rec_dtype(mode: str, rows: int, hidden: int) -> torch.dtype:
    """Compute dtype of a recurrence that the JAX package runs as a scan
    (``precision._rec_use_bf16``): bf16 under the bf16 policy when
    H >= REC_BF16_MIN_HIDDEN and rows >= REC_BF16_MIN_ROWS; else f32."""
    if (mode == "bf16" and hidden >= REC_BF16_MIN_HIDDEN
            and rows >= REC_BF16_MIN_ROWS):
        return torch.bfloat16
    return torch.float32
