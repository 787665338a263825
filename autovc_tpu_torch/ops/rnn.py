"""Plain recurrences (counterpart of ``autovc_tpu/ops/rnn.py``).

The JAX package runs these as XLA scans, not Pallas kernels.  The port runs
the LSTMs through PyTorch's fused LSTM (``torch.lstm``: cuDNN on the GPU,
ATen on the CPU; differentiable), in exact float32: the encoder BLSTM,
whose input projections take bf16-rounded operands under the bf16 policy
as the JAX package's hoisted projections do (its H = 32 recurrent product
stays f32 there too), and the speaker encoder's stack and decoder lstm1 at
inference where the scan's gate keeps them f32.  Where that gate makes
them bf16 they go through the kernels of
:mod:`autovc_tpu_torch.ops.lstm_kernels` (``lstm_stack_rec``), as does the
decoder lstm2 stack; both decoder stacks in training go through
:mod:`autovc_tpu_torch.ops.lstm_train_kernels`.  The GRU layer here is
plain PyTorch, differentiable by autograd (the reference of the GRU-pair
kernels of :mod:`autovc_tpu_torch.ops.gru_train_kernels`).

Parameter layout is the JAX package's: ``w_ih`` (in, 4H) / ``w_hh`` (H, 4H)
used as ``x @ w``, gate order i, f, g, o (LSTM) and r, z, n (GRU),
separate ``b_ih``/``b_hh``.  PyTorch's fused LSTM takes the transposes.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Sequence

import torch

from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops.conv import uniform

Params = Dict[str, Any]


def init_lstm_layer(gen, input_size: int, hidden_size: int) -> Params:
    """One LSTM layer, PyTorch default init: U(-1/sqrt(H), 1/sqrt(H))."""
    k = 1.0 / math.sqrt(hidden_size)
    return {
        "w_ih": uniform(gen, (input_size, 4 * hidden_size), k),
        "w_hh": uniform(gen, (hidden_size, 4 * hidden_size), k),
        "b_ih": uniform(gen, (4 * hidden_size,), k),
        "b_hh": uniform(gen, (4 * hidden_size,), k),
    }


def init_lstm_stack(gen, input_size: int, hidden_size: int,
                    num_layers: int) -> List[Params]:
    return [init_lstm_layer(gen, input_size if i == 0 else hidden_size,
                            hidden_size)
            for i in range(num_layers)]


def init_bilstm_stack(gen, input_size: int, hidden_size: int,
                      num_layers: int) -> List[Params]:
    layers = []
    for i in range(num_layers):
        in_size = input_size if i == 0 else 2 * hidden_size
        layers.append({"fwd": init_lstm_layer(gen, in_size, hidden_size),
                       "bwd": init_lstm_layer(gen, in_size, hidden_size)})
    return layers


def init_gru_layer(gen, input_size: int, hidden_size: int) -> Params:
    k = 1.0 / math.sqrt(hidden_size)
    return {
        "w_ih": uniform(gen, (input_size, 3 * hidden_size), k),
        "w_hh": uniform(gen, (hidden_size, 3 * hidden_size), k),
        "b_ih": uniform(gen, (3 * hidden_size,), k),
        "b_hh": uniform(gen, (3 * hidden_size,), k),
    }


def _flat(p: Params):
    """PyTorch's fused-LSTM weight list for one layer/direction."""
    return [p["w_ih"].T.contiguous(), p["w_hh"].T.contiguous(),
            p["b_ih"], p["b_hh"]]


def _fused_lstm(x, weights, num_layers, hidden, bidirectional=False,
                state=None):
    B = x.shape[0]
    nd = 2 if bidirectional else 1
    h0 = c0 = x.new_zeros(num_layers * nd, B, hidden)
    if state is not None:
        h0, c0 = (s.reshape(num_layers * nd, B, hidden) for s in state)
    with warnings.catch_warnings():
        # cuDNN notes that the per-call weight list is not one flat buffer
        # (it compacts it per call); the plain recurrences accept that
        warnings.filterwarnings("ignore", "RNN module weights")
        # cuDNN differentiates only its training-mode call: take it when
        # autograd records a gradient (no dropout, so the same outputs)
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in weights)
            or (state is not None
                and any(t.requires_grad for t in state)))
        out, h, c = torch.lstm(x.contiguous(), (h0, c0), weights, True,
                               num_layers, 0.0, grad, bidirectional, True)
    return out, h, c


def lstm_layer(params: Params, x: torch.Tensor, state=None):
    """One LSTM layer over (B, T, I) -> outputs (B, T, H), final (h, c);
    ``state``: the initial (h, c), each (B, H) (zeros when None)."""
    H = params["w_hh"].shape[0]
    out, h, c = _fused_lstm(x, _flat(params), 1, H, state=state)
    return out, (h[0], c[0])


def lstm_stack(params: Sequence[Params], x: torch.Tensor):
    """Unidirectional multi-layer LSTM (uniform hidden size, as every stack
    of these models).  Returns (outputs, last-layer (h, c), per-layer final
    hidden states (L, B, H))."""
    H = params[0]["w_hh"].shape[0]
    weights = [w for p in params for w in _flat(p)]
    out, h, c = _fused_lstm(x, weights, len(params), H)
    return out, (h[-1], c[-1]), h


def lstm_stack_skewed(params: Sequence[Params], x: torch.Tensor):
    """Same outputs as :func:`lstm_stack`.  The JAX package's layer skew is
    a TPU scheduling of the same recurrence; here the fused LSTM runs the
    stack."""
    return lstm_stack(params, x)


def bilstm_stack(params: Sequence[Params], x: torch.Tensor,
                 mode: str = "f32") -> torch.Tensor:
    """Bidirectional multi-layer LSTM over (B, T, I) -> (B, T, 2H), outputs
    concatenated [forward, backward] on the feature axis.  Layer by layer,
    so that under ``mode="bf16"`` each layer's input and ``w_ih`` are
    rounded to bf16 (``autovc_tpu/ops/rnn.py:247-248``)."""
    H = params[0]["fwd"]["w_hh"].shape[0]
    for lp in params:
        x, wf, wb = PREC.operands(mode, x, lp["fwd"]["w_ih"],
                                  lp["bwd"]["w_ih"])
        weights = (_flat(dict(lp["fwd"], w_ih=wf))
                   + _flat(dict(lp["bwd"], w_ih=wb)))
        x, _, _ = _fused_lstm(x, weights, 1, H, bidirectional=True)
    return x


def gru_cell(params: Params, xp_t: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One GRU step given ``xp_t = x_t @ w_ih + b_ih`` (B, 3H); PyTorch gate
    semantics, ``b_hh`` inside the reset gate."""
    hp = torch.matmul(h, params["w_hh"]) + params["b_hh"]
    xr, xz, xn = xp_t.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_project_inputs(params: Params, x: torch.Tensor,
                       mode: str = "f32") -> torch.Tensor:
    """Hoisted time-parallel input projection for :func:`gru_cell`:
    ``x @ w_ih + b_ih`` under policy ``mode``."""
    return PREC.dot(x, params["w_ih"], mode) + params["b_ih"]


def gru_layer(params: Params, x: torch.Tensor,
              h0: torch.Tensor | None = None):
    """One GRU layer over (B, T, I) -> outputs (B, T, H), final h; f32,
    differentiable by autograd."""
    B, T, _ = x.shape
    H = params["w_hh"].shape[0]
    xp = gru_project_inputs(params, x)
    h = x.new_zeros(B, H) if h0 is None else h0
    ys = []
    for t in range(T):
        h = gru_cell(params, xp[:, t], h)
        ys.append(h)
    return torch.stack(ys, dim=1), h
