"""Plain recurrences (counterpart of ``autovc_tpu/ops/rnn.py``).

The JAX package runs these as XLA scans, not Pallas kernels, so the port
runs them through PyTorch's fused LSTM (``torch.lstm``: cuDNN on the GPU,
ATen on the CPU) in exact float32 — used by the speaker encoder, the
encoder BLSTM and the decoder lstm1.  The decoder lstm2 stack goes through
the hand-written kernels of :mod:`autovc_tpu_torch.ops.lstm_kernels`.

Parameter layout is the JAX package's: ``w_ih`` (in, 4H) / ``w_hh`` (H, 4H)
used as ``x @ w``, gate order i, f, g, o (LSTM) and r, z, n (GRU),
separate ``b_ih``/``b_hh``.  PyTorch's fused LSTM takes the transposes.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Sequence

import torch

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


def _fused_lstm(x, weights, num_layers, hidden, bidirectional=False):
    B = x.shape[0]
    nd = 2 if bidirectional else 1
    h0 = x.new_zeros(num_layers * nd, B, hidden)
    with warnings.catch_warnings():
        # cuDNN notes that the per-call weight list is not one flat buffer
        # (it compacts it per call); the plain recurrences accept that
        warnings.filterwarnings("ignore", "RNN module weights")
        out, h, c = torch.lstm(x.contiguous(), (h0, h0), weights, True,
                               num_layers, 0.0, False, bidirectional, True)
    return out, h, c


def lstm_layer(params: Params, x: torch.Tensor):
    """One LSTM layer over (B, T, I) -> outputs (B, T, H), final (h, c)."""
    H = params["w_hh"].shape[0]
    out, h, c = _fused_lstm(x, _flat(params), 1, H)
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


def bilstm_stack(params: Sequence[Params], x: torch.Tensor) -> torch.Tensor:
    """Bidirectional multi-layer LSTM over (B, T, I) -> (B, T, 2H), outputs
    concatenated [forward, backward] on the feature axis."""
    H = params[0]["fwd"]["w_hh"].shape[0]
    weights = [w for lp in params
               for w in _flat(lp["fwd"]) + _flat(lp["bwd"])]
    out, _, _ = _fused_lstm(x, weights, len(params), H, bidirectional=True)
    return out


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
