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

Tensor parallelism (``model=``, a ``parallel.tensor.ModelAxis`` whose
shards hold the recurrences' weights): each rank holds the rule table's
block of the 4H / 3H gate columns, contiguous, so at M = 2 one rank holds
LSTM gates [i, f] and the other [g, o].  The columns are not permuted:
a rank's shard stays the JAX shard.  The hoisted input projection runs
column-parallel over all T at once; every step each rank computes its
columns of ``h @ W_hh``, the gate pre-activations are all-gathered over
the model group (once a step for all the recurrences that run in lock
step: both directions of a BLSTM layer, the input and hidden halves of a
GRU's), and every rank does the whole cell update, so h and c stay
replicated.  This is a per-step PyTorch loop, not kernels 2-7: their
persistent grids keep whole weight rows on the chip and cannot exchange
gates with another rank inside a step, as the JAX package's sharded
steps run its scans rather than its Pallas kernels.  Only the mesh makes
this choice: without a model axis the kernels run as before.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Sequence

import torch

from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops.conv import uniform
from autovc_tpu_torch.parallel import tensor as TP

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


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


def _lstm_tp_steps(xps, whhs, reverse, rec_bf16: bool, model):
    """Several LSTM recurrences in lock step, tensor-parallel: ``xps``
    this rank's input pre-activation columns (B, T, 4H / M) of each, both
    biases in; ``whhs`` its W_hh columns (H, 4H / M); ``reverse`` whether
    each runs from the last step.  ``rec_bf16``: h and W_hh rounded to
    bf16 for the recurrent product.  One all-gather a step carries every
    recurrence's gate block.  Returns each one's outputs (B, T, H) and
    final (h, c)."""
    B, T, _ = xps[0].shape
    H = whhs[0].shape[0]
    op = PREC.round_bf16 if rec_bf16 else _identity
    whhs = [op(w) for w in whhs]
    h = [xps[0].new_zeros(B, H) for _ in xps]
    c = [xps[0].new_zeros(B, H) for _ in xps]
    outs = [[None] * T for _ in xps]
    for s in range(T):
        ts = [T - 1 - s if r else s for r in reverse]
        pre = TP.gather_from_model(torch.stack(
            [xp[:, t] + torch.matmul(op(TP.copy_to_model(hj, model)), w)
             for xp, t, hj, w in zip(xps, ts, h, whhs)], dim=1), -1, model)
        for j, t in enumerate(ts):
            ai, af, ag, ao = pre[:, j].chunk(4, dim=-1)
            c[j] = torch.sigmoid(af) * c[j] + torch.sigmoid(ai) * torch.tanh(
                ag)
            h[j] = torch.sigmoid(ao) * torch.tanh(c[j])
            outs[j][t] = h[j]
    return ([torch.stack(o, dim=1) for o in outs],
            [(hj, cj) for hj, cj in zip(h, c)])


def lstm_stack_tp(params: Sequence[Params], x: torch.Tensor, mode: str,
                  cdt: torch.dtype, model):
    """The training LSTM stack (``lstm_train_kernels.lstm_stack_train``'s
    function) tensor-parallel, layer by layer: layer 0's input projection
    under policy ``mode``, the others' and every recurrent product at the
    compute dtype ``cdt`` (bf16: operands rounded, f32 accumulation).
    x (B, T, I) -> (ys (B, T, H), (h_fin, c_fin))."""
    op = PREC.round_bf16 if cdt == torch.bfloat16 else _identity
    h_in = x
    for l, p in enumerate(params):
        xin = TP.copy_to_model(h_in, model)
        if l == 0:
            xp = PREC.dot(xin, p["w_ih"], mode) + p["b_ih"] + p["b_hh"]
        else:
            xp = torch.matmul(op(xin), op(p["w_ih"])) + (p["b_ih"]
                                                          + p["b_hh"])
        (h_in,), (state,) = _lstm_tp_steps(
            [xp], [p["w_hh"]], [False], cdt == torch.bfloat16, model)
    return h_in, state


def bilstm_stack(params: Sequence[Params], x: torch.Tensor,
                 mode: str = "f32", model=None) -> torch.Tensor:
    """Bidirectional multi-layer LSTM over (B, T, I) -> (B, T, 2H), outputs
    concatenated [forward, backward] on the feature axis.  Layer by layer,
    so that under ``mode="bf16"`` each layer's input and ``w_ih`` are
    rounded to bf16 (``autovc_tpu/ops/rnn.py:247-248``).  ``model``: the
    tensor-parallel recurrence (module docstring) when the weights are
    shards, both directions in lock step, the recurrence in f32."""
    H = params[0]["fwd"]["w_hh"].shape[0]
    if TP.of(model, params[0]["fwd"]["w_hh"]) is not None:
        for lp in params:
            xin = TP.copy_to_model(x, model)
            dirs = (lp["fwd"], lp["bwd"])
            (yf, yb), _ = _lstm_tp_steps(
                [PREC.dot(xin, d["w_ih"], mode) + d["b_ih"] + d["b_hh"]
                 for d in dirs], [d["w_hh"] for d in dirs], [False, True],
                False, model)
            x = torch.cat([yf, yb], dim=-1)
        return x
    for lp in params:
        x, wf, wb = PREC.operands(mode, x, lp["fwd"]["w_ih"],
                                  lp["bwd"]["w_ih"])
        weights = (_flat(dict(lp["fwd"], w_ih=wf))
                   + _flat(dict(lp["bwd"], w_ih=wb)))
        x, _, _ = _fused_lstm(x, weights, 1, H, bidirectional=True)
    return x


def _gru_update(xp: torch.Tensor, hp: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """The GRU cell from its input and hidden pre-activations (B, 3H)."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(params: Params, xp_t: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One GRU step given ``xp_t = x_t @ w_ih + b_ih`` (B, 3H); PyTorch gate
    semantics, ``b_hh`` inside the reset gate."""
    hp = torch.matmul(h, params["w_hh"]) + params["b_hh"]
    return _gru_update(xp_t, hp, h)


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


def gru_pair_tp(xp1: torch.Tensor, base2: torch.Tensor, wih2x: torch.Tensor,
                whh1: torch.Tensor, bhh1: torch.Tensor, whh2: torch.Tensor,
                bhh2: torch.Tensor, cdt: torch.dtype, model):
    """The teacher-forced GRU pair (``gru_train_kernels.gru_pair``'s
    function) tensor-parallel: ``xp1`` / ``base2`` this rank's columns
    (T, B, 3H / M) of the hoisted projections, the weights' columns (H,
    3H / M), ``cdt`` the recurrent products' compute dtype.  Every step
    each layer gathers its input and hidden pre-activations as the two
    halves of one buffer, since the n gate needs ``r * (h W_hn + b_hn)``
    apart from the input part.  One ``copy_to_model`` of h1 feeds both
    its products (W_ih2x this step, W_hh1 the next), so its backward sums
    them before one all-reduce.  Returns ``(h1s, h2s)``, (T, B, H)."""
    T, B, _ = xp1.shape
    H = whh1.shape[0]
    op = PREC.round_bf16 if cdt == torch.bfloat16 else _identity
    w1, wx, w2 = op(whh1), op(wih2x), op(whh2)
    h1 = h2 = xp1.new_zeros(B, H)
    h1c = TP.copy_to_model(h1, model)
    h1s, h2s = [], []
    for t in range(T):
        g = TP.gather_from_model(torch.stack(
            [xp1[t], torch.matmul(op(h1c), w1) + bhh1], dim=1), -1, model)
        h1 = _gru_update(g[:, 0], g[:, 1], h1)
        h1c = TP.copy_to_model(h1, model)
        h2c = TP.copy_to_model(h2, model)
        g = TP.gather_from_model(torch.stack(
            [base2[t] + torch.matmul(op(h1c), wx),
             torch.matmul(op(h2c), w2) + bhh2], dim=1), -1, model)
        h2 = _gru_update(g[:, 0], g[:, 1], h2)
        h1s.append(h1)
        h2s.append(h2)
    return torch.stack(h1s), torch.stack(h2s)
