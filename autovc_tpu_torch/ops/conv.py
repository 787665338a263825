"""1-D convolution, batch-norm and linear blocks (counterpart of
``autovc_tpu/ops/conv.py``).

Layouts are the JAX package's: tensors (B, C, T), conv weights (O, I, K),
linear weights (out, in).  Initialisers draw from an explicit
``torch.Generator`` with the JAX package's distributions and shapes
(Xavier-uniform weights, PyTorch-default uniform biases).

Train-mode batch-norm normalises with the batch statistics and updates the
running statistics IN PLACE (under ``no_grad``), where the JAX function
returns them in a new tree: callers thread nothing, and a sequence of
train-mode calls updates them in the JAX package's order.

Tensor parallelism: with ``model=`` (a ``parallel.tensor.ModelAxis``)
:func:`conv1d` and :func:`linear` are column-parallel where their weight
is one of this rank's shards (the rule table's block of the output
channels or features, bias likewise): the input goes through
``copy_to_model`` and the output is all-gathered over the model group, so
every rank returns the whole output.  A weight the rule table leaves
whole takes the plain product.  :func:`conv_bn` gathers the channels
before its BatchNorm, whose scale and shift stay whole.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.parallel import tensor as TP

Params = Dict[str, Any]

_GAINS = {
    "linear": 1.0,
    "relu": math.sqrt(2.0),
    "tanh": 5.0 / 3.0,
    "sigmoid": 1.0,
}


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 on the CPU from ``gen``."""
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0):
    """Xavier/Glorot uniform; for conv weights (O, I, K): fan_in = I*K."""
    if len(shape) == 3:
        fan_out, fan_in = shape[0] * shape[2], shape[1] * shape[2]
    else:
        fan_out, fan_in = shape
    return uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def init_conv1d(gen, in_channels: int, out_channels: int, kernel_size: int,
                bias: bool = True, w_init_gain: str = "linear") -> Params:
    p = {"w": xavier_uniform(gen, (out_channels, in_channels, kernel_size),
                             _GAINS[w_init_gain])}
    if bias:
        p["b"] = uniform(gen, (out_channels,),
                         1.0 / math.sqrt(in_channels * kernel_size))
    return p


def init_linear(gen, in_dim: int, out_dim: int, bias: bool = True,
                w_init_gain: str = "linear") -> Params:
    p = {"w": xavier_uniform(gen, (out_dim, in_dim), _GAINS[w_init_gain])}
    if bias:
        p["b"] = uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def init_batchnorm(num_features: int) -> Params:
    return {
        "scale": torch.ones(num_features),
        "bias": torch.zeros(num_features),
        "mean": torch.zeros(num_features),
        "var": torch.ones(num_features),
    }


def init_conv_bn(gen, in_channels: int, out_channels: int, kernel_size: int,
                 w_init_gain: str = "linear") -> Params:
    return {
        "conv": init_conv1d(gen, in_channels, out_channels, kernel_size,
                            w_init_gain=w_init_gain),
        "bn": init_batchnorm(out_channels),
    }


def conv1d(params: Params, x: torch.Tensor, padding: int = 0,
           mode: str = "f32", model=None) -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, T').  Under bf16 the output is rounded to
    bf16 before the bias, as the JAX bf16 conv's bf16 output is
    (``precision.conv_output``).  ``model``: column-parallel over the
    output channels (module docstring)."""
    model = TP.of(model, params["w"])
    x, w = PREC.operands(mode, TP.copy_to_model(x, model), params["w"])
    out = F.conv1d(x, w, padding=padding)
    if mode == "bf16":
        out = PREC.round_bf16(out)
    if "b" in params:
        out = out + params["b"][None, :, None]
    return TP.gather_from_model(out, 1, model)


def linear(params: Params, x: torch.Tensor, mode: str = "f32", model=None):
    """``x @ w.T + b``; ``model``: column-parallel over the output
    features (module docstring)."""
    model = TP.of(model, params["w"])
    out = PREC.dot(TP.copy_to_model(x, model), params["w"].T, mode)
    if "b" in params:
        out = out + params["b"]
    return TP.gather_from_model(out, -1, model)


def batchnorm1d(params: Params, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1, eps: float = 1e-5, group=None):
    """BatchNorm over (B, C, T), statistics over (B, T).

    Eval mode normalises with the running statistics.  Train mode
    normalises with the batch's (biased variance) and moves the running
    statistics in place: ``new = (1 - momentum) * old + momentum * batch``
    with the UNBIASED batch variance, as ``nn.BatchNorm1d`` and the JAX
    function do.

    ``group`` (a process group; the JAX function's ``axis_name``) makes
    train mode sync BatchNorm: the per-channel sum, sum of squares and
    element count are summed over the group's ranks in one differentiable
    all-reduce, so every rank normalises with, and moves its running
    statistics by, the statistics of the global batch."""
    if train:
        if group is None:
            mean = torch.mean(x, dim=(0, 2))
            var = torch.mean(x * x, dim=(0, 2)) - mean * mean
            n = x.shape[0] * x.shape[2]
            unbiased = var * (n / max(n - 1, 1))
        else:
            from autovc_tpu_torch.parallel import collectives as COL
            C = x.shape[1]
            stats = COL.all_reduce_sum(torch.cat([
                torch.sum(x, dim=(0, 2)), torch.sum(x * x, dim=(0, 2)),
                x.new_full((1,), float(x.shape[0] * x.shape[2]))]), group)
            n = stats[2 * C]
            mean = stats[:C] / n
            var = stats[C:2 * C] / n - mean * mean
            unbiased = var * (n / torch.clamp(n - 1, min=1.0))
        with torch.no_grad():
            params["mean"].mul_(1 - momentum).add_(momentum * mean)
            params["var"].mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = params["mean"], params["var"]
    inv = torch.rsqrt(var + eps) * params["scale"]
    return ((x - mean[None, :, None]) * inv[None, :, None]
            + params["bias"][None, :, None])


def conv_bn(params: Params, x: torch.Tensor, kernel_size: int,
            activation=None, mode: str = "f32",
            train: bool = False, group=None, model=None) -> torch.Tensor:
    """conv(k, same-pad) -> BN (``train``: batch statistics, running
    statistics updated in place; ``group``: over the group's global batch)
    -> optional activation.  ``model``: as for :func:`conv1d`."""
    out = conv1d(params["conv"], x, padding=(kernel_size - 1) // 2,
                 mode=mode, model=model)
    out = batchnorm1d(params["bn"], out, train, group=group)
    return activation(out) if activation is not None else out
