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
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from autovc_tpu_torch.ops import precision as PREC

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
           mode: str = "f32") -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, T').  Under bf16 the output is rounded to
    bf16 before the bias, as the JAX bf16 conv's bf16 output is
    (``precision.conv_output``)."""
    x, w = PREC.operands(mode, x, params["w"])
    out = F.conv1d(x, w, padding=padding)
    if mode == "bf16":
        out = PREC.round_bf16(out)
    if "b" in params:
        out = out + params["b"][None, :, None]
    return out


def linear(params: Params, x: torch.Tensor, mode: str = "f32"):
    out = PREC.dot(x, params["w"].T, mode)
    if "b" in params:
        out = out + params["b"]
    return out


def batchnorm1d(params: Params, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over (B, C, T), statistics over (B, T).

    Eval mode normalises with the running statistics.  Train mode
    normalises with the batch's (biased variance) and moves the running
    statistics in place: ``new = (1 - momentum) * old + momentum * batch``
    with the UNBIASED batch variance, as ``nn.BatchNorm1d`` and the JAX
    function do."""
    if train:
        mean = torch.mean(x, dim=(0, 2))
        var = torch.mean(x * x, dim=(0, 2)) - mean * mean
        n = x.shape[0] * x.shape[2]
        with torch.no_grad():
            params["mean"].mul_(1 - momentum).add_(momentum * mean)
            params["var"].mul_(1 - momentum).add_(
                momentum * (var * (n / max(n - 1, 1))))
    else:
        mean, var = params["mean"], params["var"]
    inv = torch.rsqrt(var + eps) * params["scale"]
    return ((x - mean[None, :, None]) * inv[None, :, None]
            + params["bias"][None, :, None])


def conv_bn(params: Params, x: torch.Tensor, kernel_size: int,
            activation=None, mode: str = "f32",
            train: bool = False) -> torch.Tensor:
    """conv(k, same-pad) -> BN (``train``: batch statistics, running
    statistics updated in place) -> optional activation."""
    out = conv1d(params["conv"], x, padding=(kernel_size - 1) // 2,
                 mode=mode)
    out = batchnorm1d(params["bn"], out, train)
    return activation(out) if activation is not None else out
