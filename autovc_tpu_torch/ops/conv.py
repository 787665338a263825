"""1-D convolution, eval-mode batch-norm and linear blocks
(counterpart of ``autovc_tpu/ops/conv.py``).

Layouts are the JAX package's: tensors (B, C, T), conv weights (O, I, K),
linear weights (out, in).  Initialisers draw from an explicit
``torch.Generator`` with the JAX package's distributions and shapes
(Xavier-uniform weights, PyTorch-default uniform biases).
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
    """(B, C_in, T) -> (B, C_out, T')."""
    x, w = PREC.operands(mode, x, params["w"])
    out = F.conv1d(x, w, padding=padding)
    if "b" in params:
        out = out + params["b"][None, :, None]
    return out


def linear(params: Params, x: torch.Tensor, mode: str = "f32"):
    out = PREC.dot(x, params["w"].T, mode)
    if "b" in params:
        out = out + params["b"]
    return out


def batchnorm1d(params: Params, x: torch.Tensor, eps: float = 1e-5):
    """Eval-mode BatchNorm over (B, C, T) with the running statistics."""
    inv = torch.rsqrt(params["var"] + eps) * params["scale"]
    return ((x - params["mean"][None, :, None]) * inv[None, :, None]
            + params["bias"][None, :, None])


def conv_bn(params: Params, x: torch.Tensor, kernel_size: int,
            activation=None, mode: str = "f32") -> torch.Tensor:
    """conv(k, same-pad) -> BN -> optional activation."""
    out = conv1d(params["conv"], x, padding=(kernel_size - 1) // 2,
                 mode=mode)
    out = batchnorm1d(params["bn"], out)
    return activation(out) if activation is not None else out
