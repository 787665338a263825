"""Weights made from the seed: each reference model's state, drawn on the
device in one call, and the same numbers laid out as the program's
parameter trees.  The benchmark hands one copy to each side; both are
made again from the seed when the reference runs."""
from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def _ranges(model: torch.nn.Module) -> dict:
    """The range each state entry is drawn from: BatchNorm scales and
    variances in [0.5, 1.5), its shifts and means in [-0.1, 0.1); the
    upsample smoothing taps within 10% of 1 / (2s + 1); recurrent entries
    +-1/sqrt(hidden); other weights and biases +-1/sqrt(fan_in)."""
    out = {}
    for prefix, m in model.named_modules():
        local = dict(m.named_parameters(recurse=False))
        local.update(m.named_buffers(recurse=False))
        for leaf, v in local.items():
            name = f"{prefix}.{leaf}" if prefix else leaf
            if not v.is_floating_point():
                continue
            if isinstance(m, torch.nn.BatchNorm1d):
                r = ((0.5, 1.5) if leaf in ("weight", "running_var")
                     else (-0.1, 0.1))
            elif isinstance(m, torch.nn.Conv2d):
                w = 1.0 / v.shape[-1]
                r = (0.9 * w, 1.1 * w)
            elif isinstance(m, (torch.nn.LSTM, torch.nn.GRU)):
                b = 1.0 / math.sqrt(m.hidden_size)
                r = (-b, b)
            else:
                w = local["weight"]
                b = 1.0 / math.sqrt(max(int(np.prod(w.shape[1:])), 1))
                r = (-b, b)
            out[name] = r
    return out


def make_state(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict of ``model`` (built on the meta device) drawn from
    ``seed`` on ``device``: one ``torch.rand`` over every entry, then each
    entry's slice mapped to its range (:func:`_ranges`)."""
    ranges = _ranges(model)
    entries = [(k, v) for k, v in model.state_dict().items()
               if v.is_floating_point()]
    total = sum(v.numel() for _, v in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    state, o = {}, 0
    for name, v in entries:
        lo, hi = ranges[name]
        n = v.numel()
        state[name] = (u[o:o + n] * (hi - lo) + lo).reshape(v.shape)
        o += n
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return state


def _take(state: dict, key: str, names, transpose: bool = False):
    """``state[key]`` (transposed when the program keeps it (in, out));
    ``names``, when given, records key -> the program's tensor."""
    t = state[key].T.contiguous() if transpose else state[key]
    if names is not None:
        names[key] = t
    return t


def _lstm(state, prefix, layers, names, suffix="") -> list:
    return [{"w_ih": _take(state, f"{prefix}.weight_ih_l{l}{suffix}", names,
                           True),
             "w_hh": _take(state, f"{prefix}.weight_hh_l{l}{suffix}", names,
                           True),
             "b_ih": _take(state, f"{prefix}.bias_ih_l{l}{suffix}", names),
             "b_hh": _take(state, f"{prefix}.bias_hh_l{l}{suffix}", names)}
            for l in range(layers)]


def _bn(state, p, names) -> dict:
    return {"scale": _take(state, f"{p}.weight", names),
            "bias": _take(state, f"{p}.bias", names),
            "mean": _take(state, f"{p}.running_mean", names),
            "var": _take(state, f"{p}.running_var", names)}


def _conv_bn(state, p, names) -> dict:
    return {"conv": {"w": _take(state, f"{p}.0.weight", names),
                     "b": _take(state, f"{p}.0.bias", names)},
            "bn": _bn(state, f"{p}.1", names)}


def _linear(state, p, names) -> dict:
    return {"w": _take(state, f"{p}.weight", names),
            "b": _take(state, f"{p}.bias", names)}


def speaker_encoder_tree(state: dict, layers: int, names=None) -> dict:
    dev = state["linear.weight"].device
    return {"lstm": _lstm(state, "lstm", layers, names),
            "linear": _linear(state, "linear", names),
            "similarity_weight": torch.tensor(10.0, device=dev),
            "similarity_bias": torch.tensor(-5.0, device=dev)}


def generator_tree(state: dict, names=None) -> dict:
    """The AutoVC generator's tree; ``names`` as for :func:`_take`."""
    enc = "encoder.lstm"
    return {
        "encoder": {
            "convs": [_conv_bn(state, f"encoder.convolutions.{i}", names)
                      for i in range(3)],
            "blstm": [{"fwd": f, "bwd": b} for f, b in zip(
                _lstm(state, enc, 2, names),
                _lstm(state, enc, 2, names, "_reverse"))]},
        "decoder": {
            "lstm1": _lstm(state, "decoder.lstm1", 1, names),
            "convs": [_conv_bn(state, f"decoder.convolutions.{i}", names)
                      for i in range(3)],
            "lstm2": _lstm(state, "decoder.lstm2", 2, names),
            "proj": _linear(state, "decoder.linear_projection", names)},
        "postnet": {"convs": [_conv_bn(state, f"postnet.convolutions.{i}",
                                       names) for i in range(5)]},
    }


def vocoder_tree(state: dict, res_blocks: int, n_up: int,
                 names=None) -> dict:
    r = "upsample.resnet"

    def w(key):
        return {"w": _take(state, key, names)}

    return {
        "upsample": {
            "resnet": {
                "conv_in": w(f"{r}.conv_in.weight"),
                "bn_in": _bn(state, f"{r}.batch_norm", names),
                "blocks": [{"conv1": w(f"{r}.layers.{i}.conv1.weight"),
                            "bn1": _bn(state, f"{r}.layers.{i}.batch_norm1",
                                       names),
                            "conv2": w(f"{r}.layers.{i}.conv2.weight"),
                            "bn2": _bn(state, f"{r}.layers.{i}.batch_norm2",
                                       names)}
                           for i in range(res_blocks)],
                "conv_out": _linear(state, f"{r}.conv_out", names)},
            "up_convs": [_take(state, f"upsample.up_layers.{i}.weight", names)
                         for i in range(n_up)]},
        "I": _linear(state, "I", names),
        "rnn1": _lstm(state, "rnn1", 1, names)[0],
        "rnn2": _lstm(state, "rnn2", 1, names)[0],
        "fc1": _linear(state, "fc1", names),
        "fc2": _linear(state, "fc2", names),
        "fc3": _linear(state, "fc3", names),
    }
