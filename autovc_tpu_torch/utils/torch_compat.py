"""Reference PyTorch checkpoints -> the parameter tree (counterpart of
``autovc_tpu/utils/torch_compat.py``).

The reference ships three checkpoint formats:
  * AutoEncoder: ``{"step", "model_state", "optimizer_state"}``
    (auto_encoder/model.py:171-176)
  * SpeakerEncoder: ``{"step", "model_state", "speakers"}``
    (speaker_encoder/model.py:106-114)
  * WaveRNN: bare ``state_dict`` (wavernn/model.py:478-482)

This module maps those tensors onto the JAX package's parameter layout, as
numpy float32 arrays, so that :func:`autovc_tpu_torch.utils.bridge.
from_jax_params` puts them on the device as it does a ``.ckpt``'s.  Layout:
  * ``nn.LSTM`` / ``nn.GRU`` keep gate order (i,f,g,o) / (r,z,n), the
    order the parameter tree uses, but store ``weight_ih_l{k}`` as (4H, I);
    the tree stores (I, 4H), so conversion is a transpose;
  * bidirectional LSTMs add ``_reverse``-suffixed tensors per layer;
  * conv weights share the (O, I, K) layout: a straight copy;
  * batch norms carry their running statistics as ``mean`` / ``var``.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def lstm_layer_from_torch(sd, prefix: str, layer: int, reverse: bool = False):
    suf = f"_l{layer}" + ("_reverse" if reverse else "")
    return {
        "w_ih": _np(sd[_key(prefix, f"weight_ih{suf}")]).T,
        "w_hh": _np(sd[_key(prefix, f"weight_hh{suf}")]).T,
        "b_ih": _np(sd[_key(prefix, f"bias_ih{suf}")]),
        "b_hh": _np(sd[_key(prefix, f"bias_hh{suf}")]),
    }


gru_layer_from_torch = lstm_layer_from_torch  # identical tensor layout


def lstm_stack_from_torch(sd, prefix: str, num_layers: int):
    return [lstm_layer_from_torch(sd, prefix, i) for i in range(num_layers)]


def bilstm_stack_from_torch(sd, prefix: str, num_layers: int):
    return [{"fwd": lstm_layer_from_torch(sd, prefix, i),
             "bwd": lstm_layer_from_torch(sd, prefix, i, reverse=True)}
            for i in range(num_layers)]


def linear_from_torch(sd, prefix: str):
    p = {"w": _np(sd[_key(prefix, "weight")])}
    if _key(prefix, "bias") in sd:
        p["b"] = _np(sd[_key(prefix, "bias")])
    return p


conv1d_from_torch = linear_from_torch  # weight and optional bias, as is


def batchnorm_from_torch(sd, prefix: str):
    return {
        "scale": _np(sd[_key(prefix, "weight")]),
        "bias": _np(sd[_key(prefix, "bias")]),
        "mean": _np(sd[_key(prefix, "running_mean")]),
        "var": _np(sd[_key(prefix, "running_var")]),
    }


def conv_bn_from_torch(sd, conv_prefix: str, bn_prefix: str):
    return {"conv": conv1d_from_torch(sd, conv_prefix),
            "bn": batchnorm_from_torch(sd, bn_prefix)}


def autoencoder_from_torch(sd):
    """Reference AutoEncoder ``model_state`` -> parameter tree.

    Module names follow auto_encoder/{encoder,decoder,postnet}.py:
    ``encoder.convolutions.{i}.0.conv`` / ``.1`` (ConvNorm + BatchNorm1d),
    ``encoder.lstm`` (2-layer BLSTM), ``decoder.lstm1/lstm2``,
    ``decoder.linear_projection.linear_layer``, ``postnet.convolutions.*``.
    """
    enc = {
        "convs": [conv_bn_from_torch(sd, f"encoder.convolutions.{i}.0.conv",
                                     f"encoder.convolutions.{i}.1")
                  for i in range(3)],
        "blstm": bilstm_stack_from_torch(sd, "encoder.lstm", 2),
    }
    dec = {
        "lstm1": lstm_stack_from_torch(sd, "decoder.lstm1", 1),
        "convs": [conv_bn_from_torch(sd, f"decoder.convolutions.{i}.0.conv",
                                     f"decoder.convolutions.{i}.1")
                  for i in range(3)],
        "lstm2": lstm_stack_from_torch(sd, "decoder.lstm2", 2),
        "proj": linear_from_torch(sd, "decoder.linear_projection.linear_layer"),
    }
    post = {
        "convs": [conv_bn_from_torch(sd, f"postnet.convolutions.{i}.0.conv",
                                     f"postnet.convolutions.{i}.1")
                  for i in range(5)],
    }
    return {"encoder": enc, "decoder": dec, "postnet": post}


def speaker_encoder_from_torch(sd, num_layers: int = 3):
    """Reference SpeakerEncoder ``model_state`` -> parameter tree.  The
    GE2E scaling parameters are not registered on the reference module
    (speaker_encoder/model.py:339-340), so they take the fixed initial
    values w=10, b=-5 when absent."""
    return {
        "lstm": lstm_stack_from_torch(sd, "lstm", num_layers),
        "linear": linear_from_torch(sd, "linear"),
        "similarity_weight": _np(sd.get("similarity_weight", 10.0)).reshape(()),
        "similarity_bias": _np(sd.get("similarity_bias", -5.0)).reshape(()),
    }


def wavernn_from_torch(sd, res_blocks: int = 10, n_up_layers: int = 3):
    """Reference WaveRNN ``state_dict`` -> parameter tree
    (wavernn/model.py:16-173).  The upsample ModuleList interleaves
    [stretch, conv], so the learned smoothing convs sit at odd indices."""
    resnet = {
        "conv_in": conv1d_from_torch(sd, "upsample.resnet.conv_in"),
        "bn_in": batchnorm_from_torch(sd, "upsample.resnet.batch_norm"),
        "blocks": [
            {"conv1": conv1d_from_torch(sd, f"upsample.resnet.layers.{i}.conv1"),
             "bn1": batchnorm_from_torch(
                 sd, f"upsample.resnet.layers.{i}.batch_norm1"),
             "conv2": conv1d_from_torch(sd, f"upsample.resnet.layers.{i}.conv2"),
             "bn2": batchnorm_from_torch(
                 sd, f"upsample.resnet.layers.{i}.batch_norm2")}
            for i in range(res_blocks)],
        "conv_out": conv1d_from_torch(sd, "upsample.resnet.conv_out"),
    }
    up_convs = [_np(sd[f"upsample.up_layers.{2 * i + 1}.weight"])
                for i in range(n_up_layers)]
    return {
        "upsample": {"resnet": resnet, "up_convs": up_convs},
        "I": linear_from_torch(sd, "I"),
        "rnn1": gru_layer_from_torch(sd, "rnn1", 0),
        "rnn2": gru_layer_from_torch(sd, "rnn2", 0),
        "fc1": linear_from_torch(sd, "fc1"),
        "fc2": linear_from_torch(sd, "fc2"),
        "fc3": linear_from_torch(sd, "fc3"),
    }


def load_reference_checkpoint(path: str, model_type: str):
    """Load a reference ``.pt`` / ``.pyt`` file and convert it.

    Returns (parameter tree of numpy arrays, extras): extras carry ``step``
    and, for the speaker encoder, the embedded ``speakers`` registry
    (speaker_encoder/model.py:106-114).  The file is unpickled
    (``weights_only=False``, as the reference's ``torch.load``): load only
    files from a source you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if model_type == "vocoder":
        return wavernn_from_torch(ckpt), {}
    sd = ckpt["model_state"]
    extras = {"step": ckpt.get("step")}
    if model_type == "auto_encoder":
        return autoencoder_from_torch(sd), extras
    if model_type == "speaker_encoder":
        extras["speakers"] = {k: _np(v) for k, v in
                              ckpt.get("speakers", {}).items()}
        return speaker_encoder_from_torch(sd), extras
    raise ValueError(f"unknown model_type {model_type!r}")
