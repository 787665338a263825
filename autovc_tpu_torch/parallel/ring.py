"""Sequence-parallel (SP) recurrence over a local mesh: the time axis cut
into one slice per position, each position's LSTM running only its slice,
the boundary state (h, c) travelling to the next position (counterpart of
``autovc_tpu/parallel/ring.py``, whose ``ppermute`` ring this replaces).

A sharded sequence is a list of per-position tensors along the time axis,
each on its position's device.  A layer's wavefront visits the positions
in order (the reverse direction from the last): the position's slice
runs as one layer of the fused ``torch.lstm`` from the state the previous
position handed over (``(h, c).to(device)``), which is the same function
as the JAX ``lax.scan``; JAX runs it outside any Pallas kernel, so here no
kernel of the port runs either.  The bidirectional layer queues both
wavefronts at once, each on its own lane (CUDA stream) of every position:
the forward one from position 0 and the backward one from position n-1.

:func:`ring_autovc_infer` runs the whole generator time-sharded: the conv
stacks on each position's slice widened by a halo of two frames per
conv (k = 5, same padding; eval-mode BatchNorm is pointwise), so a slice's
outputs are exact; the recurrences as rings; only the small content
codes (B, T, 2 * neck) gather on the first position for the upsample.
The result equals ``autoencoder.infer`` of the same mel up to float
rounding, with every activation split n ways.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.parallel import streams as ST

Params = Dict[str, Any]


def _devices(mesh: shd.Mesh, axis_name: str) -> tuple:
    shd.check_no_tensor_parallel(mesh)
    if mesh.distributed:
        raise ValueError("the ring runs over a local mesh "
                         "(make_mesh(devices=...)), not over ranks")
    if mesh.shape.get(axis_name, 0) != mesh.size:
        raise ValueError(f"the ring needs a mesh of the one axis "
                         f"{axis_name!r}, got {mesh.shape}")
    return mesh.devices


def shard_time(x: torch.Tensor, devices, dim: int = 1) -> List[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal slices along ``dim``, each on
    its position's device."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"sequence length {x.shape[dim]} must divide the "
                         f"mesh axis size {n}")
    return [ST.hop(p, d, None, None)
            for p, d in zip(torch.chunk(x, n, dim=dim), devices)]


def gather_time(shards: Sequence[torch.Tensor], device,
                dim: int = 1) -> torch.Tensor:
    """The slices of a sharded sequence concatenated on ``device``."""
    return torch.cat([ST.hop(s, device, None, None) for s in shards],
                     dim=dim)


def _replicas(tree, devices) -> dict:
    return {d: shd.tree_to(tree, d) for d in set(devices)}


def _wavefront(params: Params, shards, devices, lanes, reverse: bool):
    """One direction of a layer over the positions in wavefront order."""
    reps = _replicas(params, devices)
    n = len(devices)
    outs, state, prev = [None] * n, None, None
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        dev, lane = devices[k], lanes[k]
        x = ST.hop(shards[k], dev, None, lane)
        if state is not None:
            state = tuple(ST.hop(t, dev, prev, lane) for t in state)
        with ST.on(lane):
            if reverse:
                y, state = R.lstm_layer(reps[dev], x.flip(1), state)
                y = y.flip(1)
            else:
                y, state = R.lstm_layer(reps[dev], x, state)
        outs[k], prev = y, lane
    return outs, state, prev


def ring_lstm_layer(params: Params, x, mesh: shd.Mesh,
                    axis_name: str = "data", reverse: bool = False):
    """An exact LSTM layer over a time-sharded sequence: ``x`` a (B, T, I)
    tensor (T divisible by the mesh size) or its list of slices.  Returns
    the output slices (B, T / n, H) and the final (h, c) on the first
    position's device (``rnn.lstm_layer``'s, for ``reverse`` that of the
    time-reversed run)."""
    devices = _devices(mesh, axis_name)
    shards = shard_time(x, devices) if torch.is_tensor(x) else list(x)
    lanes = ST.lanes(devices, {s.device for s in shards})
    outs, state, prev = _wavefront(params, shards, devices, lanes, reverse)
    state = tuple(ST.hop(t, devices[0], prev, None) for t in state)
    for d in set(devices):
        ST.join(lanes, d, [o for o in outs if o.device == d])
    return outs, state


def ring_bilstm_layer(layer: Params, x, mesh: shd.Mesh,
                      axis_name: str = "data") -> List[torch.Tensor]:
    """A bidirectional layer with both wavefronts queued at once, each on
    its own lanes: the forward from position 0, the backward from position
    n-1.  Output slices are [forward, backward] on the feature axis, as
    ``rnn.bilstm_stack([layer], x)`` gives them."""
    devices = _devices(mesh, axis_name)
    shards = shard_time(x, devices) if torch.is_tensor(x) else list(x)
    after = {s.device for s in shards}
    lanes_f = ST.lanes(devices, after)
    lanes_b = ST.lanes(devices, after)
    yf, _, _ = _wavefront(layer["fwd"], shards, devices, lanes_f, False)
    yb, _, _ = _wavefront(layer["bwd"], shards, devices, lanes_b, True)
    outs = []
    for k, dev in enumerate(devices):
        b = ST.hop(yb[k], dev, lanes_b[k], lanes_f[k])
        with ST.on(lanes_f[k]):
            outs.append(torch.cat([yf[k], b], dim=-1))
    for d in set(devices):
        ST.join(lanes_f, d, [o for o in outs if o.device == d])
    return outs


def ring_bilstm_stack(params: Sequence[Params], x, mesh: shd.Mesh,
                      axis_name: str = "data") -> List[torch.Tensor]:
    """A multi-layer time-sharded BLSTM (the encoder's recurrence)."""
    for layer in params:
        x = ring_bilstm_layer(layer, x, mesh, axis_name)
    return x


def ring_lstm_stack(params: Sequence[Params], x, mesh: shd.Mesh,
                    axis_name: str = "data") -> List[torch.Tensor]:
    """A multi-layer unidirectional time-sharded LSTM (the decoder's)."""
    for layer in params:
        x, _ = ring_lstm_layer(layer, x, mesh, axis_name)
    return x


def _window(shards, k: int, halo: int, device) -> tuple:
    """Position k's slice of a channel-first sharded sequence (B, C, T/n)
    widened by up to ``halo`` frames of its neighbours on each side, on
    ``device``; and the frames taken on the left."""
    n, t = len(shards), shards[0].shape[-1]
    lo, hi = max(0, k * t - halo), min(n * t, (k + 1) * t + halo)
    parts = []
    for j in range(lo // t, (hi - 1) // t + 1):
        a, b = max(lo, j * t) - j * t, min(hi, (j + 1) * t) - j * t
        parts.append(ST.hop(shards[j][..., a:b], device, None, None))
    return torch.cat(parts, dim=-1), k * t - lo


def _conv_stack(convs, shards, devices, mode: str, activations):
    """A stack of eval-mode conv(5) + BatchNorm layers over channel-first
    slices: each position runs its slice and a halo of two frames per
    layer, then keeps its own frames."""
    halo = 2 * len(convs)
    reps = _replicas(convs, devices)
    t = shards[0].shape[-1]
    outs = []
    for k, dev in enumerate(devices):
        h, left = _window(shards, k, halo, dev)
        for p, act in zip(reps[dev], activations):
            h = C.conv_bn(p, h, 5, activation=act, mode=mode)
        outs.append(h[..., left:left + t])
    return outs


def ring_autovc_infer(params: Params, x: torch.Tensor, c_org: torch.Tensor,
                      c_trg: torch.Tensor, cfg, mesh: shd.Mesh,
                      axis_name: str = "data",
                      precision: str = "f32") -> torch.Tensor:
    """Exact sequence-parallel AutoVC conversion of the unchunked mel
    ``x`` (B, n_mels, T), T divisible by the mesh size (else
    ``ValueError``): the postnet mel (B, n_mels, T) on the first
    position's device.  The recurrences run in f32 (the fused LSTM), as
    the JAX ring's scans do; ``precision`` is the convs' and the
    projection's policy."""
    from autovc_tpu_torch.models import autoencoder as AE

    devices = _devices(mesh, axis_name)
    n = len(devices)
    B, n_mels, T = x.shape
    if T % n:
        raise ValueError(
            f"ring SP needs the mel frame count ({T}) divisible by the "
            f"mesh axis size ({n}); pad or trim the input")
    mode = PREC.resolve(precision, devices[0])
    out_dev = devices[0]
    relu, tanh = torch.relu, torch.tanh
    with torch.no_grad():
        enc, dec = params["encoder"], params["decoder"]
        h = torch.cat([x, c_org[:, :, None].expand(*c_org.shape, T)], dim=1)
        h = _conv_stack(enc["convs"], shard_time(h, devices, 2), devices,
                        mode, [relu] * len(enc["convs"]))
        out = ring_bilstm_stack(enc["blstm"],
                                [s.transpose(1, 2) for s in h], mesh,
                                axis_name)
        # the content codes are small: upsample them on the first position
        out = gather_time(out, out_dev)
        neck = cfg.dim_neck
        up = AE.upsample_codes(out[:, cfg.freq - 1::cfg.freq, :neck],
                               out[:, ::cfg.freq, neck:], cfg.freq, T)
        c_trg = c_trg.to(out_dev)
        dec_in = torch.cat([up, c_trg[:, None, :].expand(B, T, -1)], dim=-1)
        h = ring_lstm_stack(dec["lstm1"], shard_time(dec_in, devices),
                            mesh, axis_name)
        h = _conv_stack(dec["convs"], [s.transpose(1, 2) for s in h],
                        devices, mode, [relu] * len(dec["convs"]))
        h = ring_lstm_stack(dec["lstm2"], [s.transpose(1, 2) for s in h],
                            mesh, axis_name)
        proj = _replicas(dec["proj"], devices)
        mel_dec = [C.linear(proj[d], s, mode).transpose(1, 2)
                   for s, d in zip(h, devices)]
        post = params["postnet"]["convs"]
        r = _conv_stack(post, mel_dec, devices, mode,
                        [tanh] * (len(post) - 1) + [None])
        return gather_time([a + b for a, b in zip(mel_dec, r)], out_dev,
                           dim=2)
