"""Streams and handoffs of the serving paths over a local mesh
(``chunk_sharded_convert``, the ring, the stage pipeline).

Each card of a mesh computes on a CUDA stream of its own (a "lane"), so
positions on several cards run concurrently, and positions that repeat a
card share its lane and run in order: the port's inference kernels 1-3 are
persistent grids of up to one block per SM, and two of them on one card
must not be resident at once.  Data moves between positions with
``tensor.to(device, non_blocking=True)`` after the receiving lane waits
for the sending one.  On the CPU every lane is ``None`` and everything
runs in order.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Sequence

import torch


def _current(device: torch.device):
    return torch.cuda.current_stream(device)


def lanes(devices: Sequence[torch.device],
          after: Iterable[torch.device] = ()) -> List:
    """The lane of each position of ``devices``: one new CUDA stream per
    distinct card, shared by the positions on it (``None`` for a CPU
    position), each waiting for the work queued so far on the current
    stream of its own device and of every CUDA device in ``after``."""
    after = [d for d in after if d.type == "cuda"]
    made, out = {}, []
    for d in devices:
        if d.type != "cuda":
            out.append(None)
            continue
        key = d.index if d.index is not None else torch.cuda.current_device()
        if key not in made:
            s = made[key] = torch.cuda.Stream(d)
            for src in {d, *after}:
                s.wait_stream(_current(src))
        out.append(made[key])
    return out


def on(stream):
    """Queue the block's CUDA work on ``stream`` (a no-op for ``None``)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def hop(t: torch.Tensor, device: torch.device, src, dst) -> torch.Tensor:
    """``t``, made on lane ``src`` (None: its device's current stream),
    for work on lane ``dst`` of ``device``: ``dst`` waits for ``src``,
    then the copy (if any) is queued there."""
    if t.device.type == "cuda":
        src = src if src is not None else _current(t.device)
        if t.device != device:
            _current(t.device).wait_stream(src)
            t.record_stream(_current(t.device))
        if dst is not None and dst is not src:
            dst.wait_stream(src)
    if device.type != "cuda":
        return t.to(device)
    with on(dst):
        out = t.to(device, non_blocking=True)
    if out is t and dst is not None:
        t.record_stream(dst)
    return out


def join(streams: Iterable, device: torch.device,
         tensors: Iterable[torch.Tensor] = ()) -> None:
    """The current stream of ``device`` waits for every lane in
    ``streams``; ``tensors`` made on those lanes are marked as used there,
    so that the allocator does not hand their memory out too early."""
    if device.type != "cuda":
        return
    cur = _current(device)
    for s in streams:
        if s is not None:
            cur.wait_stream(s)
    for t in tensors:
        if t.device == cur.device:
            t.record_stream(cur)
