"""The device trace of a run's window (``torch.profiler``) reduced to what
the per-layer readers and the result's breakdown read: the union of the
device's kernel, copy and set intervals, each device operation's time,
and the idle gaps labelled by the innermost host range open at the gap.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    ops: dict = field(default_factory=dict)        # name -> device seconds
    gaps: dict = field(default_factory=dict)       # host label -> seconds

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the operations whose names hold any of
        ``parts``."""
        return sum(s for n, s in self.ops.items()
                   if any(p in n for p in parts))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def union(spans) -> list:
    """Merged [start, end) intervals of ``spans``, sorted."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_gaps(busy: list, start: float, end: float) -> list:
    """The [start, end) stretches of the window with no device work."""
    out, t = [], start
    for lo, hi in busy:
        if lo > t:
            out.append((t, min(lo, end)))
        t = max(t, hi)
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


SHORT_GAP_US = 20.0


def label_gaps(gaps: list, ranges: list) -> dict:
    """Idle seconds by the innermost host range (name, start, end) open at
    each gap's midpoint ("host" where none is); gaps under
    ``SHORT_GAP_US`` are summed under one label of their own."""
    import bisect
    out = {}
    ranges = sorted(ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            label = f"(gaps under {SHORT_GAP_US:g} us)"
        else:
            mid = 0.5 * (a + b)
            label = "host"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if ranges[i][2] >= mid:
                    label = ranges[i][0]
                    break
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


@contextlib.contextmanager
def traced(on: bool):
    """Profile the body when ``on``; yields a holder whose ``prof`` is the
    profiler (None when off)."""
    holder = type("Holder", (), {"prof": None})()
    if not on:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        holder.prof = prof
        yield holder


def profiler():
    """A started profiler of the host and the device, for a caller that
    stops it itself (``prof.stop()``)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def reduce(prof, window_s: float) -> Trace:
    """A :class:`Trace` of a finished profile over a window of
    ``window_s`` host seconds."""
    dev, ranges = [], []
    ops = {}
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            dev.append((lo, hi))
            ops[e.name] = ops.get(e.name, 0.0) + (hi - lo) / 1e6
        elif e.name.startswith(("convert/", "bench/")):
            ranges.append((e.name, lo, hi))
    busy = union(dev)
    tr = Trace(window_s=window_s, ops=ops,
               busy_s=sum(b - a for a, b in busy) / 1e6)
    if busy:
        start = min([a for _, a, _ in ranges] + [busy[0][0]])
        end = max([b for _, _, b in ranges] + [busy[-1][1]])
        tr.gaps = label_gaps(idle_gaps(busy, start, end), ranges)
    return tr
