"""Profiling hooks (counterpart of ``autovc_tpu/utils/profiling.py``) and
the program's span and counter recorder.

``trace`` captures a ``torch.profiler`` trace (the host's operators and,
where CUDA is present, the card's kernels and copies) and writes it as a
Chrome trace, viewable in Perfetto or ``chrome://tracing``; the program's
spans are ranges in it.  ``sync`` waits for the devices of a tree's
tensors.

Spans and counters.  ``span(name, parent=None)`` marks a stretch of the
program, ``count(name, n)`` adds ``n`` to a counter, ``call()`` gives the
spans opened inside it one call identifier (one ``convert`` or
``convert_batch`` call, one training step), and ``recording()`` turns
recording on for its body and yields the :class:`Record`: the spans, kept
in memory, and the counters' sums.  A running ``torch.profiler`` turns
recording on too: the first span, count or call under it opens a record
of the profiler's stretch, which ``profiled()`` returns until the next
profiler's stretch opens one (a stretch ends at the first span, count or
call after its profiler stopped; two profilers with none between share
one record).  A span's parent is the span open on the same thread when it
opens; a span on a pool worker names its parent.  On a thread that a
profiler records, a span also opens a ``torch.profiler.record_function``
range of its name, so the range sits in the device trace beside the
kernels it launched.  With recording off and no profiler, ``span``,
``count`` and ``call`` test two flags and return.  The recorder is one
per process, as the profiler is: spans from every thread land in the one
active record.

One clock.  Host stamps are ``time.time_ns()``, the Unix clock in ns that
``torch.profiler`` stamps its host events with (an event of
``prof.events()`` is at ``trace_start_ns()`` plus its ``time_range`` in
us); under a profiler a span's host entry and exit are the middles of the
stamps taken around its range's entry and exit, where the range stamps
itself.  On a CUDA device a span also records a ``torch.cuda.Event`` on
the current stream at entry and one at exit, and nothing waits for them.
The offset rule puts those on the host's clock by one anchor: a record,
when it opens, synchronises the device once (the recorder's only
synchronise), records an anchor event A on the idle device and polls it:
the device reached A after the later of the record's return and the host
stamp taken before the last poll that found it pending, and before the
stamp taken after the poll that found it done; A is put at the middle of
those two stamps (some us apart on an H100).  An event E then reads A's time plus A.elapsed_time(E);
``elapsed_time`` is a float32 count of ms, so an event a minute after the
anchor reads to ~4 us.  The events are read when the record is read,
after the work has completed.

A span's critical-path time runs from the later of its host entry and the
device reaching its entry event to the later of its host exit and the
device reaching its exit event: consecutive spans of one chain tile the
chain's wall without overlap and without a synchronise; with no device
events it is the host wall.  Its self time is its critical-path time less
the part of that interval that its children's intervals cover.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

from autovc_tpu_torch.utils import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str = "logs/profile"):
    """Capture a trace: ``with profiling.trace(d): step(...)`` writes
    ``d/trace_<pid>_<ns>.json`` when the block ends (also when it
    raises); the profiler turns recording on, so the program's spans are
    ranges in the trace and ``profiled()`` their record.  Yields
    ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def sync(tree):
    """Wait until every CUDA device holding a tensor of ``tree`` (a tensor
    or a tree of dicts and lists) has finished its queued work; returns
    ``tree``."""
    for dev in {t.device for t in tree_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Span:
    """One recorded span: host stamps ``t0`` / ``t1`` and, once read,
    device stamps ``d0`` / ``d1`` (ns on the host's clock; None without
    device events); ``t1`` is None while it is open."""
    name: str
    parent: "Span | None" = None
    call: int | None = None
    t0: int = 0
    t1: int | None = None
    d0: float | None = None
    d1: float | None = None
    events: tuple | None = None


class Record:
    """What one ``recording()`` kept: ``spans`` in the order they opened
    and ``counters``, name -> sum."""

    def __init__(self, profiled: bool = False):
        self.spans: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()
        self.calls = itertools.count()
        self.profiled = profiled            # a profiler's stretch
        self.device: int | None = None      # the anchored CUDA device
        self.anchor = None
        self.anchor_ns = 0

    def anchor_device(self) -> None:
        """On a CUDA process, synchronise the current device once and put
        the anchor event on the host's clock (module docstring)."""
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        self.device = torch.cuda.current_device()
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record()            # made now: the first record is slow
        torch.cuda.synchronize(self.device)
        self.anchor.record()
        pending = time.time_ns()
        while True:
            now = time.time_ns()
            if self.anchor.query():
                break
            pending = now
        self.anchor_ns = (pending + time.time_ns()) // 2

    def _read_device(self, s: Span) -> None:
        if s.events is None:
            return
        e0, e1 = s.events
        e1.synchronize()
        s.d0 = self.anchor_ns + 1e6 * self.anchor.elapsed_time(e0)
        s.d1 = s.d0 + 1e6 * e0.elapsed_time(e1)
        s.events = None

    def interval(self, s: Span) -> tuple:
        """The critical-path interval (start, end) of ``s``, ns."""
        self._read_device(s)
        if s.d0 is None:
            return s.t0, s.t1
        return max(s.t0, s.d0), max(s.t1, s.d1)

    def critical_s(self, s: Span) -> float:
        a, b = self.interval(s)
        return (b - a) / 1e9

    def self_s(self, s: Span) -> float:
        """Critical-path seconds of ``s`` that no child's interval
        covers."""
        a, b = self.interval(s)
        kids = sorted(self.interval(c) for c in self.spans
                      if c.parent is s and c.t1 is not None)
        covered, end = 0.0, a
        for lo, hi in kids:
            lo, hi = max(lo, end), min(hi, b)
            if hi > lo:
                covered += hi - lo
                end = hi
        return (b - a - covered) / 1e9

    def by_call(self) -> dict:
        """Call identifier -> its finished spans, calls in the order they
        began (spans outside any call left out)."""
        out = {}
        for s in self.spans:
            if s.call is not None and s.t1 is not None:
                out.setdefault(s.call, []).append(s)
        return out

    def seconds(self, call: int, prefix: str = "") -> dict:
        """Critical-path seconds of call ``call``'s spans whose names start
        with ``prefix``, by the rest of the name (summed where a name
        recurs)."""
        out = {}
        for s in self.by_call().get(call, ()):
            if s.name.startswith(prefix):
                k = s.name[len(prefix):]
                out[k] = out.get(k, 0.0) + self.critical_s(s)
        return out

    def per_call_ms(self) -> dict:
        """Span name -> its critical-path ms in each call of
        :meth:`by_call` (summed where it recurs in a call, 0 where it did
        not run)."""
        calls = list(self.by_call().values())
        out = {}
        for i, spans in enumerate(calls):
            for s in spans:
                row = out.setdefault(s.name, [0.0] * len(calls))
                row[i] += 1e3 * self.critical_s(s)
        return out


_RECORD: Record | None = None        # the active record
_PROFILED: Record | None = None      # the last profiler stretch's record
_OPENING = threading.Lock()
_LOCAL = threading.local()


def _active() -> Record | None:
    """The active record: ``recording()``'s, or the running profiler's
    stretch's (opened here by the first span, count or call under it, and
    closed by the first after the profiler stopped); None."""
    global _RECORD, _PROFILED
    rec = _RECORD
    if rec is not None:
        if not rec.profiled or _autograd_profiler._is_profiler_enabled:
            return rec
        with _OPENING:
            if _RECORD is rec:
                _RECORD = None
        return None
    if not _autograd_profiler._is_profiler_enabled:
        return None
    with _OPENING:
        if _RECORD is None:
            rec = Record(profiled=True)
            rec.anchor_device()
            _RECORD = _PROFILED = rec
        return _RECORD


def profiled() -> Record | None:
    """The record of the last profiler's stretch (module docstring), None
    before the first."""
    return _PROFILED


class _Null:
    """What ``span`` and ``call`` return with recording off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """An open span of ``record``."""
    __slots__ = ("record", "span", "range", "e0")

    def __init__(self, record: Record, name: str, parent):
        self.record = record
        self.span = Span(name, parent if isinstance(parent, Span) else None)
        self.range = self.e0 = None

    def __enter__(self) -> Span:
        s, rec = self.span, self.record
        stack = _LOCAL.__dict__.setdefault("stack", [])
        if s.parent is None and stack:
            s.parent = stack[-1]
        s.call = (s.parent.call if s.parent is not None
                  else getattr(_LOCAL, "call", None))
        stack.append(s)
        rec.spans.append(s)
        s.t0 = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(s.name)
            self.range.__enter__()
            s.t0 = (s.t0 + time.time_ns()) // 2
        if (rec.device is not None
                and torch.cuda.current_device() == rec.device):
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        return s

    def __exit__(self, *exc):
        s = self.span
        if self.e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            s.events = (self.e0, e1)
        s.t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
            s.t1 = (s.t1 + time.time_ns()) // 2
        stack = _LOCAL.stack
        if stack and stack[-1] is s:
            stack.pop()
        return False


def span(name: str, parent: Span | None = None):
    """A context manager marking a stretch of the program as span
    ``name``; ``parent``: the enclosing span where it runs on another
    thread (by default the span open on this thread).  Yields the
    :class:`Span` (None with recording off)."""
    rec = _active()
    if rec is None:
        return _NULL
    return _Open(rec, name, parent)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the active record."""
    rec = _active()
    if rec is None:
        return
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


class _Call:
    __slots__ = ("record", "outer")

    def __init__(self, record: Record):
        self.record = record

    def __enter__(self) -> int:
        self.outer = getattr(_LOCAL, "call", None)
        if self.outer is None:
            _LOCAL.call = next(self.record.calls)
        return _LOCAL.call

    def __exit__(self, *exc):
        _LOCAL.call = self.outer
        return False


def call():
    """A context manager under which this thread's spans share one call
    identifier, which it yields (None with recording off); inside another
    call the outer identifier holds."""
    rec = _active()
    if rec is None:
        return _NULL
    return _Call(rec)


@contextlib.contextmanager
def recording():
    """Record spans and counters over the body; yields the
    :class:`Record`.  Inside an active recording, or under a running
    profiler, it yields that record.  A new record anchors the device's
    clock (module docstring)."""
    global _RECORD
    rec = _active()
    if rec is not None:
        yield rec
        return
    rec = Record()
    rec.anchor_device()
    _RECORD = rec
    try:
        yield rec
    finally:
        _RECORD = None
