"""The program's spans and counters over a traced run's profiled stretch,
for the per-layer readers: the program records while a ``torch.profiler``
runs (``autovc_tpu_torch.utils.profiling.profiled()``), and the harness's
profiler covers the traced stretch (the whole window of ``serve_batch``,
``TraceTail``'s part of ``convert`` and training).  A program without the
recorder reads None, and so does a stretch in which a span did not run.
"""
from __future__ import annotations


def record():
    """The program's record of the last profiled stretch, or None."""
    from autovc_tpu_torch.utils import profiling
    get = getattr(profiling, "profiled", None)
    return None if get is None else get()


def ms_per_call(*names: str) -> float | None:
    """Critical-path ms of the spans ``names`` in each call, request or
    step of the stretch, summed over the names and averaged over the
    calls."""
    rec = record()
    if rec is None:
        return None
    per = rec.per_call_ms()
    if not all(n in per for n in names):
        return None
    return sum(sum(per[n]) / len(per[n]) for n in names)


def counters() -> dict:
    """The stretch's counter sums ({} without a record)."""
    rec = record()
    return {} if rec is None else dict(rec.counters)
