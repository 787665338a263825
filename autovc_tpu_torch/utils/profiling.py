"""Profiling hooks (counterpart of ``autovc_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace (the host's operators and,
where CUDA is present, the card's kernels and copies) and writes it as a
Chrome trace, viewable in Perfetto or ``chrome://tracing``; ``sync`` waits
for the devices of a tree's tensors; ``StepTimer`` is the JAX package's
throughput accounting in audio-seconds per second.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from autovc_tpu_torch.utils import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str = "logs/profile"):
    """Capture a trace: ``with profiling.trace(d): step(...)`` writes
    ``d/trace_<pid>_<ns>.json`` when the block ends (also when it
    raises).  Yields ``log_dir``."""
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


class StepTimer:
    """Rolling throughput accounting for training/conversion loops."""

    def __init__(self, sr: int = 22050, hop_length: int = 275):
        self.sr = sr
        self.hop_length = hop_length
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.steps = 0
        self.frames = 0

    def tick(self, n_frames: int = 0):
        self.steps += 1
        self.frames += n_frames

    @property
    def sec_per_step(self) -> float:
        return (time.time() - self.t0) / max(self.steps, 1)

    @property
    def audio_seconds_per_second(self) -> float:
        """Processed audio-seconds per wall-clock second."""
        audio_s = self.frames * self.hop_length / self.sr
        return audio_s / max(time.time() - self.t0, 1e-9)

    def metrics(self) -> dict:
        return {"sec_per_step": self.sec_per_step,
                "audio_s_per_s": self.audio_seconds_per_second}
