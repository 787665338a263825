"""Local multi-process launcher and run supervision (counterpart of
``autovc_tpu/utils/launcher.py``'s ``supervise`` and
``launch_local_multiprocess``; its TPU-pod helpers have no counterpart on
a GPU host).

:func:`launch_local_multiprocess` starts N processes of one script or
module, each told its place in the process group by environment
variables that :func:`autovc_tpu_torch.parallel.steps.
initialize_distributed` reads: ``AUTOVC_COORD`` (the TCP rendezvous,
``localhost:<port>``), ``AUTOVC_NPROC``, ``AUTOVC_PID`` and
``AUTOVC_DEVICE`` (``cpu``, or ``cuda:<rank % cards>``).  A rank that has
not ended within the timeout is killed, with all the others.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of localhost that is free now (bound to port 0 and
    released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def supervise(cmd: Sequence[str], max_restarts: int = 3,
              env: dict | None = None, verbose: bool = True,
              retry_on: Sequence[int] | None = None) -> int:
    """Run a training command under preemption supervision: relaunched
    after a non-zero exit (crash, OOM kill, SIGTERM) up to
    ``max_restarts`` times; with ``resume=True`` in the training loops a
    relaunch continues from the newest checkpoint.

    Args:
      retry_on: optional whitelist of exit codes to retry (default: any
        non-zero).
    Returns the number of restarts performed.  Raises RuntimeError when
    the command still fails after the restart budget."""
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    restarts = 0
    while True:
        rc = subprocess.call(list(cmd), env=full_env)
        if rc == 0:
            return restarts
        if retry_on is not None and rc not in retry_on:
            raise RuntimeError(f"command exited {rc} (not retryable): {cmd}")
        if restarts >= max_restarts:
            raise RuntimeError(
                f"command failed {restarts + 1} times (last exit {rc}): "
                f"{cmd}")
        restarts += 1
        if verbose:
            print(f"[supervise] exit {rc}; restart {restarts}/"
                  f"{max_restarts}")


def _rank_device(pid: int, device: str | None) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return f"cuda:{pid % torch.cuda.device_count()}"


def launch_local_multiprocess(script: str, num_processes: int = 2,
                              args: Sequence[str] = (),
                              coordinator_port: int | None = None,
                              device: str | None = None,
                              timeout: float = 600.0,
                              module: bool = False) -> list:
    """Run ``script`` (a path, or with ``module`` a module name for
    ``python -m``) in ``num_processes`` local processes joined into one
    process group.

    Each process gets ``AUTOVC_COORD=localhost:<coordinator_port>`` (None:
    a free port), ``AUTOVC_NPROC``, ``AUTOVC_PID`` and ``AUTOVC_DEVICE``:
    ``device="cpu"`` puts every rank on the CPU, None on the card
    ``rank % cards`` (several ranks may share a card; no card raises).
    The ranks inherit this process's environment, with the repository
    root put on ``PYTHONPATH``.
    When a rank has not ended after ``timeout`` seconds every rank still
    running is killed.  Returns one ``(returncode, output)`` per rank, in
    rank order (a killed rank's return code is negative)."""
    port = coordinator_port if coordinator_port is not None else free_port()
    cmd = [sys.executable] + (["-m", script] if module else [script])
    # the ranks write to files, not pipes: a rank blocked on a full pipe
    # would stall the collectives of every other
    logs = [tempfile.TemporaryFile() for _ in range(num_processes)]
    procs = []
    for pid, log in enumerate(logs):
        penv = dict(os.environ)
        penv.update({
            "AUTOVC_COORD": f"localhost:{port}",
            "AUTOVC_NPROC": str(num_processes),
            "AUTOVC_PID": str(pid),
            "AUTOVC_DEVICE": _rank_device(pid, device),
            "PYTHONPATH": os.pathsep.join(
                [REPO_ROOT] + [p for p in (penv.get("PYTHONPATH"),) if p]),
        })
        procs.append(subprocess.Popen(cmd + list(args), env=penv,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, log in zip(procs, logs):
        log.seek(0)
        results.append((p.returncode, log.read().decode(errors="replace")))
        log.close()
    return results
