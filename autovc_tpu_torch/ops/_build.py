"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded through ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the repository root, keyed
by a hash of the sources so a stale library is never loaded.  Nothing here
runs at import time: the modules import on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("lstm_stack.cu", "wavernn_sample.cu")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, for the logs
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def _command(source: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build_all(sources=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _target(src)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (subprocess.Popen(
                _command(src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[src] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src: _target(src) for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all((source,))[source]
            lib = ctypes.CDLL(str(path))
            _LIBS[source] = lib
        return lib


class Kernel:
    """One kernel's C entry point and its launch counter.

    ``launches`` counts the launches made through the kernel's wrapper; a
    run sets it to 0 before a phase and reads it after, to show that the
    phase went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        """Launch on the current stream's arguments; raise on any CUDA
        error the launch reports."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{err}")
        self.launches += 1
