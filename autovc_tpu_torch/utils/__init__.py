"""Small shared utilities: file discovery and device resolution.

``retrieve_file_paths`` is a copy of ``autovc_tpu/utils/__init__.py``'s.
"""
from __future__ import annotations

import os

import torch


def retrieve_file_paths(paths, excluded=(), extensions=(".wav",)):
    """Recursively resolve a path / list of paths into a sorted list of audio
    files, skipping anything under ``excluded`` (utils/__init__.py:4-34)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    excluded = [os.path.normpath(str(e)) for e in
                ([excluded] if isinstance(excluded, (str, os.PathLike))
                 else excluded)]

    def is_excluded(p):
        p = os.path.normpath(p)
        return any(p == e or p.startswith(e + os.sep) for e in excluded)

    out = []
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    full = os.path.join(root, f)
                    if f.lower().endswith(extensions) and not is_excluded(full):
                        out.append(full)
        elif os.path.isfile(p):
            if not is_excluded(p):
                out.append(p)
        else:
            raise FileNotFoundError(f"No such file or directory: {p}")
    return sorted(out)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: with no CUDA device present this raises rather
    than carry on quietly on the CPU.  The CPU runs only when the caller
    asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
