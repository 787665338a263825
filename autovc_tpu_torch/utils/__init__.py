"""Small shared utilities: file discovery, device resolution, parameter
trees and a progress bar.

``retrieve_file_paths`` and ``progbar`` are copies of
``autovc_tpu/utils/__init__.py``'s.
"""
from __future__ import annotations

import os
import sys

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


def tree_leaves(tree) -> list:
    """The tensor leaves of a parameter tree (dicts and lists), in the
    order ``jax.tree_util.tree_leaves`` gives the same tree: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose tensor leaves are ``leaves``,
    taken in :func:`tree_leaves` order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it) if isinstance(node, torch.Tensor) else node

    return walk(tree)


def tree_clone(tree):
    """A copy of a parameter tree with every tensor leaf cloned."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_clone(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def progbar(i, n, info=None, size=16):
    """Minimal textual progress bar."""
    done = int(size * i / max(n, 1))
    bar = "\u2588" * done + "\u2591" * (size - done)
    msg = f"\r{i}/{n} |{bar}| "
    if info:
        msg += " ".join(f"{k}: {v}" for k, v in info.items())
    sys.stdout.write(msg)
    sys.stdout.flush()


def close_progbar():
    sys.stdout.write("\n")
    sys.stdout.flush()
