"""Weight bridge: a JAX param pytree of numpy arrays -> the port's tensors.

The JAX package keeps parameters as nested dicts and lists of arrays
(``autoencoder.init``, ``speaker_encoder.init``, ``wavernn.init``); the port
keeps the SAME tree of ``torch.Tensor`` leaves, leaf for leaf, in the same
layouts (linear ``w`` (out, in), conv ``w`` (O, I, K), RNN ``w_ih``
(in, 4H or 3H) used as ``x @ w_ih``, separate ``b_ih``/``b_hh``).  So a
parameter path in one package names the same numbers in the other.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device=None, dtype: torch.dtype | None = None):
    """Convert every array leaf of ``tree`` to a tensor on ``device``.

    Leaves may be numpy arrays (including JAX arrays, through
    ``np.asarray``), numpy scalars or tensors.  Floating leaves are cast to
    ``dtype`` when one is given.  Dicts stay dicts; lists and tuples become
    lists."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            t = x
        else:
            arr = np.asarray(x)
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(
                    np.ascontiguousarray(arr).view(np.int16)).view(
                        torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        return leaf(node)

    return walk(tree)
