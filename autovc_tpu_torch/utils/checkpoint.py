"""Reader for the JAX package's v2 ``.ckpt`` format.

The format (``autovc_tpu/utils/checkpoint.py:1-31,57-108``) is a ZIP
container of ``manifest.json`` — the payload tree with every array leaf
replaced by ``{"__tensor__": name}`` — plus one ``.npy`` member per tensor.
bf16 leaves are stored as a uint16 view tagged ``"__viewed__": "bfloat16"``;
they are read back as ``torch.bfloat16`` tensors (no ``ml_dtypes``).  Every
other leaf comes back as a numpy array; :func:`autovc_tpu_torch.utils.bridge.
from_jax_params` turns the tree into tensors.  Nothing is unpickled.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _decode(node, tensor):
    if isinstance(node, dict):
        if "__tensor__" in node:
            arr = tensor(node["__tensor__"])
            viewed = node.get("__viewed__")
            if viewed == "bfloat16":
                return torch.from_numpy(
                    np.ascontiguousarray(arr).view(np.int16)).view(
                        torch.bfloat16)
            if viewed is not None:
                raise ValueError(f"unsupported stored dtype {viewed!r}")
            return arr
        if "__tuple__" in node:
            items = [_decode(v, tensor) for v in node["__tuple__"]]
            if "__fields__" in node:
                return dict(zip(node["__fields__"], items))
            return tuple(items)
        return {k: _decode(v, tensor) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v, tensor) for v in node]
    return node


def is_checkpoint(path: str) -> bool:
    """True for a v2 container (a zip holding ``manifest.json``)."""
    try:
        with zipfile.ZipFile(path) as zf:
            return _MANIFEST in zf.namelist()
    except (OSError, zipfile.BadZipFile):
        return False


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a v2 checkpoint's payload tree (``step``, ``params``, extras)."""
    if not is_checkpoint(path):
        raise ValueError(f"{path} is not a v2 .ckpt container")
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read(_MANIFEST))

        def tensor(name):
            return np.lib.format.read_array(
                io.BytesIO(zf.read(name + ".npy")), allow_pickle=False)

        return _decode(manifest["payload"], tensor)
