"""Reader and writer of the JAX package's v2 ``.ckpt`` format.

The format (``autovc_tpu/utils/checkpoint.py:1-31,57-185``) is a ZIP
container of ``manifest.json`` — the payload tree with every array leaf
replaced by ``{"__tensor__": name}`` — plus one ``.npy`` member per tensor.
bf16 leaves are stored as a uint16 view tagged ``"__viewed__": "bfloat16"``;
they are read back as ``torch.bfloat16`` tensors (no ``ml_dtypes``).  Every
other leaf comes back as a numpy array; :func:`autovc_tpu_torch.utils.bridge.
from_jax_params` turns the tree into tensors.  Nothing is unpickled.  The
writer takes trees of tensors, numpy arrays and JSON scalars, and writes
synchronously and atomically (temporary file, then rename).  A
reference PyTorch file (``_is_torch_checkpoint``) is not a ``.ckpt``:
``models.load_model`` reads it through :mod:`autovc_tpu_torch.utils.
torch_compat`.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict

import numpy as np
import torch

FORMAT_VERSION = 2
_MANIFEST = "manifest.json"


def _encode(node, tensors: Dict[str, np.ndarray]):
    """Payload tree -> JSON-able manifest tree + tensor table."""
    if isinstance(node, torch.Tensor):
        name = f"t{len(tensors)}"
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            tensors[name] = t.view(torch.int16).numpy().view(np.uint16)
            return {"__tensor__": name, "__viewed__": "bfloat16"}
        tensors[name] = t.numpy()
        return {"__tensor__": name}
    if isinstance(node, np.ndarray):
        name = f"t{len(tensors)}"
        tensors[name] = node
        return {"__tensor__": name}
    if isinstance(node, dict):
        if not all(isinstance(k, str) and not k.startswith("__")
                   for k in node):
            raise TypeError(f"unserialisable dict keys: {list(node)}")
        return {k: _encode(v, tensors) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_encode(v, tensors) for v in node]
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, (np.integer, np.floating)):
        return node.item()
    raise TypeError(f"cannot serialise checkpoint leaf of type "
                    f"{type(node).__name__}")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` as a v2 checkpoint at ``path``, atomically."""
    tensors: Dict[str, np.ndarray] = {}
    manifest = {"format_version": FORMAT_VERSION,
                "payload": _encode(payload, tensors)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest))
        for name, arr in tensors.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, allow_pickle=False)
            zf.writestr(name + ".npy", buf.getvalue())
    os.replace(tmp, path)


def latest_checkpoint(model_dir: str, suffix: str = ".ckpt") -> str | None:
    """Most recently modified checkpoint in a directory, or None."""
    if not os.path.isdir(model_dir):
        return None
    cands = [os.path.join(model_dir, f) for f in os.listdir(model_dir)
             if f.endswith(suffix)]
    return max(cands, key=os.path.getmtime) if cands else None


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


def _is_torch_checkpoint(path: str) -> bool:
    """True for a PyTorch file: a ``.pt`` / ``.pyt`` / ``.pth`` name, or a
    zip without ``manifest.json`` (torch's serialisation is a zip too)."""
    if path.endswith((".pt", ".pyt", ".pth")):
        return True
    return zipfile.is_zipfile(path) and not is_checkpoint(path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a v2 checkpoint's payload tree (``step``, ``params``, extras).
    A PyTorch file is refused: ``models.load_model`` converts those."""
    if _is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is a PyTorch checkpoint; use load_model() which converts "
            "it via torch_compat")
    if not is_checkpoint(path):
        raise ValueError(f"{path} is not a v2 .ckpt container")
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read(_MANIFEST))

        def tensor(name):
            return np.lib.format.read_array(
                io.BytesIO(zf.read(name + ".npy")), allow_pickle=False)

        return _decode(manifest["payload"], tensor)
