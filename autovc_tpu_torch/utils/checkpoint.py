"""Reader and writer of the JAX package's v2 ``.ckpt`` format.

The format (``autovc_tpu/utils/checkpoint.py:1-31,57-185``) is a ZIP
container of ``manifest.json`` — the payload tree with every array leaf
replaced by ``{"__tensor__": name}`` — plus one ``.npy`` member per tensor.
bf16 leaves are stored as a uint16 view tagged ``"__viewed__": "bfloat16"``;
they are read back as ``torch.bfloat16`` tensors (no ``ml_dtypes``).  Every
other leaf comes back as a numpy array; :func:`autovc_tpu_torch.utils.bridge.
from_jax_params` turns the tree into tensors.  Nothing is unpickled unless
the caller opts in to the JAX package's legacy v1 pickles
(``load_checkpoint(allow_v1=True)``).  The writer takes trees of tensors,
numpy arrays and JSON scalars, and writes atomically (temporary file, then
rename).  A reference PyTorch file (``_is_torch_checkpoint``) is not a
``.ckpt``: ``models.load_model`` reads it through
:mod:`autovc_tpu_torch.utils.torch_compat`.

``save_checkpoint(..., block=False)`` takes the snapshot before it returns
and writes the file on one background thread, so a periodic save does not
hold up the training loop; :func:`wait_for_saves` waits for every such
write.  The snapshot owns its memory (a copy of each CPU tensor or array, a
finished device-to-host copy of each CUDA tensor): the port's optimizer
updates parameters in place, so a view of the live storage would let a
later step's weights into the file.
"""
from __future__ import annotations

import io
import json
import os
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

FORMAT_VERSION = 2
_MANIFEST = "manifest.json"


def _encode(node, tensors: Dict[str, np.ndarray]):
    """Payload tree -> JSON-able manifest tree + a tensor table of host
    arrays that own their memory (see the module docstring)."""
    if isinstance(node, torch.Tensor):
        name = f"t{len(tensors)}"
        t = node.detach()
        # .cpu() of a CUDA tensor is a finished copy; of a CPU tensor it is
        # the tensor itself
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            tensors[name] = t.view(torch.int16).numpy().view(np.uint16)
            return {"__tensor__": name, "__viewed__": "bfloat16"}
        tensors[name] = t.numpy()
        return {"__tensor__": name}
    if isinstance(node, np.ndarray):
        name = f"t{len(tensors)}"
        tensors[name] = node.copy()
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


_EXECUTOR: ThreadPoolExecutor | None = None
_PENDING: list[Future] = []
_LOCK = threading.Lock()


def _write(path: str, manifest: dict, tensors: Dict[str, np.ndarray]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest))
        for name, arr in tensors.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, allow_pickle=False)
            zf.writestr(name + ".npy", buf.getvalue())
    os.replace(tmp, path)


def save_checkpoint(path: str, payload: Dict[str, Any],
                    block: bool = True) -> None:
    """Write ``payload`` as a v2 checkpoint at ``path``, atomically.

    ``block=False`` returns once the snapshot is taken; the file is written
    on one background thread, so saves stay in order.  A blocking save
    first waits for the background ones (same order, same temporary
    file).  A failed background write raises on the next save or at
    :func:`wait_for_saves`."""
    global _EXECUTOR
    tensors: Dict[str, np.ndarray] = {}
    manifest = {"format_version": FORMAT_VERSION,
                "payload": _encode(payload, tensors)}
    if block:
        wait_for_saves()
        _write(path, manifest, tensors)
        return
    with _LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-save")
        _reap_pending()
        _PENDING.append(_EXECUTOR.submit(_write, path, manifest, tensors))


def _reap_pending():
    """Drop the finished background writes, raising the first failure."""
    for f in [f for f in _PENDING if f.done()]:
        _PENDING.remove(f)
        f.result()


def wait_for_saves() -> None:
    """Block until every background save is on disk; raises the error of
    a failed one."""
    with _LOCK:
        while _PENDING:
            _PENDING.pop(0).result()


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


def load_checkpoint(path: str, allow_v1: bool = False) -> Dict[str, Any]:
    """Load a v2 checkpoint's payload tree (``step``, ``params``, extras).
    A PyTorch file is refused: ``models.load_model`` converts those.

    ``allow_v1=True`` also accepts the JAX package's legacy v1 format, a
    pickled dict of numpy leaves.  It is off by default because
    ``pickle.load`` of an untrusted file runs arbitrary code: enable it
    only for files you wrote yourself."""
    if _is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is a PyTorch checkpoint; use load_model() which converts "
            "it via torch_compat")
    if is_checkpoint(path):
        with zipfile.ZipFile(path) as zf:
            manifest = json.loads(zf.read(_MANIFEST))

            def tensor(name):
                return np.lib.format.read_array(
                    io.BytesIO(zf.read(name + ".npy")), allow_pickle=False)

            return _decode(manifest["payload"], tensor)
    with open(path, "rb") as f:
        head = f.read(1)
    if head != b"\x80" or not allow_v1:     # \x80: the pickle PROTO opcode
        raise ValueError(
            f"{path} is not a v2 checkpoint"
            + ("" if allow_v1 else
               " (if it is a legacy v1 pickle YOU wrote, pass allow_v1=True"
               " — v1 loading executes pickle bytecode and is opt-in)"))
    import pickle
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob.pop("format_version", None)
    return blob
