"""The mesh and the sharding rules (counterpart of
``autovc_tpu/parallel/sharding.py``).

A :class:`Mesh` is a grid of positions, each on one ``torch.device``,
with named axes (``"data"``, and ``"model"`` for tensor parallelism).  A
local mesh (``make_mesh(devices=...)``, or every CUDA device when no
process group is up) is driven by one process; positions may repeat a
device (``[cuda:0] * 2``, ``[cpu] * 4``), which stands in for the JAX
tests' forced host device count.  After
:func:`autovc_tpu_torch.parallel.steps.initialize_distributed`,
``make_mesh()`` has one position per rank of the process group, each on
that rank's device; such a mesh drives the data-parallel steps.

``TP_RULES`` is the JAX package's rule table, copied: ``param_shardings``
gives every leaf of a parameter tree the same partition spec tuple as the
JAX ``_spec_for`` (replication, ``()``, on a mesh without a ``"model"``
axis).  The port computes nothing tensor-parallel: a ``"model"`` axis
larger than 1 raises ``NotImplementedError`` wherever a mesh is used
(ROADMAP, Queue 1).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from autovc_tpu_torch.parallel import collectives as COL
from autovc_tpu_torch.utils import resolve_device

# This process's device in the process group, set by
# ``steps.initialize_distributed``: like the process group itself, one a
# process.
_RANK_DEVICE: torch.device | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Positions (``devices``, one ``torch.device`` each, row-major over
    ``sizes``) with axis names.  ``distributed``: the positions are the
    ranks of the default process group, this process being position
    ``rank``; else one process drives every position."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int | None:
        return COL.rank() if self.distributed else None

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the positions this process drives."""
        return ((self.devices[self.rank],) if self.distributed
                else self.devices)


def _rank_devices() -> list:
    """Every rank's device, by one all-reduce of device codes (0: the CPU,
    i + 1: ``cuda:i``) on this rank's device: the one
    ``steps.initialize_distributed`` chose, else (a process group set up
    some other way) the current CUDA device, raising without a card as
    every entry point does; the CPU only by ``initialize_distributed(...,
    device="cpu")``."""
    me = _RANK_DEVICE
    if me is None:
        try:
            me = resolve_device(None)
        except RuntimeError as e:
            raise RuntimeError(
                f"{e}; for ranks on the CPU call parallel.steps."
                f"initialize_distributed(..., device='cpu') instead of "
                f"init_process_group") from None
    if me.type == "cuda" and me.index is None:
        me = torch.device("cuda", torch.cuda.current_device())
    codes = torch.zeros(COL.world_size(), device=me)
    codes[COL.rank()] = me.index + 1 if me.type == "cuda" else 0
    dist.all_reduce(codes)
    return [torch.device("cuda", int(c) - 1) if c > 0
            else torch.device("cpu") for c in codes.tolist()]


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (any ``torch.device``s, repeats allowed);
    without them, over the process group's ranks when one is initialised,
    else over every local CUDA device (none: ``RuntimeError``).

    ``make_mesh()`` is a 1-D data mesh; ``make_mesh((4, 2), ("data",
    "model"))`` a DP x TP grid (whose TP half the port does not compute).
    """
    distributed = False
    if devices is None:
        if dist.is_available() and dist.is_initialized():
            devices, distributed = _rank_devices(), True
        elif torch.cuda.is_available() and torch.cuda.device_count():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise RuntimeError(
                "no CUDA device is available; pass devices="
                "[torch.device('cpu')] * n for a mesh on the CPU")
    devices = tuple(torch.device(d) for d in devices)
    if shape is None:
        shape, axis_names = (len(devices),), tuple(axis_names[:1])
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    assert math.prod(shape) == len(devices), \
        f"mesh shape {shape} != {len(devices)} devices"
    return Mesh(devices, tuple(axis_names), shape, distributed)


def check_no_tensor_parallel(mesh: Mesh) -> None:
    """Raise where a mesh asks for tensor parallelism, which the port does
    not compute."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "a 'model' mesh axis larger than 1 (tensor parallelism) is not "
            "ported: only its rule table is (ROADMAP, Queue 1, "
            "tensor-parallel computation)")


# Parameter-path regex -> partition spec.  Paths look like
# 'decoder/lstm2/0/w_ih', 'encoder/convs/1/conv/w', 'fc1/w'.  Specs name
# the 'model' axis; on a data-only mesh every leaf is replicated.
TP_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # LSTM/GRU gate matrices: shard the (gates*H) output dim.
    (r".*/(w_ih|w_hh)$", (None, "model")),
    (r".*/(b_ih|b_hh)$", ("model",)),
    # Conv channels: shard output channels (O, I, K).
    (r".*convs?/\d+/conv/w$", ("model", None, None)),
    (r".*convs?/\d+/conv/b$", ("model",)),
    # Linear layers (O, I): shard the output dim.
    (r".*(proj|linear|fc\d|I)/w$", ("model", None)),
    (r".*(proj|linear|fc\d|I)/b$", ("model",)),
)


def _spec_for(path: str, leaf: torch.Tensor, mesh: Mesh, rules) -> tuple:
    if "model" not in mesh.axis_names:
        return ()
    model_size = mesh.shape["model"]
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            if len(spec) > leaf.dim():
                continue
            # only shard when the dimension divides evenly
            if all(ax is None or leaf.shape[i] % model_size == 0
                   for i, ax in enumerate(spec)):
                return tuple(spec)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def param_shardings(params, mesh: Mesh, rules=TP_RULES):
    """A tree of ``params``' structure holding each leaf's partition spec
    (a tuple of axis names or None per dim, ``()`` = replicated), as the
    JAX ``param_shardings`` gives them."""
    return _map_with_path(
        lambda path, leaf: _spec_for(path, leaf, mesh, rules), params)


# ``replicated``, ``batch_sharding`` and ``tree_shardings_like`` keep the
# JAX API's names and give its specs; nothing in the port computes with
# them: they are placeholders until tensor-parallel computation is ported
# (ROADMAP, Queue 1).
def replicated(mesh: Mesh) -> tuple:
    """The spec of a leaf every position holds whole (a constant)."""
    return ()


def batch_sharding(mesh: Mesh, ndim: int | None = None) -> tuple:
    """The spec of a batch whose leading axis is split over 'data' (a
    constant: the data-parallel steps split rows with
    ``steps.shard_batch``)."""
    return ("data",)


def tree_shardings_like(tree, sharding):
    """A tree of ``tree``'s structure with ``sharding`` at every leaf."""
    return _map_with_path(lambda path, leaf: sharding, tree)


def tree_to(tree, device):
    """``tree`` with every tensor leaf on ``device`` (a leaf already there
    is the same tensor)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def shard_params(params, mesh: Mesh) -> list:
    """A replica of ``params`` for each position this process drives
    (``mesh.local_devices``), one copy a device: positions on one device
    share it.  A 'model' axis larger than 1 raises."""
    check_no_tensor_parallel(mesh)
    copies = {}
    return [copies.setdefault(d, tree_to(params, d))
            for d in mesh.local_devices]
