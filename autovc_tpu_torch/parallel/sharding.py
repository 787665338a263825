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
that rank's device; such a mesh drives the sharded training steps.

Positions are row-major over the axes, as ``np.asarray(devices).reshape(
shape)`` lays out the JAX mesh: on a ``("data", "model")`` mesh of shape
(D, M) position ``d * M + m`` has data index d and model index m.  A
distributed mesh carries this rank's process groups: the **model group**
(the M ranks of its data index; none when M is 1) and the **data group**
(the D ranks of its model index; the whole group when M is 1).  Every
rank creates every group, in one order, since ``new_group`` is
collective.

``TP_RULES`` is the JAX package's rule table: ``param_shardings`` gives
every leaf of a parameter tree the partition spec tuple of the JAX
``_spec_for`` (replication, ``()``, on a mesh without a ``"model"``
axis), and :func:`shard_leaf` cuts a leaf to the block that the JAX
``NamedSharding`` puts on the device at a model index: contiguous equal
blocks of each dimension named ``"model"``.  :func:`shard_params` gives
each position its shards; :func:`gather_params` rebuilds the full tree on
every rank of a model group.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

from autovc_tpu_torch.parallel import collectives as COL
from autovc_tpu_torch.utils import resolve_device, tree_leaves, tree_unflatten

# This process's device in the process group, set by
# ``steps.initialize_distributed``: like the process group itself, one a
# process.
_RANK_DEVICE: torch.device | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Positions (``devices``, one ``torch.device`` each, row-major over
    ``sizes``) with axis names.  ``distributed``: the positions are the
    ranks of the default process group, this process being position
    ``rank``; else one process drives every position.  ``data_group`` /
    ``model_group``: this rank's process groups (distributed meshes)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    distributed: bool = False
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def model_size(self) -> int:
        """Positions along the model axis (1 without one)."""
        return self.shape.get("model", 1)

    @property
    def data_size(self) -> int:
        """Positions along the other axes: the number of model rows."""
        return self.size // self.model_size

    @property
    def rank(self) -> int | None:
        return COL.rank() if self.distributed else None

    @property
    def local_positions(self) -> Tuple[int, ...]:
        """The positions this process drives."""
        return ((self.rank,) if self.distributed
                else tuple(range(self.size)))

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the positions this process drives."""
        return tuple(self.devices[p] for p in self.local_positions)

    @property
    def row_devices(self) -> Tuple[torch.device, ...]:
        """The device of the first position of each model row, one per
        data index: where a path split over the data axis alone runs."""
        return self.devices[::self.model_size]


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


def _axis_groups(rows: int, model: int) -> tuple:
    """This rank's (data group, model group) on a (rows, model) grid of
    the default group's ranks.  Every rank creates every group, the model
    rows first, in one order."""
    me, mine = COL.rank(), {}
    grid = [[d * model + m for m in range(model)] for d in range(rows)]
    for kind, groups in (("model", grid),
                         ("data", [list(c) for c in zip(*grid)])):
        for ranks in groups:
            group = dist.new_group(ranks)
            if me in ranks:
                mine[kind] = group
    return mine["data"], mine["model"]


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (any ``torch.device``s, repeats allowed);
    without them, over the process group's ranks when one is initialised,
    else over every local CUDA device (none: ``RuntimeError``).

    ``make_mesh()`` is a 1-D data mesh; ``make_mesh((4, 2), ("data",
    "model"))`` a DP x TP grid.  A ``"model"`` axis comes last.  Over a
    process group this creates the data and model groups, so every rank
    calls ``make_mesh`` alike."""
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
    if "model" in axis_names[:-1]:
        raise ValueError(f"the 'model' axis must be the last mesh axis, "
                         f"got {axis_names}")
    assert math.prod(shape) == len(devices), \
        f"mesh shape {shape} != {len(devices)} devices"
    groups = (None, None)
    if distributed:
        model = dict(zip(axis_names, shape)).get("model", 1)
        groups = (_axis_groups(len(devices) // model, model) if model > 1
                  else (dist.group.WORLD, None))
    return Mesh(devices, tuple(axis_names), shape, distributed, *groups)


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


def spec_leaves(specs, tree) -> list:
    """The partition specs of ``specs`` (a :func:`param_shardings` tree
    of ``tree``'s structure) in ``tree_leaves(tree)`` order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in spec_leaves(specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for sp, v in zip(specs, tree) for s in spec_leaves(sp, v)]
    return [specs] if isinstance(tree, torch.Tensor) else []


def replicated(mesh: Mesh) -> tuple:
    """The spec of a leaf that every position holds whole."""
    return ()


def batch_sharding(mesh: Mesh, ndim: int | None = None) -> tuple:
    """The spec of a batch whose leading axis is split over 'data': data
    index d's rows go to every position of model row d
    (``steps.shard_batch``)."""
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


def shard_leaf(leaf: torch.Tensor, spec: tuple, index: int,
               size: int) -> torch.Tensor:
    """The block of ``leaf`` at model index ``index`` of ``size``: each
    dimension that ``spec`` names ``"model"`` cut into ``size`` contiguous
    equal blocks, as a tensor of its own; ``leaf`` itself when ``spec``
    names no model axis."""
    if "model" not in spec:
        return leaf
    for dim, axis in enumerate(spec):
        if axis == "model":
            n = leaf.shape[dim] // size
            leaf = leaf.narrow(dim, index * n, n)
    return leaf.clone(memory_format=torch.contiguous_format)


def _map_pairs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_pairs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs) if isinstance(tree, torch.Tensor) else tree


def shard_tree(tree, specs, index: int, size: int):
    """``tree`` with each leaf cut to its block at model index ``index``
    (:func:`shard_leaf` under its spec in ``specs``, a
    :func:`param_shardings` tree of ``tree``'s structure)."""
    return _map_pairs(lambda leaf, spec: shard_leaf(leaf, spec, index, size),
                      tree, specs)


def shard_params(params, mesh: Mesh, rules=TP_RULES) -> list:
    """``params`` as each position this process drives
    (``mesh.local_positions``) holds them, on its device: every leaf that
    the rule table shards over 'model' cut to the position's block, the
    others whole.  Positions on one device with one model index share a
    tree; without a model axis larger than 1 it is ``params`` itself
    wherever that already lies on the device."""
    M = mesh.model_size
    specs = param_shardings(params, mesh, rules)
    trees, out = {}, []
    for pos in mesh.local_positions:
        key = (mesh.devices[pos], pos % M)
        if key not in trees:
            tree = params if M == 1 else shard_tree(params, specs, key[1], M)
            trees[key] = tree_to(tree, key[0])
        out.append(trees[key])
    return out


def gather_params(tree, specs, mesh: Mesh):
    """The full tree from this rank's shards ``tree``, collective over the
    model group (every rank of the mesh calls it): each sharded leaf
    rebuilt by one all-reduce of zero-padded blocks, which is exact; the
    replicated leaves as they are.  ``specs``: :func:`param_shardings` of
    the full tree.  A mesh without a model axis larger than 1 returns
    ``tree``."""
    M = mesh.model_size
    if M == 1:
        return tree
    if not mesh.distributed:
        raise ValueError("gather_params runs in the ranks of a distributed "
                         "mesh")
    m = mesh.rank % M
    full, blocks = [], []
    for leaf, spec in zip(tree_leaves(tree), spec_leaves(specs, tree)):
        if "model" in spec:
            dim = spec.index("model")
            n = leaf.shape[dim]
            shape = list(leaf.shape)
            shape[dim] = n * M
            buf = leaf.new_zeros(shape)
            buf.narrow(dim, m * n, n).copy_(leaf)
            blocks.append(buf)
            leaf = buf
        full.append(leaf)
    COL.all_reduce_flat(blocks, mesh.model_group)
    return tree_unflatten(tree, full)
