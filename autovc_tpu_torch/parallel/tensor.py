"""The model axis's differentiable collectives: Megatron's *f* and *g*
(Shoeybi et al., 2019), the port's counterpart of the collectives that
GSPMD inserts around the JAX package's TP-sharded products.

Under tensor parallelism every rank of a model group holds the same
activations (they are replicated across the model axis) and its own
block of each sharded weight's output columns.  A column-parallel product
``y = x W`` is then

    y_k = copy_to_model(x) W_k          (this rank's output columns)
    y   = gather_from_model(y_k, dim)   (every rank: all columns)

* :func:`copy_to_model` is the identity forward; its backward is the
  all-reduce SUM over the model group, so ``dx = sum_k dy_k W_k^T``.
* :func:`gather_from_model` all-gathers the ranks' blocks along ``dim``
  in model-index order; its backward is this rank's slice of the
  gradient, with no reduction: the work after the gather is replicated,
  so every rank already holds the whole gradient.  (The data axis's
  ``collectives.all_gather`` sums the gradient first, since each data
  rank's work after its gather differs; under TP that would be M times
  too large.)

Both use ``torch.distributed.all_reduce`` alone: the gather is an
all-reduce of a zero block with this rank's slice filled in (adding zeros
is exact), since gloo offers only ``broadcast`` and ``all_reduce`` for
CUDA tensors.

``COUNTS`` counts the gathers (forward) and the input-gradient
all-reduces (backward) made, for the logs.

A :class:`ModelAxis` names the group, this rank's model index, the
axis size and the leaves of the parameter tree that this rank holds as
shards; :meth:`ModelAxis.of` gives the axis for a product whose weight is
such a shard and None for one whose weight the rule table leaves whole
(the product is then the plain one, replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from autovc_tpu_torch.utils import tree_leaves

# collectives made over a model group: "gather" by gather_from_model's
# forward, "reduce" by copy_to_model's backward
COUNTS = {"gather": 0, "reduce": 0}


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A model group: ``group`` (a process group), this rank's ``index``
    in it, its ``size``, and ``shards``, the ids of the parameter leaves
    this rank holds as shards."""
    group: Any
    index: int
    size: int
    shards: frozenset = frozenset()

    def of(self, weight: torch.Tensor) -> "ModelAxis | None":
        """This axis when ``weight`` is a shard, else None."""
        return self if id(weight) in self.shards else None


def model_axis(mesh, params, specs) -> ModelAxis | None:
    """This rank's :class:`ModelAxis` on a distributed mesh with a model
    axis larger than 1, for the parameter tree ``params`` (this rank's
    shards) whose full tree has the specs ``specs``
    (``sharding.param_shardings``); None without such an axis."""
    from autovc_tpu_torch.parallel import sharding as shd
    M = mesh.model_size
    if M == 1:
        return None
    shards = frozenset(
        id(leaf) for leaf, spec in zip(tree_leaves(params),
                                       shd.spec_leaves(specs, params))
        if "model" in spec)
    return ModelAxis(mesh.model_group, mesh.rank % M, M, shards)


def of(model: ModelAxis | None, weight: torch.Tensor) -> ModelAxis | None:
    """``model.of(weight)``, None without an axis."""
    return None if model is None else model.of(weight)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        COUNTS["reduce"] += 1
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, axis):
        n = y.shape[dim]
        ctx.dim, ctx.start, ctx.n = dim, axis.index * n, n
        shape = list(y.shape)
        shape[dim] = n * axis.size
        out = y.new_zeros(shape)
        out.narrow(dim, ctx.start, n).copy_(y)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
        COUNTS["gather"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, \
            None


def copy_to_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """``x`` (replicated over the model axis) as the input of
    column-parallel products: the identity, whose backward sums the
    ranks' partial input gradients.  No axis: ``x``."""
    if axis is None:
        return x
    return _CopyToModel.apply(x, axis.group)


def gather_from_model(y: torch.Tensor, dim: int,
                      axis: ModelAxis | None) -> torch.Tensor:
    """Every rank's block ``y`` concatenated along ``dim`` in model-index
    order; the backward keeps this rank's slice of the gradient.  No
    axis: ``y``."""
    if axis is None:
        return y
    return _GatherFromModel.apply(y, dim % y.dim(), axis)
