"""Cross-rank operations of the data-parallel steps: the port's counterpart
of the collectives GSPMD inserts into the JAX package's sharded programs.

Two differentiable operations, each a ``torch.autograd.Function``:

* :func:`all_reduce_sum`: every rank gets the sum over ranks; its
  backward is an all-reduce SUM of the gradient (each rank's output feeds
  that rank's share of the loss, and the shares sum to the loss);
* :func:`all_gather`: the ranks' tensors concatenated along dim 0, in rank
  order; its backward is an all-reduce SUM of the gradient, of which each
  rank keeps its own slice.

Both use ``torch.distributed.all_reduce`` alone.  The gather is an
all-reduce of a zero block with this rank's slice filled in (adding zeros
is exact): gloo offers only ``broadcast`` and ``all_reduce`` for CUDA
tensors, and ``torch.distributed.nn.functional.all_gather``'s backward
needs ``reduce_scatter`` (NCCL) or ``all_to_all``, which gloo lacks.
A world of one rank makes every operation the identity.

:func:`all_reduce_flat` is the steps' one gradient exchange: the tensors
flattened into one buffer, one all-reduce SUM, written back in place.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def world_size(group=None) -> int:
    """Ranks in ``group`` (1 without an initialised process group)."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, r = world_size(group), rank(group)
        ctx.group, ctx.rank, ctx.rows = group, r, x.shape[0]
        out = x.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
        out[r * x.shape[0]:(r + 1) * x.shape[0]] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        b = ctx.rows
        return g[ctx.rank * b:(ctx.rank + 1) * b], None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``, differentiable."""
    if world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along dim 0 in
    rank order, differentiable."""
    if world_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group=None) -> List[torch.Tensor]:
    """All-reduce SUM of several tensors (one device, one dtype) through
    one flattened buffer; the results are written back in place."""
    tensors = list(tensors)
    if world_size(group) == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return tensors
