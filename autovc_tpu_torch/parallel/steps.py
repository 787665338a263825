"""Sharded training steps and the chunk-sharded conversion (counterpart
of ``autovc_tpu/parallel/steps.py``).

JAX writes its sharded steps as the single-device functions jitted over
sharded arrays, GSPMD inserting the collectives.  Here each mesh position
is a process (rank) of a ``torch.distributed`` group, and the steps say
what GSPMD does, with one rule for gradients: each rank's loss is its
share of the global loss, and the shares of the data axis sum to the
global loss.  On a ``("data", "model")`` mesh the M ranks of a model row
compute the same loss (their activations are replicated), so the shares,
the sync BatchNorm statistics, the GE2E gather and the gradient
all-reduce all go over the **data group**, never the whole world, which
would count each term M times.

* The generator and the vocoder: a rank's share is the mean loss of its
  rows over the number of ranks; BatchNorm is sync BatchNorm (the
  statistics of the global batch, ``conv.batchnorm1d(group=)``).
* The speaker encoder (GE2E): each rank embeds its S / N speakers, the
  embeddings are all-gathered, and each rank's share is the GE2E loss of
  the whole gathered block over N.  Then the similarity weight's and
  bias's gradients are scaled by 0.01, as ``make_sharded_se_step`` does:
  the global GE2E, not the per-replica loss of ``make_se_step(axis_name=)``.
* Every parameter gradient (and the loss terms) then goes through one
  all-reduce SUM of one flattened buffer over the data group before the
  optimizer, so the update, the EMA and ``grad_norm`` are the same on
  every rank of a data group.

Tensor parallelism (a model axis M > 1): each rank holds, for every leaf
that the rule table shards, the JAX shard at its model index
(``sharding.shard_params``), and so does its Adam state and EMA, which
are elementwise.  The losses run with a ``parallel.tensor.ModelAxis``:
the sharded convs and linears column-parallel, the recurrences the
per-step loops of ``ops.rnn`` (gates all-gathered every step), as the
JAX sharded steps run their scans and not their Pallas kernels.  The
global norm sums the sharded leaves' squares over the model group
(``schedules.Optimizer.global_norm``).  JAX replicates the optimizer
state over the mesh (``opt_shard``); its values are the same, sharded
here like the parameters.  ``with_grads`` gathers the gradients whole.

On CUDA each rank of a data-only mesh runs the port's kernels on its
rows (kernels 6/7 for the LSTM stacks, 4/5 for the vocoder's GRU pair).
The step takes this rank's rows (:func:`shard_batch` of the global batch
every rank draws).

:func:`chunk_sharded_convert` runs one process over a local mesh: each
position converts its share of the mel chunks on its own device and lane,
and the rows are merged on the first position.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from autovc_tpu_torch.parallel import collectives as COL
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.parallel import streams as ST
from autovc_tpu_torch.parallel import tensor as TP
from autovc_tpu_torch.train import loop as L
from autovc_tpu_torch.utils import resolve_device, tree_leaves, tree_unflatten


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> torch.device:
    """Join the process group: ``torch.distributed.init_process_group``
    over ``tcp://coordinator_address``.  Unset arguments come from the
    launcher's environment (``AUTOVC_COORD``, ``AUTOVC_NPROC``,
    ``AUTOVC_PID``, ``AUTOVC_DEVICE``); with no device anywhere the rank
    takes ``cuda:(rank % cards)`` (no card: ``RuntimeError``; ``"cpu"``
    on request).  The backend is ``nccl`` when every rank can have a card
    of its own and ``gloo`` otherwise (NCCL refuses two ranks on one
    card).  Returns this rank's device, which ``make_mesh()`` then uses."""
    env = os.environ
    coord = coordinator_address or env.get("AUTOVC_COORD")
    if coord is None:
        raise ValueError("no coordinator address: pass one or set "
                         "AUTOVC_COORD (launch_local_multiprocess does)")
    n = int(num_processes if num_processes is not None
            else env["AUTOVC_NPROC"])
    pid = int(process_id if process_id is not None else env["AUTOVC_PID"])
    device = device if device is not None else env.get("AUTOVC_DEVICE")
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", pid % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = ("nccl" if device.type == "cuda"
               and n <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=n, rank=pid)
    shd._RANK_DEVICE = device
    return device


def _data_parallel(mesh: shd.Mesh):
    """The data group and its rank count of a distributed mesh (a local
    mesh of one position: no group)."""
    if not mesh.distributed and mesh.size > 1:
        raise ValueError(
            "the data-parallel steps run one process per mesh position: "
            "launch the ranks (utils.launcher.launch_local_multiprocess), "
            "call initialize_distributed, then make_mesh()")
    return mesh.data_group, mesh.data_size


def full_specs(mesh: shd.Mesh, init: Callable, cfg):
    """The rule table's specs of the full parameter tree ``init(gen,
    cfg)`` (built on the meta device: shapes only), or None on a mesh
    without a model axis larger than 1."""
    if mesh.model_size == 1:
        return None
    with torch.device("meta"):
        return shd.param_shardings(init(torch.Generator(), cfg), mesh)


def _tensor_parallel(mesh: shd.Mesh, specs, params):
    """This rank's model axis for ``params`` (None on a data-only mesh)."""
    return None if specs is None else TP.model_axis(mesh, params, specs)


def _grads_tree(params, grads, specs, mesh: shd.Mesh):
    """The gradient tree, gathered whole on a model axis."""
    tree = tree_unflatten(params, grads)
    return tree if specs is None else shd.gather_params(tree, specs, mesh)


def _sum_over_ranks(grads, shares: dict, group) -> dict:
    """One all-reduce SUM over ``group`` (the data group) of every
    gradient (in place) and of the loss shares; returns the summed shares
    (the global loss terms)."""
    keys = list(shares)
    vals = [shares[k].detach().reshape(1).float().clone() for k in keys]
    COL.all_reduce_flat(list(grads) + vals, group)
    return {k: v[0] for k, v in zip(keys, vals)}


def make_sharded_ae_step(cfg, tx, ema_decay: float, mesh: shd.Mesh,
                         precision: str | None = None,
                         with_grads: bool = False) -> Callable:
    """The sharded AutoVC train step, ``step(params, opt_state, ema, x,
    c_org) -> (params, opt_state, ema, aux)`` with this rank's rows of the
    global batch and this rank's shards of the state; aux as
    ``loop.make_ae_step``'s, every term the global batch's
    (``with_grads``: the summed gradients, whole, as ``grads``)."""
    from autovc_tpu_torch.models import autoencoder as AE

    precision = precision or cfg.learn.precision
    group, n = _data_parallel(mesh)
    specs = full_specs(mesh, AE.init, cfg)

    def step(params, opt_state, ema, x, c_org):
        x, c_org = L._on_device(params, x, c_org)
        model = _tensor_parallel(mesh, specs, params)
        terms = {}

        def share(p):
            value, out = AE.loss(p, x, c_org, cfg, mode=precision,
                                 group=group, model=model)
            terms.update(out)
            return value / n

        _, grads = L._value_and_grads(params, share)
        aux = _sum_over_ranks(grads, {k: v / n for k, v in terms.items()},
                              group)
        if with_grads:
            aux["grads"] = _grads_tree(params, grads, specs, mesh)
        aux["grad_norm"] = tx.step(tree_leaves(params), grads, opt_state,
                                   model)
        L.ema_update(ema, params, ema_decay)
        return params, opt_state, ema, aux

    return step


def make_sharded_se_step(cfg, tx, mesh: shd.Mesh,
                         precision: str | None = None,
                         with_grads: bool = False) -> Callable:
    """The sharded GE2E step over the speaker axis, ``step(params,
    opt_state, block) -> (params, opt_state, aux)`` with this rank's
    speakers (S / N, U, frames, mels, N the data axis); aux carries the
    global ``loss`` and ``grad_norm`` (after the 0.01 scaling, before
    clipping)."""
    from autovc_tpu_torch.models import speaker_encoder as SE

    precision = precision or cfg.learn.precision
    group, n = _data_parallel(mesh)
    specs = full_specs(mesh, SE.init, cfg)

    def step(params, opt_state, block):
        model = _tensor_parallel(mesh, specs, params)
        if model is None:
            L.check_se_depth(params)
        block, = L._on_device(params, block)
        S, U, T, M = block.shape

        def share(p):
            emb = SE._forward_train(p, block.reshape(S * U, T, M),
                                    precision, model).reshape(S, U, -1)
            return SE.ge2e_loss(p, COL.all_gather(emb, group)) / n

        value, grads = L._value_and_grads(params, share)
        aux = _sum_over_ranks(grads, {"loss": value}, group)
        scaled = {id(params["similarity_weight"]),
                  id(params["similarity_bias"])}
        leaves = tree_leaves(params)
        grads = [g * 0.01 if id(p) in scaled else g
                 for p, g in zip(leaves, grads)]
        if with_grads:
            aux["grads"] = _grads_tree(params, grads, specs, mesh)
        aux["grad_norm"] = tx.step(leaves, grads, opt_state, model)
        return params, opt_state, aux

    return step


def make_sharded_vocoder_step(cfg, tx, mesh: shd.Mesh,
                              precision: str = "bf16",
                              with_grads: bool = False) -> Callable:
    """The sharded WaveRNN train step, ``step(params, opt_state, x_in, y,
    mels) -> (params, opt_state, aux)`` with this rank's rows; the
    MelResNet BatchNorms take the global batch's statistics."""
    from autovc_tpu_torch.models import wavernn as WR

    group, n = _data_parallel(mesh)
    specs = full_specs(mesh, WR.init, cfg)

    def step(params, opt_state, x_in, y, mels):
        x_in, y, mels = L._on_device(params, x_in, y, mels)
        model = _tensor_parallel(mesh, specs, params)
        value, grads = L._value_and_grads(params, lambda p: WR.loss(
            p, x_in, y, mels, cfg, train=True, mode=precision,
            group=group, model=model) / n)
        aux = _sum_over_ranks(grads, {"loss": value}, group)
        if with_grads:
            aux["grads"] = _grads_tree(params, grads, specs, mesh)
        aux["grad_norm"] = tx.step(tree_leaves(params), grads, opt_state,
                                   model)
        return params, opt_state, aux

    return step


def shard_batch(batch, mesh: shd.Mesh):
    """This rank's rows ``[d * B / N, (d + 1) * B / N)`` of a global batch
    (numpy array or tensor), d being the rank's data index and N the data
    axis (``sharding.batch_sharding``: every rank of a model row takes
    the same rows); on a local mesh, every position's rows, each on its
    position's device."""
    n, M = mesh.data_size, mesh.model_size
    if batch.shape[0] % n:
        raise ValueError(f"batch of {batch.shape[0]} rows does not split "
                         f"over {n} mesh positions")
    b = batch.shape[0] // n
    if mesh.distributed:
        d = mesh.rank // M
        return batch[d * b:(d + 1) * b]
    rows = torch.as_tensor(batch)
    return [ST.hop(rows[(i // M) * b:(i // M + 1) * b], dev, None, None)
            for i, dev in enumerate(mesh.devices)]


def on_rows(step: Callable, mesh: shd.Mesh, n_state: int) -> Callable:
    """``step`` taking the global batch: its arguments after the first
    ``n_state`` (parameters and optimizer state) cut to this rank's rows
    (:func:`shard_batch`)."""
    def run(*args):
        return step(*args[:n_state],
                    *(shard_batch(a, mesh) for a in args[n_state:]))
    return run


def pad_batch_to(batch, size: int):
    """Pad the leading axis to ``size`` (devices must divide the batch)."""
    n = batch.shape[0]
    if n == size:
        return batch, n
    pad = [(0, size - n)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(batch, pad), n


def chunk_sharded_convert(params, chunks: torch.Tensor, c_org, c_trg,
                          valid_rows, cfg, overlap: float = 0.5,
                          precision: str = "f32",
                          mesh: shd.Mesh | None = None,
                          lstm2_packed=None) -> torch.Tensor:
    """Chunk-parallel conversion with padded rows over a local mesh (None:
    every local CUDA device): the counterpart of the JAX
    ``chunk_sharded_convert`` and the ``convert(parallel="chunks")``
    backend.

    The chunk rows split over the mesh's data axis, as the JAX path's
    ``mesh.shape["data"]``, and the generator's parameters stay whole, as
    there: on a mesh with a model axis, data slice i runs once, on the
    first position of model row i (``Mesh.row_devices``).  ``chunks``
    (M_padded, n_mels, N), M_padded divisible by the data axis size n;
    rows from ``valid_rows`` (an int or a 0-d tensor: data, not shape) on
    are padding.  Slice i converts rows [i * M / n, (i + 1) * M / n) on
    its device and lane (decoder lstm2 on kernel 2 at <= 8 rows, kernel 3
    above, on CUDA); the rows gather on the first position, where the mean
    overlap-add merge takes the valid rows and sends the pad rows to its
    trash window.  ``params``: a tree (copied to each device), or one
    replica a data slice; ``lstm2_packed``: lstm2's packed kernel weights
    at ``precision`` (None: packed per call), copied to each device.
    ``c_org`` / ``c_trg``: (1, emb).  Returns the merged (n_mels, N +
    (M_padded - 1) * step) mel on the padded timeline: keep its first N +
    (valid_rows - 1) * step frames."""
    from autovc_tpu_torch.models import autoencoder as AE
    from autovc_tpu_torch.ops import precision as PREC

    mesh = mesh or shd.make_mesh()
    if mesh.distributed:
        raise ValueError("chunk_sharded_convert runs over a local mesh")
    devices = mesh.row_devices
    n = len(devices)
    M, n_mels, N = chunks.shape
    if M % n:
        raise ValueError(f"{M} chunk rows do not split over {n} positions; "
                         f"pad them to a multiple of {n}")
    if not isinstance(params, list):
        on = {d: shd.tree_to(params, d) for d in set(devices)}
        params = [on[d] for d in devices]
    packed = {d: shd.tree_to(lstm2_packed, d) for d in set(devices)}
    out_dev = devices[0]
    lanes = ST.lanes(devices, {chunks.device, out_dev})
    b = M // n
    rows_out = []
    for i, (dev, lane) in enumerate(zip(devices, lanes)):
        x = ST.hop(chunks[i * b:(i + 1) * b], dev, None, lane)
        co = ST.hop(c_org.reshape(1, -1), dev, None, lane)
        ct = ST.hop(c_trg.reshape(1, -1), dev, None, lane)
        with ST.on(lane):
            mode = PREC.resolve(precision, dev)
            _, post, _ = AE.forward(params[i], x, co.expand(b, -1),
                                    ct.expand(b, -1), cfg, mode, packed[dev])
        rows_out.append(ST.hop(post, out_dev, lane, None))
    ST.join(lanes, out_dev, rows_out)
    mel_rows = torch.cat(rows_out, dim=0)
    step = int(N * (1 - overlap))
    total = N + (M - 1) * step
    idx = torch.arange(M, device=out_dev)
    offsets = torch.where(idx < torch.as_tensor(valid_rows, device=out_dev),
                          idx * step, total)
    return AE.merge_rows(mel_rows, offsets, total)
