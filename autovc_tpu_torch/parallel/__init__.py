"""Multi-device runs of the port (counterpart of ``autovc_tpu/parallel``):
the mesh and the tensor-parallel rule table (:mod:`.sharding`), the
cross-rank operations (:mod:`.collectives`), the data-parallel steps and
the chunk-sharded conversion (:mod:`.steps`), the sequence-parallel ring
(:mod:`.ring`) and the stage pipeline (:mod:`.pipeline`).

JAX runs every multi-device path from one process over a mesh of devices,
GSPMD inserting the collectives.  The port splits that in two, both on the
one :class:`~.sharding.Mesh` type:

* **Serving runs in one process over a list of local devices**:
  ``convert(parallel="chunks" | "ring")`` and
  ``convert_batch(parallel="pipeline")``.  ``Mesh.devices`` holds one
  ``torch.device`` per position, and positions may repeat a device
  (``[cuda:0] * 2``, ``[cpu] * 4``), which plays the part of JAX's forced
  host device count: the CPU tests and a single card get more than one
  position that way.  Each position computes on a CUDA stream of its own
  and data moves between positions with ``tensor.to(device,
  non_blocking=True)`` after the receiving stream waits for the sending
  one (:mod:`.streams`).  A pipeline stage computes on the first device
  of its group.
* **Data-parallel training runs one process per position over
  ``torch.distributed``**: ``train_*(mesh=)`` and the
  ``make_sharded_*_step`` functions.  ``steps.initialize_distributed``
  joins the process group over ``tcp://`` (the launcher's
  ``AUTOVC_COORD`` / ``AUTOVC_NPROC`` / ``AUTOVC_PID``), on ``nccl`` when
  every rank has a card of its own and ``gloo`` otherwise (two ranks on one
  card; NCCL refuses that); ``make_mesh()`` then has one position per
  rank.  Every rank draws the same seeded global batch and takes its rows;
  only rank 0 saves and logs.

``make_mesh()`` with neither a process group nor ``devices`` takes every
local CUDA device and raises without one: there is no CPU fallback (the
tests pass ``devices=[torch.device("cpu")] * n``).  A ``"model"`` axis
larger than 1 (tensor parallelism) raises ``NotImplementedError``: the
port carries the rule table, not the computation (ROADMAP, Queue 1).
"""
from autovc_tpu_torch.parallel.sharding import (Mesh, make_mesh,
                                                param_shardings, replicated,
                                                shard_params)

__all__ = ["Mesh", "make_mesh", "param_shardings", "replicated",
           "shard_params"]
