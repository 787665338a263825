"""Learning-rate schedules and the optimizer (counterpart of
``autovc_tpu/train/schedules.py``).

The schedules are plain functions of the update count.  :func:`make_optimizer`
is the JAX package's optax chain written out in PyTorch, update for update:

  * ``optax.clip_by_global_norm(max_norm)``: with the global norm g of all
    gradients, each gradient becomes ``t / g * max_norm`` when ``g >=
    max_norm`` and stays as it is otherwise (``torch.nn.utils.
    clip_grad_norm_`` adds 1e-6 to the norm and is not the same);
  * ``optax.scale_by_adam(b1, b2, eps)``: ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, bias-corrected by ``1 - b^count`` (count
    after this update) and ``mu_hat / (sqrt(nu_hat) + eps)``, eps outside
    the square root;
  * ``optax.add_decayed_weights(weight_decay)`` when it is set;
  * ``optax.scale_by_learning_rate(schedule)``: times ``-schedule(count)``,
    count being the number of updates BEFORE this one.

The state is ``{"count", "mu", "nu"}`` with ``mu``/``nu`` lists in the
order of the leaves given to :meth:`Optimizer.init`.

Under tensor parallelism (``model=``, a ``parallel.tensor.ModelAxis``)
the leaves are this rank's shards: the global norm sums the squares of
the sharded leaves over the model group and counts the replicated ones
once, so the clip and ``grad_norm`` are those of the full tree; Adam and
the weight decay are elementwise and run on the shards as they are.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from autovc_tpu_torch.config import OptimizerConfig
from autovc_tpu_torch.parallel import collectives as COL


def noam_schedule(base_lr: float, dim_model: int, n_warmup_steps: int):
    """lr(step) = base_lr * dim^-0.5 * min(step^-0.5, step * warmup^-1.5),
    step counted from 1."""

    def schedule(step):
        s = step + 1.0
        return (base_lr * dim_model ** -0.5
                * min(s ** -0.5, s * n_warmup_steps ** -1.5))

    return schedule


def exponential_per_epoch(base_lr: float, gamma: float,
                          steps_per_epoch: int):
    """ExponentialLR stepped once per epoch (the reference AE behaviour)."""

    def schedule(step):
        return base_lr * gamma ** (step // max(steps_per_epoch, 1))

    return schedule


def make_schedule(cfg: OptimizerConfig, steps_per_epoch: int,
                  dim_model: int = 80) -> Callable[[int], float]:
    if cfg.lr_scheduler in ("exponential", "ExponentialLR"):
        return exponential_per_epoch(cfg.lr, cfg.gamma, steps_per_epoch)
    if cfg.lr_scheduler in ("noam", "NoamScheduler"):
        return noam_schedule(cfg.lr, dim_model, cfg.n_warmup_steps)
    if cfg.lr_scheduler in (None, "none", "constant"):
        return lambda step: cfg.lr
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


class Optimizer:
    """clip -> Adam -> (weight decay) -> -lr, applied in place."""

    def __init__(self, schedule: Callable[[int], float], b1: float,
                 b2: float, eps: float, grad_clip_norm: float | None,
                 weight_decay: float = 0.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor],
             grad_norm: torch.Tensor) -> List[torch.Tensor]:
        """``optax.clip_by_global_norm``, given the global norm."""
        if not self.grad_clip_norm:
            return grads
        keep = grad_norm < self.grad_clip_norm
        return [torch.where(keep, g, g / grad_norm * self.grad_clip_norm)
                for g in grads]

    @staticmethod
    @torch.no_grad()
    def global_norm(params: Sequence[torch.Tensor],
                    grads: List[torch.Tensor], model=None) -> torch.Tensor:
        """The global norm of ``grads``; with ``model``, of the full tree
        whose shards are the leaves of ``params`` it holds (module
        docstring)."""
        if model is None:
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))
        split = [torch.sum(g * g) for p, g in zip(params, grads)
                 if model.of(p) is not None]
        whole = [torch.sum(g * g) for p, g in zip(params, grads)
                 if model.of(p) is None]
        sq = grads[0].new_zeros(1) + sum(split)
        COL.all_reduce_flat([sq], model.group)
        return torch.sqrt(sq[0] + sum(whole))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: List[torch.Tensor], state: dict,
             model=None) -> torch.Tensor:
        """One update of ``params`` (in place) and ``state``; returns the
        global norm of ``grads`` before clipping (``model``: module
        docstring)."""
        grad_norm = self.global_norm(params, grads, model)
        grads = self.clip(grads, grad_norm)
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        dev = grads[0].device
        bc1 = 1 - torch.tensor(self.b1, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, device=dev) ** count
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(torch.tensor(-lr, dtype=u.dtype, device=dev) * u)
        state["count"] = count
        return grad_norm


def make_optimizer(cfg: OptimizerConfig, steps_per_epoch: int,
                   dim_model: int = 80) -> Optimizer:
    """Adam + global-norm clip + schedule, mirroring the reference setup
    (auto_encoder/model.py:279-318): clip(max_norm) -> Adam(betas, eps)."""
    return Optimizer(make_schedule(cfg, steps_per_epoch, dim_model),
                     cfg.betas[0], cfg.betas[1], cfg.eps, cfg.grad_clip_norm,
                     cfg.weight_decay)
