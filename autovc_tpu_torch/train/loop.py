"""AutoVC generator training (counterpart of ``autovc_tpu/train/loop.py``'s
``ema_update``, ``make_ae_step`` and ``train_autoencoder``).

The JAX step is a pure jitted function; here it runs eagerly and updates
in place: the parameters and the optimizer moments (under ``no_grad``),
the BatchNorm running statistics (inside the forward, see
:func:`autovc_tpu_torch.ops.conv.batchnorm1d`) and the EMA.  The step
returns the same trees it was given, so the JAX signatures hold.  As in
the JAX package the optimizer sees every leaf of the tree, BatchNorm
statistics included (their gradient is zero, so Adam leaves them where
the forward put them), and the EMA covers the whole tree.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

from autovc_tpu_torch.config import AutoEncoderConfig
from autovc_tpu_torch.train import schedules
from autovc_tpu_torch.utils import (close_progbar, progbar, tree_clone,
                                    tree_leaves)


@torch.no_grad()
def ema_update(ema, params, decay: float):
    """``e = decay * e + (1 - decay) * p`` for every leaf, in place."""
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        e.copy_(decay * e + (1.0 - decay) * p)
    return ema


def loss_and_grads(params, x, c_org, cfg: AutoEncoderConfig,
                   precision: str):
    """``AE.loss`` in training mode and its gradient with respect to every
    leaf of ``params`` (``tree_leaves`` order; zeros for the BatchNorm
    statistics).  ``x`` (B, n_mels, T) and ``c_org`` (B, emb) are numpy
    arrays or tensors; they go to the parameters' device.  Returns
    (aux of detached device scalars, gradients)."""
    from autovc_tpu_torch.models import autoencoder as AE

    leaves = tree_leaves(params)
    dev = leaves[0].device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    c_org = torch.as_tensor(c_org, dtype=torch.float32, device=dev)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, aux = AE.loss(params, x, c_org, cfg, mode=precision)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return {k: v.detach() for k, v in aux.items()}, grads


def make_ae_step(cfg: AutoEncoderConfig, tx: schedules.Optimizer,
                 ema_decay: float, precision: str | None = None) -> Callable:
    """AutoVC train step.  ``precision`` ("bf16" by default, from
    ``cfg.learn.precision``) is the matmul/conv policy; parameters,
    gradients, Adam moments, EMA and BatchNorm statistics stay f32.
    ``step(params, opt_state, ema, x, c_org) -> (params, opt_state, ema,
    aux)``; aux carries ``loss``, ``loss_recon``, ``loss_recon0``,
    ``loss_content`` and ``grad_norm`` (before clipping), all device
    scalars."""
    precision = precision or cfg.learn.precision

    def step(params, opt_state, ema, x, c_org):
        aux, grads = loss_and_grads(params, x, c_org, cfg, precision)
        aux["grad_norm"] = tx.step(tree_leaves(params), grads, opt_state)
        ema_update(ema, params, ema_decay)
        return params, opt_state, ema, aux

    return step


def _restore(blob, params, opt_state):
    """Parameters, EMA and optimizer state from a checkpoint payload, on
    the device of ``params``."""
    from autovc_tpu_torch.utils.bridge import from_jax_params
    dev = tree_leaves(params)[0].device
    params = from_jax_params(blob["params"], dev, torch.float32)
    ema = (from_jax_params(blob["ema_params"], dev, torch.float32)
           if "ema_params" in blob else tree_clone(params))
    saved = blob.get("opt_state")
    if isinstance(saved, dict) and {"count", "mu", "nu"} <= set(saved):
        opt_state = {"count": int(saved["count"]),
                     "mu": from_jax_params(saved["mu"], dev, torch.float32),
                     "nu": from_jax_params(saved["nu"], dev, torch.float32)}
    return params, ema, opt_state


def train_autoencoder(params, dataset, cfg: AutoEncoderConfig,
                      n_epochs: int | None = None,
                      batch_size: int | None = None,
                      log_freq: int | None = None,
                      save_freq: int | None = None,
                      model_name: str | None = None,
                      save_dir: str | None = None,
                      ema_decay: float | None = None,
                      logger=None, verbose: bool = True,
                      on_epoch_end: Callable | None = None,
                      start_step: int = 0, resume: bool = False,
                      opt_overrides: Dict[str, Any] | None = None,
                      precision: str | None = None, mesh=None):
    """AutoVC training (auto_encoder/model.py:218-361).  Returns
    (params, ema_params, info-dict).

    ``resume=True`` restores params + EMA + optimizer state + step from the
    newest checkpoint in ``save_dir``.  The loss stays on the device and is
    pulled to the host once per ``log_freq`` window.  ``mesh`` (the
    data-parallel loop) is not ported."""
    if mesh is not None:
        raise NotImplementedError("the data-parallel training loop (mesh=) "
                                  "is not ported yet (ROADMAP, Next)")
    lc, oc = cfg.learn, cfg.optimizer
    if opt_overrides:
        oc = oc.with_overrides(**opt_overrides)
    n_epochs = n_epochs if n_epochs is not None else lc.n_epochs
    batch_size = batch_size if batch_size is not None else lc.batch_size
    log_freq = log_freq if log_freq is not None else lc.log_freq
    save_freq = save_freq if save_freq is not None else lc.save_freq
    ema_decay = ema_decay if ema_decay is not None else lc.ema_decay
    # None -> config default; '' -> saving disabled
    model_name = lc.model_name if model_name is None else model_name
    save_dir = lc.save_dir if save_dir is None else save_dir

    steps_per_epoch = dataset.epoch_steps(batch_size)
    lr_schedule = schedules.make_schedule(oc, steps_per_epoch, dim_model=80)
    tx = schedules.make_optimizer(oc, steps_per_epoch, dim_model=80)
    opt_state = tx.init(tree_leaves(params))
    ema = tree_clone(params)

    if resume:
        from autovc_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                       load_checkpoint)
        latest = latest_checkpoint(save_dir)
        if latest is not None:
            blob = load_checkpoint(latest)
            params, ema, opt_state = _restore(blob, params, opt_state)
            start_step = int(blob.get("step", start_step) or 0)
            if verbose:
                print(f"Resumed from '{latest}' at step {start_step}")

    step_fn = make_ae_step(cfg, tx, ema_decay, precision=precision)
    n_total = n_epochs * steps_per_epoch
    step = start_step
    loss_hist, t_start = [], time.time()
    for epoch in range(1, n_epochs + 1):
        for x, c in dataset.batches(batch_size, shuffle=True, seed=epoch):
            params, opt_state, ema, aux = step_fn(params, opt_state, ema,
                                                  x, c)
            step += 1
            # the loss stays a device scalar: pulling it every step would
            # synchronise the host with the device every step
            loss_hist.append(aux["loss"])
            if len(loss_hist) > max(log_freq, 1):
                loss_hist.pop(0)        # bounded when no logger consumes
            if verbose:
                progbar(step - start_step, n_total, {
                    "sec/step": round((time.time() - t_start)
                                      / (step - start_step), 2)})
            if logger is not None and (step % log_freq == 0
                                       or step - start_step == n_total):
                logger.log({"loss": float(torch.stack(loss_hist).mean()),
                            "loss_recon": float(aux["loss_recon"]),
                            "loss_content": float(aux["loss_content"]),
                            "grad_norm": float(aux["grad_norm"]),
                            "learning_rate": float(lr_schedule(step)),
                            "epoch": epoch, "step": step}, step=step)
                loss_hist = []
        if (epoch % save_freq == 0 or epoch == n_epochs) and model_name:
            from autovc_tpu_torch.utils.checkpoint import save_checkpoint
            save_checkpoint(f"{save_dir.rstrip('/')}/{model_name}",
                            {"step": step, "params": params,
                             "ema_params": ema, "opt_state": opt_state})
        if on_epoch_end is not None:
            on_epoch_end(epoch, params)
    if verbose:
        close_progbar()
    return params, ema, {"step": step, "opt_state": opt_state}
