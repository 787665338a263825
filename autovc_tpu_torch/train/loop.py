"""Training loops (counterpart of ``autovc_tpu/train/loop.py``'s
``ema_update``, ``make_ae_step``, ``train_autoencoder``, ``make_se_step``,
``train_speaker_encoder``, ``make_vocoder_step`` and ``train_vocoder``).

The JAX steps are pure jitted functions; here they run eagerly and update
in place: the parameters and the optimizer moments (under ``no_grad``),
the BatchNorm running statistics (inside the forward, see
:func:`autovc_tpu_torch.ops.conv.batchnorm1d`) and the EMA.  The steps
return the same trees they were given, so the JAX signatures hold.  As in
the JAX package the optimizer sees every leaf of the tree, BatchNorm
statistics included (their gradient is zero, so Adam leaves them where
the forward put them), and the AutoVC EMA covers the whole tree.

At each save epoch the loops do what the JAX loops do, in their order:
the checkpoint is saved asynchronously (``save_checkpoint(block=False)``,
waited for before the loop returns), and a logger that has the
``MetricsLogger`` methods gets the parameter (and, for the generator,
gradient) histograms and a figure: the generator's original-vs-
reconstruction mel, the speaker encoder's embedding TSNE.  A figure whose
plotting package (matplotlib, scikit-learn) is missing is skipped, with
the reason printed when ``verbose``.  A logger with only ``log`` gets the
scalars alone.

``mesh=`` makes a loop sharded over ``torch.distributed``: every rank
(one process per mesh position, ``parallel.steps.initialize_distributed``
then ``parallel.sharding.make_mesh()``) calls the loop with the same
arguments and draws the same seeded global batches, steps on its data
index's rows (``parallel.steps.make_sharded_*_step``: sync BatchNorm, one
all-reduce of the gradients over the data group, the same update on
every rank of it), and only rank 0 logs, saves, histograms and runs
``on_epoch_end``, so a run writes each file once.  On a mesh with a
``"model"`` axis each rank holds its shards of the parameters, the EMA
and the Adam state (``parallel.sharding.shard_params``); every save
epoch, and every epoch when ``on_epoch_end`` is given, each rank first
takes part in ``parallel.sharding.gather_params``, so that rank 0 writes
and logs the full tree: the checkpoint has the one-process layout, and a
resume loads the full tree and shards it.  The loops return the full
trees.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from autovc_tpu_torch.config import (AutoEncoderConfig, OptimizerConfig,
                                     SpeakerEncoderConfig, WaveRNNConfig)
from autovc_tpu_torch.ops import lstm_train_kernels as LT
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.train import schedules
from autovc_tpu_torch.utils import (close_progbar, progbar, tree_clone,
                                    tree_leaves, tree_unflatten)
from autovc_tpu_torch.utils.bridge import from_jax_params
from autovc_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint,
                                               wait_for_saves)


@torch.no_grad()
def ema_update(ema, params, decay: float):
    """``e = decay * e + (1 - decay) * p`` for every leaf, in place."""
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        e.copy_(decay * e + (1.0 - decay) * p)
    return ema


def _value_and_grads(params, fn):
    """``fn(params)`` (a scalar tensor) and its gradient with respect to
    every leaf of ``params`` (``tree_leaves`` order; zeros for the leaves
    it does not reach, such as the BatchNorm statistics)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        value = fn(params)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return value, [torch.zeros_like(p) if g is None else g
                   for g, p in zip(grads, leaves)]


def _on_device(params, *arrays):
    dev = tree_leaves(params)[0].device
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays]


def loss_and_grads(params, x, c_org, cfg: AutoEncoderConfig,
                   precision: str):
    """``AE.loss`` in training mode and its gradient with respect to every
    leaf of ``params`` (``tree_leaves`` order; zeros for the BatchNorm
    statistics).  ``x`` (B, n_mels, T) and ``c_org`` (B, emb) are numpy
    arrays or tensors; they go to the parameters' device.  Returns
    (aux of detached device scalars, gradients)."""
    from autovc_tpu_torch.models import autoencoder as AE

    x, c_org = _on_device(params, x, c_org)
    aux = {}

    def total(p):
        value, out = AE.loss(p, x, c_org, cfg, mode=precision)
        aux.update(out)
        return value

    _, grads = _value_and_grads(params, total)
    return {k: v.detach() for k, v in aux.items()}, grads


def make_ae_step(cfg: AutoEncoderConfig, tx: schedules.Optimizer,
                 ema_decay: float, precision: str | None = None,
                 with_grads: bool = False) -> Callable:
    """AutoVC train step.  ``precision`` ("bf16" by default, from
    ``cfg.learn.precision``) is the matmul/conv policy; parameters,
    gradients, Adam moments, EMA and BatchNorm statistics stay f32.
    ``step(params, opt_state, ema, x, c_org) -> (params, opt_state, ema,
    aux)``; aux carries ``loss``, ``loss_recon``, ``loss_recon0``,
    ``loss_content`` and ``grad_norm`` (before clipping), all device
    scalars, and with ``with_grads`` the raw (pre-clip) gradients as
    ``grads``, a tree of ``params``' structure, for the histograms."""
    precision = precision or cfg.learn.precision

    def step(params, opt_state, ema, x, c_org):
        aux, grads = loss_and_grads(params, x, c_org, cfg, precision)
        if with_grads:
            aux["grads"] = tree_unflatten(params, grads)
        aux["grad_norm"] = tx.step(tree_leaves(params), grads, opt_state)
        ema_update(ema, params, ema_decay)
        return params, opt_state, ema, aux

    return step


def _adam_state(saved):
    """The Adam state ``{count, mu, nu}`` inside a saved optimizer state:
    the port's own dict, or the JAX package's optax chain (a tuple of
    states, one of them Adam's, with ``mu``/``nu`` parameter trees)."""
    if isinstance(saved, dict):
        return saved if {"count", "mu", "nu"} <= set(saved) else None
    if isinstance(saved, (list, tuple)):
        for s in saved:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _restore(blob, params, opt_state):
    """Parameters, EMA and optimizer state from a checkpoint payload of
    either package, on the device of ``params``."""
    dev = tree_leaves(params)[0].device
    params = from_jax_params(blob["params"], dev, torch.float32)
    ema = (from_jax_params(blob["ema_params"], dev, torch.float32)
           if "ema_params" in blob else tree_clone(params))
    adam = _adam_state(blob.get("opt_state"))
    if adam is not None:
        opt_state = {"count": int(adam["count"]), **{
            k: tree_leaves(from_jax_params(adam[k], dev, torch.float32))
            for k in ("mu", "nu")}}
    return params, ema, opt_state


class _OnMesh:
    """What a loop does on its ``mesh`` (None: nothing).  ``params``: the
    parameters, whole, on this rank's device; ``main``: whether this rank
    logs and saves (rank 0, or the one position of a local mesh);
    ``verbose``: the other ranks run quiet.  On a model axis, ``shard``
    cuts a parameter tree (or an Adam state of one) to this rank's blocks
    and ``gather`` rebuilds it whole, a collective that every rank
    calls; elsewhere both return what they are given."""

    def __init__(self, mesh, params, verbose: bool):
        self.mesh, self.specs = mesh, None
        self.main, self.verbose, self.params = True, verbose, params
        if mesh is None:
            return
        self.params = shd.tree_to(params, mesh.local_devices[0])
        self.main = not mesh.rank
        self.verbose = verbose and self.main
        if mesh.model_size > 1:
            self.specs = shd.param_shardings(self.params, mesh)

    def shard(self, tree, like=None):
        """``tree`` (or, with ``like`` its parameter tree, an Adam state
        ``{count, mu, nu}`` of it) cut to this rank's blocks."""
        if self.specs is None:
            return tree
        M = self.mesh.model_size
        m = (self.mesh.rank or 0) % M
        if like is not None:
            return {**tree, **{k: tree_leaves(self.shard(tree_unflatten(
                like, tree[k]))) for k in ("mu", "nu")}}
        return shd.shard_tree(tree, self.specs, m, M)

    def gather(self, tree, like=None):
        """The whole ``tree`` (or Adam state, as for :meth:`shard`)."""
        if self.specs is None:
            return tree
        if like is not None:
            return {**tree, **{k: tree_leaves(self.gather(tree_unflatten(
                like, tree[k]))) for k in ("mu", "nu")}}
        return shd.gather_params(tree, self.specs, self.mesh)


def _log_figure(logger, name: str, draw: Callable, step: int,
                verbose: bool) -> None:
    """``logger.log_figure(name, draw())`` for a logger that has the
    method; skipped, with the reason printed when ``verbose``, where
    ``draw`` finds its plotting package missing."""
    log_figure = getattr(logger, "log_figure", None)
    if log_figure is None:
        return
    try:
        fig = draw()
    except ImportError as e:
        if verbose:
            print(f"[metrics] figure skipped: {e}")
        return
    log_figure(name, fig, step=step)


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
    pulled to the host once per ``log_freq`` window.  At each save epoch
    (every ``save_freq``-th and the last): the asynchronous save (with
    ``model_name``), the ``params`` and ``grads`` histograms (the last
    step's raw gradients), the reconstruction figure of the last batch's
    first row, then ``on_epoch_end(epoch, params)`` (every epoch).

    ``mesh``: the sharded loop (module docstring;
    ``parallel.steps.make_sharded_ae_step``: global batch statistics and
    gradients); ``batch_size`` must divide by the mesh's 'data' axis."""
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
    # the gradient tree rides in aux only for a logger that histograms it
    # (decided before the other ranks drop the logger: a mesh's ranks
    # gather the gradients together)
    hist = getattr(logger, "log_tree_histograms", None)
    with_grads, each_epoch = hist is not None, on_epoch_end is not None
    saving = bool(model_name)
    if mesh is not None:
        assert batch_size % mesh.shape["data"] == 0, \
            f"batch_size {batch_size} must divide mesh 'data' axis " \
            f"{mesh.shape['data']}"
    run = _OnMesh(mesh, params, verbose)
    params, verbose = run.params, run.verbose
    if not run.main:
        logger, model_name, on_epoch_end, hist = None, "", None, None

    steps_per_epoch = dataset.epoch_steps(batch_size)
    lr_schedule = schedules.make_schedule(oc, steps_per_epoch, dim_model=80)
    tx = schedules.make_optimizer(oc, steps_per_epoch, dim_model=80)
    opt_state = tx.init(tree_leaves(params))
    ema = tree_clone(params)

    if resume:
        latest = latest_checkpoint(save_dir)
        if latest is not None:
            blob = load_checkpoint(latest)
            params, ema, opt_state = _restore(blob, params, opt_state)
            start_step = int(blob.get("step", start_step) or 0)
            if verbose:
                print(f"Resumed from '{latest}' at step {start_step}")
    full = params
    params, ema = run.shard(params), run.shard(ema)
    opt_state = run.shard(opt_state, full)

    if mesh is not None:
        from autovc_tpu_torch.parallel import steps as psteps
        step_fn = psteps.on_rows(psteps.make_sharded_ae_step(
            cfg, tx, ema_decay, mesh, precision=precision,
            with_grads=with_grads), mesh, 3)
    else:
        step_fn = make_ae_step(cfg, tx, ema_decay, precision=precision,
                               with_grads=hist is not None)
    n_total = n_epochs * steps_per_epoch
    step = start_step
    loss_hist, t_start = [], time.time()
    x = c = None   # the last batch, for the reconstruction figure
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
        save_epoch = epoch % save_freq == 0 or epoch == n_epochs
        if save_epoch or each_epoch:
            full = run.gather(params)
        if save_epoch and saving:
            payload = {"step": step, "params": full,
                       "ema_params": run.gather(ema),
                       "opt_state": run.gather(opt_state, params)}
            if model_name:
                save_checkpoint(f"{save_dir.rstrip('/')}/{model_name}",
                                payload, block=False)
        if logger is not None and x is not None and save_epoch:
            if hist is not None:
                hist("params", full, step=step)
                hist("grads", aux["grads"], step=step)
            _log_figure(logger, "mel_reconstruction", functools.partial(
                _reconstruction_figure, full, x, c, cfg), step, verbose)
        if on_epoch_end is not None:
            on_epoch_end(epoch, full)
    wait_for_saves()
    if verbose:
        close_progbar()
    return run.gather(params), run.gather(ema), {
        "step": step, "opt_state": run.gather(opt_state, params)}


def _reconstruction_figure(params, x, c, cfg: AutoEncoderConfig):
    """The original-vs-reconstruction mel figure of the first row of a
    batch, from an eval-mode f32 forward (auto_encoder/model.py:371-374,
    439-450)."""
    from autovc_tpu_torch.models import autoencoder as AE
    from autovc_tpu_torch.utils import visual
    x1, c1 = _on_device(params, x[:1], c[:1])
    with torch.no_grad():
        _, post, _ = AE.forward(params, x1, c1, c1, cfg)
    return visual.plot_conversion(x1[0].cpu().numpy(), post[0].cpu().numpy())


def se_loss_and_grads(params, batch, precision: str):
    """``SE.batch_ge2e_loss`` of a mel block (S, U, frames, mels; a numpy
    array or tensor, moved to the parameters' device) and its gradient
    with respect to every leaf of ``params``.  Returns (detached device
    loss, gradients)."""
    from autovc_tpu_torch.models import speaker_encoder as SE

    batch, = _on_device(params, batch)
    value, grads = _value_and_grads(params, lambda p: SE.batch_ge2e_loss(
        p, batch, precision))
    return value.detach(), grads


def make_se_step(cfg: SpeakerEncoderConfig, tx: schedules.Optimizer,
                 precision: str | None = None) -> Callable:
    """GE2E train step: ``step(params, opt_state, batch) -> (params,
    opt_state, aux)``.  ``precision`` ("bf16" by default, from
    ``cfg.learn.precision``) is the matmul / recurrence policy; parameters,
    gradients and Adam moments stay f32.  The similarity weight's and
    bias's gradients are scaled by 0.01 before the optimizer, so aux's
    ``grad_norm`` (with ``loss``, device scalars) is the norm after that
    scaling and before clipping, as in the JAX step."""
    precision = precision or cfg.learn.precision

    def step(params, opt_state, batch):
        loss, grads = se_loss_and_grads(params, batch, precision)
        scaled = {id(params["similarity_weight"]),
                  id(params["similarity_bias"])}
        leaves = tree_leaves(params)
        grads = [g * 0.01 if id(p) in scaled else g
                 for p, g in zip(leaves, grads)]
        grad_norm = tx.step(leaves, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return step


def check_se_depth(params) -> None:
    """Raise when a speaker encoder on CUDA is deeper than kernel 7 carries
    (``lstm_train_kernels.MAX_LAYERS``); the CPU path has no limit."""
    if tree_leaves(params)[0].device.type == "cuda":
        LT.check_depth(len(params["lstm"]))


def optax_layout(opt_state, params, oc: OptimizerConfig) -> list:
    """The optimizer state in the JAX package's optax chain layout: one
    entry for each transformation of ``schedules.make_optimizer`` (clip,
    Adam with ``mu`` / ``nu`` as parameter trees, weight decay, the
    schedule's count), which the JAX loops' ``restore_like`` rebuilds and
    :func:`_restore` reads back."""
    count = np.asarray(opt_state["count"], np.int32)
    adam = {"count": count,
            "mu": tree_unflatten(params, opt_state["mu"]),
            "nu": tree_unflatten(params, opt_state["nu"])}
    return (([{}] if oc.grad_clip_norm else []) + [adam]
            + ([{}] if oc.weight_decay else []) + [{"count": count}])


def train_speaker_encoder(params, dataset, cfg: SpeakerEncoderConfig,
                          n_epochs: int | None = None,
                          utterances_per_speaker: int = 8,
                          steps_per_epoch: int = 8,
                          log_freq: int | None = None,
                          save_freq: int | None = None,
                          model_name: str | None = None,
                          save_dir: str | None = None,
                          logger=None, verbose: bool = True,
                          speakers: Dict[str, np.ndarray] | None = None,
                          start_step: int = 0, resume: bool = False,
                          opt_overrides: Dict[str, Any] | None = None,
                          mesh=None):
    """GE2E training (speaker_encoder/model.py:276-408).  Returns (params,
    info-dict).

    ``dataset.batches(utterances_per_speaker, n_batches=steps_per_epoch,
    seed=epoch)`` gives the (S, U, frames, mels) blocks.  The loss stays on
    the device and is pulled to the host only at the steps that log it.
    At each save epoch the loop logs ``eer`` from the last block's
    similarity matrix (an f32 forward) and, with ``model_name``, saves
    ``{step, params, speakers, opt_state}``, the optimizer state in the
    JAX chain's layout, so the JAX loop resumes it too.  ``resume=True``
    restores params, the Adam state and the step from the newest
    checkpoint in ``save_dir`` (either package's) and updates
    ``speakers`` from it.

    The save epoch logs, in the JAX loop's order, the EER, the
    ``params`` histograms, saves asynchronously and logs the TSNE figure
    of the last block's embeddings; the loop waits for its saves before it
    returns.  On CUDA the stack runs kernels 6/7, which carry at most
    ``lstm_train_kernels.MAX_LAYERS`` = 4 layers: a deeper speaker
    encoder raises here, before any batch is drawn.

    ``mesh``: the sharded loop over the speaker axis of the blocks
    (module docstring; ``parallel.steps.make_sharded_se_step``: the GE2E
    loss of the gathered block).  On a model axis the stack runs the
    per-step tensor-parallel loop, which has no depth limit."""
    run = _OnMesh(mesh, params, verbose)
    params, verbose = run.params, run.verbose
    if run.specs is None:
        check_se_depth(params)
    from autovc_tpu_torch.models import speaker_encoder as SE
    lc, oc = cfg.learn, cfg.optimizer
    if opt_overrides:
        oc = oc.with_overrides(**opt_overrides)
    n_epochs = n_epochs if n_epochs is not None else lc.n_epochs
    log_freq = log_freq if log_freq is not None else lc.log_freq
    save_freq = save_freq if save_freq is not None else lc.save_freq
    model_name = lc.model_name if model_name is None else model_name
    save_dir = lc.save_dir if save_dir is None else save_dir
    # what rank 0 does at a save epoch, which every rank's gathers match
    gathering = logger is not None or bool(model_name)
    if not run.main:
        logger, model_name = None, ""

    tx = schedules.make_optimizer(oc, steps_per_epoch,
                                  dim_model=cfg.embedding_size)
    opt_state = tx.init(tree_leaves(params))
    if resume:
        latest = latest_checkpoint(save_dir)
        if latest is not None:
            blob = load_checkpoint(latest)
            params, _, opt_state = _restore(blob, params, opt_state)
            start_step = int(blob.get("step", start_step) or 0)
            if speakers is not None:
                speakers.update(blob.get("speakers", {}))
            if verbose:
                print(f"Resumed from '{latest}' at step {start_step}")
    if tree_leaves(params)[0].device.type == "cuda":
        PREC.exact_f32()
    full = params
    params, opt_state = run.shard(params), run.shard(opt_state, full)

    if mesh is not None:
        from autovc_tpu_torch.parallel import steps as psteps
        step_fn = psteps.on_rows(psteps.make_sharded_se_step(cfg, tx, mesh),
                                 mesh, 2)
    else:
        step_fn = make_se_step(cfg, tx)
    n_total = n_epochs * steps_per_epoch
    step = start_step
    for epoch in range(1, n_epochs + 1):
        for batch in dataset.batches(utterances_per_speaker,
                                     n_batches=steps_per_epoch, seed=epoch):
            params, opt_state, aux = step_fn(params, opt_state, batch)
            step += 1
            log_now = step % max(log_freq, 1) == 0
            if verbose:
                progbar(step - start_step, n_total,
                        {"loss": round(float(aux["loss"]), 4)}
                        if log_now else {})
            if logger is not None and log_now:
                logger.log({"loss": float(aux["loss"]),
                            "grad_norm": float(aux["grad_norm"]),
                            "epoch": epoch, "step": step}, step=step)
        save_epoch = epoch % save_freq == 0 or epoch == n_epochs
        if save_epoch and gathering:
            full = run.gather(params)
            full_opt = run.gather(opt_state, params)
        if logger is not None and save_epoch:
            S, U = batch.shape[:2]
            rows, = _on_device(full, batch.reshape(S * U, *batch.shape[2:]))
            with torch.no_grad():
                emb = SE.forward(full, rows).reshape(S, U, -1)
                sim = SE.similarity_matrix(full, emb)
            logger.log({"eer": SE.equal_error_rate(sim.cpu().numpy()),
                        "epoch": epoch, "step": step}, step=step)
            hist = getattr(logger, "log_tree_histograms", None)
            if hist is not None:
                hist("params", full, step=step)
        if save_epoch and model_name:
            save_checkpoint(f"{save_dir.rstrip('/')}/{model_name}",
                            {"step": step, "params": full,
                             "speakers": speakers or {},
                             "opt_state": optax_layout(full_opt, full,
                                                       oc)}, block=False)
        if logger is not None and save_epoch:
            from autovc_tpu_torch.utils import visual
            _log_figure(logger, "embedding_tsne", functools.partial(
                visual.visualise_embedding, emb.cpu().numpy()), step,
                verbose)
    wait_for_saves()
    if verbose:
        close_progbar()
    return run.gather(params), {"step": step,
                                "opt_state": run.gather(opt_state, params)}


def vocoder_loss_and_grads(params, x_in, y, mels, cfg: WaveRNNConfig,
                           precision: str):
    """``WR.loss`` in training mode and its gradient with respect to every
    leaf of ``params``; the batch (numpy arrays or tensors) goes to the
    parameters' device.  Returns (detached device loss, gradients)."""
    from autovc_tpu_torch.models import wavernn as WR

    x_in, y, mels = _on_device(params, x_in, y, mels)
    value, grads = _value_and_grads(params, lambda p: WR.loss(
        p, x_in, y, mels, cfg, train=True, mode=precision))
    return value.detach(), grads


def make_vocoder_step(cfg: WaveRNNConfig, tx: schedules.Optimizer,
                      precision: str = "bf16") -> Callable:
    """WaveRNN train step: ``step(params, opt_state, x_in, y, mels) ->
    (params, opt_state, aux)``, aux carrying ``loss`` and ``grad_norm``
    (before clipping) as device scalars.  ``precision`` is the matmul /
    recurrence policy; parameters, gradients and Adam moments stay f32."""

    def step(params, opt_state, x_in, y, mels):
        loss, grads = vocoder_loss_and_grads(params, x_in, y, mels, cfg,
                                             precision)
        grad_norm = tx.step(tree_leaves(params), grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return step


def train_vocoder(params, dataset, cfg: WaveRNNConfig,
                  n_epochs: int = 1, batch_size: int = 8,
                  steps_per_epoch: int = 50, seq_frames: int = 9,
                  lr: float = 1e-4, log_freq: int = 10,
                  model_name: str | None = None,
                  save_dir: str | None = None, logger=None,
                  verbose: bool = True, start_step: int = 0,
                  resume: bool = False, mesh=None):
    """WaveRNN teacher-forced training, bf16 policy, Adam at a constant
    ``lr`` with global-norm clip 4.  Returns (params, info-dict).

    The loss stays on the device and is pulled to the host only at the
    steps that log it (every ``log_freq``-th).  With ``model_name`` the
    loop saves ``{step, params, opt_state}`` asynchronously after each
    epoch and waits for the writes before it returns;
    ``resume=True`` restores them from the newest checkpoint in
    ``save_dir`` (the JAX package's vocoder checkpoints too).

    ``mesh``: the sharded loop (module docstring;
    ``parallel.steps.make_sharded_vocoder_step``: the MelResNet
    BatchNorms over the global batch)."""
    run = _OnMesh(mesh, params, verbose)
    params, verbose = run.params, run.verbose
    saving = bool(model_name)
    if not run.main:
        logger, model_name = None, ""
    oc = OptimizerConfig(lr=lr, lr_scheduler="constant", grad_clip_norm=4.0)
    tx = schedules.make_optimizer(oc, steps_per_epoch)
    opt_state = tx.init(tree_leaves(params))
    save_dir = save_dir or cfg.model_dir
    if resume:
        latest = latest_checkpoint(save_dir)
        if latest is not None:
            blob = load_checkpoint(latest)
            params, _, opt_state = _restore(blob, params, opt_state)
            start_step = int(blob.get("step", start_step) or 0)
            if verbose:
                print(f"Resumed from '{latest}' at step {start_step}")
    if tree_leaves(params)[0].device.type == "cuda":
        PREC.exact_f32()
    full = params
    params, opt_state = run.shard(params), run.shard(opt_state, full)

    if mesh is not None:
        from autovc_tpu_torch.parallel import steps as psteps
        step_fn = psteps.on_rows(psteps.make_sharded_vocoder_step(
            cfg, tx, mesh), mesh, 2)
    else:
        step_fn = make_vocoder_step(cfg, tx)
    step = start_step
    n_total = n_epochs * steps_per_epoch
    for epoch in range(1, n_epochs + 1):
        for x_in, y, mels in dataset.batches(batch_size, seq_frames,
                                             n_batches=steps_per_epoch,
                                             seed=epoch):
            params, opt_state, aux = step_fn(params, opt_state, x_in, y,
                                             mels)
            step += 1
            log_now = step % max(log_freq, 1) == 0
            if verbose:
                progbar(step - start_step, n_total,
                        {"loss": round(float(aux["loss"]), 4)}
                        if log_now else {})
            if logger is not None and log_now:
                logger.log({"loss": float(aux["loss"]),
                            "grad_norm": float(aux["grad_norm"]),
                            "epoch": epoch, "step": step}, step=step)
        if saving:
            payload = {"step": step, "params": run.gather(params),
                       "opt_state": run.gather(opt_state, params)}
            if model_name:
                save_checkpoint(f"{save_dir.rstrip('/')}/{model_name}",
                                payload, block=False)
    wait_for_saves()
    if verbose:
        close_progbar()
    return run.gather(params), {"step": step,
                                "opt_state": run.gather(opt_state, params)}
