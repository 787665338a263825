"""Structured metrics writer: wandb-compatible with a JSONL fallback
(counterpart of ``autovc_tpu/utils/logging.py``).

A ``MetricsLogger`` owns the run: it forwards to wandb when the package
imports and the mode is not 'disabled', and always appends JSONL records
locally, so training is observable offline; ``finish`` ends the run.
Histograms are taken as the JAX logger takes them (``np.histogram`` of a
float64 host copy), so the two packages write equal records for equal
values.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping

import numpy as np
import torch

from autovc_tpu_torch.config import WandbConfig


def _named_leaves(tree, path: tuple = ()):
    """(key path, leaf) of every leaf with a ``shape``, in
    ``jax.tree_util.tree_flatten_with_path``'s order for dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (str(i),))
    elif hasattr(tree, "shape"):
        yield "/".join(path), tree


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        if hasattr(v, "item") and getattr(v, "size", 2) == 1:
            return v.item()
        if hasattr(v, "tolist") and getattr(v, "size", 1 << 30) <= 64:
            return v.tolist()
        return str(type(v).__name__)


class MetricsLogger:
    def __init__(self, cfg: WandbConfig = WandbConfig(),
                 log_dir: str = "logs", run_config: Mapping | None = None,
                 **wandb_overrides):
        self.cfg = cfg
        self.run = None
        self._t0 = time.time()
        os.makedirs(os.path.join(log_dir, cfg.project), exist_ok=True)
        self.jsonl_path = os.path.join(
            log_dir, cfg.project, f"metrics_{int(self._t0)}.jsonl")
        if cfg.mode != "disabled":
            try:
                import wandb
                self.run = wandb.init(
                    entity=cfg.entity, project=cfg.project, mode=cfg.mode,
                    reinit=cfg.reinit, save_code=cfg.save_code,
                    dir=os.path.join(log_dir, cfg.project),
                    config=dict(run_config or {}), **wandb_overrides)
            except Exception as e:  # no wandb / no network: fall back
                print(f"[metrics] wandb unavailable ({e}); JSONL only")
                self.run = None

    def _append(self, record: Dict[str, Any], step: int | None) -> None:
        record["_time"] = round(time.time() - self._t0, 3)
        if step is not None:
            record["_step"] = step
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log(self, metrics: Dict[str, Any], step: int | None = None) -> None:
        self._append({k: _jsonable(v) for k, v in metrics.items()}, step)
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_histogram(self, name: str, values, step: int | None = None,
                      bins: int = 24) -> None:
        """Log a value histogram: a ``wandb.Histogram`` when a run is live;
        the JSONL record always gets the bin counts and summary stats.
        With :meth:`log_tree_histograms` this is the reference's
        ``run.watch(model)`` parameter / gradient stream
        (auto_encoder/model.py:276-277, speaker_encoder/model.py:332-333).
        ``values``: a tensor (any device) or anything ``np.asarray``
        takes."""
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().double().numpy()
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        counts, edges = np.histogram(v, bins=bins)
        self._append({f"hist/{name}": {
            "count": int(v.size), "mean": float(v.mean()),
            "std": float(v.std()), "min": float(v.min()),
            "max": float(v.max()), "bins": counts.tolist(),
            "lo": float(edges[0]), "hi": float(edges[-1])}}, step)
        if self.run is not None:
            import wandb
            self.run.log({name: wandb.Histogram(
                np_histogram=(counts, edges))}, step=step)

    def log_tree_histograms(self, prefix: str, tree, step: int | None = None,
                            bins: int = 24) -> None:
        """Histogram every array leaf of a parameter tree, named
        ``prefix/<key path>`` in the JAX order (dict keys sorted, list
        indices ``0``, ``1``, ...)."""
        for name, leaf in _named_leaves(tree):
            self.log_histogram(f"{prefix}/{name}", leaf, step=step,
                               bins=bins)

    def log_audio(self, name: str, wav, sr: int, caption: str = "",
                  step: int | None = None, save_dir: str | None = None):
        """Log converted audio: to wandb when a run is live, else to
        ``save_dir/name.wav`` when ``save_dir`` is given, else nowhere."""
        if self.run is not None:
            import wandb
            self.run.log({name: wandb.Audio(wav, caption=caption,
                                            sample_rate=sr)}, step=step)
        elif save_dir:
            from autovc_tpu_torch.audio import io
            os.makedirs(save_dir, exist_ok=True)
            io.save_wav(os.path.join(save_dir, f"{name}.wav"), wav, sr)

    def log_figure(self, name: str, fig, step: int | None = None,
                   save_dir: str | None = None) -> None:
        """Log a matplotlib figure: a wandb Image when a run is live, else
        a PNG ``name[_step].png`` under ``save_dir`` (by default beside the
        JSONL log).  The figure is closed either way.  The reference's
        mel-comparison / TSNE figures (auto_encoder/model.py:371-374,
        speaker_encoder/model.py:417-419)."""
        try:
            if self.run is not None:
                import wandb
                self.run.log({name: wandb.Image(fig)}, step=step)
            else:
                out_dir = save_dir or os.path.dirname(self.jsonl_path)
                os.makedirs(out_dir, exist_ok=True)
                suffix = f"_{step}" if step is not None else ""
                fig.savefig(os.path.join(out_dir, f"{name}{suffix}.png"))
        finally:
            import matplotlib.pyplot as plt
            plt.close(fig)

    def log_artifact(self, path: str, name: str, type_: str) -> None:
        if self.run is not None:
            import wandb
            artifact = wandb.Artifact(name, type_)
            artifact.add_file(path)
            self.run.log_artifact(artifact)

    def finish(self) -> None:
        """End the wandb run, if one is live."""
        if self.run is not None:
            self.run.finish()
            self.run = None
