"""Structured metrics writer: wandb-compatible with a JSONL fallback
(counterpart of ``autovc_tpu/utils/logging.py``).

A ``MetricsLogger`` owns the run: it forwards to wandb when the package
imports and the mode is not 'disabled', and always appends JSONL records
locally, so training is observable offline; ``finish`` ends the run.
The JAX logger's histogram and figure methods come with the port of their
callers.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping

import torch

from autovc_tpu_torch.config import WandbConfig


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

    def log(self, metrics: Dict[str, Any], step: int | None = None) -> None:
        record = {k: _jsonable(v) for k, v in metrics.items()}
        record["_time"] = round(time.time() - self._t0, 3)
        if step is not None:
            record["_step"] = step
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.run is not None:
            self.run.log(metrics, step=step)

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
