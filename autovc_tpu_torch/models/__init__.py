"""Model loader (counterpart of ``autovc_tpu/models/__init__.py``).

``load_model(model_type, ...)`` reads a v2 ``.ckpt`` (written by either
package, through the weight bridge) or, when no checkpoint is requested,
returns fresh parameters made from a seeded ``torch.Generator`` with the
JAX init's shapes and layout.  Parameters land on ``device`` — the GPU
unless the caller passes ``device="cpu"``.  ``save_model`` writes one.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from autovc_tpu_torch.config import (AutoEncoderConfig, SpeakerEncoderConfig,
                                     WaveRNNConfig)
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.utils import checkpoint as ckpt_util
from autovc_tpu_torch.utils import resolve_device
from autovc_tpu_torch.utils.bridge import from_jax_params

MODEL_TYPES = ("auto_encoder", "speaker_encoder", "vocoder")


@dataclass
class LoadedModel:
    model_type: str
    params: Any
    config: Any
    step: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def speakers(self) -> Dict[str, np.ndarray]:
        """Mean-speaker registry (speaker_encoder only)."""
        return self.extras.setdefault("speakers", {})


def default_config(model_type: str):
    return {"auto_encoder": AutoEncoderConfig,
            "speaker_encoder": SpeakerEncoderConfig,
            "vocoder": WaveRNNConfig}[model_type]()


def _init_params(model_type: str, config, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    if model_type == "auto_encoder":
        from autovc_tpu_torch.models import autoencoder
        return autoencoder.init(gen, config)
    if model_type == "speaker_encoder":
        from autovc_tpu_torch.models import speaker_encoder
        return speaker_encoder.init(gen, config)
    from autovc_tpu_torch.models import wavernn
    return wavernn.init(gen, config)


def _resolve(model_name: str, model_dir: str) -> str | None:
    if os.path.isfile(model_name):
        return model_name
    cand = os.path.join(model_dir.rstrip("/"), model_name)
    return cand if os.path.isfile(cand) else None


def load_model(model_type: str, model_name: str | None = None,
               model_dir: str | None = None, config=None, seed: int = 0,
               verbose: bool = True, missing_ok: bool = False,
               device=None) -> LoadedModel:
    """Construct (and optionally restore) one model on ``device``.

    ``model_name`` is a path or a file in ``model_dir``; a missing
    requested checkpoint raises unless ``missing_ok``; ``model_name=None``
    gives a fresh seeded init."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"'{model_type}' is not a supported model_type; "
                         f"choose from {MODEL_TYPES}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        PREC.exact_f32()
    config = config if config is not None else default_config(model_type)
    model_dir = model_dir if model_dir is not None else config.model_dir
    path = _resolve(model_name, model_dir) if model_name else None
    if path is None:
        if model_name and not missing_ok:
            raise FileNotFoundError(
                f"[{model_type}] checkpoint '{model_name}' not found (not a "
                f"file, not in '{model_dir}'); pass model_name=None for a "
                f"fresh init, or missing_ok=True to fall back to one")
        if verbose:
            print(f"[{model_type}] using fresh init (seed {seed})")
        params = _init_params(model_type, config, seed)
        return LoadedModel(model_type, from_jax_params(params, dev), config)
    blob = ckpt_util.load_checkpoint(path)
    params = from_jax_params(blob.pop("params"), dev, torch.float32)
    step = blob.pop("step", 0) or 0
    if "ema_params" in blob:
        blob["ema_params"] = from_jax_params(blob["ema_params"], dev,
                                             torch.float32)
    if verbose:
        print(f"[{model_type}] loaded '{path}' (step {step})")
    return LoadedModel(model_type, params, config, step, blob)


def save_model(model: LoadedModel, model_name: str,
               save_dir: str | None = None, **extra_payload) -> str:
    """Persist a model as a v2 ``.ckpt`` (``{step, params, extras...}``,
    the JAX package's ``save_model`` payload); returns its path."""
    save_dir = save_dir or model.config.model_dir
    path = os.path.join(save_dir.rstrip("/"), model_name)
    ckpt_util.save_checkpoint(path, {"step": model.step,
                                     "params": model.params,
                                     **model.extras, **extra_payload})
    return path
