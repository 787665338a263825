"""Model loader (counterpart of ``autovc_tpu/models/__init__.py``).

``load_model(model_type, ...)`` resolves a checkpoint name
(:func:`resolve_artifact`, in the JAX order: an explicit path, then
``model_dir/name``, then the local artifact cache ``AUTOVC_MODEL_CACHE``,
then, only while a wandb run is live, a download from its artifact
registry).  It reads a v2 ``.ckpt`` (written by either package, through
the weight bridge) or converts a reference PyTorch ``.pt`` / ``.pyt`` file
(:mod:`autovc_tpu_torch.utils.torch_compat`); when no checkpoint is
requested it returns fresh parameters made from a seeded
``torch.Generator`` with the JAX init's shapes and layout.  Parameters
land on ``device``: the GPU unless the caller passes ``device="cpu"``.
``load_models`` loads several at once; ``save_model`` writes one.
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


def artifact_cache_dir() -> str:
    """Local model-artifact cache (name -> file), the offline half of the
    reference's wandb artifact registry (voice_converter.py:462-478)."""
    return os.path.expanduser(
        os.environ.get("AUTOVC_MODEL_CACHE", "~/.cache/autovc_tpu/models"))


def resolve_artifact(model_name: str, model_dir: str,
                     verbose: bool = True) -> str | None:
    """Resolve a checkpoint name to a local file: an explicit path ->
    ``model_dir/name`` -> the local artifact cache -> a wandb artifact
    download, only while a wandb run is live.  None when unresolved."""
    if os.path.isfile(model_name):
        return model_name
    cand = os.path.join(model_dir.rstrip("/"), model_name)
    if os.path.isfile(cand):
        return cand
    cached = os.path.join(artifact_cache_dir(), model_name)
    if os.path.isfile(cached):
        return cached
    try:
        import wandb
        if wandb.run is not None:
            name = os.path.splitext(model_name)[0]
            artifact = wandb.run.use_artifact(f"{name}:latest")
            adir = artifact.download(root=artifact_cache_dir())
            for f in sorted(os.listdir(adir)):
                if f == model_name or f.startswith(name):
                    return os.path.join(adir, f)
    except Exception as e:  # no wandb, no network, no such artifact
        if verbose:
            print(f"[registry] wandb artifact lookup for "
                  f"'{model_name}' failed: {e}")
    return None


def load_model(model_type: str, model_name: str | None = None,
               model_dir: str | None = None, config=None, seed: int = 0,
               verbose: bool = True, missing_ok: bool = False,
               device=None) -> LoadedModel:
    """Construct (and optionally restore) one model on ``device``.

    ``model_name`` is resolved by :func:`resolve_artifact`; a missing
    requested checkpoint raises unless ``missing_ok`` (a typo'd name must
    not silently train from scratch); ``model_name=None`` gives a fresh
    seeded init.  A reference ``.pt`` / ``.pyt`` file is converted, with
    its ``step`` and the speaker encoder's ``speakers``."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"'{model_type}' is not a supported model_type; "
                         f"choose from {MODEL_TYPES}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        PREC.exact_f32()
    config = config if config is not None else default_config(model_type)
    model_dir = model_dir if model_dir is not None else config.model_dir
    path = (resolve_artifact(model_name, model_dir, verbose=verbose)
            if model_name else None)
    if path is None:
        if model_name and not missing_ok:
            raise FileNotFoundError(
                f"[{model_type}] checkpoint '{model_name}' not found: not a "
                f"file, not in '{model_dir}', not in the artifact cache "
                f"('{artifact_cache_dir()}'), and no live wandb run to fetch "
                f"from.  Pass model_name=None for a fresh init, or "
                f"missing_ok=True to fall back to one explicitly.")
        if verbose:
            tag = (f"requested '{model_name}' missing; " if model_name
                   else "no checkpoint requested; ")
            print(f"[{model_type}] {tag}using fresh init (seed {seed})")
        params = _init_params(model_type, config, seed)
        return LoadedModel(model_type, from_jax_params(params, dev), config)
    if ckpt_util._is_torch_checkpoint(path):
        from autovc_tpu_torch.utils import torch_compat
        params, extras = torch_compat.load_reference_checkpoint(path,
                                                                model_type)
        step = extras.pop("step", 0) or 0
        if verbose:
            print(f"[{model_type}] converted PyTorch checkpoint '{path}' "
                  f"(step {step})")
        return LoadedModel(model_type, from_jax_params(params, dev), config,
                           step, extras)
    blob = ckpt_util.load_checkpoint(path)
    params = from_jax_params(blob.pop("params"), dev, torch.float32)
    step = blob.pop("step", 0) or 0
    if "ema_params" in blob:
        blob["ema_params"] = from_jax_params(blob["ema_params"], dev,
                                             torch.float32)
    if verbose:
        print(f"[{model_type}] loaded '{path}' (step {step})")
    return LoadedModel(model_type, params, config, step, blob)


def load_models(model_types, model_names, model_dirs=None, configs=None,
                verbose: bool = True, device=None):
    """Load several models at once, each as :func:`load_model` on
    ``device`` (``models.py:38-54``)."""
    n = len(model_types)
    model_dirs = model_dirs or [None] * n
    configs = configs or [None] * n
    return [load_model(t, name, d, c, verbose=verbose, device=device)
            for t, name, d, c in zip(model_types, model_names, model_dirs,
                                     configs)]


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
