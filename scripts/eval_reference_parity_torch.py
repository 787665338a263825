#!/usr/bin/env python
"""Mel-reconstruction parity of the PyTorch port against a reference
AutoVC checkpoint (counterpart of ``scripts/eval_reference_parity.py``).

Point it at a reference-format AutoVC ``.pt`` file (real or written from
the test mirrors), or at a ``.ckpt`` converted from one together with
``--mirror_pt``, and a directory of wavs.  It

  1. loads the weights into the torch mirror of the reference architecture
     (``tests/torch_mirrors.py``) and into the port through
     ``autovc_tpu_torch.models.load_model``;
  2. computes each wav's auto-encoder mel with the port's front end
     (``autovc_tpu_torch.audio.dsp``), trimmed to a multiple of ``freq``,
     so that both sides see the same input;
  3. runs both generator forwards in float32 (TF32 off on a GPU), the
     mirror on the same device, and reports each file's post-net mel MSE
     and the allclose verdict at rtol 1e-3 / atol 1e-4.

It runs on the GPU; ``evaluate(..., device="cpu")`` or ``main(argv,
device="cpu")`` runs it on the CPU.  Exit code 0 when every file is
allclose, else 1.

Usage:
    python scripts/eval_reference_parity_torch.py --auto_encoder AutoVC.pt \
        --samples data/samples [--max_files N] [--max_seconds S] \
        [--mirror_pt AutoVC.pt]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def evaluate(auto_encoder: str, samples: str, max_files: int | None = None,
             max_seconds: float | None = None, rtol: float = 1e-3,
             atol: float = 1e-4, mirror_pt: str | None = None,
             device=None) -> dict:
    """``auto_encoder``: a reference-format ``.pt`` or a ``.ckpt``; the
    mirror loads from ``mirror_pt`` (default ``auto_encoder``, which must
    then be a ``.pt``).  Returns ``{"allclose_rtol1e3", "mel_mse",
    "files": {name: {"mel_mse", "allclose"}}, "device"}``."""
    import torch

    from autovc_tpu_torch.audio import dsp, io
    from autovc_tpu_torch.config import AutoEncoderConfig
    from autovc_tpu_torch.models import autoencoder as AE
    from autovc_tpu_torch.models import load_model
    from autovc_tpu_torch.ops import precision as PREC
    from autovc_tpu_torch.utils import resolve_device

    # the torch mirror of the reference modules (a test-only re-expression;
    # its state-dict names are the reference's, so the file loads directly)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from torch_mirrors import MirrorAutoVC
    finally:
        sys.path.pop(0)

    dev = resolve_device(device)
    if dev.type == "cuda":
        PREC.exact_f32()
    cfg = AutoEncoderConfig()
    loaded = load_model("auto_encoder", auto_encoder, verbose=False,
                        device=dev)
    mirror = MirrorAutoVC()
    blob = torch.load(mirror_pt or auto_encoder, map_location="cpu",
                      weights_only=False)
    state = blob["model_state"] if isinstance(blob, dict) and \
        "model_state" in blob else blob
    mirror.load_state_dict(state)
    mirror.to(dev).eval()

    rng = np.random.default_rng(0)
    c = rng.standard_normal((1, 256)).astype(np.float32)
    c /= np.linalg.norm(c)
    c_t = torch.from_numpy(c).to(dev)

    wavs = sorted(f for f in os.listdir(samples) if f.endswith(".wav"))
    if max_files:
        wavs = wavs[:max_files]
    per_file, ok = {}, True
    for name in wavs:
        wav, sr = io.load_wav(os.path.join(samples, name),
                              sr=cfg.spectrogram.sr)
        if max_seconds:
            wav = wav[: int(max_seconds * sr)]
        mel = dsp.mel_spec_auto_encoder(wav, cfg.spectrogram)
        # trim to a freq multiple, as the reference harness does
        T = (mel.shape[-1] // cfg.freq) * cfg.freq
        x = torch.from_numpy(np.ascontiguousarray(
            mel[:, :T], dtype=np.float32))[None].to(dev)
        with torch.inference_mode():
            _, post_ref, _ = mirror(x, c_t, c_t)
            _, post, _ = AE.forward(loaded.params, x, c_t, c_t, cfg, "f32")
        post_ref = post_ref[0].cpu().numpy()
        post = post[0].cpu().numpy()

        mse = float(np.mean((post - post_ref) ** 2))
        close = bool(np.allclose(post, post_ref, rtol=rtol, atol=atol))
        ok = ok and close
        per_file[name] = {"mel_mse": mse, "allclose": close}

    return {"allclose_rtol1e3": ok,
            "mel_mse": float(np.mean([v["mel_mse"]
                                      for v in per_file.values()])),
            "files": per_file, "device": str(dev)}


def main(argv=None, device=None) -> None:
    """Print the report as JSON and exit 0 if every file is allclose, else
    1.  ``device``: as for :func:`evaluate` (the command line has no device
    flag: it runs on the GPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--auto_encoder", required=True)
    ap.add_argument("--samples", required=True,
                    help="directory of the wavs to reconstruct")
    ap.add_argument("--max_files", type=int, default=None)
    ap.add_argument("--max_seconds", type=float, default=None)
    ap.add_argument("--mirror_pt", default=None,
                    help="reference-format .pt for the torch-mirror side "
                         "when --auto_encoder is a .ckpt")
    args = ap.parse_args(argv)
    report = evaluate(args.auto_encoder, args.samples, args.max_files,
                      args.max_seconds, mirror_pt=args.mirror_pt,
                      device=device)
    print(json.dumps(report, indent=2))
    sys.exit(0 if report["allclose_rtol1e3"] else 1)


if __name__ == "__main__":
    main()
