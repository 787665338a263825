#!/usr/bin/env python
"""Convert reference PyTorch checkpoints to v2 ``.ckpt`` files with the
PyTorch port (counterpart of ``scripts/convert_reference_checkpoints.py``).

The reference distributes pretrained weights as three torch files
(``AutoVC_seed40_200k.pt``, ``SpeakerEncoder.pt``,
``WaveRNN_Pretrained.pyt``).  Point this script at them and it writes one
``.ckpt`` each (gate order kept, the speaker encoder's speaker registry and
every file's ``step`` included), which both ``autovc_tpu`` and
``autovc_tpu_torch`` load.  It converts files only: no tensor is computed,
so it runs on any machine, with or without a GPU.

Usage:
    python scripts/convert_reference_checkpoints_torch.py \
        --auto_encoder models/AutoVC/AutoVC_seed40_200k.pt \
        --speaker_encoder models/SpeakerEncoder/SpeakerEncoder.pt \
        --vocoder models/WaveRNN/WaveRNN_Pretrained.pyt \
        --out_dir models/native
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> list[str]:
    """Convert each file given; returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--auto_encoder")
    ap.add_argument("--speaker_encoder")
    ap.add_argument("--vocoder")
    ap.add_argument("--out_dir", default="models/native")
    args = ap.parse_args(argv)

    from autovc_tpu_torch.utils import torch_compat
    from autovc_tpu_torch.utils.checkpoint import save_checkpoint

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for model_type, path in [("auto_encoder", args.auto_encoder),
                             ("speaker_encoder", args.speaker_encoder),
                             ("vocoder", args.vocoder)]:
        if not path:
            continue
        params, extras = torch_compat.load_reference_checkpoint(path,
                                                                model_type)
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(path))[0] + ".ckpt")
        save_checkpoint(out, {"params": params, **extras})
        print(f"{model_type}: {path} -> {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
