"""Kernel 1, the WaveRNN sampling loop, timed at given row counts.

    python3 scripts/wavernn_rows.py [--rows 16 48 128] [--frames 44]
                                    [--mode RAW --bits 9]

Needs an NVIDIA GPU and nvcc.  Times the kernel of the checkout it is run
from (the current directory), so running this file from the root of
another commit's checkout (``git archive`` it into a directory) times that
commit's kernel on the same inputs: the script uses only what the port
has had since its first slice.  Default config (rd = fc = 512, MOL, or
``--mode RAW`` with ``--bits`` bits: 2 ** bits classes), bf16,
fresh seeded weights, ``frames`` frames a row (44: one 11000-sample fold
with its overlap, 12100 steps), pinned noise; device ms of one launch
(CUDA events, mean of 2 after a warm-up) and us a step.  Prints the card's
name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from autovc_tpu_torch.config import WaveRNNConfig  # noqa: E402
from autovc_tpu_torch.models import wavernn as WR  # noqa: E402
from autovc_tpu_torch.ops import wavernn_kernels as WK  # noqa: E402
from autovc_tpu_torch.utils.bridge import from_jax_params  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[16, 48, 128])
    ap.add_argument("--frames", type=int, default=44)
    ap.add_argument("--mode", choices=("MOL", "RAW"), default="MOL")
    ap.add_argument("--bits", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    S.PREC.exact_f32()
    gen, dev = torch.Generator().manual_seed(0), torch.device("cuda")
    cfg = WaveRNNConfig().with_overrides(mode=args.mode, bits=args.bits)
    params = from_jax_params(WR.init(gen, cfg), dev)
    out = {"tree": os.path.basename(os.getcwd()), "frames": args.frames,
           "mode": args.mode, "n_classes": cfg.n_classes}
    for rows in args.rows:
        inp, gum, lgs = S.wavernn_inputs(cfg, params, rows, args.frames,
                                         True, gen, dev, pinned=True)
        ms = S.timed_ms(lambda: WK.launch(inp, gum, lgs), 2)
        out[f"{rows} rows"] = {"ms": ms, "us_per_step": ms * 1e3 / inp.steps}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
