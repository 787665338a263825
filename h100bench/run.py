"""Run one cell of the benchmark once:

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs as many CUDA devices as the cell
asks for and exits with code 2 and no result without them.  The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number of the output check beside its limit (also the
last lines of standard error).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program lives at a fixed path in the checkout
    build = REPO / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))
    import torch
    from h100bench import harness
    harness.stamp("torch")
    chips = harness.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.stamp("cuda")
    from autovc_tpu_torch.ops import _build
    _build.build_all()
    harness.stamp("program")
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark may load none of "
              f"{harness.FORBIDDEN}", file=sys.stderr)
        return 3
    for name, age, user, system, majflt, steal in harness.STAMPS:
        print(f"setup {name} at {age:.3f} s user {user:.3f} s system "
              f"{system:.3f} s majflt {majflt} steal {steal:.2f} s",
              file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
