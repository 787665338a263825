"""The readings that the output check's limits are set from, for one
cell, in one process on the chip:

    python3 h100bench/control.py --workload <name> --seeds 12 --seconds 3

For each seed, a short run of the cell at its own load (``harness.run``)
with the program as it is and with each fp8 control put in its place
(``check.CONTROLS``: the plain reference with fp8 weights and layer
inputs, judged by the float32 reference at the same positions and by the
rule that decides ``correct``); then each fault of ``faults.py`` that the
cell can have, planted under the timed path, on ``--fault-seeds`` seeds.
One JSON line per reading; the last line sums them up: the largest sound
reading, and the smallest control and fault reading, of each number.  It
exits with 1 where a control came out correct on any seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to plant (default: all)")
    ap.add_argument("--mix", default="{}",
                    help="JSON overrides of the mix (smaller pools)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from h100bench import faults, harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from autovc_tpu_torch.ops import _build
    _build.build_all()
    mix = json.loads(args.mix)
    kind = harness.load_cell(args.workload).kind
    sound, ctrl, bad, passed = {}, {}, {}, []
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        r = harness.run(args.workload, seed, args.seconds, False,
                        control=True, mix=mix)
        line = {"seed": seed, "correct": r["correct"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "control": r["control"],
                "control_correct": r["control_correct"],
                "detail": r["detail"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        for k, v in line["checks"].items():
            sound[k] = max(sound.get(k, 0.0), v)
        for name, readings in r["control"].items():
            c = ctrl.setdefault(name, {})
            for k, v in readings.items():
                c[k] = min(c.get(k, float("inf")), v)
        passed += [f"{name} (seed {seed})"
                   for name, ok in r["control_correct"].items() if ok]
    wanted = [f for f in args.faults.split(",") if f]
    for name, fault in faults.for_kind(kind).items():
        if wanted and name not in wanted:
            continue
        for seed in seeds[:args.fault_seeds]:
            r = harness.run(args.workload, seed, args.seconds, False,
                            fault=fault, mix=mix)
            vals = {k: v["value"] for k, v in r["checks"].items()}
            print(json.dumps({"seed": seed, "fault": name,
                              "correct": r["correct"], "checks": vals,
                              "detail": r["detail"]}),
                  flush=True)
            for k, v in vals.items():
                bad.setdefault(name, {})
                bad[name][k] = min(bad[name].get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "sound_max": sound,
                      "control_min": ctrl, "fault_min": bad,
                      "control_passed": passed}))
    if passed:
        print(f"controls that came out correct: {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
