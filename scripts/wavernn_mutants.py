"""Mutation check of the WaveRNN sampling kernel (kernel 1).

    python3 scripts/wavernn_mutants.py           # from the repository root

Needs an NVIDIA GPU and nvcc.  For each mutant the port is copied into a
temporary directory and one edit is made to the copy's
``csrc/wavernn_sample.cu`` (the ring slots, the pre_I phase, the M-tiles
of a product, the logits a block picks from, a counter's target, who
arrives on a counter; the split pick's wait, slot and tie rule); every
copy's kernel is built at once (one nvcc per copy, all started together),
then for each a subprocess holds the mutated kernel against the plain
loop with ``chip_smoke.compare_wavernn_f32`` (8 rows drawn, 48 rows
pinned, 4 frames) and ``chip_smoke.compare_wavernn_bf16`` (16 and 48
rows in MOL, 32 and 128 rows in RAW with 9 bits, the split pick, 8
frames) and ``chip_smoke.hold_wavernn_raw9_tie`` (ties within a class
slice and across two, 64 rows), the smoke run's bars.  The first "mutant" is an
unmutated copy.  Prints one JSON line per mutant: each geometry's "pass"
or the first failure's message.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import make_copy, run  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "wavernn_sample.cu")

# name -> [(text in wavernn_sample.cu, its replacement), ...]
MUTANTS = {
    "none": [],
    # the h1 product reads the ring slot of step t - 1, not t
    "hh_from_wrong_step": [(
        "wr_hh<T, MT>(a, s, r, wr_op(a, kOpH1, wr_slot(t)));",
        "wr_hh<T, MT>(a, s, r, wr_op(a, kOpH1, wr_slot(t + 1)));")],
    # pre_I of step t + 1 taken with the taps of the next phase
    "pre_wrong_phase": [(
        "const int q = tt / a.S, p = tt % a.S, rd = a.rd;",
        "const int q = tt / a.S, p = (tt + 1) % a.S, rd = a.rd;")],
    # M-tiles after the first multiply the first M-tile's rows
    "mtile_reuses_first_a": [("const uint4* xa = x[q][mt];",
                              "const uint4* xa = x[q][0];")],
    # one R1 block picks from its logits' first K part only
    "own_partial_logits": [(
        "wr_psum(s.parts, kp3, a.mpad, n3, (r), (c))",
        "wr_psum(s.parts, blockIdx.x == 1 ? 1 : kp3, a.mpad, n3, (r), (c))")],
    # stage B starts one R1 arrival short of step t's x1
    "counter_one_short": [(
        "wr_wait(bar + kC1, e * a.prod[kC1]);   // x1 of step t",
        "wr_wait(bar + kC1, e * a.prod[kC1] - 1);   // x1 of step t")],
    # stage B waits for step t - 1's arrivals only
    "counter_one_epoch_short": [(
        "wr_wait(bar + kC1, e * a.prod[kC1]);   // x1 of step t",
        "wr_wait(bar + kC1, (e - 1) * a.prod[kC1]);   // x1 of step t")],
    # every block bumps c2, not only R2's: the launch, which counts the
    # producers from wr_arrives, refuses the plan's targets
    "c2_arrivals_not_the_plans": [("    case kC2: return !r.r1;",
                                   "    case kC2: return true;")],
    # the split pick (RAW-9): the merge reads the candidates without
    # waiting for the slices
    "cs_wait_removed": [(
        "wr_wait(bar + kCS, t * a.prod[kCS]);   // every slice's best",
        ";")],
    # block 0's slice does not arrive on cs: the launch, which counts the
    # producers from wr_arrives, finds one fewer than the plan's
    "cs_producers_one_short": [("    case kCS: return r.nk > 0;",
                                "    case kCS: return r.nk > 0 && r.k0 > 0;")],
    # the slices put their candidates into the other slot than the merge
    # reads
    "cs_wrong_slot": [(
        "  unsigned long long* keys = a.keys + (size_t)wr_slot(ts) * a.B;",
        "  unsigned long long* keys = a.keys + (size_t)wr_slot(ts + 1) * "
        "a.B;")],
    # a tie between two classes of one slice goes to the higher one
    "cs_tie_to_higher": [(
        "if (ob > best || (ob == best && op < pick)) {\n"
        "            best = ob;\n            pick = op;\n          }\n"
        "        }\n        if (tq == 0",
        "if (ob > best || (ob == best && op > pick)) {\n"
        "            best = ob;\n            pick = op;\n          }\n"
        "        }\n        if (tq == 0")],
    # the key's class field not inverted: a tie across two slices goes to
    # the higher class
    "cs_key_class_not_inverted": [
        ("(cmask - (unsigned int)pick));", "((unsigned int)pick));"),
        ("? (int)(cmask - (unsigned int)(k & cmask))",
         "? (int)(unsigned int)(k & cmask)")],
}

CHECK = """
import json, torch
import chip_smoke as S
from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.models import wavernn as WR
from autovc_tpu_torch.utils.bridge import from_jax_params
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
cfg = WaveRNNConfig()
params = from_jax_params(WR.init(gen, cfg), dev)
raw9 = cfg.with_overrides(mode="RAW", bits=9)   # the split pick
raw9_params = from_jax_params(WR.init(gen, raw9), dev)
for key, fn in (
        ("f32 8 rows", lambda: S.compare_wavernn_f32(cfg, params, 8, False,
                                                     gen, dev)),
        ("f32 48 rows", lambda: S.compare_wavernn_f32(cfg, params, 48, True,
                                                      gen, dev)),
        ("bf16 16 rows", lambda: S.compare_wavernn_bf16(cfg, params, 16, 8,
                                                        gen, dev)),
        ("bf16 48 rows", lambda: S.compare_wavernn_bf16(cfg, params, 48, 8,
                                                        gen, dev)),
        ("raw9 bf16 32 rows", lambda: S.compare_wavernn_bf16(
            raw9, raw9_params, 32, 8, gen, dev)),
        ("raw9 bf16 128 rows", lambda: S.compare_wavernn_bf16(
            raw9, raw9_params, 128, 8, gen, dev)),
        ("raw9 tie 64 rows", lambda: S.hold_wavernn_raw9_tie(
            raw9, raw9_params, 64, gen, dev))):
    try:
        fn()
        out[key] = "pass"
    except Exception as e:   # a disagreement, or a CUDA error
        out[key] = f"FAIL ({type(e).__name__}): " + str(e)[:300]
print("RESULT " + json.dumps(out))
"""


def edited_copy(name: str, edits, tmp: str) -> str:
    """A copy of the port under ``tmp/name`` with each edit made in
    ``SOURCE``: (old, new) where ``old`` occurs once, or (old, new, n)
    where it occurs n times (all replaced)."""
    copy = make_copy(name, "", "", tmp)
    path = os.path.join(copy, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new, *n in edits:
        if text.count(old) != (n[0] if n else 1):
            raise RuntimeError(f"{name}: the edit {old!r} does not apply "
                               f"{n[0] if n else 1} time(s)")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return copy


def main(variants=MUTANTS, check: str = CHECK) -> int:
    """Copy every variant, build all their kernels at once, then run
    ``check`` in each copy, one after another."""
    with tempfile.TemporaryDirectory() as tmp:
        copies = {name: edited_copy(name, edits, tmp)
                  for name, edits in variants.items()}
        build = ("from autovc_tpu_torch.ops import _build; "
                 "_build.build_all(('wavernn_sample.cu',))")
        builds = {name: subprocess.Popen([sys.executable, "-c", build],
                                         cwd=copy, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                  for name, copy in copies.items()}
        failed = {name: proc.communicate()[0][-2000:]
                  for name, proc in builds.items() if proc.wait() != 0}
        for name, copy in copies.items():
            res = ({"error": "build failed: " + failed[name]}
                   if name in failed else run(copy, check))
            print(json.dumps({"variant": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
