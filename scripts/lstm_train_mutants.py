"""Mutation check of the LSTM-stack kernels 6 and 7 (training) and 3
(inference at more than 8 rows, which shares kernel 6's routine).

    python3 scripts/lstm_train_mutants.py        # from the repository root

Needs an NVIDIA GPU and nvcc.  For each mutant the port is copied into a
temporary directory and one edit is made to one file of the copy's
``csrc/`` (``lstm_fwd.cuh``: the forward routine of kernels 6 and 3;
``lstm_train.cu``: kernel 7); every copy's kernels are built at once, then
for each a subprocess holds the mutated kernels against their plain
versions with ``chip_smoke.compare_lstm`` (kernel 3 at lstm2 width, bf16,
9 and 24 rows) and ``chip_smoke.compare_lstm_train`` at the smoke run's
five training geometries (lstm2 f32 and bf16, lstm1 bf16, the speaker
encoder's stack bf16, lstm2 bf16 at a ragged 33 rows, last: a mutant that
writes out of bounds may leave the device unusable).  The first "mutant"
is an unmutated copy.  Prints one JSON line per mutant:
each geometry's "pass" or the failure message.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("autovc_tpu_torch", "csrc", "lstm_train.cu")
FWD = os.path.join("autovc_tpu_torch", "csrc", "lstm_fwd.cuh")

# name -> (text in lstm_train.cu, its replacement), or (file, text, its
# replacement)
MUTANTS = {
    "none": ("", ""),
    "da_f_uses_c_t": ("const float da_f = dc * c_p * f_",
                      "const float da_f = dc * c_t * f_"),
    # kernel 6 saves h rounded to bf16
    "h_saved_bf16": (FWD, "store_cs(a.hs + at, h);",
                     "store_cs(a.hs + at, "
                     "__bfloat162float(__float2bfloat16_rn(h)));"),
    "dwih_wrong_layer": ("push_back({hs + (l - 1) * TBH, da + l * TBH * 4",
                         "push_back({hs + l * TBH, da + l * TBH * 4"),
    # the top layer's step s reads dys of the neighbouring step s ^ 1
    "dys_off_by_one": ("__ldcs(a.dys + (size_t)t * BH",
                       "__ldcs(a.dys + (size_t)(t ^ 1) * BH"),
    # kernel 7's next-round inputs loaded for the current step at each
    # step boundary
    "prefetch_wrong_step": ("nt = l > 0 ? t : t - 1;", "nt = t;"),
    # the products read da from the ring slot the epilogue did not write
    "ring_slots_swapped": ("const int slot = t & 1;",
                           "const int slot = (t & 1) ^ 1;"),
    # the epilogue also runs the padded rows of the last M-tile
    "row_mask_dropped": ("ok[k] = pin[k] && prow[k] < rows_g;",
                         "ok[k] = pin[k];"),
    # the forward (kernels 6 and 3): a layer reads the layer below's h
    # from the ring slot written this round
    "fwd_below_from_this_round": (
        FWD, "return fwd_read_slot(s);", "return s & 1;"),
    # the forward reads every h from the slot it writes this round
    "fwd_ring_slots_swapped": (
        FWD, "int fwd_read_slot(int s) { return (s + 1) & 1; }",
        "int fwd_read_slot(int s) { return s & 1; }"),
    # every M-tile after the first multiplies the first M-tile's rows
    "fwd_mtile_reuses_first_a": (FWD, "const uint4* xa = x[q][mt];",
                                 "const uint4* xa = x[q][0];"),
    # the W_hh product also runs at t = 0, over the ring's unwritten slot
    # (torch.empty: not zeroed)
    "fwd_t0_hh_not_skipped": (
        FWD, "bool fwd_has_hh(int t) { return t > 0; }",
        "bool fwd_has_hh(int t) { return t >= 0; }"),
}

CHECK = """
import json, sys, torch
import chip_smoke as S
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
for rows in (9, 24):
    key = f"lstm_stack_stream {rows} rows torch.bfloat16"
    try:
        S.compare_lstm("lstm_stack_stream", rows, torch.bfloat16, gen, dev)
        out[key] = "pass"
    except Exception as e:   # a disagreement, or a CUDA error
        out[key] = f"FAIL ({type(e).__name__}): " + str(e).split("; {")[0]
for geom, L, H, I, rows, T, dtype, cts in (
        ("lstm2", 2, 1024, 512, 16, 400, torch.float32, "all"),
        ("lstm2", 2, 1024, 512, 16, 400, torch.bfloat16, "all"),
        ("lstm1", 1, 512, 320, 16, 400, torch.bfloat16, "all"),
        ("speaker_encoder", 3, 256, 40, 48, 160, torch.bfloat16, "h_fin"),
        ("ragged", 2, 1024, 512, 33, 400, torch.bfloat16, "all")):
    key = f"{geom} {dtype}"
    try:
        S.compare_lstm_train(geom, L, H, I, rows, T, dtype, gen, dev, cts)
        out[key] = "pass"
    except Exception as e:   # a disagreement, or a CUDA error
        out[key] = f"FAIL ({type(e).__name__}): " + str(e).split("; {")[0]
print("RESULT " + json.dumps(out))
"""


def make_copy(name: str, old: str, new: str, tmp: str,
              source: str = SOURCE) -> str:
    """A copy of the port under ``tmp/name`` with ``old`` replaced by
    ``new`` in ``source`` (once)."""
    copy = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "autovc_tpu_torch"),
                    os.path.join(copy, "autovc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    if old:
        path = os.path.join(copy, source)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: the edit does not apply once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return copy


def run(copy: str, check: str = CHECK) -> dict:
    """Check one mutant's copy with the script ``check`` in a subprocess,
    which prints its result as a ``RESULT`` JSON line."""
    proc = subprocess.run([sys.executable, "-c", check], cwd=copy,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return {"error": (proc.stderr or proc.stdout)[-2000:]}


def main(mutants=MUTANTS, source: str = SOURCE, check: str = CHECK,
         sources=("lstm_stack.cu", "lstm_train.cu")) -> int:
    """Copy every mutant, build the kernels ``sources`` of all copies at
    once (one nvcc per source and copy, all started together), then check
    the copies one after another."""
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for name, edit in mutants.items():
            path, (old, new) = (edit[0], edit[1:]) if len(edit) == 3 \
                else (source, edit)
            copies[name] = make_copy(name, old, new, tmp, path)
        build = ("from autovc_tpu_torch.ops import _build; "
                 f"_build.build_all({tuple(sources)!r})")
        builds = {name: subprocess.Popen([sys.executable, "-c", build],
                                         cwd=copy, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                  for name, copy in copies.items()}
        failed = {name: proc.communicate()[0][-2000:]
                  for name, proc in builds.items() if proc.wait() != 0}
        for name, copy in copies.items():
            res = ({"error": "build failed: " + failed[name]}
                   if name in failed else run(copy, check))
            print(json.dumps({"mutant": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
