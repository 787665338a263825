"""Mutation check of the LSTM-stack training kernels (kernels 6 and 7).

    python3 scripts/lstm_train_mutants.py        # from the repository root

Needs an NVIDIA GPU and nvcc.  For each mutant the port is copied into a
temporary directory, one edit is made to the copy's
``csrc/lstm_train.cu``, and a subprocess holds the mutated kernels against
their plain versions with ``chip_smoke.compare_lstm_train`` at the smoke
run's five training geometries (lstm2 f32 and bf16, lstm1 bf16, the speaker
encoder's stack bf16, lstm2 bf16 at a ragged 33 rows, last: a mutant that
writes out of bounds may leave the device unusable).  The first "mutant" is
an unmutated copy.  Prints one JSON line per mutant: each geometry's "pass"
or the failure message.
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

# name -> (text in lstm_train.cu, its replacement)
MUTANTS = {
    "none": ("", ""),
    "da_f_uses_c_t": ("const float da_f = dc * c_p * f_",
                      "const float da_f = dc * c_t * f_"),
    "h_saved_bf16": ("store_cs(h_out + idx, h_new);",
                     "store_cs(h_out + idx, "
                     "__bfloat162float(__float2bfloat16_rn(h_new)));"),
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
}

CHECK = """
import json, sys, torch
import chip_smoke as S
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
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


def run(name: str, old: str, new: str, tmp: str, source: str = SOURCE,
        check: str = CHECK) -> dict:
    """One mutant: a copy of the port with ``old`` replaced by ``new`` in
    ``source`` (once), checked by the script ``check`` in a subprocess,
    which prints its result as a ``RESULT`` JSON line."""
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
    proc = subprocess.run([sys.executable, "-c", check], cwd=copy,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return {"error": (proc.stderr or proc.stdout)[-2000:]}


def main(mutants=MUTANTS, source: str = SOURCE, check: str = CHECK) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for name, (old, new) in mutants.items():
            print(json.dumps({"mutant": name,
                              **run(name, old, new, tmp, source, check)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
