"""Mutation check of the GRU-pair training kernels (kernels 4 and 5).

    python3 scripts/gru_train_mutants.py         # from the repository root

Needs an NVIDIA GPU and nvcc.  As ``scripts/lstm_train_mutants.py`` (whose
runner it uses): for each mutant the port is copied into a temporary
directory and one edit is made to the copy's ``csrc/gru_train.cu`` (the
layer-skewed schedule of kernel 4 or 5, the saved state, or the dW
problems); every copy's kernels are built at once, then for each a
subprocess holds the mutated kernels against their plain versions with
``chip_smoke.compare_gru_train`` at the smoke run's three geometries (f32
and bf16 at 8 x 2475, bf16 at 32 x 1375).  The first "mutant" is an
unmutated copy.  Prints one JSON line per mutant: each geometry's "pass"
or the first failure's message.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "gru_train.cu")

# name -> (text in gru_train.cu, its replacement)
MUTANTS = {
    "none": ("", ""),
    # both layers' saved hn without b_hn (the reset product's bias)
    "hn_without_bhh": ("store_cs(act + 3 * H, hp[2]);",
                       "store_cs(act + 3 * H, "
                       "hp[2] - __ldg((l ? a.bhh2 : a.bhh1) + 2 * H + j));"),
    # the carried dh of both layers drops its dh z term
    "dh_next_without_dh_z": ("  return dh * z;\n}", "  return 0.0f;\n}"),
    # dW_ih2x from h1_{t-1} instead of h1_t
    "dwih2x_from_h1_prev": ("{hs, dxp2, dwih2x, nullptr, nullptr, M, N, K, 0,",
                            "{hs, dxp2, dwih2x, nullptr, nullptr, M, N, K, B,"),
    # kernel 4's skewed schedule: layer 2 reads h1 from the ring slot
    # layer 1 writes this round
    "fwd_x_from_this_round": (
        "int fwd_x_slot(int s) { return fwd_read_slot(s); }",
        "int fwd_x_slot(int s) { return fwd_write_slot(s); }"),
    # kernel 4 reads every product operand from the slot written this round
    "fwd_ring_slots_swapped": (
        "int fwd_read_slot(int s) { return (s + 1) & 1; }",
        "int fwd_read_slot(int s) { return s & 1; }"),
    # kernel 4's M-tiles after the first multiply the first M-tile's rows
    "fwd_mtile_reuses_first_a": ("const uint4* xm = x[q][mt];",
                                 "const uint4* xm = x[q][0];"),
    # kernel 4's barrier k waits for k - 1 rounds' arrivals: a block runs
    # up to a round ahead of the others
    "fwd_barrier_count_one_short": (
        "unsigned int nbar = 0;   // grid barriers passed",
        "unsigned int nbar = 0u - 1u;   // grid barriers passed"),
    # kernel 5's skewed schedule: layer 1 reads dxp2 from the ring slot
    # layer 2 writes this round
    "bwd_x_from_this_round": (
        "int bwd_x_slot(int s) { return bwd_read_slot(s); }",
        "int bwd_x_slot(int s) { return bwd_write_slot(s); }"),
    # every product operand read from the slot written this round
    "bwd_ring_slots_swapped": (
        "int bwd_read_slot(int s) { return (s + 1) & 1; }",
        "int bwd_read_slot(int s) { return s & 1; }"),
    # M-tiles after the first multiply the first M-tile's rows
    "bwd_mtile_reuses_first_a": ("const uint4* xa = x[q][mt];",
                                 "const uint4* xa = x[q][0];"),
    # the last round (layer 1 at step 0) skipped
    "bwd_last_round_skipped": (
        "    load_round_inputs(a, r, 0, g0, ok, pli, prow, punit, in);\n"
        "    for (int s = 0; s <= T; ++s) {",
        "    load_round_inputs(a, r, 0, g0, ok, pli, prow, punit, in);\n"
        "    for (int s = 0; s < T; ++s) {"),
}

CHECK = """
import json, torch
import chip_smoke as S
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
for rows, T, dtype in ((8, 2475, torch.float32), (8, 2475, torch.bfloat16),
                       (32, 1375, torch.bfloat16)):
    key = f"{rows} x {T} {dtype}"
    try:
        S.compare_gru_train(rows, T, dtype, gen, dev)
        out[key] = "pass"
    except AssertionError as e:
        out[key] = "FAIL: " + str(e).split("; {")[0]
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(MUTANTS, SOURCE, CHECK, ("gru_train.cu",)))
