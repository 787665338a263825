"""Mutation check of kernel 2, the layer-skewed LSTM stack at 8 rows or
fewer (``csrc/lstm_stack.cu:lstm_small_kernel``).

    python3 scripts/lstm_small_mutants.py        # from the repository root

Needs an NVIDIA GPU and nvcc.  As ``scripts/lstm_train_mutants.py`` (whose
runner it uses): for each mutant the port is copied into a temporary
directory and one edit is made to the copy's ``csrc/lstm_stack.cu`` (the
schedule's ring slots, the barrier, the carried c, layer 0's
pre-activations, the row mask); every copy's kernels are built at once,
then for each a subprocess holds the mutated kernel against the plain
version with ``chip_smoke.compare_lstm`` at six geometries: the decoder
lstm2 in bf16 at 1, 2 and 8 rows and in f32 at 2 rows, the speaker
encoder's stack in bf16 at 5 rows (one layer a block) and lstm1 in bf16 at
8 rows.  The first "mutant" is an unmutated copy; the last writes past its
buffers.  Prints one JSON line per mutant: each geometry's "pass" or the
failure message.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "lstm_stack.cu")

# name -> (text in lstm_stack.cu, its replacement)
MUTANTS = {
    "none": ("", ""),
    # every product reads h from the ring slot written this round
    "ring_slots_swapped": (
        "int small_read_slot(int s) { return (s + 1) & 1; }",
        "int small_read_slot(int s) { return s & 1; }"),
    # barrier k waits for k - 1 rounds' arrivals: a block runs up to a
    # round ahead of the others
    "barrier_count_one_short": (
        "unsigned int nbar = 0;   // grid barriers passed",
        "unsigned int nbar = 0u - 1u;   // grid barriers passed"),
    # the cell drops f * c_{t-1}
    "c_not_carried": ("  c = fg * c_old + ig * gg;", "  c = ig * gg;"),
    # layer 0 at step t adds the pre-activations of step t + 1
    "xp0_wrong_step": ("small_load_x0<NG>(a, r, s, xin);",
                       "small_load_x0<NG>(a, r, s + 1, xin);"),
    # layers >= 1 read the layer below's h from the slot written this round
    "below_from_this_round": (
        "(size_t)(small_read_slot(s) * a.L + l - ih)",
        "(size_t)((ih ? small_write_slot(s) : small_read_slot(s)) * a.L"
        " + l - ih)"),
    # the N-tile's columns past the batch stored to the ring too (into the
    # next ring entry's rows, and past the end of the ring)
    "rows_past_batch_unmasked": (
        "if (row < a.B)   // the N-tile's columns past the batch are not "
        "stored", "if (true)"),
}

CHECK = """
import json, torch
import chip_smoke as S
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
for name, geom, rows, dtype in (
        ("lstm2", S.LSTM2, 1, torch.bfloat16),
        ("lstm2", S.LSTM2, 2, torch.bfloat16),
        ("lstm2", S.LSTM2, 8, torch.bfloat16),
        ("lstm2", S.LSTM2, 2, torch.float32),
        ("speaker_encoder", S.SE_STACK, 5, torch.bfloat16),
        ("lstm1", S.LSTM1, 8, torch.bfloat16)):
    key = f"{name} {rows} rows {dtype}"
    try:
        S.compare_lstm("lstm_stack_skewed", rows, dtype, gen, dev, geom)
        out[key] = "pass"
    except Exception as e:   # a disagreement, or a CUDA error
        out[key] = f"FAIL ({type(e).__name__}): " + str(e)[:200]
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(MUTANTS, SOURCE, CHECK, ("lstm_stack.cu",)))
