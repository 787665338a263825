"""Where a round of kernel 2, the layer-skewed LSTM stack at 8 rows or
fewer (``csrc/lstm_stack.cu:lstm_small_kernel``), spends its time.

    python3 scripts/lstm_small_ablation.py       # from the repository root

Needs an NVIDIA GPU and nvcc.  No trace sees inside a persistent kernel,
so each variant below is a copy of the port with one part of the round
removed (its results are wrong by design; only the time is read), built
and run by ``scripts/lstm_train_mutants.py``'s runner.  "one_part_read"
splits the epilogue.  Four variants keep the round whole and undo one
choice of the design: "sc_fence" (a sequentially consistent fence
before the barrier's arrival), "accurate_cell" (tanhf and expf in the
cells), "y_before_barrier" (the top layer's y stored before the
barrier), "wave_every_round" (the warps' pieces recomputed every
round); "all_layers" gives each block every layer where the plan gives
each layer its own blocks (the speaker encoder's stack).  Each prints,
in bf16, the device ms of one call (CUDA events, mean of 10 after a
warm-up) and its us per round (T + L - 1 rounds) at lstm2 (2 x 1024, T =
400) at 1 and 8 rows, the speaker encoder's stack (3 x 256, T = 160) at 1
and 8 rows and lstm1 (1 x 512, T = 400) at 8 rows.  A part's cost is the
unmodified copy's time less the variant's.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "lstm_stack.cu")
PLAN = os.path.join("autovc_tpu_torch", "ops", "lstm_kernels.py")
BARRIER = "        grid_sync_count<false>(a.bar, nbar);\n"
FLUSH = "        small_flush_y<NG>(a, r, y);\n"

# name -> (text in lstm_stack.cu, its replacement), or (file, text, its
# replacement)
VARIANTS = {
    "none": ("", ""),
    # the grid barrier replaced by a block barrier
    "no_barrier": (BARRIER + FLUSH, "        __syncthreads();\n" + FLUSH),
    # the barrier's arrival after a sequentially consistent fence (the
    # form of kernels 3-6)
    "sc_fence": (BARRIER + FLUSH,
                 "        grid_sync_count<true>(a.bar, nbar);\n" + FLUSH),
    # the A operands (the resident weight rows) not read
    "no_a_loads": (
        "            f0 = wsm[small_frag(m, mt, c + q, 0, lane, MT, nch)];\n"
        "            f1 = wsm[small_frag(m, mt, c + q, 1, lane, MT, nch)];\n",
        "            f0 = make_uint4(c + q, mt, lane, 0);\n"
        "            f1 = make_uint4(q, m, 0, lane);\n"),
    # the B operands (h from the ring in L2) read as constants
    "no_b_loads": ("? __ldcg(reinterpret_cast<const uint4*>(hrow + k))",
                   "? make_uint4(k, q, 0, 1)"),
    # the tensor-core products replaced by one integer op on the operands
    "no_mma": ("          mma_u4(acc[mt][0], f0, xb[q].x, xb[q].y);\n"
               "          mma_u4(acc[mt][1], f1, xb[q].z, xb[q].w);\n",
               "          acc[mt][0][0] += "
               "__uint_as_float(f0.x ^ f1.w ^ xb[q].x);\n"),
    # the whole product (A, B, mma) skipped
    "no_product": ("        if (li >= 0) {\n          float acc",
                   "        if (false) {\n          float acc"),
    # the epilogue (partial sums, cells, stores) skipped
    "no_epilogue": ("        if (i < n)\n          small_epilogue_mma<NG>(",
                    "        if (false)\n          small_epilogue_mma<NG>("),
    # the epilogue's parts: one partial tile read a sum, not all of the
    # layer's; the accurate transcendentals (tanhf, expf) for the fast ones
    "one_part_read": (
        "    for (int q = first; q < first + cnt; ++q) {",
        "    for (int q = first; q < first + min(cnt, 1); ++q) {"),
    "accurate_cell": ("small_cell<true>(pre", "small_cell<false>(pre"),
    # the top layer's y stored before the barrier, not after
    "y_before_barrier": (BARRIER + FLUSH, FLUSH + BARRIER),
    # the warps' pieces recomputed every round, not only when they change
    "wave_every_round": ("        if (wkey != key) {", "        if (true) {"),
    # whole round, each block holding every layer
    "all_layers": (PLAN, "    split = L > 1 and L * -(-H // 8) <= sms",
                   "    split = False"),
}

CHECK = """
import json, torch
import chip_smoke as S
from autovc_tpu_torch.ops import lstm_kernels as LK
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
for name, geom, rows in (("lstm2", S.LSTM2, 1), ("lstm2", S.LSTM2, 8),
                         ("se", S.SE_STACK, 1), ("se", S.SE_STACK, 8),
                         ("lstm1", S.LSTM1, 8)):
    L, H, I, T = geom
    params = S.from_jax_params(S.R.init_lstm_stack(gen, I, H, L), dev)
    x = torch.randn(rows, T, I, generator=gen).to(dev)
    xp0 = LK.hoist_xp0(params[0], x, "bf16")
    w = LK.pack_stack(params, torch.bfloat16)
    ms = S.timed_ms(lambda: LK.launch(LK.SKEWED, xp0, *w), 10)
    plan = LK.device_small_plan(rows, H, L, True, dev)
    out[f"{name} {rows} rows"] = {
        "ms": ms, "us_per_round": ms * 1e3 / (T + L - 1),
        "split": plan.split, "blocks": plan.blocks}
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(VARIANTS, SOURCE, CHECK, ("lstm_stack.cu",)))
