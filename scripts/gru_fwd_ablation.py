"""Where a round of kernel 4, the GRU pair's layer-skewed training forward
(``csrc/gru_train.cu``), spends its time.

    python3 scripts/gru_fwd_ablation.py          # from the repository root

Needs an NVIDIA GPU and nvcc.  No trace sees inside a persistent kernel,
so each variant below is a copy of the port with one part of the round
removed (its results are wrong by design; only the time is read), built
and run by ``scripts/lstm_train_mutants.py``'s runner; "one_part_read",
"no_saves" and "fast_cell" split the epilogue; "no_prefetch" keeps the
round whole but loads the next round's xp1 / base2 slices after the
barrier, and "both_layers" gives each block both layers (64 blocks at
H = 512) where the plan gives each layer its own (128).  Each prints, at
the vocoder's bf16 8 rows x 2475 steps and the JAX bench's 32 x 1375, the
device ms of the launch (``torch.profiler``, mean over 3 calls) and its us
per round (T + 1 rounds).  A part's cost is the unmodified copy's time
less the variant's.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "gru_train.cu")
PLAN = os.path.join("autovc_tpu_torch", "ops", "gru_train_kernels.py")
PREFETCH = "        fwd_load_inputs(a, r, s + 1, g0, ok, pli, prow, punit, in);\n"
BARRIER = "        grid_sync_count(a.bar, nbar);\n"

# name -> (text in gru_train.cu, its replacement), or (file, text, its
# replacement)
VARIANTS = {
    "none": ("", ""),
    # the grid barrier replaced by a block barrier
    "no_barrier": (PREFETCH + BARRIER, PREFETCH + "        __syncthreads();\n"),
    # the A operands (h1, h2 from the ring in L2) read as zero
    "no_a_loads": (
        "        x[q][mt][0] = in && rlo < rows_g\n"
        "            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rlo "
        "* H + k))\n"
        "            : zero;\n"
        "        x[q][mt][1] = in && rhi < rows_g\n",
        "        x[q][mt][0] = make_uint4(rlo, k, 0, 0);\n"
        "        x[q][mt][1] = false && rhi < rows_g\n"),
    # the B operand (the resident weight columns) not read
    "no_b_loads": (
        "const uint4 b = in ? ld_w16(W + g * gstride + k, resident) : zero;",
        "const uint4 b = make_uint4(k, g, 0, 0);"),
    # the tensor-core products replaced by one integer op on the operands
    "no_mma": ("          mma_bf16(acc[mt][g], s0, b.x, b.y);\n"
               "          mma_bf16(acc[mt][g], s1, b.z, b.w);",
               "          acc[mt][g][0] += __uint_as_float(s0[0] ^ s1[3] ^ "
               "b.x);"),
    # the epilogue (partial sums, cells, stores) skipped
    "no_epilogue": ("if (!ok[k] || t < 0 || t >= T) continue;\n"
                    "        const int row = prow[k], u = punit[k];",
                    "if (true) continue;\n"
                    "        const int row = prow[k], u = punit[k];"),
    # the epilogue's parts: the partial tiles' sums cut to one tile read,
    # the saved state (hs, acts) not stored, the cell's accurate
    # transcendentals replaced by the fast intrinsics
    "one_part_read": (
        "    for (int w = first; w < kWarps; w += step) sum += p[w * tile];",
        "    sum = p[first * tile];"),
    "no_saves": ("  store_cs(a.hs + at + j, h);\n"
                 "  WT* act = a.acts + at * 4 + j;\n"
                 "  store_cs(act, r);\n"
                 "  store_cs(act + H, z);\n"
                 "  store_cs(act + 2 * H, n);\n"
                 "  store_cs(act + 3 * H, hp[2]);\n", ""),
    "fast_cell": ("  const float r = sigmoidf_(xp[0] + hp[0]);\n"
                  "  const float z = sigmoidf_(xp[1] + hp[1]);\n"
                  "  const float n = tanhf(xp[2] + r * hp[2]);\n",
                  "  const float r = __fdividef(1.0f, 1.0f + __expf(-xp[0] - "
                  "hp[0]));\n"
                  "  const float z = __fdividef(1.0f, 1.0f + __expf(-xp[1] - "
                  "hp[1]));\n"
                  "  const float n = 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f "
                  "* (xp[2] + r * hp[2])));\n"),
    # the next round's inputs loaded after the barrier, not before it
    "no_prefetch": (PREFETCH + BARRIER, BARRIER + PREFETCH),
    # whole round, each block holding both layers
    "both_layers": (PLAN, "    split = sms >= 2 * -(-H // 8)",
                    "    split = False"),
}

CHECK = """
import json, statistics, torch
import chip_smoke as S
from autovc_tpu_torch.ops import gru_train_kernels as GT
g, out, H = torch.Generator().manual_seed(0), {}, 512
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
for rows, T in ((8, 2475), (32, 1375)):
    w = [(torch.randn(H, 3 * H, generator=g) * H ** -0.5).cuda()
         for _ in range(3)]
    xp1, base2 = (0.5 * torch.randn(T, rows, 3 * H, generator=g)).cuda(), \\
        (0.5 * torch.randn(T, rows, 3 * H, generator=g)).cuda()
    b = torch.zeros(3 * H).cuda()
    wf = GT.pack_fwd(*w, torch.bfloat16)
    fn = lambda: GT.fwd_launch(xp1, base2, *wf, b, b)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rec = S.kernel_launch_ms(prof, ("gru_train_fwd_kernel",))
    ms = statistics.fmean(rec["gru_train_fwd_kernel"])
    plan = GT.device_fwd_plan(rows, H, True, xp1.device)
    out[f"{rows} x {T} bf16"] = {"ms": ms, "us_per_round": ms * 1e3 / (T + 1),
                                 "split": plan.split, "blocks": plan.blocks}
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(VARIANTS, SOURCE, CHECK, ("gru_train.cu",)))
