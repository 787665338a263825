"""Where a round of kernel 5's layer-skewed chain (``csrc/gru_train.cu``,
kernel 5 (a)) spends its time.

    python3 scripts/gru_bwd_ablation.py          # from the repository root

Needs an NVIDIA GPU and nvcc.  No trace sees inside a persistent kernel,
so each variant below is a copy of the port with one part of the round
removed (its results are wrong by design; only the time is read), built
and run by ``scripts/lstm_train_mutants.py``'s runner; "both_layers" keeps
the round whole and gives each block both layers (64 blocks at H = 512)
where the plan gives each layer its own (128).  Each prints, at the
vocoder's bf16 8 rows x 2475 steps and the JAX bench's 32 x 1375, the
device ms of the recurrence launch (``torch.profiler``, mean over 3 calls)
and its us per round (T + 1 rounds).  A part's cost is the unmodified
copy's time less the variant's.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "gru_train.cu")
PLAN = os.path.join("autovc_tpu_torch", "ops", "gru_train_kernels.py")

# name -> (text in gru_train.cu, its replacement), or (file, text, its
# replacement)
VARIANTS = {
    "none": ("", ""),
    # the A operands (dxp2, dhp1, dhp2 from the ring in L2) read as zero
    "no_a_loads": (
        "        x[q][mt][0] = in && rlo < rows_g\n"
        "            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rlo "
        "* K + k))\n"
        "            : zero;\n"
        "        x[q][mt][1] = in && rhi < rows_g\n",
        "        x[q][mt][0] = make_uint4(rlo, k, 0, 0);\n"
        "        x[q][mt][1] = false && rhi < rows_g\n"),
    # the B operand (the resident weight rows) not read
    "no_b_loads": ("y[q] = in && u_ok ? ld_w16(W + k, resident) : zero;",
                   "y[q] = make_uint4(k, q, 0, 0);"),
    # the tensor-core products replaced by one integer op on the operands
    "no_mma": ("        mma_bf16(acc[mt], s0, y[q].x, y[q].y);\n"
               "        mma_bf16(acc[mt], s1, y[q].z, y[q].w);",
               "        acc[mt][0] += __uint_as_float(s0[0] ^ s1[3] ^ "
               "y[q].x);"),
    # the epilogue (partial sums, gate derivatives, stores) skipped
    "no_epilogue": ("if (!ok[k] || t < 0 || t >= T) continue;\n"
                    "        float dh_prod = 0.0f;",
                    "if (true) continue;\n        float dh_prod = 0.0f;"),
    # the grid barrier replaced by a block barrier
    "no_barrier": ("        load_round_inputs(a, r, s + 1, g0, ok, pli, prow, "
                   "punit, in);\n        grid_sync_count(a.bar, nbar);",
                   "        load_round_inputs(a, r, s + 1, g0, ok, pli, prow, "
                   "punit, in);\n        __syncthreads();"),
    # whole round, each block holding both layers
    "both_layers": (PLAN, "    split = 2 * -(-H // 8) <= sms",
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
    hs, saved = GT.fwd_launch(xp1, base2,
                              *GT.pack_fwd(*w, torch.bfloat16), b, b)
    cts = [torch.randn(T, rows, H, generator=g).cuda() for _ in range(2)]
    wb = GT.pack_bwd(*w, torch.bfloat16)
    fn = lambda: GT.bwd_launch(saved, hs, *cts, *wb)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rec = S.kernel_launch_ms(prof, ("gru_train_bwd_kernel",))
    ms = statistics.fmean(rec["gru_train_bwd_kernel"])
    out[f"{rows} x {T} bf16"] = {"recurrence_ms": ms,
                                 "us_per_round": ms * 1e3 / (T + 1)}
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(VARIANTS, SOURCE, CHECK, ("gru_train.cu",)))
