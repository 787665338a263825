"""Where a round of the layer-skewed LSTM forward (kernels 6 and 3,
``csrc/lstm_fwd.cuh``) spends its time.

    python3 scripts/lstm_fwd_ablation.py         # from the repository root

Needs an NVIDIA GPU and nvcc.  No trace sees inside a persistent kernel,
so each variant below is a copy of the port with one part of the round
removed (its results are wrong by design; only the time is read), built
and run by ``scripts/lstm_train_mutants.py``'s runner.  Each prints the
device ms of one call and the us per round (T + L - 1 rounds) of kernel 6
at lstm2 (bf16, 16 rows x 400) and kernel 3 at lstm2 (bf16, 9 and 33
rows), CUDA events over 3 calls after a warm-up.  A part's cost is the
unmodified copy's time less the variant's.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lstm_train_mutants import main  # noqa: E402

SOURCE = os.path.join("autovc_tpu_torch", "csrc", "lstm_fwd.cuh")

# name -> (text in lstm_fwd.cuh, its replacement)
VARIANTS = {
    "none": ("", ""),
    # the A operand (h from the ring in L2) read as zero
    "no_a_loads": ("const bool in = c + q < hi && k < H;",
                   "const bool in = false;"),
    # the B operand (the resident weights) not read from shared memory
    "no_b_loads": ("const uint4 b = in ? ld_w16(W + g * rstride + k, "
                   "a.resident) : zero;",
                   "const uint4 b = make_uint4(k, g, 0, 0);"),
    # the tensor-core products replaced by one integer op on the operands
    "no_mma": ("            mma_bf16(acc[mt][g], s0, b.x, b.y);\n"
               "            mma_bf16(acc[mt][g], s1, b.z, b.w);",
               "            acc[mt][g][0] += __uint_as_float(s0[0] ^ s1[3] ^ "
               "b.x);"),
    # the epilogue (partial sums, cell update, stores) skipped
    "no_epilogue": ("for (int q = threadIdx.x; q < n * 16 * 8; q += kThreads)",
                    "for (int q = threadIdx.x; q < 0; q += kThreads)"),
    # the grid barrier replaced by a block barrier
    "no_barrier": (
        "        grid_sync_count(a.bar, nbar);\n      }\n    } else {",
        "        __syncthreads();\n      }\n    } else {"),
}

CHECK = """
import json, torch
import chip_smoke as S
from autovc_tpu_torch.ops import lstm_kernels as LK, lstm_train_kernels as LT
g, out = torch.Generator().manual_seed(0), {}
L, H, T = 2, 1024, 400
whh = (torch.randn(L, 4 * H, H, generator=g) * H ** -0.5).cuda().bfloat16()
wih = (torch.randn(L - 1, 4 * H, H, generator=g) * H ** -0.5).cuda().bfloat16()
bias = torch.zeros(L - 1, 4 * H).cuda()
for name, rows in (("kernel6 16 rows", 16), ("kernel3 9 rows", 9),
                   ("kernel3 33 rows", 33)):
    xp0 = torch.randn(T, rows, 4 * H, generator=g).cuda()
    if name.startswith("kernel6"):
        fn = lambda: LT.fwd_launch(xp0, whh, wih, bias)
    else:
        fn = lambda: LK.launch(LK.STREAM, xp0, whh, wih, bias)
    ms = S.timed_ms(fn, 3)
    out[name] = {"ms": ms, "us_per_round": ms * 1e3 / (T + L - 1)}
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(VARIANTS, SOURCE, CHECK))
