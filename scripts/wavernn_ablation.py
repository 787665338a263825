"""Where a step of kernel 1, the WaveRNN sampling loop
(``csrc/wavernn_sample.cu``), spends its time.

    python3 scripts/wavernn_ablation.py          # from the repository root

Needs an NVIDIA GPU and nvcc.  No trace sees inside a persistent kernel,
so each variant below is a copy of the port with one part of the step
removed (its samples are wrong by design; only the time is read), built
and run by ``scripts/wavernn_mutants.py``'s runner.  Each prints the
device ms of one bf16 launch (CUDA events, mean of 2 after a warm-up) at
rd = fc = 512 over 16 frames (4400 steps) and its us a step, at 16 and
48 rows: in MOL (the default config), and for the ``raw9_*`` variants in
RAW with 9 bits (512 classes, a 512-lane pick).  The unmodified copy runs
both: MOL also at the main path's other row buckets, 8, 24, 32 and 64,
RAW-9 at 32, 64 and 128.  A part's cost is the unmodified copy's time
less the variant's.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wavernn_mutants import main  # noqa: E402

# name -> [(text in wavernn_sample.cu, its replacement), ...]
VARIANTS = {
    "none": [],
    # each exchange's wait on the critical path (A waits for c4, B for
    # c1, C for c2, D for c3; A's in both picks), then all four
    "no_wait_a": [("wr_wait(bar + kC4, t * a.prod[kC4]);", ";", 2)],
    "no_wait_b": [("wr_wait(bar + kC1, e * a.prod[kC1]);   // x1", ";  //")],
    "no_wait_c": [("wr_wait(bar + kC2, e * a.prod[kC2]);   // x2", ";  //")],
    "no_wait_d": [("wr_wait(bar + kC3, e * a.prod[kC3]);", ";")],
    "no_waits": [("wr_wait(bar + kC4, t * a.prod[kC4]);", ";", 2),
                 ("wr_wait(bar + kC1, e * a.prod[kC1]);   // x1", ";  //"),
                 ("wr_wait(bar + kC2, e * a.prod[kC2]);   // x2", ";  //"),
                 ("wr_wait(bar + kC3, e * a.prod[kC3]);", ";")],
    # the products' A fragments (the ring in L2; stage A's xI formed from
    # pre_I and the samples) read as zero
    "no_a_loads": [
        ("          x[q][mt][0] = in ? A.load(mt * 16 + gid, k) : zero;\n"
         "          x[q][mt][1] = in ? A.load(mt * 16 + gid + 8, k) : zero;",
         "          x[q][mt][0] = make_uint4(k, mt, 0, 0);\n"
         "          x[q][mt][1] = zero;")],
    # the B fragments (the resident weight rows) not read
    "no_b_loads": [("          y[q][jj] = !(in && nok[jj]) ? zero\n"
                    "                     : w.resident\n"
                    "                         ? lds16(wr[jj] + k)\n"
                    "                         : __ldg(reinterpret_cast<const "
                    "uint4*>(wr[jj] + k));",
                    "          y[q][jj] = make_uint4(k, jj, 0, 0);")],
    # the tensor-core products replaced by one integer op on the operands
    "no_mma": [("            mma_bf16(acc[jj][mt], s0, y[q][jj].x, y[q][jj].y);\n"
                "            mma_bf16(acc[jj][mt], s1, y[q][jj].z, y[q][jj].w);",
                "            acc[jj][mt][0] += __uint_as_float(s0[0] ^ s1[3] ^ "
                "y[q][jj].x);")],
    # the epilogues (cell updates, ReLUs, h-product sums)
    "no_epilogues": [
        ("if (i >= nr << sh) break;", "if (true) break;", 3),
        ("i < nr * 3 * u; i += kThreads", "i < 0; i += kThreads")],
    # stage A's fc3 and pick (the fed-back samples stay 0)
    "no_fc3_pick": [("        wr_pick<T, MT>(a, s, t - 1);", "")],
    # the off-path work: the h products, pre_I's slices
    "no_h_products": [
        ("wr_hh<T, MT>(a, s, r, wr_op(a, kOpH1, wr_slot(t)));", ";"),
        ("wr_hh<T, MT>(a, s, r, wr_op(a, kOpH2, wr_slot(t)));", ";")],
    "no_pre_slices": [("if (t + 1 < steps) wr_pre_slice(a, r, t + 1);",
                       ";")],
    # RAW-9 (the split pick): the slices' fc3 and picks and the merge,
    # with the exchange on cs (the fed-back samples stay 0; the owners
    # still wait for x4)
    "raw9_no_fc3_pick": [
        ("            wr_slice<MT>(a, s, r, t - 1);\n"
         "            wr_arrive(bar + kCS);\n", ""),
        ("          wr_wait(bar + kCS, t * a.prod[kCS]);   // every slice's "
         "best\n          wr_merge(a, s, t - 1);\n", ""),
        ("wr_wait(bar + kCS, steps * a.prod[kCS]);", ";")],
    # RAW-9: the slices' fc3 products alone (their K loops)
    "raw9_no_fc3_product": [("      for (int c = 0; c < nch; c += KB) {",
                             "      for (int c = nch; c < nch; c += KB) {")],
    # RAW-9: the Gumbel lanes neither prefetched nor read
    "raw9_no_noise_reads": [
        ("const float v = acc[2 * h + e] + b3[c] + gn;",
         "const float v = acc[2 * h + e] + b3[c];"),
        ("if (a.noise_smem && ts >= 0 && r.nk > 0) {", "if (false) {")],
    # RAW-9: the merge's wait on cs (the new exchange)
    "raw9_no_wait_cs": [
        ("          wr_wait(bar + kCS, t * a.prod[kCS]);   // every slice's "
         "best", "")],
}

CHECK = """
import json, torch
import chip_smoke as S
from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.models import wavernn as WR
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.utils.bridge import from_jax_params
import os
S.PREC.exact_f32()
gen, dev, out = torch.Generator().manual_seed(0), torch.device("cuda"), {}
name = os.path.basename(os.getcwd())
mol = WaveRNNConfig()
raw9 = mol.with_overrides(mode="RAW", bits=9)
runs = ([("", mol, (8, 16, 24, 32, 48, 64)),
         ("raw9 ", raw9, (16, 32, 48, 64, 128))] if name == "none"
        else [("raw9 ", raw9, (16, 48))] if name.startswith("raw9_")
        else [("", mol, (16, 48))])
frames = 16
for tag, cfg, rows_list in runs:
    params = from_jax_params(WR.init(gen, cfg), dev)
    for rows in rows_list:
        inp, gum, lgs = S.wavernn_inputs(cfg, params, rows, frames, True,
                                         gen, dev, pinned=True)
        ms = S.timed_ms(lambda: WK.launch(inp, gum, lgs), 2)
        out[f"{tag}{rows} rows"] = {"ms": ms,
                                    "us_per_step": ms * 1e3 / inp.steps}
print("RESULT " + json.dumps(out))
"""

if __name__ == "__main__":
    sys.exit(main(VARIANTS, CHECK))
