"""Kernel 2, the LSTM stack at 8 rows or fewer, timed at the geometries it
takes, beside kernel 3's routine on the same inputs.

    python3 scripts/lstm_small_rows.py

Needs an NVIDIA GPU and nvcc.  ``chip_smoke.py`` logs the same numbers
for its own tree (its ``lstm_stack_skewed plan`` lines); this script times
the kernels of the checkout it is run from (the current directory), so
running this file from the root of an older commit's checkout (``git
archive`` it into a directory), whose ``chip_smoke.py`` does not time
kernel 2 at these geometries, times that commit's kernels on the same
inputs.  It uses only what the port has had since its first slice
(``lstm_kernels.launch`` of ``SKEWED`` and ``STREAM``) and the checkout's
``chip_smoke.timed_ms`` (device ms of one launch: CUDA events, mean of 10
after a warm-up), with ``chip_smoke.py``'s geometries (their values where
the checkout's ``chip_smoke.py`` predates them).  Fresh seeded weights;
the decoder lstm2 (2 x 1024, input 512, T = 400) at 1, 2 and 8 rows in
bf16 and at 2 rows in f32, the speaker encoder's stack (3 x 256, input
40, T = 160) and lstm1 (1 x 512, input 320, T = 400) at 8 rows in bf16;
us a round (T + L - 1 rounds) and kernel 2's largest error relative to
max |plain|.  Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from autovc_tpu_torch.ops import lstm_kernels as LK  # noqa: E402
from autovc_tpu_torch.ops import rnn as R  # noqa: E402
from autovc_tpu_torch.utils.bridge import from_jax_params  # noqa: E402

# (layers, hidden, input, steps)
LSTM2 = getattr(S, "LSTM2", (2, 1024, 512, 400))
SE_STACK = getattr(S, "SE_STACK", (3, 256, 40, 160))
LSTM1 = getattr(S, "LSTM1", (1, 512, 320, 400))
# (name, geometry, rows, dtype)
CASES = [("lstm2", LSTM2, 1, torch.bfloat16),
         ("lstm2", LSTM2, 2, torch.bfloat16),
         ("lstm2", LSTM2, 8, torch.bfloat16),
         ("lstm2", LSTM2, 2, torch.float32),
         ("speaker_encoder", SE_STACK, 8, torch.bfloat16),
         ("lstm1", LSTM1, 8, torch.bfloat16)]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, dev = torch.Generator().manual_seed(0), torch.device("cuda")
    out = {"tree": os.path.basename(os.getcwd())}
    for name, (L, H, I, T), rows, dtype in CASES:
        params = from_jax_params(R.init_lstm_stack(gen, I, H, L), dev)
        x = torch.randn(rows, T, I, generator=gen).to(dev)
        mode = "bf16" if dtype == torch.bfloat16 else "f32"
        xp0 = LK.hoist_xp0(params[0], x, mode)
        w = LK.pack_stack(params, dtype)
        ref = LK.lstm_stack_plain(xp0, *w)
        err = float((LK.launch(LK.SKEWED, xp0, *w) - ref).abs().max())
        k2 = S.timed_ms(lambda: LK.launch(LK.SKEWED, xp0, *w), 10)
        k3 = S.timed_ms(lambda: LK.launch(LK.STREAM, xp0, *w), 10)
        out[f"{name} {rows} rows {mode}"] = {
            "ms": k2, "us_per_round": k2 * 1e3 / (T + L - 1),
            "stream_ms": k3, "stream_us_per_round": k3 * 1e3 / (T + L - 1),
            "rel_err": err / float(ref.abs().max())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
