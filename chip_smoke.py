"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  2. build: every CUDA kernel of the port, compiled with nvcc for sm_90a;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs and noise, at full model width;
  4. end to end: ``VoiceConverter()`` (default config, fresh seeded
     weights) converts a ~4 s wav (decoder lstm2 through kernel 2) and a
     ~24 s wav (9 mel chunks: kernel 3), with every kernel's launch count
     read around each conversion; then converts each again under
     ``torch.profiler`` (the device's idle share) and with its stages
     timed (where the wall time goes).
It prints one JSON line per comparison, then the per-kernel summary line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from autovc_tpu_torch import Audio, VoiceConverter  # noqa: E402
from autovc_tpu_torch.audio import dsp  # noqa: E402
from autovc_tpu_torch.config import WaveRNNConfig  # noqa: E402
from autovc_tpu_torch.models import wavernn as WR  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import lstm_kernels as LK  # noqa: E402
from autovc_tpu_torch.ops import precision as PREC  # noqa: E402
from autovc_tpu_torch.ops import rnn as R  # noqa: E402
from autovc_tpu_torch.ops import wavernn_kernels as WK  # noqa: E402
from autovc_tpu_torch.utils.bridge import from_jax_params  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is max(bytes / HBM rate, operations / peak rate of their type).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNELS = {
    "wavernn_sample": dict(
        kernel=WK.SAMPLE, source="autovc_tpu_torch/csrc/wavernn_sample.cu",
        replaces="autovc_tpu/ops/wavernn_pallas.py:269"),
    "lstm_stack_skewed": dict(
        kernel=LK.SKEWED, source="autovc_tpu_torch/csrc/lstm_stack.cu",
        replaces="autovc_tpu/ops/lstm_pallas.py:136"),
    "lstm_stack_stream": dict(
        kernel=LK.STREAM, source="autovc_tpu_torch/csrc/lstm_stack.cu",
        replaces="autovc_tpu/ops/lstm_pallas.py:271"),
}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``, CUDA events over ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment() -> str:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log(nvcc.strip().splitlines()[-1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    return card


def phase_build() -> None:
    t0 = time.time()
    _build.build_all()
    log({"phase": "build", "seconds": round(time.time() - t0, 2)})
    for src, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")


def compare_lstm(name: str, rows: int, dtype, gen, dev) -> dict:
    """Kernel 2 or 3 against the plain version at the decoder lstm2
    geometry (L=2, H=1024, input 512, T=400)."""
    L, H, I, T = 2, 1024, 512, 400
    params = from_jax_params(R.init_lstm_stack(gen, I, H, L), dev)
    x = torch.randn(rows, T, I, generator=gen).to(dev)
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    xp0 = LK.hoist_xp0(params[0], x, mode)
    whh, wih, bias = LK.pack_stack(params, dtype)
    kernel = KERNELS[name]["kernel"]
    out = LK.launch(kernel, xp0, whh, wih, bias)
    ref = LK.lstm_stack_plain(xp0, whh, wih, bias)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ok = err < 1e-4 if dtype == torch.float32 else err / scale < 2e-2
    ms = timed_ms(lambda: LK.launch(kernel, xp0, whh, wih, bias), 5)
    plain_ms = timed_ms(lambda: LK.lstm_stack_plain(xp0, whh, wih, bias), 1)
    lib_params = [{k: v.to(dtype) for k, v in p.items()} for p in params]
    xl = x.to(dtype)
    library_ms = timed_ms(lambda: R.lstm_stack(lib_params, xl), 5)
    ops = 2.0 * rows * T * (L + L - 1) * 4 * H * H
    b_ms, b_by = bound(nbytes(xp0, whh, wih, bias, out), ops, dtype)
    res = {"phase": "compare", "kernel": name, "dtype": str(dtype),
           "rows": rows, "T": T, "max_abs_err": err, "ref_max_abs": scale,
           "tolerance": ("atol 1e-4" if dtype == torch.float32
                         else "max_err / max|ref| < 2e-2"),
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(res)
    if not ok:
        raise AssertionError(f"{name} {dtype} disagrees with its plain "
                             f"version: {err} (max |ref| {scale})")
    return res


def wavernn_inputs(cfg, params, rows: int, frames: int, fast_math: bool,
                   gen, dev, pinned: bool = False):
    """Kernel 1's inputs for ``rows`` fold rows of ``frames`` frames:
    random conditioning through the main path's projections and packed
    weights, and the sampling noise from ``draw_noise`` (bf16-rounded in
    fast mode, as ``generate_rows`` hands it over).  ``pinned`` raises one
    random Gumbel lane per step and row by 1e3: the pick then no longer
    hangs on the logits' last bits, so two implementations that sum in
    another order stay on one sample path over a whole fold.  (With the
    drawn noise a pick that one side flips decorrelates the two sample
    streams, often within ~100 steps.)"""
    J = WR._upsample_margin(params["upsample"]["up_convs"],
                            cfg.upsample_factors)
    mel_rows = torch.rand(rows, frames + 2 * J, cfg.feat_dims,
                          generator=gen).to(dev)
    aux_rows = torch.randn(rows, frames, cfg.res_out_dims,
                           generator=gen).to(dev)
    packed = WK.pack_weights(params, cfg, fast_math)
    inp = WK.prepare_rows(params, mel_rows, aux_rows, cfg, fast_math, packed)
    noise_gen = torch.Generator(device=dev).manual_seed(7)
    gumbel, logistic = WK.draw_noise(inp.steps, rows, inp.pick_dim,
                                     noise_gen, dev)
    if pinned:
        lane = torch.randint(0, inp.pick_dim, (inp.steps, rows, 1),
                             generator=gen).to(dev)
        gumbel = gumbel.scatter(-1, lane, 1e3)
    if fast_math:
        gumbel, logistic = PREC.round_bf16(gumbel), PREC.round_bf16(logistic)
    return inp, gumbel.contiguous(), logistic.contiguous()


def first_frames(inp, gumbel, logistic, frames: int):
    """The inputs of the loop's first ``frames`` frames (for the plain
    loop, whose first steps see nothing later)."""
    J = inp.ktab.shape[0] // 2
    steps = frames * inp.ktab.shape[1]
    cut = {k: v for k, v in vars(inp).items()}
    cut["mf"] = inp.mf[:, :frames + 2 * J]
    for k in ("base", "pre_r2", "pre_f1", "pre_f2"):
        cut[k] = getattr(inp, k)[:, :frames]
    return WK.RowsInputs(**cut), gumbel[:steps], logistic[:steps]


def wavernn_cost(inp, gumbel, logistic, out) -> tuple[int, float]:
    weights = (inp.w_ih1, inp.w_hh1, inp.w_ih2, inp.w_hh2, inp.w_fc1,
               inp.w_fc2, inp.w_fc3)
    moved = nbytes(*weights, inp.mf, inp.base, inp.pre_r2, inp.pre_f1,
                   inp.pre_f2, inp.ktab, inp.w_x, gumbel, logistic, out)
    per_row_step = sum(w.numel() for w in weights) + inp.ktab.shape[0] * \
        inp.w_x.shape[0]
    return moved, 2.0 * inp.rows * inp.steps * per_row_step


def hold(out, ref, max_bar: float, mean_bar: float | None = None,
         **info) -> dict:
    """Log kernel-1 samples ``out`` against the plain loop's ``ref`` (both
    (rows, steps)); raise if a sample differs by ``max_bar`` or more, if
    the mean difference reaches ``mean_bar``, or if a sample is not finite
    in [-1, 1]."""
    diff = (out - ref).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    bad = (diff >= max_bar).any(dim=0).nonzero()
    ok = not len(bad) and (mean_bar is None or mean_err < mean_bar)
    in_range = bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1
    res = {"phase": "compare", "kernel": "wavernn_sample", **info,
           "compared_steps": ref.shape[1], "max_abs_err": err,
           "mean_abs_err": mean_err,
           "tolerance": f"max |err| < {max_bar:.4g}" + (
               "" if mean_bar is None else f", mean |err| < {mean_bar:.4g}"),
           "ok": ok and in_range, "samples_in_range": in_range,
           "first_divergent_step": int(bad[0]) if len(bad) else None}
    log(res)
    if not res["ok"]:
        raise AssertionError(f"wavernn_sample disagrees with its plain "
                             f"version: {res}")
    return res


def compare_wavernn(gen, dev) -> dict:
    """Kernel 1 against the plain loop, at rd = fc = 512, MOL:
      * f32, 8 rows x 4 frames, drawn noise: atol 1e-3;
      * f32, 48 rows x 4 frames, pinned noise: atol 1e-3;
      * bf16 (the main path's tensor-core GRU stages) at the main path's
        row buckets, 16 (the 4 s wav's 10 folds) and 48 (the 24 s wav's
        48), on a full 11000 + 2 * 550 fold (44 frames, 12100 steps):
        - drawn noise, the first 8 steps: atol 1e-2 (later, a pick that
          one side flips decorrelates the streams); all steps finite, in
          [-1, 1], mean and std within 0.1 and 0.15 of the f32 kernel's
          on the same inputs;
        - pinned noise, the first 30 steps: atol 1e-2;
        - pinned noise, all 12100 steps: max |err| below twice, mean |err|
          below 1.15 times the plain loop's own spread when its mel
          projection is scaled by 1 + 1e-6 N(0, 1).  In bf16 any
          perturbation, however small, flips some operand roundings and
          settles at that spread (max ~1.1e-2, mean ~4.5e-4 over a fold),
          so no implementation meets a fixed 1e-2 over a whole fold.  The
          kernel's mean |err| is that spread (ratio ~1.00); one that kept
          the GRU state rounded to bf16 gives ~1.25, a misplaced bias far
          more.
    Returns the 16-row bf16 full-fold comparison, with its kernel time."""
    cfg = WaveRNNConfig()
    params = from_jax_params(WR.init(gen, cfg), dev)
    for rows, pinned in ((8, False), (48, True)):
        inp, gum, lgs = wavernn_inputs(cfg, params, rows, 4, False, gen, dev,
                                       pinned)
        hold(WK.launch(inp, gum, lgs), WK.sample_rows_plain(inp, gum, lgs),
             1e-3, dtype="torch.float32", rows=rows, steps=inp.steps,
             noise="pinned" if pinned else "drawn")
    fpf = (11000 + 2 * 550) // cfg.total_scale
    main = None
    for rows in (16, 48):
        bf16 = dict(dtype="torch.bfloat16", rows=rows)
        inp, gum, lgs = wavernn_inputs(cfg, params, rows, fpf, True, gen, dev)
        out = WK.launch(inp, gum, lgs)
        ref = WK.sample_rows_plain(*first_frames(inp, gum, lgs, 1))
        hold(out[:, :8], ref[:, :8], 1e-2, steps=inp.steps, noise="drawn",
             **bf16)
        if not bool(torch.isfinite(out).all()) or float(out.abs().max()) > 1:
            raise AssertionError(f"wavernn_sample bf16 at {rows} rows gave "
                                 f"samples that are not finite in [-1, 1]")
        # the f32 kernel on the same (bf16-rounded) conditioning, weights
        # and noise: the two sample streams agree in distribution
        inp32 = WK.RowsInputs(**{
            k: (v.float() if isinstance(v, torch.Tensor) else v)
            for k, v in vars(inp).items()})
        out32 = WK.launch(inp32, gum, lgs)
        stats = {"mean_bf16": float(out.mean()),
                 "mean_f32": float(out32.mean()),
                 "std_bf16": float(out.std()), "std_f32": float(out32.std())}
        ok = (abs(stats["mean_bf16"] - stats["mean_f32"]) < 0.1
              and abs(stats["std_bf16"] - stats["std_f32"]) < 0.15)
        log({"phase": "compare", "kernel": "wavernn_sample",
             "dtype": "torch.bfloat16 vs its f32 run", "rows": rows,
             "steps": inp.steps, "noise": "drawn", **stats,
             "tolerance": "|d mean| < 0.1, |d std| < 0.15", "ok": ok})
        if not ok:
            raise AssertionError(f"wavernn_sample bf16 statistics out of "
                                 f"bounds: {stats}")

        inp, gum, lgs = wavernn_inputs(cfg, params, rows, fpf, True, gen, dev,
                                       pinned=True)
        out = WK.launch(inp, gum, lgs)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = WK.sample_rows_plain(inp, gum, lgs)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        shaken = dict(vars(inp))
        shaken["mf"] = inp.mf * (1 + 1e-6 * torch.randn(
            inp.mf.shape, generator=gen).to(dev))
        spread = (WK.sample_rows_plain(WK.RowsInputs(**shaken), gum, lgs)
                  - ref).abs()
        hold(out[:, :30], ref[:, :30], 1e-2, steps=inp.steps, noise="pinned",
             **bf16)
        ms = timed_ms(lambda: WK.launch(inp, gum, lgs), 2)
        moved, ops = wavernn_cost(inp, gum, lgs, out)
        b_ms, b_by = bound(moved, ops, torch.bfloat16)
        res = hold(out, ref, 2 * float(spread.max()),
                   1.15 * float(spread.mean()),
                   steps=inp.steps, noise="pinned",
                   plain_spread_max=float(spread.max()),
                   plain_spread_mean=float(spread.mean()), ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, us_per_step=ms * 1e3 / inp.steps, **bf16)
        main = main or res
    return main


def synthetic_wav(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A voiced-like test signal: a gliding harmonic tone with syllable-rate
    amplitude modulation and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.2 * tone * env + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


def device_busy(prof) -> tuple[float, dict]:
    """(ms the device was busy, ms by kernel name) over a profiled run:
    the union of the device's kernel, copy and set intervals (the
    ``convert/*`` ranges' device spans left out)."""
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("convert/")):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return busy / 1e3, top


def phase_end_to_end(card: str) -> dict:
    """Each wav converts three times after a warm-up: once timed with the
    launch counts read around it (the main path), once under
    ``torch.profiler`` (device busy share, device time by kernel), once with
    ``VoiceConverter.stage_times`` set (each stage's wall to a device
    synchronise)."""
    sr = 22050
    vc = VoiceConverter(verbose=False)
    target = Audio(synthetic_wav(3.0, sr, 99), sr_org=sr)
    launches = {name: 0 for name in KERNELS}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def convert(wav):
        return vc.convert(Audio(wav.copy(), sr_org=sr),
                          Audio(target.wav.copy(), sr_org=sr),
                          save_name=False)

    # warm-up (cuDNN / cuFFT plans, allocator, the profiler's start-up):
    # not timed, not counted
    with torch.profiler.profile(activities=acts):
        convert(synthetic_wav(2.0, sr, 1))
    for seconds, path_kernel in ((4.0, "lstm_stack_skewed"),
                                 (24.0, "lstm_stack_stream")):
        wav = synthetic_wav(seconds, sr, int(seconds))
        mel_cfg = vc.AE.config.spectrogram
        _, mel_slices = dsp.compute_partial_slices(
            len(wav), sr, partial_utterance_n_frames=mel_cfg.
            partial_utterance_n_frames, mel_window_step=mel_cfg.mel_window_step)
        N = mel_cfg.partial_utterance_n_frames
        frames = N + (len(mel_slices) - 1) * (N // 2)
        expected = (frames - 1) * mel_cfg.hop_length
        for spec in KERNELS.values():
            spec["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = convert(wav)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {name: spec["kernel"].launches
                  for name, spec in KERNELS.items()}
        for name in KERNELS:
            launches[name] += counts[name]

        t0 = time.time()
        with torch.profiler.profile(activities=acts) as prof:
            convert(wav)
            torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
        busy_ms, top = device_busy(prof)
        vc.stage_times = {}
        convert(wav)
        stage_s, vc.stage_times = vc.stage_times, None

        rms = float(np.sqrt(np.mean(out.wav.astype(np.float64) ** 2)))
        res = {"phase": "end_to_end", "seconds_in": seconds,
               "chunks": len(mel_slices), "samples_out": len(out.wav),
               "samples_expected": expected, "rms": rms, "wall_s": wall,
               "audio_s_per_s": len(out.wav) / sr / wall,
               "launches": counts, "profiled_wall_ms": prof_wall_ms,
               "device_busy_ms": busy_ms,
               "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
               "device_ms_by_kernel": top, "stage_s": stage_s,
               "card": card}
        log(res)
        if not np.all(np.isfinite(out.wav)):
            raise AssertionError("non-finite output")
        if rms <= 1e-4:
            raise AssertionError(f"silent output (rms {rms})")
        if len(out.wav) != expected:
            raise AssertionError(f"output length {len(out.wav)} != "
                                 f"{expected}")
        for name in ("wavernn_sample", path_kernel):
            if counts[name] < 1:
                raise AssertionError(f"the {seconds} s conversion did not "
                                     f"launch {name}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    PREC.exact_f32()
    card = phase_environment()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    # kernels 2 and 3 at 2 and 24 rows in both dtypes, then in bf16 at the
    # row counts the main path gives them: 1 chunk (the 4 s wav), 9 chunks
    # (the 24 s wav)
    for dt in (torch.float32, torch.bfloat16):
        compare_lstm("lstm_stack_skewed", 2, dt, gen, dev)
        compare_lstm("lstm_stack_stream", 24, dt, gen, dev)
    k2 = compare_lstm("lstm_stack_skewed", 1, torch.bfloat16, gen, dev)
    k3 = compare_lstm("lstm_stack_stream", 9, torch.bfloat16, gen, dev)
    k1 = compare_wavernn(gen, dev)
    launches = phase_end_to_end(card)

    def entry(name, cmp, err):
        return {"name": name, "route": "cuda",
                "source": KERNELS[name]["source"],
                "replaces": KERNELS[name]["replaces"],
                "launches": launches[name], "max_abs_err": err,
                "ms": cmp["ms"], "plain_ms": cmp["plain_ms"],
                "bound_ms": cmp["bound_ms"], "bound_by": cmp["bound_by"],
                "library_ms": cmp["library_ms"]}

    summary = {"kernels": [
        entry("wavernn_sample", k1, k1["max_abs_err"]),
        entry("lstm_stack_skewed", k2, k2["max_abs_err"]),
        entry("lstm_stack_stream", k3, k3["max_abs_err"])]}
    for e in summary["kernels"]:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} never launched on the main "
                                 f"path")
        if not all(math.isfinite(e[k]) for k in ("ms", "plain_ms",
                                                  "bound_ms")):
            raise AssertionError(f"non-finite timing for {e['name']}")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
