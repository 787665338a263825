"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  2. build: every CUDA kernel of the port, compiled with nvcc for sm_90a;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs and noise, at full model width: the inference kernels
     1-3 (kernel 1's launch plan and time per step at 16 and 48 rows,
     kernel 3's launch plan and time per round; kernels 2 and 3 at each
     conversion's chunk count of lstm2 and, from 2 chunks, of lstm1;
     kernel 2 also at 2 and 8 rows of lstm2 and at 8 rows of the speaker
     encoder's stack and lstm1, each with its plan and time per round
     beside kernel 3's routine at the same rows), and the training
     kernels 6 (forward) and 7 (backward) at the decoder's lstm2 (f32 and
     bf16, and bf16 at a ragged 33 rows) and lstm1 geometries and the
     speaker encoder's, at 48 rows and at a GE2E batch of 64 x 8 = 512
     rows, where both kernels run several row groups (kernel 6's and
     kernel 7's launch plans, kernel 7's recurrence and dW times apart,
     each recurrence's time per round; kernels 3 and 6 are one
     layer-skewed routine, csrc/lstm_fwd.cuh), and
     the GRU-pair training kernels 4 (forward) and 5
     (backward) at the vocoder's geometry (f32 and bf16, 8 x 2475) and the
     JAX bench's (bf16, 32 x 1375) (both layer-skewed: kernel 4's launch
     plan and time per round, kernel 5's launch plan, its recurrence and
     dW times apart, its time per round; kernel 5 runs on kernel 4's
     saved state); for batch serving, kernel 3 at lstm2 and lstm1 at every
     slab of the ladder above 8 rows (16-256; 128 and 256 rows run 2 and
     4 row groups), kernel 1 at its 64-row slab (f32 pinned, and bf16 over
     a whole fold), kernel 2 at one row over the 24 s wav's unchunked mel
     (f32 and bf16), and the ``ae_slab_ms`` line: ``convert_slab``'s wall
     at each slab size, the source of ``autoencoder._SLAB_MS``; and
     kernel 1 in bf16 over a whole fold at every (rows, frames a fold)
     that the fold picker gives phases 4 and 8 (``kernel1_geometries``:
     short folds, and buckets above 64 rows that stage a step's rows in
     passes), with the ``wavernn_sample picked`` line of their times, and
     in f32 at the smallest of those buckets above 64 rows; phases 4 and 8
     then fail if they run kernel 1 in bf16 at a geometry not held here;
     kernel 1 in bf16 in RAW with 9 bits (the split pick) at 32, 64 and
     128 rows over a 2475-step fold, the ``wavernn_sample raw9`` line.
     Kernel 1's plain version runs each step as one CUDA graph replay of
     ``wavernn_kernels.plain_step`` (``plain_graphed``: the step index,
     the previous sample and the GRU states in static buffers), first
     held bitwise against the eager loop over one frame at 8 rows, f32
     and bf16 (the eager loop makes a step's ~50 launches one by one
     from the host, which bounds its pace);
  4. end to end, conversion: ``VoiceConverter()`` (default config, fresh
     seeded weights) converts a ~4 s wav (decoder lstm2 through kernel 2
     at 1 row), a ~10 s wav (3 mel chunks: kernel 2 at 3 rows, for lstm1
     and lstm2) and a ~24 s wav (9 mel chunks: kernel 3), with every
     kernel's launch count read around each conversion; then converts each
     again under ``torch.profiler`` (the device's idle share) and with its
     stages timed (where the wall time goes); each line logs the
     vocoder's picked geometry (target, folds, row bucket, steps, the wall
     model's kernel-1 ms), and for each wav the conversion's and the
     vocoder stage's walls at the pick and with each ladder entry pinned
     (the fixed 11000 among them), logged, not asserted;
  8. end to end, batch serving (run after 4): ``convert_batch`` of
     serve-8 (8 wavs of 2-24 s) and serve-24 (24 wavs of 10 s), bf16, each
     the median wall of 3 serves after a warm-up and its audio-s/s beside
     the summed wall of ``convert`` on the same wavs one by one and the
     median of 3 serves at the fixed fold length 11000, the picked fold
     length and the slab plans, the kernels' launches under ``torch.profiler`` (kernels 1 and
     3 must launch) and the device idle share; every output finite and as
     long as ``convert``'s; in f32 with row-invariant pinned noise each
     utterance of ``convert_batch`` equal to ``convert`` of its wav
     (max |err| < 1e-3); ``convert(cut=False)`` of the 10 s (timed) and
     24 s wavs and ``pad_to_seconds`` 5 and 3 on the 10 s one, each of its
     expected length;
  5. end to end, training: ``VoiceConverter().train`` of the AutoVC
     generator on synthetic wavs, bf16, batch 16 x 400 frames, at least 8
     steps (kernels 6 and 7 twice a step each), with the loss falling;
     one step profiled (device idle share, kernel time); then one f32
     full-width step on the card against the same step on the CPU;
  6. end to end, vocoder training: ``VoiceConverter().train(...,
     model_type="vocoder")`` on synthetic wavs, bf16, batch 8 x 9 frames
     (2475 samples a row), 16 steps (kernels 4 and 5 once a step each),
     with the loss falling; one step profiled; then one f32 full-width
     step on the card against the same step on the CPU;
  7. end to end, speaker-encoder training: ``train_speaker_encoder`` at
     the full-width ``SpeakerEncoderConfig()``, bf16, GE2E batches of 64
     speakers x 8 utterances x 160 frames from a seeded synthetic
     dataset, 12 steps (kernels 6 and 7 once a step each), with the loss
     falling and the EER logged; one step profiled; then one f32 step
     (4 x 3 x 160) on the card against the same step on the CPU;
  9. the command line, in-process (``autovc_tpu_torch.__main__.main``)
     from a scratch directory: full-width seeded checkpoints written with
     ``save_model`` and named through ``model_dir`` (the generator), the
     artifact cache ``AUTOVC_MODEL_CACHE`` (the speaker encoder) and a
     path (the vocoder); a convert of the 4 s and 24 s wavs, timed, then
     under ``torch.profiler`` (kernels 1, 2 and 3 must launch; each wav
     finite, not silent and of its expected length; the wall and the
     device idle share); a convert with ``trim_long_silences`` of a wav
     with a 2 s silent gap beside one without; the reference's three
     PyTorch checkpoint formats written from ``tests/torch_mirrors.py``,
     loaded onto the card and held in f32 against their mirrors there
     (the generator, the speaker embedding, the vocoder's conditioning
     network), then converted from by path; a 2-step generator training
     run (kernels 6 and 7 must launch) and a convert with the checkpoint
     it wrote, resolved by name;
 12. the reference-checkpoint scripts (``phase_reference_scripts``, after
     9): the three reference formats written from the mirrors converted by
     ``scripts/convert_reference_checkpoints_torch.py`` and each ``.ckpt``
     loaded onto the card equal to its source file's conversion; the
     parity harness ``scripts/eval_reference_parity_torch.py`` on the card
     over a 1 s and a 3 s synthetic wav (allclose at rtol 1e-3 / atol 1e-4
     must hold, kernel 2 must launch), then its command line with one
     weight of the mirror moved, which must exit 1;
 10. the training extras, from a scratch directory (``phase_train_extras``):
     ``VoiceConverter().train`` of the generator, bf16, 2 epochs of 2
     steps of 16 x 400 frames, each epoch a save epoch, with a JSONL
     ``MetricsLogger`` and the per-epoch conversion examples of the 4 s
     and 24 s wavs (kernels 1, 2, 3, 6 and 7 must launch): a ``params``
     and a ``grads`` histogram of every leaf at each save epoch, the
     examples finite, not silent and of their length, the reconstruction
     figure written or reported skipped with its reason; measured, each
     save epoch's save stall and histogram time, the wait at the end, and
     a blocking and an asynchronous save of the same payload in turns,
     with the checkpoint's bytes.  At f32 the epoch-2 example of the 4 s
     wav equals ``convert`` by a converter loaded from the epoch-2
     checkpoint (within one int16 step) and differs from the epoch-1
     example.  The speaker encoder, GE2E 64 x 8 x 160, 2 epochs of 2
     steps: its histograms, asynchronous checkpoint and TSNE figure
     (written or reported skipped).  One generator step under
     ``profiling.trace`` writes a trace.  Then the roofline: phase 4's
     conversions (their mel, generator and vocoder stages) and phases
     5-7's median steps through ``utils/roofline.py`` at the card's peaks
     (``chip_spec``), printed as JSON; an entry faster than its
     throughput bound fails the run;
 11. multi-device on the one card (``phase_multi_device``), mesh positions
     ``[cuda:0, cuda:0]``: ``convert(parallel="chunks")`` of the 24 s wav
     (9 chunks padded to 10, 5 rows a position: kernel 2), its f32
     post-mel against the default path's (<= 1e-4), its bf16 wall beside
     the default path's, kernels 1 and 2 launched; ``convert(parallel=
     "ring")`` of the 10 s wav in f32, its post-mel against
     ``autoencoder.infer`` of the same trimmed mel (<= 1e-4), the wav
     finite and of its length; ``convert_batch(parallel="pipeline")`` of
     serve-8, the bf16 median of 3 serves and its audio-s/s beside the
     default ``convert_batch``, kernels 1-3 launched under
     ``torch.profiler`` and the streams' overlap (the two stages share the
     card's lane, so it should be nil),
     and in f32 with pinned noise each utterance against ``convert(seed=
     seed + i)`` (phase 8's bar); two data-parallel ranks on the card
     (``gloo``, started by the port's launcher, each running this script
     with ``--dp-rank``): one f32 step of the generator (16 x 400
     global), the vocoder (8 x 2475) and the speaker encoder (4 x 3 x
     160) against the single-process step on the global batch on the
     card (loss and ``grad_norm`` rel 1e-4, gradients rtol 2e-3 / atol
     1e-3, beside the largest reference gradient), kernels 6/7
     and 4/5 launched in each rank (a line per rank), then 6 bf16
     generator steps through ``train_autoencoder(mesh=)`` (the loss
     falling, the median s/step beside phase 5's); one ``nccl`` rank
     (``python -m autovc_tpu_torch.parallel.multihost_smoke``); and two
     tensor-parallel ranks on the card as a (1, 2) ("data", "model")
     mesh (``gloo``, ``--tp-rank``), full widths on short sequences: one
     f32 step of the generator (4 x 80 x 64), the vocoder (4 x 550
     samples) and the speaker encoder (4 x 3 x 160) from each rank's
     shards against the single-process step on the card (the data-parallel
     bars), kernels 4-7 launched in neither rank (the per-step TP
     recurrences run instead), 3 timed bf16 steps of each (median s/step
     beside phases 5-7's, and the model group's gathers and reduces a
     step), and a 2-step ``train_autoencoder(mesh=)`` whose checkpoint
     rank 0 reads back equal to the full tree it returned;
 13. the native host mel core (``phase_native_mel``, last): built with
     g++, the AE and SE host mels of the 24 s synthetic wav against the
     port's numpy mels (rtol 1e-3 / atol 1e-4 and rtol 2e-3), with their
     host ms at 1 thread and at all threads beside numpy's.
Every kernel's ``bound_ms`` takes its peaks from ``roofline.chip_spec``;
the summary's kernel 1 is held at the 4 s wav's picked geometry.
It prints one JSON line per comparison, each phase's wall seconds
(``{"phase": "seconds", ...}`` and a ``phase seconds`` line with the
total), then the per-kernel summary line, the card's name and power
limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from autovc_tpu_torch import Audio, VoiceConverter  # noqa: E402
from autovc_tpu_torch.audio import dsp, io as audio_io  # noqa: E402
from autovc_tpu_torch.config import (AutoEncoderConfig,  # noqa: E402
                                     OptimizerConfig, SpeakerEncoderConfig,
                                     WandbConfig, WaveRNNConfig)
from autovc_tpu_torch.models import autoencoder as AE  # noqa: E402
from autovc_tpu_torch.models import speaker_encoder as SE  # noqa: E402
from autovc_tpu_torch.models import wavernn as WR  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import gru_train_kernels as GT  # noqa: E402
from autovc_tpu_torch.ops import lstm_kernels as LK  # noqa: E402
from autovc_tpu_torch.ops import lstm_train_kernels as LT  # noqa: E402
from autovc_tpu_torch.ops import precision as PREC  # noqa: E402
from autovc_tpu_torch.ops import rnn as R  # noqa: E402
from autovc_tpu_torch.ops import wavernn_kernels as WK  # noqa: E402
from autovc_tpu_torch.parallel import sharding as PSHD  # noqa: E402
from autovc_tpu_torch.train import loop as TRL  # noqa: E402
from autovc_tpu_torch.train import schedules as TRS  # noqa: E402
from autovc_tpu_torch.utils import tree_clone, tree_leaves  # noqa: E402
from autovc_tpu_torch.utils import checkpoint as CK  # noqa: E402
from autovc_tpu_torch.utils import profiling  # noqa: E402
from autovc_tpu_torch.utils import roofline as RL  # noqa: E402
from autovc_tpu_torch.utils.bridge import from_jax_params  # noqa: E402
from autovc_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

KERNELS = {
    "wavernn_sample": dict(
        kernel=WK.SAMPLE, source="autovc_tpu_torch/csrc/wavernn_sample.cu",
        replaces="autovc_tpu/ops/wavernn_pallas.py:269"),
    "lstm_stack_skewed": dict(
        kernel=LK.SKEWED, source="autovc_tpu_torch/csrc/lstm_stack.cu",
        replaces="autovc_tpu/ops/lstm_pallas.py:136"),
    "lstm_stack_stream": dict(
        kernel=LK.STREAM, source="autovc_tpu_torch/csrc/lstm_fwd.cuh",
        replaces="autovc_tpu/ops/lstm_pallas.py:271"),
    "lstm_train_fwd": dict(
        kernel=LT.FWD, source="autovc_tpu_torch/csrc/lstm_fwd.cuh",
        replaces="autovc_tpu/ops/lstm_train_pallas.py:356"),
    "lstm_train_bwd": dict(
        kernel=LT.BWD, source="autovc_tpu_torch/csrc/lstm_train.cu",
        replaces="autovc_tpu/ops/lstm_train_pallas.py:434"),
    "gru_train_fwd": dict(
        kernel=GT.FWD, source="autovc_tpu_torch/csrc/gru_train.cu",
        replaces="autovc_tpu/ops/gru_train_pallas.py:357"),
    "gru_train_bwd": dict(
        kernel=GT.BWD, source="autovc_tpu_torch/csrc/gru_train.cu",
        replaces="autovc_tpu/ops/gru_train_pallas.py:429"),
}
CONVERT_KERNELS = ("wavernn_sample", "lstm_stack_skewed", "lstm_stack_stream")
TRAIN_KERNELS = ("lstm_train_fwd", "lstm_train_bwd")
VOCODER_KERNELS = ("gru_train_fwd", "gru_train_bwd")


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
    """The least ms the card could take: max(bytes / its HBM rate,
    operations / its peak rate for their type), the card's published
    peaks from ``roofline.chip_spec``."""
    spec = RL.chip_spec()
    peak = (spec.peak_bf16_tflops if dtype == torch.bfloat16
            else spec.peak_f32_tflops)
    t_bytes = bytes_moved / (spec.hbm_gbs * 1e9) * 1e3
    t_ops = ops / (peak * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_launch_ms(prof, tags) -> dict:
    """Device ms of each launch of the kernels whose names hold each tag,
    from a ``torch.profiler`` run."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for tag in tags:
                if tag in e.name:
                    out.setdefault(tag, []).append(
                        e.time_range.elapsed_us() / 1e3)
    return out


def kernel_ms_of(prof, tags) -> dict:
    """Device ms of the kernels whose names hold each tag, summed over a
    ``torch.profiler`` run."""
    return {tag: sum(ms) for tag, ms in kernel_launch_ms(prof, tags).items()}


def recurrence_and_dw_ms(fn, tag: str):
    """A training backward's two launches apart, (a) the recurrence (the
    kernel whose name holds ``tag``) and (b) the dW / db tiles: the mean
    device ms of each over 3 profiled calls of ``fn`` (the profiler may
    drop some), and how many of each it recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    split = kernel_launch_ms(prof, (tag, "dw_"))
    rec, dw = (split.get(k, [float("nan")]) for k in (tag, "dw_"))
    return statistics.fmean(rec), statistics.fmean(dw), [len(rec), len(dw)]


# Wall seconds of each phase of this run, in the order they ran.
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def phase_clock(name: str):
    """Log and keep the wall seconds of the block, as phase ``name``."""
    t0 = time.time()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = round(time.time() - t0, 2)
        log({"phase": "seconds", "of": name,
             "seconds": PHASE_SECONDS[name]})


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
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"  {src}: {line.strip()}")


# Kernel 2's geometries (layers, hidden, input, steps): the decoder's
# lstm2 (the main path at 1-8 chunks), the speaker encoder's stack (its
# 160-frame partials) and decoder lstm1, both kernel 2's under the bf16
# policy from 2 rows.
LSTM2, SE_STACK, LSTM1 = (2, 1024, 512, 400), (3, 256, 40, 160), \
    (1, 512, 320, 400)
# The main path's conversions: (seconds of the source wav, the kernel of
# decoder lstm2 at the wav's mel chunks, their count).  From 2 chunks the
# same kernel runs lstm1 (bf16 from 2 rows at H >= 256); at 1 chunk lstm1
# runs in f32 (torch.lstm).
CONVERSIONS = ((4.0, "lstm_stack_skewed", 1), (10.0, "lstm_stack_skewed", 3),
               (24.0, "lstm_stack_stream", 9))


def compare_lstm(name: str, rows: int, dtype, gen, dev,
                 geom=LSTM2) -> dict:
    """Kernel 2 or 3 against the plain version at ``geom`` (L, H, input, T;
    the decoder lstm2's by default).  Kernel 2 logs its plan and time per
    round beside kernel 3's routine at the same rows and geometry."""
    L, H, I, T = geom
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
    bf16 = dtype == torch.bfloat16
    info = {"rows": rows, "dtype": str(dtype), "L": L, "H": H, "T": T}
    if kernel is LK.STREAM:
        # kernel 3's plan and its time per round (T + L - 1 rounds)
        log({"phase": "compare", "kernel": f"{name} plan", **info,
             "plan": dataclasses.asdict(LK.device_plan(rows, H, L, bf16,
                                                       dev)),
             "per_round_us": ms * 1e3 / (T + L - 1)})
    else:
        # kernel 2's plan and time per round, kernel 3's routine beside it
        stream_ms = timed_ms(lambda: LK.launch(LK.STREAM, xp0, whh, wih,
                                               bias), 5)
        log({"phase": "compare", "kernel": f"{name} plan", **info,
             "plan": dataclasses.asdict(LK.device_small_plan(
                 rows, H, L, bf16, dev)),
             "ms": ms, "per_round_us": ms * 1e3 / (T + L - 1),
             "stream_ms": stream_ms,
             "stream_per_round_us": stream_ms * 1e3 / (T + L - 1)})
    plain_ms = timed_ms(lambda: LK.lstm_stack_plain(xp0, whh, wih, bias), 1)
    lib_params = [{k: v.to(dtype) for k, v in p.items()} for p in params]
    xl = x.to(dtype)
    library_ms = timed_ms(lambda: R.lstm_stack(lib_params, xl), 5)
    ops = 2.0 * rows * T * (L + L - 1) * 4 * H * H
    b_ms, b_by = bound(nbytes(xp0, whh, wih, bias, out), ops, dtype)
    res = {"phase": "compare", "kernel": name, **info, "max_abs_err": err,
           "ref_max_abs": scale,
           "tolerance": ("atol 1e-4" if dtype == torch.float32
                         else "max_err / max|ref| < 2e-2"),
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(res)
    if not ok:
        raise AssertionError(f"{name} {dtype} {geom} disagrees with its "
                             f"plain version: {err} (max |ref| {scale})")
    return res


def held(name: str, got, want, bar_of, **info) -> float:
    """Hold each tensor of ``got`` against ``want``: the error must not
    exceed ``bar_of(max |want|)``.  Returns the largest error relative to
    its bar; raises on a failure."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not b.numel():            # dW_ih of a one-layer stack
            continue
        a, b = a.float(), b.float()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if not err <= bar_of(scale):
            raise AssertionError(f"{name} output {i} disagrees with its "
                                 f"plain version: {err} (max |ref| {scale}, "
                                 f"bar {bar_of(scale)}; {info})")
        worst = max(worst, err / bar_of(scale))
    return worst


def compare_lstm_train(geom: str, L: int, H: int, I: int, rows: int, T: int,
                       dtype, gen, dev, cotangents: str = "all") -> dict:
    """Kernels 6 and 7 against their plain versions on the same inputs:
    random params and x, xp0 hoisted as the main path hoists it, non-zero
    cotangents on ys, h_fin and c_fin (``cotangents="h_fin"``: on h_fin
    only, as the speaker encoder's loss gives them); kernel 7 runs on the
    plain forward's saved state.  Bars: f32 forward atol 1e-5 and each
    gradient within 1e-4 of its max |ref| (dW sums T * B products in
    another order); bf16 within 2e-2 of max |ref|, as kernels 2/3.
    Timed against cuDNN ``torch.lstm`` forward and its autograd backward
    (``library_ms``; the port never calls them)."""
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    if PREC.lstm_kernel_dtype(mode, H) != dtype:
        raise ValueError(f"H={H} does not run {dtype} kernels")
    params = from_jax_params(R.init_lstm_stack(gen, I, H, L), dev)
    x = torch.randn(rows, T, I, generator=gen).to(dev)
    xp0 = LK.hoist_xp0(params[0], x, mode)
    whh = torch.stack([p["w_hh"] for p in params])
    wih = (torch.stack([p["w_ih"] for p in params[1:]]) if L > 1
           else whh.new_zeros(0, H, 4 * H))
    bias = (torch.stack([p["b_ih"] + p["b_hh"] for p in params[1:]])
            if L > 1 else whh.new_zeros(0, 4 * H))
    wf, wb = LT.pack_fwd(whh, wih, dtype), LT.pack_bwd(whh, wih, dtype)
    if cotangents == "all":
        cts = tuple(torch.randn(*s, generator=gen).to(dev)
                    for s in ((T, rows, H), (rows, H), (rows, H)))
    else:
        cts = (torch.zeros(T, rows, H, device=dev),
               torch.randn(rows, H, generator=gen).to(dev),
               torch.zeros(rows, H, device=dev))
    bf16 = dtype == torch.bfloat16
    info = dict(geometry=geom, dtype=str(dtype), L=L, H=H, rows=rows, T=T)
    out = LT.fwd_launch(xp0, *wf, bias)
    ref = LT.lstm_train_fwd_plain(xp0, *wf, bias)
    fwd_bar = (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-5)
    fwd_ratio = held("lstm_train_fwd", out, ref, fwd_bar, **info)
    fwd_err = float((out[0] - ref[0]).abs().max())
    saved = (ref[5], ref[3], ref[4])
    got = LT.bwd_launch(*saved, *cts, *wb)
    want = LT.lstm_train_bwd_plain(*saved, *cts, *wb)
    bwd_bar = (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-4 * s)
    bwd_ratio = held("lstm_train_bwd", got, want, bwd_bar, **info)
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                  if b.numel())
    torch.cuda.synchronize()

    fwd_ms = timed_ms(lambda: LT.fwd_launch(xp0, *wf, bias), 3)
    log({"phase": "compare", "kernel": "lstm_train_fwd plan", **info,
         "plan": dataclasses.asdict(LK.device_plan(rows, H, L, bf16, dev)),
         "per_round_us": fwd_ms * 1e3 / (T + L - 1)})
    bwd_ms = timed_ms(lambda: LT.bwd_launch(*saved, *cts, *wb), 3)
    # kernel 7's two launches, (a) the recurrence and (b) the dW / db tiles
    rec_ms, dw_ms, profiled = recurrence_and_dw_ms(
        lambda: LT.bwd_launch(*saved, *cts, *wb), "lstm_train_bwd_kernel")
    plan = LT.bwd_plan(rows, H, L, bf16, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log({"phase": "compare", "kernel": "lstm_train_bwd split", **info,
         "plan": dataclasses.asdict(plan), "recurrence_ms": rec_ms,
         "dw_ms": dw_ms, "launches_profiled": profiled,
         "per_round_us": rec_ms * 1e3 / (T * L)})
    fwd_plain = timed_ms(lambda: LT.lstm_train_fwd_plain(xp0, *wf, bias), 1)
    bwd_plain = timed_ms(lambda: LT.lstm_train_bwd_plain(*saved, *cts, *wb),
                         1)
    # cuDNN in the working dtype, x -> ys forward; its backward through
    # autograd to x and every weight
    lib = [{k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
           for p in params]
    xl = x.to(dtype).requires_grad_(True)
    with torch.no_grad():
        lib_fwd = timed_ms(lambda: R.lstm_stack(lib, xl), 3)
    ys_lib, _, _ = R.lstm_stack(lib, xl)
    dys_lib = cts[0].transpose(0, 1).to(dtype)
    leaves = [xl] + [v for p in lib for v in p.values()]
    lib_bwd = timed_ms(lambda: torch.autograd.grad(
        ys_lib, leaves, dys_lib, retain_graph=True), 3)

    n_mat = L + (L - 1)              # recurrent + in-kernel input matrices
    ops_seq = 2.0 * T * rows * n_mat * 4 * H * H
    fwd_bytes = nbytes(xp0, *wf, bias, *out)
    bwd_bytes = nbytes(*saved, *cts, *wb, *got)
    f_ms, f_by = bound(fwd_bytes, ops_seq, dtype)
    b_ms, b_by = bound(bwd_bytes, 2 * ops_seq, dtype)   # + dW: as many
    res = {"phase": "compare", "kernel": "lstm_train", **info,
           "cotangents": cotangents,
           "fwd": {"max_abs_err": fwd_err, "err_over_bar": fwd_ratio,
                   "ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": lib_fwd,
                   "bound_ms": f_ms, "bound_by": f_by},
           "bwd": {"max_abs_err": bwd_err, "err_over_bar": bwd_ratio,
                   "ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": lib_bwd,
                   "bound_ms": b_ms, "bound_by": b_by},
           "tolerance": ("bf16: max err / max|ref| <= 2e-2" if bf16 else
                         "f32: forward atol 1e-5, gradients 1e-4 of max|ref|"),
           "ok": True}
    log(res)
    return res


def compare_gru_train(rows: int, T: int, dtype, gen, dev) -> dict:
    """Kernels 4 and 5 against their plain versions on the same inputs, at
    the vocoder's width (H = rd = 512): weights from the GRU init, xp1 and
    base2 ~ N(0, 0.5^2), cotangents on h1 and h2 ~ N(0, 1); kernel 5 runs
    on the plain forward's saved state.  Bars, written before the first
    run: f32 forward atol 1e-5 and each gradient within 1e-4 of its max
    |ref|; bf16 within 2e-2 of max |ref|, as kernels 6/7.  Timed against
    two cuDNN ``torch.gru`` calls (layer 1 over xI, then layer 2 over
    [x1, a2], with their input projections), forward and autograd
    backward (``library_ms``; the port never calls them).  Kernel 5 runs
    on kernel 4's saved state, its plain version on the same.  Kernel 4's
    launch plan and time per round, and kernel 5's plan, its recurrence
    and dW times apart and its time per round, are logged on lines of
    their own."""
    H, aux = 512, 32
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    if PREC.rec_dtype(mode, rows, H) != dtype:
        raise ValueError(f"{rows} rows at H={H} do not run {dtype} kernels")
    p1, p2 = (from_jax_params(R.init_gru_layer(gen, n, H), dev)
              for n in (H, H + aux))
    xp1, base2 = (0.5 * torch.randn(T, rows, 3 * H, generator=gen)).to(dev), \
        (0.5 * torch.randn(T, rows, 3 * H, generator=gen)).to(dev)
    whh1, wih2x, whh2 = p1["w_hh"], p2["w_ih"][:H], p2["w_hh"]
    bhh1, bhh2 = p1["b_hh"], p2["b_hh"]
    wf = GT.pack_fwd(whh1, wih2x, whh2, dtype)
    wb = GT.pack_bwd(whh1, wih2x, whh2, dtype)
    cts = tuple(torch.randn(T, rows, H, generator=gen).to(dev)
                for _ in range(2))
    bf16 = dtype == torch.bfloat16
    info = dict(geometry="wavernn", dtype=str(dtype), H=H, rows=rows, T=T)
    out = GT.fwd_launch(xp1, base2, *wf, bhh1, bhh2)
    ref = GT.gru_pair_fwd_plain(xp1, base2, *wf, bhh1, bhh2)
    fwd_ratio = held("gru_train_fwd", out, ref,
                     (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-5),
                     **info)
    fwd_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out, ref))
    saved = (out[1], out[0])
    got = GT.bwd_launch(*saved, *cts, *wb)
    want = GT.gru_pair_bwd_plain(*saved, *cts, *wb)
    bwd_ratio = held("gru_train_bwd", got, want,
                     (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-4 * s),
                     **info)
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    torch.cuda.synchronize()

    fwd_ms = timed_ms(lambda: GT.fwd_launch(xp1, base2, *wf, bhh1, bhh2), 3)
    # kernel 4: one launch, T + 1 layer-skewed rounds, T grid barriers
    log({"phase": "compare", "kernel": "gru_train_fwd split", **info,
         "plan": dataclasses.asdict(GT.device_fwd_plan(rows, H, bf16, dev)),
         "ms": fwd_ms, "rounds": T + 1, "barriers": T,
         "per_round_us": fwd_ms * 1e3 / (T + 1)})
    bwd_ms = timed_ms(lambda: GT.bwd_launch(*saved, *cts, *wb), 3)
    # kernel 5's two launches, (a) the layer-skewed chain (T + 1 rounds)
    # and (b) the dW / db tiles
    rec_ms, dw_ms, profiled = recurrence_and_dw_ms(
        lambda: GT.bwd_launch(*saved, *cts, *wb), "gru_train_bwd_kernel")
    log({"phase": "compare", "kernel": "gru_train_bwd split", **info,
         "plan": dataclasses.asdict(GT.device_bwd_plan(rows, H, bf16, dev)),
         "recurrence_ms": rec_ms, "dw_ms": dw_ms,
         "launches_profiled": profiled,
         "per_round_us": rec_ms * 1e3 / (T + 1)})
    fwd_plain = timed_ms(lambda: GT.gru_pair_fwd_plain(xp1, base2, *wf, bhh1,
                                                       bhh2), 1)
    bwd_plain = timed_ms(lambda: GT.gru_pair_bwd_plain(*saved, *cts, *wb), 1)
    # two cuDNN GRU calls in the working dtype; backward through autograd
    # to their inputs and every weight
    lib = [[t.to(dtype).contiguous().requires_grad_(True)
            for t in (p["w_ih"].T, p["w_hh"].T, p["b_ih"], p["b_hh"])]
           for p in (p1, p2)]
    xI = (0.5 * torch.randn(T, rows, H, generator=gen)).to(dev, dtype)
    a2 = (0.5 * torch.randn(T, rows, aux, generator=gen)).to(dev, dtype)
    xI.requires_grad_(True)
    h0 = torch.zeros(1, rows, H, device=dev, dtype=dtype)

    def two_grus():
        with warnings.catch_warnings():
            # cuDNN compacts the per-call weight list (timed as it is)
            warnings.filterwarnings("ignore", "RNN module weights")
            h1, _ = torch.gru(xI, h0, lib[0], True, 1, 0.0, True, False,
                              False)
            x1 = h1 + xI
            h2, _ = torch.gru(torch.cat([x1, a2], dim=-1), h0, lib[1], True,
                              1, 0.0, True, False, False)
        return h1, h2

    with torch.no_grad():
        lib_fwd = timed_ms(two_grus, 3)
    h1_lib, h2_lib = two_grus()
    leaves = [xI] + [w for ws in lib for w in ws]
    lib_bwd = timed_ms(lambda: torch.autograd.grad(
        (h1_lib, h2_lib), leaves, tuple(c.to(dtype) for c in cts),
        retain_graph=True), 3)

    ops_seq = 2.0 * T * rows * 3 * H * 3 * H   # three (H, 3H) products
    f_ms, f_by = bound(nbytes(xp1, base2, *wf, bhh1, bhh2, *out), ops_seq,
                       dtype)
    b_ms, b_by = bound(nbytes(*saved, *cts, *wb, *got), 2 * ops_seq, dtype)
    res = {"phase": "compare", "kernel": "gru_train", **info,
           "fwd": {"max_abs_err": fwd_err, "err_over_bar": fwd_ratio,
                   "ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": lib_fwd,
                   "bound_ms": f_ms, "bound_by": f_by},
           "bwd": {"max_abs_err": bwd_err, "err_over_bar": bwd_ratio,
                   "ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": lib_bwd,
                   "bound_ms": b_ms, "bound_by": b_by},
           "library": "two cuDNN torch.gru calls (layer 1, layer 2 over "
                      "[x1, a2]) with their input projections",
           "tolerance": ("bf16: max err / max|ref| <= 2e-2" if bf16 else
                         "f32: forward atol 1e-5, gradients 1e-4 of max|ref|"),
           "ok": True}
    log(res)
    return res


def compare_inference_kernels(gen, dev, card: str) -> tuple:
    """Phase 3's holds of kernels 2 and 3 and the ``ae_slab_ms`` line;
    returns the summary's comparisons of kernel 2 and of kernel 3."""
    # kernels 2 and 3 at 2 and 24 rows in both dtypes; in bf16, each at
    # the chunks of the conversions it runs, lstm2 (the summary's: kernel
    # 2 at the 4 s wav's one chunk, kernel 3 at the 24 s wav's nine) and
    # lstm1 from 2 chunks; kernel 2 at 8 rows of lstm2, the speaker
    # encoder's stack and lstm1
    for dt in (torch.float32, torch.bfloat16):
        compare_lstm("lstm_stack_skewed", 2, dt, gen, dev)
        compare_lstm("lstm_stack_stream", 24, dt, gen, dev)
    by_wav = []
    for _, name, chunks in CONVERSIONS:
        by_wav.append(compare_lstm(name, chunks, torch.bfloat16, gen, dev))
        if chunks > 1:
            compare_lstm(name, chunks, torch.bfloat16, gen, dev, LSTM1)
    compare_lstm("lstm_stack_skewed", 8, torch.bfloat16, gen, dev)
    for geom in (SE_STACK, LSTM1):
        compare_lstm("lstm_stack_skewed", 8, torch.bfloat16, gen, dev, geom)
    # batch serving: kernel 3 at every slab of the ladder above 8 rows
    # (128 and 256 rows: several row groups), lstm2 and lstm1; kernel 2
    # at one row over the 24 s wav's unchunked mel (cut=False); then the
    # generator's wall at each slab size (the planner's cost table)
    for rows in AE._SLAB_LADDER[1:]:
        for geom in (LSTM2, LSTM1):
            compare_lstm("lstm_stack_stream", rows, torch.bfloat16, gen, dev,
                         geom)
    long_T = dsp.mel_spec_auto_encoder(
        synthetic_wav(24.0, 22050, 24),
        AutoEncoderConfig().spectrogram).shape[-1]
    for dt in (torch.float32, torch.bfloat16):
        compare_lstm("lstm_stack_skewed", 1, dt, gen, dev,
                     (2, 1024, 512, long_T))
    ae_slab_ms(gen, dev, card)
    return by_wav[0], by_wav[-1]


def compare_training_kernels(gen, dev) -> tuple:
    """Phase 3's holds of kernels 6 and 7 and of kernels 4 and 5; returns
    the summary's comparisons of each pair."""
    # kernels 6 and 7 at the training path's geometries: decoder lstm2 in
    # f32 and bf16, lstm1 (input 2 * 32 + 256), the speaker encoder's stack
    # (cotangent on h_fin only) and lstm2 at a ragged 33 rows (kernel 7's
    # last M-tile part-filled); the bf16 lstm2 run is the summary's
    compare_lstm_train("lstm2", 2, 1024, 512, 16, 400, torch.float32, gen,
                       dev)
    k67 = compare_lstm_train("lstm2", 2, 1024, 512, 16, 400, torch.bfloat16,
                             gen, dev)
    compare_lstm_train("lstm1", 1, 512, 320, 16, 400, torch.bfloat16, gen,
                       dev)
    compare_lstm_train("ragged", 2, 1024, 512, 33, 400, torch.bfloat16, gen,
                       dev)
    se48 = compare_lstm_train("speaker_encoder", 3, 256, 40, 48, 160,
                              torch.bfloat16, gen, dev, cotangents="h_fin")
    # the speaker encoder's GE2E batch, 64 speakers x 8 utterances: both
    # kernels over several row groups
    se512 = compare_lstm_train("speaker_encoder_ge2e", 3, 256, 40, 512, 160,
                               torch.bfloat16, gen, dev, cotangents="h_fin")
    log({"phase": "compare", "kernel": "lstm_train se rows", **{
        f"{r['rows']}_rows": {k: {m: r[k][m] for m in ("ms", "library_ms",
                                                       "bound_ms")}
                              for k in ("fwd", "bwd")}
        for r in (se48, se512)}})
    # kernels 4 and 5 at the vocoder's training geometry, f32 and bf16
    # (the summary's), and the JAX bench's
    compare_gru_train(8, 9 * 275, torch.float32, gen, dev)
    k45 = compare_gru_train(8, 9 * 275, torch.bfloat16, gen, dev)
    compare_gru_train(32, 5 * 275, torch.bfloat16, gen, dev)
    return k67, k45


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


def plain_graphed(inp, gumbel, logistic) -> torch.Tensor:
    """``WK.sample_rows_plain`` with each step one CUDA graph replay: the
    same :func:`WK.plain_step` on the same inputs, captured once with the
    step index, the previous sample and the GRU states in static device
    buffers (the graph reads its frame inputs, taps and noise at that
    index, writes its sample and advances the index), so a step costs one
    ``replay()`` of host time where the eager loop makes its ~50 launches
    one by one."""
    B, S = inp.rows, inp.ktab.shape[1]
    W, rd, dev = inp.ktab.shape[0], inp.w_x.shape[0], inp.mf.device
    w = WK.plain_weights(inp)
    x, h1, h2 = (inp.mf.new_zeros(B, n) for n in (1, rd, rd))
    t = torch.zeros(1, dtype=torch.long, device=dev)
    taps = torch.arange(W, device=dev)
    out = inp.mf.new_zeros(B, inp.steps)

    def at(a, i):
        return a.index_select(1, i)[:, 0]

    def step():
        q = torch.div(t, S, rounding_mode="floor")
        mfw = inp.mf.index_select(1, q + taps)
        sample, n1, n2 = WK.plain_step(
            inp, w, x, h1, h2, at(inp.base, q),
            [mfw[:, k] for k in range(W)], at(inp.ktab, t - q * S),
            at(inp.pre_r2, q), at(inp.pre_f1, q), at(inp.pre_f2, q),
            gumbel.index_select(0, t)[0], logistic.index_select(0, t)[0])
        out.index_copy_(1, t, sample[:, None])
        x.copy_(sample[:, None])
        h1.copy_(n1)
        h2.copy_(n2)
        t.add_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()                                  # warm-up before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for buf in (x, h1, h2, t, out):
        buf.zero_()
    for _ in range(inp.steps):
        graph.replay()
    torch.cuda.synchronize(dev)
    return out


def check_plain_graphed(cfg, params, gen, dev) -> None:
    """The graphed plain loop against the eager one over one fold frame
    (275 steps) at 8 rows, f32 and bf16: they must agree bitwise."""
    for fast in (False, True):
        inp, gum, lgs = wavernn_inputs(cfg, params, 8, 1, fast, gen, dev)
        t0 = time.time()
        eager = WK.sample_rows_plain(inp, gum, lgs)
        torch.cuda.synchronize()
        t1 = time.time()
        graphed = plain_graphed(inp, gum, lgs)
        t2 = time.time()
        res = {"phase": "compare", "kernel": "wavernn_sample plain graphed",
               "fast_math": fast, "rows": 8, "steps": inp.steps,
               "max_abs_err": float((graphed - eager).abs().max()),
               "eager_s": t1 - t0, "graphed_s": t2 - t1,
               "tolerance": "bitwise", "ok": torch.equal(graphed, eager)}
        log(res)
        if not res["ok"]:
            raise AssertionError(f"the graphed plain loop is not the eager "
                                 f"one: {res}")


def compare_wavernn_f32(cfg, params, rows: int, pinned: bool, gen,
                        dev) -> dict:
    """Kernel 1 in f32 against the plain loop, ``rows`` x 4 frames:
    atol 1e-3."""
    inp, gum, lgs = wavernn_inputs(cfg, params, rows, 4, False, gen, dev,
                                   pinned)
    return hold(WK.launch(inp, gum, lgs), plain_graphed(inp, gum, lgs),
                1e-3, dtype="torch.float32", rows=rows, steps=inp.steps,
                noise="pinned" if pinned else "drawn")


# The largest nudge of one Gumbel lane that may explain a drawn-noise pick
# flip (:func:`near_tie_flips`): kernel and plain loop sum their bf16
# products in another order, and an operand that rounds the other way
# moves the later ones, so their pick scores differ by up to a few 1e-3
# where no bug moves them (a misplaced term moves them by O(0.1-1)).
PICK_TIE = 1e-2
# the most rows of one hold that :func:`near_tie_flips` searches
MAX_FLIPS = 4


def near_tie_flips(inp, gumbel, logistic, out, ref, steps: int,
                   bar: float = 1e-2) -> dict:
    """{row: (step, lane, nudge)} for each row whose first sample at or
    above ``bar`` from the plain loop's ``ref`` (in the first ``steps``)
    is a near-tie pick: raising one Gumbel lane of the plain loop at that
    step and row by ``nudge`` (the smallest of 1e-4, 3e-4, 1e-3, 3e-3
    and ``PICK_TIE`` that does) makes it give the kernel's sample there.  A row whose first
    difference no such nudge explains is left out, and fails its hold.
    In RAW the kernel's sample names its class, so only that lane can
    explain it and only that lane is tried.  Near-ties are rare: where
    more than ``MAX_FLIPS`` rows differ none is searched (all fail)."""
    S = inp.ktab.shape[1]
    diff = (out[:, :steps] - ref[:, :steps]).abs() >= bar
    flips = {}
    rows = diff.any(dim=1).nonzero().flatten().tolist()
    if len(rows) > MAX_FLIPS:
        return flips
    for r in rows:
        t = int(diff[r].nonzero()[0])
        cut, gum, lgs = first_frames(inp, gumbel, logistic, t // S + 1)
        lanes = ([round((float(out[r, t]) + 1.0) * (inp.n_classes - 1) / 2)]
                 if inp.raw_mode else range(inp.pick_dim))
        for nudge in (1e-4, 3e-4, 1e-3, 3e-3, PICK_TIE):
            for lane in lanes:
                g = gum.clone()
                g[t, r, lane] += nudge
                s = WK.sample_rows_plain(cut, g, lgs)
                if abs(float(s[r, t] - out[r, t])) < bar:
                    flips[r] = (t, lane, nudge)
                    break
            if r in flips:
                break
    return flips


def compare_wavernn_bf16(cfg, params, rows: int, fpf: int, gen,
                         dev, **tags) -> dict:
    """Kernel 1 in bf16 against the plain loop over ``fpf`` frames (the
    holds of :func:`compare_wavernn`); returns the full-fold comparison
    with the kernel's time and the plan the timed launches ran on.
    ``tags`` go into every line it logs."""
    bf16 = dict(dtype="torch.bfloat16", rows=rows, frames=fpf, **tags)
    inp, gum, lgs = wavernn_inputs(cfg, params, rows, fpf, True, gen, dev)
    out = WK.launch(inp, gum, lgs)
    ref = plain_graphed(*first_frames(inp, gum, lgs, 1))
    # a row whose pick flips on a near-tie is compared up to that step
    flips = near_tie_flips(inp, gum, lgs, out, ref, 8)
    head = out[:, :8].clone()
    for r, (t, _, _) in flips.items():
        head[r, t:] = ref[r, t:8]
    hold(head, ref[:, :8], 1e-2, steps=inp.steps, noise="drawn",
         near_tie_flips={str(r): dict(zip(("step", "lane", "nudge"), f))
                         for r, f in flips.items()}, **bf16)
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
         "steps": inp.steps, "noise": "drawn", **tags, **stats,
         "tolerance": "|d mean| < 0.1, |d std| < 0.15", "ok": ok})
    if not ok:
        raise AssertionError(f"wavernn_sample bf16 statistics out of "
                             f"bounds: {stats}")

    inp, gum, lgs = wavernn_inputs(cfg, params, rows, fpf, True, gen, dev,
                                   pinned=True)
    out = WK.launch(inp, gum, lgs)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = plain_graphed(inp, gum, lgs)
    plain_ms = (time.time() - t0) * 1e3
    shaken = dict(vars(inp))
    shaken["mf"] = inp.mf * (1 + 1e-6 * torch.randn(
        inp.mf.shape, generator=gen).to(dev))
    spread = (plain_graphed(WK.RowsInputs(**shaken), gum, lgs)
              - ref).abs()
    hold(out[:, :30], ref[:, :30], 1e-2, steps=inp.steps, noise="pinned",
         **bf16)
    ms = timed_ms(lambda: WK.launch(inp, gum, lgs), 2)
    moved, ops = wavernn_cost(inp, gum, lgs, out)
    b_ms, b_by = bound(moved, ops, torch.bfloat16)
    # RAW: the pinned lane decides every pick, so the plain loop has no
    # spread and the kernel must give its classes exactly (a class step
    # is 2 / (n_classes - 1))
    exact = inp.raw_mode and float(spread.max()) == 0.0
    return hold(out, ref, 1e-3 if exact else 2 * float(spread.max()),
                None if exact else 1.15 * float(spread.mean()),
                steps=inp.steps, noise="pinned",
                plain_spread_max=float(spread.max()),
                plain_spread_mean=float(spread.mean()), ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, us_per_step=ms * 1e3 / inp.steps,
                plan=dataclasses.asdict(WK.device_plan(inp, dev)), **bf16)


def fold_rows(frames: int, target: int, wr_cfg) -> int:
    """Fold rows of a ``frames``-frame mel at ``target`` (the sampling
    path folds at frame rate, ``wavernn._fold_rows``)."""
    S, g = wr_cfg.total_scale, wr_cfg.generate
    return WR._fold_count(frames, target // S, g.overlap // S)


def single_pick(frames: int, wr_cfg) -> dict:
    """The fold geometry that one sampling pass over a ``frames``-frame
    mel runs at (``generate``, ``convert``): the picker's target
    (``wavernn.auto_fold_target`` with ``cfg``, on the (frames - 1) x hop
    output samples), the folds, their row bucket, frames a fold and
    steps, and the wall model's kernel-1 ms."""
    g = wr_cfg.generate
    samples = (frames - 1) * wr_cfg.hop_length
    t = WR.auto_fold_target(samples, g.overlap, wr_cfg)
    folds = fold_rows(frames, t, wr_cfg)
    return {"target": t, "folds": folds, "rows": WR._row_bucket(folds),
            "frames": (t + 2 * g.overlap) // wr_cfg.total_scale,
            "steps": t + 2 * g.overlap,
            "predicted_kernel1_ms": WR._sampling_wall_model(
                samples, t, g.overlap, wr_cfg) / 1e3}


def serve_pick(frames, wr_cfg) -> dict:
    """Batch serving's geometry for mels of ``frames`` frames
    (``generate_many``): the picker's target over the pooled output
    samples at ``cap=_MAX_SLAB_ROWS``, the union's folds and the slab
    rows."""
    g = wr_cfg.generate
    t = WR.auto_fold_target(sum((f - 1) * wr_cfg.hop_length for f in frames),
                            g.overlap, cap=WR._MAX_SLAB_ROWS)
    folds = sum(fold_rows(f, t, wr_cfg) for f in frames)
    return {"target": t, "folds": folds,
            "rows": min(WR._MAX_SLAB_ROWS, WR._row_bucket(folds)),
            "frames": (t + 2 * g.overlap) // wr_cfg.total_scale}


def kernel1_geometries() -> dict:
    """{(rows, frames a fold): [the runs that pick it]} of every bf16
    kernel-1 launch of phases 4 and 8, from the picker: ``convert`` of
    each wav of ``CONVERSIONS`` and ``SERVES``, of the 2 s warm-ups and of
    the 10 s wav padded to 5 and 3 s multiples (cut=True: the merged
    chunks' frames); ``cut=False`` of the 2 s, 10 s and 24 s wavs (the
    whole mel); each ``SERVES`` workload's slabs."""
    sr = 22050
    wr_cfg, mel_cfg = WaveRNNConfig(), AutoEncoderConfig().spectrogram
    geos = {}

    def add(pick, what):
        geos.setdefault((pick["rows"], pick["frames"]), []).append(what)

    ten = int(10.0 * sr)
    cut = {f"{sec:g} s": int(sec * sr) for sec in sorted(
        {2.0} | {c[0] for c in CONVERSIONS}
        | {x for v in SERVES.values() for x in v})}
    for pad in (5.0, 3.0):
        bucket = int(round(pad * sr))
        cut[f"10 s padded to {pad:g} s"] = ten + (-ten) % bucket
    for what, n in cut.items():
        add(single_pick(expected_frames(n, mel_cfg), wr_cfg), what)
    for sec in (2.0, 10.0, 24.0):
        frames = dsp.mel_spec_auto_encoder(
            synthetic_wav(sec, sr, int(sec)), mel_cfg).shape[-1]
        add(single_pick(frames, wr_cfg), f"{sec:g} s cut=False")
    for name, seconds in SERVES.items():
        add(serve_pick([expected_frames(int(x * sr), mel_cfg)
                        for x in seconds], wr_cfg), f"{name} slabs")
    return geos


class Kernel1Geometries:
    """While entered, counts the bf16 ``wavernn_kernels.generate_rows``
    calls by (rows, frames a fold) (``ran``); ``paused()`` stops the
    count for a block."""

    def __enter__(self):
        self.ran, self.active = {}, True
        self._fn = fn = WK.generate_rows

        @functools.wraps(fn)
        def recorded(params, mel_rows, aux_rows, cfg, fast_math=True,
                     *args, **kwargs):
            if self.active and fast_math:
                geo = (int(aux_rows.shape[0]), int(aux_rows.shape[1]))
                self.ran[geo] = self.ran.get(geo, 0) + 1
            return fn(params, mel_rows, aux_rows, cfg, fast_math, *args,
                      **kwargs)

        WK.generate_rows = recorded
        return self

    def __exit__(self, *exc):
        WK.generate_rows = self._fn

    @contextlib.contextmanager
    def paused(self):
        self.active = False
        try:
            yield
        finally:
            self.active = True


def compare_wavernn(gen, dev, geos: dict) -> dict:
    """Kernel 1 against the plain loop, at rd = fc = 512, MOL:
      * f32, 8 rows x 4 frames, drawn noise: atol 1e-3;
      * f32, 48 and 64 rows x 4 frames, and at the smallest picked row
        bucket above 64 (several row passes a step), pinned noise: atol
        1e-3;
      * bf16 (the main path's tensor-core products) at 16 and 48 rows and
        at batch serving's 64-row slab, on a full 11000 + 2 * 550 fold
        (44 frames, 12100 steps), and at every (rows, frames) of
        ``geos`` (:func:`kernel1_geometries`: the geometries that the
        picker gives phases 4 and 8, short folds and more than 64 rows
        among them), each over its whole fold:
        - drawn noise, the first 8 steps: atol 1e-2 (later, a pick that
          one side flips decorrelates the streams), a row whose first
          differing sample is a near-tie pick (:func:`near_tie_flips`: a
          nudge of at most ``PICK_TIE`` to one Gumbel lane of the plain
          loop gives the kernel's sample) compared up to that step, each
          such flip logged; all steps finite, in [-1, 1], mean and std
          within 0.1 and 0.15 of the f32 kernel's on the same inputs;
        - pinned noise, the first 30 steps: atol 1e-2;
        - pinned noise, all steps: max |err| below twice, mean |err|
          below 1.15 times the plain loop's own spread when its mel
          projection is scaled by 1 + 1e-6 N(0, 1).  In bf16 any
          perturbation, however small, flips some operand roundings and
          settles at that spread (max ~1.1e-2, mean ~4.5e-4 over a fold),
          so no implementation meets a fixed 1e-2 over a whole fold.  The
          kernel's mean |err| is that spread (ratio ~1.00); one that kept
          the GRU state rounded to bf16 gives ~1.25, a misplaced bias far
          more.
    Logs kernel 1's plan (``WK.device_plan`` of the timed launches) and
    its us a step at 16, 48 and 64 rows, and a ``wavernn_sample picked``
    line of each picked geometry's ms, bound and plain ms.  Returns the
    full-fold comparison at the 4 s wav's pick (the summary's), with its
    kernel time."""
    cfg = WaveRNNConfig()
    params = from_jax_params(WR.init(gen, cfg), dev)
    check_plain_graphed(cfg, params, gen, dev)
    above = min(r for r, _ in geos if r > WR._MAX_SLAB_ROWS)
    for rows, pinned in ((8, False), (48, True), (WR._MAX_SLAB_ROWS, True),
                         (above, True)):
        compare_wavernn_f32(cfg, params, rows, pinned, gen, dev)
    fpf = (11000 + 2 * 550) // cfg.total_scale
    bf16_rows = (16, 48, WR._MAX_SLAB_ROWS)
    res = {rows: compare_wavernn_bf16(cfg, params, rows, fpf, gen, dev)
           for rows in bf16_rows}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log({"phase": "wavernn_sample plan", "sms": sms, **{
        f"{rows}_rows": dict(res[rows]["plan"],
                             us_per_step=res[rows]["us_per_step"],
                             ms=res[rows]["ms"],
                             us_per_row_step=res[rows]["us_per_step"] / rows)
        for rows in bf16_rows}})
    # a pick at a full fold of 16, 48 or 64 rows is the hold above
    picked = {geo: (res[geo[0]] if geo[1] == fpf and geo[0] in res
                    else compare_wavernn_bf16(cfg, params, *geo, gen, dev,
                                              picked_by=what))
              for geo, what in sorted(geos.items())}
    log({"phase": "wavernn_sample picked", "sms": sms, **{
        f"{r}x{f}": {"picked_by": geos[(r, f)], "steps": c["steps"],
                     "ms": c["ms"], "us_per_step": c["us_per_step"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "plain_ms": c["plain_ms"],
                     "max_abs_err": c["max_abs_err"],
                     "passes": c["plan"]["passes"]}
        for (r, f), c in picked.items()}})
    compare_wavernn_raw9(gen, dev)
    four = single_pick(expected_frames(int(CONVERSIONS[0][0] * 22050),
                                       AutoEncoderConfig().spectrogram), cfg)
    return picked[(four["rows"], four["frames"])]


def hold_wavernn_raw9_tie(cfg, params, rows: int, gen, dev) -> dict:
    """Kernel 1 on the split pick where three classes tie exactly at every
    step, two in one slice (on two lanes of a quad) and one in another:
    the fc3 rows and biases of classes 102 and 300 are class 100's (R1
    blocks 12, 12 and 37), and their Gumbel lanes are raised by 1e3
    (exact in bf16), so every pick is a tie that goes to the lowest class,
    as the plain loop's argmax: every sample is class 100's."""
    tied = [100, 102, 300]
    fc3 = {k: v.clone() for k, v in params["fc3"].items()}
    for c in tied[1:]:
        fc3["w"][c] = fc3["w"][tied[0]]
        fc3["b"][c] = fc3["b"][tied[0]]
    inp, gum, lgs = wavernn_inputs(cfg, dict(params, fc3=fc3), rows, 2,
                                   True, gen, dev)
    gum[:, :, tied] = 1e3
    out = WK.launch(inp, gum, lgs)
    want = torch.full_like(out, 2.0 * tied[0] / (cfg.n_classes - 1) - 1.0)
    return hold(out, want, 1e-3, dtype="torch.bfloat16", rows=rows,
                steps=inp.steps, noise=f"lanes {tied} tied")


def compare_wavernn_raw9(gen, dev) -> dict:
    """Kernel 1 in bf16 in RAW with 9 bits (512 classes: the split pick,
    each R1 block 8 of them) against the plain loop at 32, 64 and 128
    rows x 9 frames (2475 steps, the 4 s wav's fold), the holds of
    :func:`compare_wavernn_bf16` (pinned, every step: the classes exactly,
    since the pinned lane decides every pick), and a tie across two slices
    at 64 rows (:func:`hold_wavernn_raw9_tie`); logs a ``wavernn_sample
    raw9`` line of each one's plan, ms and us a step."""
    cfg = WaveRNNConfig().with_overrides(mode="RAW", bits=9)
    params = from_jax_params(WR.init(gen, cfg), dev)
    res = {rows: compare_wavernn_bf16(cfg, params, rows, 9, gen, dev,
                                      mode="RAW-9")
           for rows in (32, 64, 128)}
    hold_wavernn_raw9_tie(cfg, params, 64, gen, dev)
    log({"phase": "wavernn_sample raw9", **{
        f"{rows}_rows": {"ms": c["ms"], "us_per_step": c["us_per_step"],
                         "bound_ms": c["bound_ms"], "plain_ms": c["plain_ms"],
                         "max_abs_err": c["max_abs_err"],
                         "slice_classes": c["plan"]["slice_classes"],
                         "from_l2": list(WK.WrPlan(**c["plan"]).from_l2)}
        for rows, c in res.items()}})
    return res


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


class CallTimer:
    """Replaces ``owner.<name>`` while entered with a wrapper that keeps
    each call's wall (host clock, ``walls``) and the device ms between
    CUDA events recorded just before and after it (``device_ms``)."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.walls, self._events = [], []
        self._fn = fn = getattr(self.owner, self.name)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.walls.append(time.perf_counter() - t0)
                end.record()
                self._events.append((start, end))

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._fn)

    @property
    def device_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]


@contextlib.contextmanager
def pinned_target(target: int):
    """``wavernn.auto_fold_target`` returns ``target`` while entered."""
    real = WR.auto_fold_target
    WR.auto_fold_target = lambda *args, **kwargs: target
    try:
        yield
    finally:
        WR.auto_fold_target = real


def ladder_walls(vc, convert, wav, reps: int = 3) -> dict:
    """The conversion's wall (host clock to a device synchronise), its
    vocoder stage's wall (``stage_times``) and the sampling loop's device
    ms (CUDA events around ``generate_rows``) of ``convert(wav)`` at the
    picker's target and with each ladder entry pinned: the median of
    ``reps`` runs each, after one run at that geometry."""
    out = {}
    for t in (None,) + WR._TARGET_LADDER:
        with (contextlib.nullcontext() if t is None else pinned_target(t)):
            convert(wav)
            convs, walls, loops = [], [], []
            for _ in range(reps):
                vc.stage_times = {}
                with CallTimer(WK, "generate_rows") as loop:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    convert(wav)
                    torch.cuda.synchronize()
                    convs.append(time.perf_counter() - t0)
                walls.append(vc.stage_times["vocoder"])
                loops.append(sum(loop.device_ms))
            vc.stage_times = None
        out["pick" if t is None else str(t)] = {
            "convert_wall_s": statistics.median(convs),
            "vocoder_wall_s": statistics.median(walls),
            "sampling_loop_ms": statistics.median(loops)}
    fastest = min(v["vocoder_wall_s"] for k, v in out.items() if k != "pick")
    out["pick_over_fastest"] = out["pick"]["vocoder_wall_s"] / fastest
    return out


def phase_end_to_end(card: str, recorder=None) -> tuple[dict, list]:
    """Each wav converts three times after a warm-up: once timed with the
    launch counts read around it (the main path), once under
    ``torch.profiler`` (device busy share, device time by kernel), once with
    ``VoiceConverter.stage_times`` set (each stage's wall to a device
    synchronise; the sampling loop's device ms, ``wavernn_kernels.
    generate_rows`` between CUDA events, in the same run).  Each line
    carries the vocoder's picked geometry (``vocoder_pick``: target,
    folds, row bucket, steps, the wall model's kernel-1 ms) and its
    walls at the pick and at every ladder entry (:func:`ladder_walls`,
    with ``recorder`` paused: those geometries are not picks).  Returns the launches and each
    conversion's line."""
    sr = 22050
    vc = VoiceConverter(verbose=False)
    target = Audio(synthetic_wav(3.0, sr, 99), sr_org=sr)
    launches = {name: 0 for name in CONVERT_KERNELS}
    results = []
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
    for seconds, path_kernel, chunks in CONVERSIONS:
        wav = synthetic_wav(seconds, sr, int(seconds))
        mel_cfg = vc.AE.config.spectrogram
        _, mel_slices = dsp.compute_partial_slices(
            len(wav), sr, partial_utterance_n_frames=mel_cfg.
            partial_utterance_n_frames, mel_window_step=mel_cfg.mel_window_step)
        N = mel_cfg.partial_utterance_n_frames
        frames = N + (len(mel_slices) - 1) * (N // 2)
        expected = (frames - 1) * mel_cfg.hop_length
        pick = single_pick(frames, vc.vocoder.config)
        for spec in KERNELS.values():
            spec["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = convert(wav)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {name: KERNELS[name]["kernel"].launches
                  for name in CONVERT_KERNELS}
        for name in CONVERT_KERNELS:
            launches[name] += counts[name]

        t0 = time.time()
        with torch.profiler.profile(activities=acts) as prof:
            convert(wav)
            torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
        busy_ms, top = device_busy(prof)
        vc.stage_times = {}
        with CallTimer(WK, "generate_rows") as loop:
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
               "sampling_loop_ms": loop.device_ms, "vocoder_pick": pick,
               "card": card}
        with (recorder.paused() if recorder is not None
              else contextlib.nullcontext()):
            res["vocoder_ladder"] = ladder_walls(vc, convert, wav)
        log(res)
        results.append(res)
        if not np.all(np.isfinite(out.wav)):
            raise AssertionError("non-finite output")
        if rms <= 1e-4:
            raise AssertionError(f"silent output (rms {rms})")
        if len(out.wav) != expected:
            raise AssertionError(f"output length {len(out.wav)} != "
                                 f"{expected}")
        if len(mel_slices) != chunks:   # phase 3 held its kernel at chunks
            raise AssertionError(f"the {seconds} s wav gave "
                                 f"{len(mel_slices)} chunks, not {chunks}")
        for name in ("wavernn_sample", path_kernel):
            if counts[name] < 1:
                raise AssertionError(f"the {seconds} s conversion did not "
                                     f"launch {name}")
    return launches, results


def ae_slab_ms(gen, dev, card: str, reps: int = 5) -> dict:
    """``convert_slab`` wall (host clock to a device synchronise, median of
    ``reps`` after a warm-up) at each slab size of the ladder: bf16, T =
    400, full width, fresh seeded weights.  The source of
    ``autoencoder._SLAB_MS``; kernel 3's row groups of lstm2 beside it."""
    cfg = AutoEncoderConfig()
    params = from_jax_params(AE.init(gen, cfg), dev)
    packed = LK.pack(params["decoder"]["lstm2"], "bf16")
    ms, groups = {}, {}
    with torch.inference_mode():
        for S in AE._SLAB_LADDER:
            chunks = torch.rand(S, cfg.n_mels, 400, generator=gen).to(dev)
            c = torch.nn.functional.normalize(
                torch.randn(2 * S, cfg.dim_emb, generator=gen), dim=1).to(dev)

            def run():
                AE.convert_slab(params, chunks, c[:S], c[S:], cfg, "bf16",
                                packed)
                torch.cuda.synchronize()

            run()
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms[S] = statistics.median(walls)
            groups[S] = (LK.device_plan(S, 1024, 2, True, dev).groups
                         if S > LK.LATENCY_MAX_ROWS else 0)
    res = {"phase": "ae_slab_ms", "precision": "bf16", "T": 400,
           "ms": ms, "us_per_row": {S: ms[S] * 1e3 / S for S in ms},
           "lstm2_kernel3_groups": groups, "card": card}
    log(res)
    return res


# Batch serving's two workloads (source wav seconds): eight mixed
# lengths, and 24 wavs of 10 s (3 chunks each: 72 generator rows).
SERVES = {"serve-8": (2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 16.0, 24.0),
          "serve-24": (10.0,) * 24}
SERVE_TAGS = {"wavernn_sample": "wr_kernel",
              "lstm_stack_skewed": "lstm_small_kernel",
              "lstm_stack_stream": "lstm_fwd_kernel"}


def chunk_count(n_samples: int, mel_cfg) -> int:
    """Mel chunks of a cut=True conversion of ``n_samples``."""
    return len(dsp.compute_partial_slices(
        n_samples, mel_cfg.sr,
        partial_utterance_n_frames=mel_cfg.partial_utterance_n_frames,
        mel_window_step=mel_cfg.mel_window_step)[1])


def expected_frames(n_samples: int, mel_cfg) -> int:
    """Merged mel frames of a cut=True conversion of ``n_samples``."""
    N = mel_cfg.partial_utterance_n_frames
    return N + (chunk_count(n_samples, mel_cfg) - 1) * (N // 2)


def expected_samples(n_samples: int, mel_cfg) -> int:
    """Waveform length of a cut=True conversion of ``n_samples``."""
    return (expected_frames(n_samples, mel_cfg) - 1) * mel_cfg.hop_length


def write_wavs(tmp: str, name: str, seconds, sr: int) -> list[str]:
    paths = []
    for k, sec in enumerate(seconds):
        paths.append(os.path.join(tmp, f"{name}_{k:02d}.wav"))
        audio_io.save_wav(paths[-1], synthetic_wav(sec, sr, 200 + k), sr)
    return paths


def serve_workload(vc, name: str, paths, target, card: str,
                   recorder=None) -> dict:
    """One workload through ``convert_batch`` (bf16): a profiled warm-up,
    three timed serves (the first with the launch counts read around it), one
    under ``torch.profiler`` (device idle share, launches by kernel name),
    then ``convert`` of each wav one by one, then a warm-up and three timed
    serves at the config's fixed fold length (11000, the geometry before
    the picker; ``recorder`` paused).  Fails unless kernels 1 and 3
    launched, every output is finite and as long as ``convert``'s."""
    sr = 22050
    mel_cfg = vc.AE.config.spectrogram
    wr_cfg = vc.vocoder.config
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def serve():
        return vc.convert_batch(paths, Audio(target.copy(), sr_org=sr))

    # warm-up (allocator, cuDNN plans, the profiler's start-up): not
    # timed, not counted
    with torch.profiler.profile(activities=acts):
        serve()
    walls = []
    for i in range(3):
        if i == 0:
            for spec in KERNELS.values():
                spec["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = serve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            counts = {k: KERNELS[k]["kernel"].launches
                      for k in CONVERT_KERNELS}
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        serve()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof)
    by_tag = kernel_launch_ms(prof, tuple(SERVE_TAGS.values()))
    prof_launches = {k: len(by_tag.get(tag, []))
                     for k, tag in SERVE_TAGS.items()}
    one_walls, singles = [], []
    for p in paths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles.append(vc.convert(p, Audio(target.copy(), sr_org=sr),
                                  save_name=False))
        torch.cuda.synchronize()
        one_walls.append(time.perf_counter() - t0)
    fixed_walls = []
    with (recorder.paused() if recorder is not None
          else contextlib.nullcontext()), \
            pinned_target(wr_cfg.generate.target):
        serve()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            fixed_walls.append(time.perf_counter() - t0)

    lens = [len(audio_io.load_wav(p)[0]) for p in paths]
    expected = [expected_samples(n, mel_cfg) for n in lens]
    chunks = [chunk_count(n, mel_cfg) for n in lens]
    pick = serve_pick([expected_frames(n, mel_cfg) for n in lens], wr_cfg)
    folds, slab = pick["folds"], pick["rows"]
    audio_s = sum(len(o.wav) for o in outs) / sr
    wall = statistics.median(walls)
    res = {"phase": "batch_serving", "workload": name,
           "seconds_in": [round(n / sr, 3) for n in lens],
           "audio_s": audio_s, "wall_s": walls, "median_wall_s": wall,
           "audio_s_per_s": audio_s / wall,
           "one_by_one_wall_s": sum(one_walls),
           "one_by_one_audio_s_per_s": audio_s / sum(one_walls),
           "fixed_target": wr_cfg.generate.target,
           "fixed_target_wall_s": fixed_walls,
           "fixed_target_audio_s_per_s": audio_s / statistics.median(
               fixed_walls),
           "ae_rows": sum(chunks), "ae_slab_plan": AE._slab_plan(sum(chunks)),
           "vocoder_target": pick["target"], "vocoder_folds": folds,
           "vocoder_slab_rows": slab, "vocoder_slabs": -(-folds // slab),
           "vocoder_frames_per_fold": pick["frames"],
           "launches": counts, "profiler_launches": prof_launches,
           "profiled_wall_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "device_ms_by_kernel": top, "card": card}
    log(res)
    for k in ("wavernn_sample", "lstm_stack_stream"):
        if prof_launches[k] < 1 or counts[k] < 1:
            raise AssertionError(f"{name} did not launch {k}: {res}")
    for o, one, e in zip(outs, singles, expected):
        if not np.all(np.isfinite(o.wav)):
            raise AssertionError(f"{name}: non-finite output")
        if not len(o.wav) == len(one.wav) == e:
            raise AssertionError(f"{name}: output length {len(o.wav)}, "
                                 f"convert's {len(one.wav)}, expected {e}")
    return counts


def batch_f32_hold(tmp: str, target, card: str, bar: float = 1e-3) -> dict:
    """f32 generator and vocoder, row-invariant pinned noise: each
    utterance of ``convert_batch`` over three wavs of 1-3 s equals
    ``convert`` of the same wav, max |err| < ``bar`` (both through int16
    PCM; no outprocess).  A fold at a wrong slab offset or an utterance cut
    at a wrong fold changes whole folds.  The fold picker prices the
    batch's pooled folds in 64-row slabs and each ``convert`` as one pass,
    so their picks may differ: both run here at the batch's pick."""
    sr = 22050
    vc = VoiceConverter(verbose=False, ae_precision="f32",
                        vocoder_precision="f32")
    paths = write_wavs(tmp, "hold", (1.0, 2.0, 3.0), sr)
    mel_cfg = vc.AE.config.spectrogram
    pick = serve_pick([expected_frames(len(audio_io.load_wav(p)[0]), mel_cfg)
                       for p in paths], vc.vocoder.config)
    draw = WK.draw_noise

    def pinned(steps, rows, pick_dim, generator, device):
        # the same sequence on every row and in every call, one Gumbel
        # lane a step raised by 1e3 (as phase 3's pinned holds): a fold's
        # samples depend on its conditioning alone, wherever it sits in a
        # slab, and no pick hangs on the logits' last bits
        g = torch.Generator().manual_seed(11)
        gumbel, logistic = draw(steps, 1, pick_dim, g, "cpu")
        lane = torch.randint(0, pick_dim, (steps, 1, 1), generator=g)
        gumbel = gumbel.scatter(-1, lane, 1e3)
        return (gumbel.expand(steps, rows, pick_dim).contiguous().to(device),
                logistic.expand(steps, rows).contiguous().to(device))

    WK.draw_noise = pinned
    try:
        with pinned_target(pick["target"]):
            outs = vc.convert_batch(paths, Audio(target.copy(), sr_org=sr),
                                    outprocess=())
            singles = [vc.convert(p, Audio(target.copy(), sr_org=sr),
                                  outprocess=(), save_name=False)
                       for p in paths]
    finally:
        WK.draw_noise = draw
    errs = []
    for o, one in zip(outs, singles):
        if o.wav.shape != one.wav.shape:
            raise AssertionError(f"f32 hold: lengths {o.wav.shape} and "
                                 f"{one.wav.shape}")
        errs.append(float(np.max(np.abs(o.wav - one.wav))))
    res = {"phase": "batch_serving f32 hold", "seconds_in": [1, 2, 3],
           "vocoder_target": pick["target"],
           "max_abs_err": errs, "rms": [float(np.sqrt(np.mean(
               o.wav.astype(np.float64) ** 2))) for o in outs],
           "tolerance": f"max |err| < {bar}", "ok": max(errs) < bar,
           "card": card}
    log(res)
    if not res["ok"]:
        raise AssertionError(f"convert_batch disagrees with convert: {res}")
    return res


def unchunked_and_padded(vc, target, card: str) -> dict:
    """``convert(cut=False)`` of the 10 s and 24 s wavs (lstm2 on kernel 2
    at one row over every frame), the 10 s one timed after a 2 s warm-up;
    ``pad_to_seconds`` 5 and 3 on the 10 s wav.  Each output finite and of
    its expected length (cut=False: (mel frames - 1) x hop; padded:
    ``convert``'s)."""
    sr = 22050
    mel_cfg = vc.AE.config.spectrogram
    counts = {k: 0 for k in CONVERT_KERNELS}

    def convert(wav, **kw):
        for spec in KERNELS.values():
            spec["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vc.convert(Audio(wav.copy(), sr_org=sr),
                         Audio(target.copy(), sr_org=sr), save_name=False,
                         **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in CONVERT_KERNELS:
            counts[k] += KERNELS[k]["kernel"].launches
        return out, wall, {k: KERNELS[k]["kernel"].launches
                           for k in CONVERT_KERNELS}

    convert(synthetic_wav(2.0, sr, 2), cut=False)
    res = {"phase": "convert paths", "card": card}
    for sec in (10.0, 24.0):
        wav = synthetic_wav(sec, sr, int(sec))
        frames = dsp.mel_spec_auto_encoder(wav, mel_cfg).shape[-1]
        out, wall, n = convert(wav, cut=False)
        res[f"cut_false_{int(sec)}s"] = {
            "mel_frames": frames, "samples_out": len(out.wav),
            "wall_s": wall, "audio_s_per_s": len(out.wav) / sr / wall,
            "launches": n}
        if not np.all(np.isfinite(out.wav)) \
                or len(out.wav) != (frames - 1) * mel_cfg.hop_length:
            raise AssertionError(f"cut=False {sec} s: {res}")
        if n["lstm_stack_skewed"] < 1 or n["wavernn_sample"] < 1:
            raise AssertionError(f"cut=False {sec} s did not run kernels 1 "
                                 f"and 2: {n}")
    wav = synthetic_wav(10.0, sr, 10)
    for pad in (5.0, 3.0):
        out, wall, n = convert(wav, pad_to_seconds=pad)
        res[f"pad_to_{pad:g}s"] = {"samples_out": len(out.wav),
                                   "wall_s": wall}
        if not np.all(np.isfinite(out.wav)) \
                or len(out.wav) != expected_samples(len(wav), mel_cfg):
            raise AssertionError(f"pad_to_seconds={pad}: {res}")
    log(res)
    return counts


def phase_batch_serving(card: str, recorder=None) -> dict:
    """Batch serving on ``VoiceConverter()`` (default config, fresh seeded
    weights, bf16): serve-8 and serve-24 (:func:`serve_workload`), the f32
    hold of ``convert_batch`` against ``convert``
    (:func:`batch_f32_hold`), then ``cut=False`` and ``pad_to_seconds``
    (:func:`unchunked_and_padded`).  Returns the kernels' launches."""
    sr = 22050
    vc = VoiceConverter(verbose=False)
    target = synthetic_wav(3.0, sr, 99)
    launches = {k: 0 for k in CONVERT_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for name, seconds in SERVES.items():
            counts = serve_workload(vc, name, write_wavs(tmp, name, seconds,
                                                         sr), target, card,
                                    recorder)
            for k in CONVERT_KERNELS:
                launches[k] += counts[k]
        batch_f32_hold(tmp, target, card)
        for k, n in unchunked_and_padded(vc, target, card).items():
            launches[k] += n
    return launches


class StepClock:
    """A training logger (``log_freq=1``) that keeps each step's loss and
    the host time when it arrived: the loop pulls the loss to the host to
    log it, so the times are of finished steps."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((time.perf_counter(), metrics))


def phase_train(card: str, steps_min: int = 8) -> dict:
    """``VoiceConverter().train`` of the AutoVC generator (default config,
    bf16, 16 chunks of 400 frames a step) on synthetic wavs: every loss
    finite, the mean of the last two below the first, kernels 6 and 7
    launched at least twice a step each.  Then one step of the same step
    function profiled (device idle share, device time by kernel)."""
    sr = 22050
    vc = VoiceConverter(verbose=False)
    clock = StepClock()
    vc.logger = clock
    n_epochs = 3
    with tempfile.TemporaryDirectory() as tmp:
        # 8 wavs of 22.5 s: 8 chunks of 400 frames each, 4 steps an epoch
        for i in range(8):
            audio_io.save_wav(os.path.join(tmp, f"speaker{i % 4}_{i}.wav"),
                              synthetic_wav(22.5, sr, 100 + i), sr)
        for name in TRAIN_KERNELS:
            KERNELS[name]["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = vc.train(tmp, model_type="auto_encoder", n_epochs=n_epochs,
                        batch_size=16, log_freq=1, model_name="")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {name: KERNELS[name]["kernel"].launches for name in TRAIN_KERNELS}
    steps = info["step"]
    losses = [m["loss"] for _, m in clock.records]
    times = [t for t, _ in clock.records]
    step_s = statistics.median(b - a for a, b in zip(times, times[1:]))
    ok = (steps >= steps_min and len(losses) == steps
          and all(math.isfinite(v) for v in losses)
          and (losses[-1] + losses[-2]) / 2 < losses[0]
          and all(c >= 2 * steps for c in counts.values()))

    # one more step of the same step function, profiled (a random batch of
    # the same shape; the first call warms up)
    cfg = vc.AE.config
    tx = TRS.make_optimizer(cfg.optimizer, 1)
    step_fn = TRL.make_ae_step(cfg, tx, cfg.learn.ema_decay)
    params = vc.AE.params
    opt_state = tx.init(tree_leaves(params))
    ema = vc.AE.extras["ema_params"]
    g = torch.Generator().manual_seed(3)
    x = torch.rand(16, 80, 400, generator=g).cuda()
    c = torch.nn.functional.normalize(torch.randn(16, 256, generator=g),
                                      dim=1).cuda()
    step_fn(params, opt_state, ema, x, c)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(params, opt_state, ema, x, c)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof)
    kernel_ms = kernel_ms_of(prof, ("lstm_fwd_kernel",
                                    "lstm_train_bwd_kernel", "dw_bf16_kernel",
                                    "dw_f32_kernel"))
    res = {"phase": "train", "steps": steps, "epochs": n_epochs,
           "batch": [16, 80, 400], "precision": cfg.learn.precision,
           "losses": losses, "launches": counts, "wall_s": wall,
           "median_step_s": step_s, "frames_per_s": 16 * 400 / step_s,
           "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           # the profiler's host overhead stretches the profiled step; the
           # device time it records set against the unprofiled median step
           "device_idle_share_of_median_step":
               1.0 - busy_ms / (step_s * 1e3),
           # kernel 6 of lstm1 and lstm2 is lstm_fwd_kernel, kernel 7
           # lstm_train_bwd_kernel (the recurrence) and dw_*_kernel (its
           # dW / db products)
           "device_ms_by_kernel": top, "train_kernel_ms": kernel_ms,
           "card": card, "ok": ok}
    log(res)
    if not ok:
        raise AssertionError(f"training phase failed: {res}")
    return res


def leaf_names(tree, path="") -> list[str]:
    """Leaf paths of a parameter tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{path}/{i}")]
    return [path.lstrip("/")]


def hold_f32_step(phase: str, grads_of, params_cpu, arrays, perturbed,
                  zero_grad, card: str, **info) -> dict:
    """One f32 full-width training step's loss and gradients on the card
    (the kernels) against the same step on the CPU (their plain versions),
    from the same weights.  ``grads_of(params, *arrays)`` gives (loss, host
    gradients) from a copy of ``params`` (the BN statistics move), on the
    batch ``arrays``.  Bars:
      * the loss: relative 1e-4;
      * each gradient leaf: its relative L2 error ``|a - b| / |b|`` at most
        1e-3, or at most the CPU's own relative L2 change when the
        arrays at ``perturbed`` are scaled by 1 + 1e-5 N(0, 1) (the larger
        of two draws), whichever is larger.  f32 training gradients through
        train-mode batch-norms (one-pass variance, as in the JAX package)
        are ill-conditioned at small batches: a change of summation order
        anywhere moves every leaf by about a part in a thousand, and the
        largest element of a leaf by up to a few percent of its max |ref|,
        so a max-abs bar of 1e-3 of max |ref| fails the CPU against itself
        under a 1e-6 perturbation;
      * BN running statistics get no gradient; the leaves named by
        ``zero_grad`` (conv biases that feed a batch-norm) have an
        analytically zero gradient: both sides below 1e-5 of the largest
        gradient."""
    params_gpu = from_jax_params(params_cpu, torch.device("cuda"))
    t0 = time.perf_counter()
    loss_g, grads_g = grads_of(params_gpu, *arrays)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, grads_c = grads_of(params_cpu, *arrays)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    rng = np.random.default_rng(13)
    spread = [0.0] * len(grads_c)
    for _ in range(2):
        shaken = [(a * (1 + 1e-5 * rng.standard_normal(a.shape))).astype(
            np.float32) if i in perturbed else a for i, a in enumerate(arrays)]
        _, grads_s = grads_of(params_cpu, *shaken)
        spread = [max(s, rel_l2(g, r))
                  for s, g, r in zip(spread, grads_s, grads_c)]
    noise = 1e-5 * max(float(g.abs().max()) for g in grads_c)
    worst, worst_leaf, max_err, failed = 0.0, None, 0.0, []
    for name, a, b, s in zip(leaf_names(params_cpu), grads_g, grads_c,
                             spread):
        scale = float(b.abs().max())
        if name.endswith("/mean") or name.endswith("/var"):
            if scale or float(a.abs().max()):
                failed.append(f"{name}: running statistic has a gradient")
            continue
        if zero_grad(name):
            if max(float(a.abs().max()), scale) > noise:
                failed.append(f"{name}: gradient not ~0")
            continue
        err = rel_l2(a, b)
        max_err = max(max_err, err)
        ratio = err / max(1e-3, s)
        if ratio > 1:
            failed.append(f"{name}: rel L2 err {err:.3g}, bar "
                          f"{max(1e-3, s):.3g}")
        if ratio > worst:
            worst, worst_leaf = ratio, name
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    if loss_rel > 1e-4:
        failed.append(f"loss rel err {loss_rel:.3g}")
    res = {"phase": phase, **info,
           "loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_rel,
           "grads_max_rel_l2": max_err, "grads_worst_leaf": worst_leaf,
           "grads_worst_err_over_bar": worst,
           "card_s": gpu_s, "cpu_s": cpu_s, "card": card,
           "tolerance": ("loss rel 1e-4; each gradient's relative L2 error "
                         "within max(1e-3, the CPU's own change under a "
                         "1e-5 perturbation of the batch)"),
           "failed": failed, "ok": not failed}
    log(res)
    if failed:
        raise AssertionError(f"f32 card step disagrees with the CPU: {res}")
    return res


def phase_train_f32_vs_cpu(card: str) -> dict:
    """The AutoVC generator's f32 step (batch 4 x 400 frames; kernels 6 and
    7 on the card) held against the CPU's by :func:`hold_f32_step`, the
    mel batch perturbed; the conv biases before a batch-norm have zero
    gradient."""
    cfg = AutoEncoderConfig()
    rng = np.random.default_rng(12)
    x = rng.random((4, 80, 400), dtype=np.float32)
    c = rng.standard_normal((4, 256)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)

    def grads_of(params, x, c):
        aux, grads = TRL.loss_and_grads(tree_clone(params), x, c, cfg, "f32")
        return float(aux["loss"]), [g.cpu() for g in grads]

    return hold_f32_step(
        "train_f32_card_vs_cpu", grads_of,
        AE.init(torch.Generator().manual_seed(11), cfg), (x, c), (0,),
        lambda name: name.endswith("/conv/b"), card, batch=[4, 80, 400])


def phase_vocoder_train(card: str, steps: int = 16) -> dict:
    """``VoiceConverter().train(..., model_type="vocoder")`` at the default
    config (rnn / fc 512, MOL, 10 res blocks; bf16) and the JAX loop's
    defaults (batch 8 x 9 frames = 2475 samples a row, lr 1e-4, constant,
    clip 4) on synthetic wavs, 2 epochs of ``steps / 2``: every loss
    finite, the mean of the last two below the first, kernels 4 and 5
    launched once a step each.  Then one step of the same step function
    profiled (device idle share, kernels 4/5's share of device time)."""
    sr = 22050
    vc = VoiceConverter(verbose=False)
    clock = StepClock()
    vc.logger = clock
    batch, frames = 8, 9
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(8):
            audio_io.save_wav(os.path.join(tmp, f"voice{i}.wav"),
                              synthetic_wav(3.0, sr, 200 + i), sr)
        for name in VOCODER_KERNELS:
            KERNELS[name]["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = vc.train(tmp, model_type="vocoder", n_epochs=2,
                        steps_per_epoch=steps // 2, batch_size=batch,
                        seq_frames=frames, log_freq=1, model_name="")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {n: KERNELS[n]["kernel"].launches for n in VOCODER_KERNELS}
    n_steps = info["step"]
    losses = [m["loss"] for _, m in clock.records]
    times = [t for t, _ in clock.records]
    step_s = statistics.median(b - a for a, b in zip(times, times[1:]))
    samples = batch * frames * vc.vocoder.config.hop_length
    ok = (n_steps == steps and len(losses) == steps
          and all(math.isfinite(v) for v in losses)
          and (losses[-1] + losses[-2]) / 2 < losses[0]
          and all(c == steps for c in counts.values()))

    # one more step of the same step function, profiled (a random batch of
    # the same shape; the first call warms up)
    cfg = vc.vocoder.config
    tx = TRS.make_optimizer(OptimizerConfig(
        lr=1e-4, lr_scheduler="constant", grad_clip_norm=4.0), 1)
    step_fn = TRL.make_vocoder_step(cfg, tx)
    params = vc.vocoder.params
    opt_state = tx.init(tree_leaves(params))
    g = torch.Generator().manual_seed(4)
    x = (0.3 * torch.randn(batch, samples // batch, generator=g)).clamp(-1, 1)
    y = torch.roll(x, -1, 1)
    mels = torch.rand(batch, 80, frames + 2 * cfg.pad, generator=g)
    x, y, mels = x.cuda(), y.cuda(), mels.cuda()
    step_fn(params, opt_state, x, y, mels)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(params, opt_state, x, y, mels)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof)
    kernel_ms = kernel_ms_of(prof, ("gru_train_fwd_kernel",
                                    "gru_train_bwd_kernel", "dw_bf16_kernel"))
    res = {"phase": "vocoder_train", "steps": n_steps, "epochs": 2,
           "batch": [batch, frames, samples // batch], "precision": "bf16",
           "losses": losses, "launches": counts, "wall_s": wall,
           "median_step_s": step_s, "samples_per_s": samples / step_s,
           "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "device_idle_share_of_median_step":
               1.0 - busy_ms / (step_s * 1e3),
           "device_ms_by_kernel": top, "gru_kernel_ms": kernel_ms,
           "gru_kernel_share_of_busy": sum(kernel_ms.values()) / busy_ms,
           "card": card, "ok": ok}
    log(res)
    if not ok:
        raise AssertionError(f"vocoder training phase failed: {res}")
    return res


def phase_vocoder_f32_vs_cpu(card: str) -> dict:
    """The vocoder's f32 step at full width (batch 2 x 3 frames, 825
    samples a row: small enough for the CPU's plain GRU loop; kernels 4
    and 5 on the card) held against the CPU's by :func:`hold_f32_step`,
    the teacher-forced samples and the mels perturbed."""
    cfg = WaveRNNConfig()
    rng = np.random.default_rng(14)
    frames = 3
    T = frames * cfg.hop_length
    x = np.clip(0.3 * rng.standard_normal((2, T)), -1, 1).astype(np.float32)
    y = np.roll(x, -1, 1)
    mels = rng.random((2, 80, frames + 2 * cfg.pad), dtype=np.float32)

    def grads_of(params, x, y, mels):
        loss, grads = TRL.vocoder_loss_and_grads(tree_clone(params), x, y,
                                                 mels, cfg, "f32")
        return float(loss), [g.cpu() for g in grads]

    return hold_f32_step(
        "vocoder_f32_card_vs_cpu", grads_of,
        WR.init(torch.Generator().manual_seed(15), cfg), (x, y, mels), (0, 2),
        lambda name: False, card, batch=[2, frames, T])


class SyntheticSpeakers:
    """A GE2E dataset of ``speakers`` synthetic speakers, made from
    ``seed``: each speaker's mel rows are its prototype (uniform in
    [0, 4) a mel band) plus uniform noise in [0, 1) a frame, as
    ``tests/test_training.py``'s synthetic speakers."""

    def __init__(self, speakers: int, frames: int, mels: int, seed: int):
        self.protos = 4.0 * np.random.default_rng(seed).random(
            (speakers, 1, 1, mels), dtype=np.float32)
        self.shape, self.seed = (frames, mels), seed

    def batches(self, utterances: int, n_batches: int, seed: int = 0):
        rng = np.random.default_rng((self.seed, seed))
        for _ in range(n_batches):
            yield self.protos + rng.random(
                (len(self.protos), utterances, *self.shape),
                dtype=np.float32)


def phase_se_train(card: str, steps: int = 12) -> dict:
    """``train_speaker_encoder`` at the full-width ``SpeakerEncoderConfig()``
    (3 x 256 on 40 mels, bf16, the config's optimizer) on GE2E batches of
    64 speakers (the config's ``learn.batch_size``, the GE2E paper's N) x
    8 utterances (the loop's default) x 160 frames from
    :class:`SyntheticSpeakers`, 2 epochs of ``steps / 2``: every loss
    finite, the mean of the last two below the first, the EER of each
    epoch in [0, 1], kernels 6 and 7 launched once a step each.  Then one
    step of the same step function profiled (device idle share, device
    time by kernel) and kernel 7's recurrence and dW times over 3 steps."""
    dev = torch.device("cuda")
    cfg = SpeakerEncoderConfig()
    S, U = cfg.learn.batch_size, 8
    T = cfg.spectrogram.partial_utterance_n_frames
    params = from_jax_params(SE.init(torch.Generator().manual_seed(21), cfg),
                             dev)
    data = SyntheticSpeakers(S, T, cfg.input_size, 22)
    clock = StepClock()
    for name in TRAIN_KERNELS:
        KERNELS[name]["kernel"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = TRL.train_speaker_encoder(
        params, data, cfg, n_epochs=2, utterances_per_speaker=U,
        steps_per_epoch=steps // 2, log_freq=1, model_name="",
        logger=clock, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: KERNELS[name]["kernel"].launches for name in TRAIN_KERNELS}
    records = [(t, m) for t, m in clock.records if "loss" in m]
    losses = [m["loss"] for _, m in records]
    eers = [m["eer"] for _, m in clock.records if "eer" in m]
    times = [t for t, _ in records]
    step_s = statistics.median(b - a for a, b in zip(times, times[1:]))
    ok = (info["step"] == steps and len(losses) == steps
          and all(math.isfinite(v) for v in losses)
          and (losses[-1] + losses[-2]) / 2 < losses[0]
          and len(eers) == 2 and all(0.0 <= e <= 1.0 for e in eers)
          and all(c == steps for c in counts.values()))

    # one more step of the same step function, profiled (the first call
    # warms up), and kernel 7's two launches apart over 3 more steps
    tx = TRS.make_optimizer(cfg.optimizer, steps // 2,
                            dim_model=cfg.embedding_size)
    step_fn = TRL.make_se_step(cfg, tx)
    opt_state = tx.init(tree_leaves(params))
    batch = next(data.batches(U, 1, seed=99))
    step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof)
    kernel_ms = kernel_ms_of(prof, ("lstm_fwd_kernel",
                                    "lstm_train_bwd_kernel",
                                    "dw_bf16_kernel"))
    rec_ms, dw_ms, profiled = recurrence_and_dw_ms(
        lambda: step_fn(params, opt_state, batch), "lstm_train_bwd_kernel")
    res = {"phase": "se_train", "steps": info["step"], "epochs": 2,
           "batch": [S, U, T, cfg.input_size],
           "precision": cfg.learn.precision, "losses": losses, "eers": eers,
           "launches": counts, "wall_s": wall, "median_step_s": step_s,
           "utterances_per_s": S * U / step_s,
           "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "device_idle_share_of_median_step":
               1.0 - busy_ms / (step_s * 1e3),
           # kernel 6 is lstm_fwd_kernel, kernel 7 lstm_train_bwd_kernel
           # (the recurrence) and dw_bf16_kernel (its dW / db products)
           "device_ms_by_kernel": top, "train_kernel_ms": kernel_ms,
           "kernel7_recurrence_ms": rec_ms, "kernel7_dw_ms": dw_ms,
           "kernel7_launches_profiled": profiled,
           "kernel7_share_of_median_step": (rec_ms + dw_ms)
           / (step_s * 1e3),
           "card": card, "ok": ok}
    log(res)
    if not ok:
        raise AssertionError(f"speaker-encoder training phase failed: {res}")
    return res


def phase_se_f32_vs_cpu(card: str) -> dict:
    """The speaker encoder's f32 GE2E step at full width (4 speakers x 3
    utterances x 160 frames; kernels 6 and 7 in f32 on the card) held
    against the CPU's by :func:`hold_f32_step`, the mel block perturbed;
    the similarity bias's gradient is analytically zero (it shifts every
    logit of a row alike)."""
    cfg = SpeakerEncoderConfig()
    block = next(SyntheticSpeakers(4, cfg.spectrogram.
                                   partial_utterance_n_frames,
                                   cfg.input_size, 23).batches(3, 1))

    def grads_of(params, block):
        loss, grads = TRL.se_loss_and_grads(tree_clone(params), block, "f32")
        return float(loss), [g.cpu() for g in grads]

    return hold_f32_step(
        "se_f32_card_vs_cpu", grads_of,
        SE.init(torch.Generator().manual_seed(24), cfg), (block,), (0,),
        lambda name: name == "similarity_bias", card, batch=list(block.shape))



class OutputTap:
    """Keeps every :class:`Audio` that ``VoiceConverter.convert`` returns
    while it is entered (the command line writes only the int16 files)."""

    def __enter__(self):
        self.outputs = []
        self._convert = VoiceConverter.convert

        # wrapped: the command line reads convert's signature
        @functools.wraps(self._convert)
        def convert(vc, *args, **kwargs):
            out = self._convert(vc, *args, **kwargs)
            self.outputs.append(out)
            return out

        VoiceConverter.convert = convert
        return self

    def __exit__(self, *exc):
        VoiceConverter.convert = self._convert


def cli_run(argv, kernels, profile: bool = False) -> dict:
    """``autovc_tpu_torch.__main__.main(argv)`` in-process: its wall
    (host clock to a device synchronise), the launches of ``kernels`` in
    it (the wrappers' counts, set to 0 just before), what ``convert``
    returned and, with ``profile``, the device's busy ms and idle share
    under ``torch.profiler``."""
    from autovc_tpu_torch.__main__ import main as cli_main
    for name in kernels:
        KERNELS[name]["kernel"].launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with OutputTap() as tap, (torch.profiler.profile(activities=acts)
                              if profile else contextlib.nullcontext()) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = {"wall_s": wall,
           "launches": {k: KERNELS[k]["kernel"].launches for k in kernels},
           "outputs": tap.outputs}
    if profile:
        busy_ms, top = device_busy(prof)
        res.update(device_busy_ms=busy_ms,
                   device_idle_share=1.0 - busy_ms / (wall * 1e3),
                   device_ms_by_kernel=top)
    return res


def check_outputs(what: str, run: dict, files, n_in, mel_cfg) -> list:
    """Each converted wav finite, as long as a ``cut=True`` conversion of
    its source gives, not silent, and its file of that length."""
    lens = []
    for out, path, n in zip(run["outputs"], files, n_in, strict=True):
        want = expected_samples(n, mel_cfg)
        got = len(audio_io.load_wav(path)[0])
        rms = float(np.sqrt(np.mean(out.wav.astype(np.float64) ** 2)))
        if not (np.all(np.isfinite(out.wav)) and len(out.wav) == got == want
                and rms > 1e-4):
            raise AssertionError(f"{what}: {path} has {len(out.wav)} / "
                                 f"{got} samples (want {want}), rms {rms}")
        lens.append(got)
    return lens


def require_launches(what: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] < 1:
            raise AssertionError(f"{what} did not launch {k}: {launches}")


def reference_files(tmp: str, dev) -> dict:
    """The reference's three checkpoint formats, written from
    ``tests/torch_mirrors.py`` at its default (full) widths, seeded
    (``tests/test_torch_checkpoints.py``): {model_type: (mirror on
    ``dev``, path)}."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    try:
        from torch_mirrors import (MirrorAutoVC, MirrorSpeakerEncoder,
                                   MirrorWaveRNN)
    finally:
        sys.path.pop(0)
    torch.manual_seed(13)
    ae, se, wr = MirrorAutoVC(), MirrorSpeakerEncoder(), MirrorWaveRNN()
    for m in (ae, wr):
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm1d):
                with torch.no_grad():
                    bn.running_mean.uniform_(-0.5, 0.5)
                    bn.running_var.uniform_(0.5, 2.0)
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("auto_encoder", "AutoVC_ref.pt"),
        ("speaker_encoder", "SpeakerEncoder_ref.pt"),
        ("vocoder", "WaveRNN_ref.pyt"))}
    torch.save({"step": 200_000, "model_state": ae.state_dict(),
                "optimizer_state": torch.optim.Adam(
                    ae.parameters()).state_dict()}, paths["auto_encoder"])
    hilde = torch.nn.functional.normalize(torch.randn(256), dim=0)
    torch.save({"step": 3_000, "model_state": se.state_dict(),
                "speakers": {"hilde": hilde}}, paths["speaker_encoder"])
    torch.save(wr.state_dict(), paths["vocoder"])
    return {k: (m.eval().to(dev), paths[k]) for k, m in (
        ("auto_encoder", ae), ("speaker_encoder", se), ("vocoder", wr))}


# f32 holds of the reference files against their mirrors on the card (TF32
# off): |port - mirror| <= REF_BAR * max |mirror| + 1e-5.  The port's f32
# products sum in another order than cuDNN's over at most a few thousand
# terms of ~1e-7 relative rounding each.
REF_BAR = 1e-4


def hold_reference_files(refs: dict, card: str, dev) -> dict:
    """``load_model(path, device="cuda")`` of each reference file, then in
    f32 the port's generator (post-net mel and content codes), speaker
    embedding and vocoder conditioning network (``wavernn.upsample``) on
    the card against the mirror module's forward on the card."""
    from autovc_tpu_torch.models import load_model
    g = torch.Generator().manual_seed(7)
    loaded = {k: load_model(k, p, verbose=False, device=dev)
              for k, (_, p) in refs.items()}
    x = torch.rand(2, 80, 192, generator=g).to(dev)
    c = torch.nn.functional.normalize(torch.randn(2, 256, generator=g),
                                      dim=1).to(dev)
    utt = torch.randn(4, 160, 40, generator=g).to(dev)
    mel = torch.rand(1, 80, 24, generator=g).to(dev)
    wr_cfg = WaveRNNConfig()
    with torch.no_grad():
        _, post, codes = AE.forward(loaded["auto_encoder"].params, x, c, c,
                                    AutoEncoderConfig(), "f32")[:3]
        _, post_ref, codes_ref = refs["auto_encoder"][0](x, c, c)
        emb = SE.forward(loaded["speaker_encoder"].params, utt, "f32")
        emb_ref = refs["speaker_encoder"][0](utt)
        up = WR.upsample(loaded["vocoder"].params["upsample"], mel, wr_cfg)
        up_ref = refs["vocoder"][0].upsample(mel)
    pairs = {"ae_post_mel": (post, post_ref), "ae_codes": (codes, codes_ref),
             "se_embedding": (emb, emb_ref),
             "vocoder_cond_mels": (up[0], up_ref[0]),
             "vocoder_cond_aux": (up[1], up_ref[1])}
    res = {"phase": "cli reference files", "precision": "f32", "card": card,
           "steps": {k: m.step for k, m in loaded.items()},
           "speakers": sorted(loaded["speaker_encoder"].speakers)}
    ok = (res["steps"] == {"auto_encoder": 200_000, "speaker_encoder": 3_000,
                           "vocoder": 0} and res["speakers"] == ["hilde"])
    for name, (got, want) in pairs.items():
        err = float((got - want).abs().max())
        bar = REF_BAR * float(want.abs().max()) + 1e-5
        res[name] = {"max_abs_err": err, "bar": bar,
                     "shape": list(got.shape)}
        ok = ok and got.shape == want.shape and err <= bar
    res["ok"] = ok
    log(res)
    if not ok:
        raise AssertionError(f"reference files disagree with their mirrors: "
                             f"{res}")
    return res


def phase_cli(card: str) -> dict:
    """Phase 9: ``python -m autovc_tpu_torch`` in-process on the card
    (``main(argv)``, default widths, fresh seeded weights), from a
    scratch working directory.  Returns the launches of the runs that
    convert (kernels 1-3) and train (kernels 6 and 7)."""
    from autovc_tpu_torch.models import load_model, save_model
    dev = torch.device("cuda")
    sr = 22050
    mel_cfg = AutoEncoderConfig().spectrogram
    launches = {k: 0 for k in CONVERT_KERNELS + TRAIN_KERNELS}

    def add(run):
        for k, n in run["launches"].items():
            launches[k] += n

    cwd, cache_env = os.getcwd(), os.environ.get("AUTOVC_MODEL_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            # checkpoints by name: the generator in a model_dir, the
            # speaker encoder in the artifact cache, the vocoder by path
            for i, (kind, where) in enumerate((
                    ("auto_encoder", "ae_models"),
                    ("speaker_encoder", "cache"), ("vocoder", "voc"))):
                save_model(load_model(kind, seed=40 + i, verbose=False,
                                      device=dev), f"{kind}.ckpt",
                           os.path.join(tmp, where))
            os.environ["AUTOVC_MODEL_CACHE"] = os.path.join(tmp, "cache")
            write_s = time.perf_counter() - t0
            srcs = [os.path.join(tmp, f"src{s:02d}.wav") for s in (4, 24)]
            for p, s in zip(srcs, (4, 24)):
                audio_io.save_wav(p, synthetic_wav(s, sr, 90 + s), sr)
            trg = os.path.join(tmp, "trg.wav")
            audio_io.save_wav(trg, synthetic_wav(3.0, sr, 99), sr)
            n_in = [len(audio_io.load_wav(p)[0]) for p in srcs]
            named = ["-mode", "convert", "-quiet",
                     "-auto_encoder", "auto_encoder.ckpt",
                     "-auto_encoder_params",
                     f"model_dir={os.path.join(tmp, 'ae_models')}",
                     "-speaker_encoder", "speaker_encoder.ckpt",
                     "-vocoder", os.path.join(tmp, "voc", "vocoder.ckpt"),
                     "-targets", trg]

            def outs(d, paths):
                return [os.path.join(tmp, d, os.path.splitext(
                    os.path.basename(p))[0] + "_to_trg.wav") for p in paths]

            # the 4 s and 24 s wavs by name: timed, then profiled
            argv = named + ["-sources", *srcs, "-save_dir",
                            os.path.join(tmp, "named")]
            timed = cli_run(argv, CONVERT_KERNELS)
            prof = cli_run(argv, CONVERT_KERNELS, profile=True)
            for run in (timed, prof):
                require_launches("the CLI convert", run["launches"],
                                 CONVERT_KERNELS)
                lens = check_outputs("the CLI convert", run,
                                     outs("named", srcs), n_in, mel_cfg)
            add(timed)
            res = {"phase": "cli convert", "seconds_in": [4.0, 24.0],
                   "checkpoint_write_s": write_s,
                   "wall_s": timed["wall_s"],
                   "profiled_wall_s": prof["wall_s"],
                   "launches": timed["launches"],
                   "profiled_launches": prof["launches"],
                   "device_busy_ms": prof["device_busy_ms"],
                   "device_idle_share": prof["device_idle_share"],
                   "device_ms_by_kernel": prof["device_ms_by_kernel"],
                   "samples_out": lens, "card": card}
            log(res)

            # trim_long_silences: 3 s, 2 s of near silence, 3 s.  The
            # pipeline resamples to the nearest VAD rate (16 kHz) and, as
            # in the JAX package, converts those samples as 22.05 kHz ones
            gap_wav = np.concatenate([
                synthetic_wav(3.0, sr, 31),
                1e-4 * np.random.default_rng(32).standard_normal(
                    2 * sr).astype(np.float32),
                synthetic_wav(3.0, sr, 33)])
            gap = os.path.join(tmp, "gap.wav")
            audio_io.save_wav(gap, gap_wav, sr)
            pre = ("normalize_volume", "trim_long_silences")
            host = Audio(gap, sr).preprocess(*pre, target_dBFS=-20)
            plain = cli_run(named + ["-sources", gap, "-save_dir",
                                     os.path.join(tmp, "plain")],
                            CONVERT_KERNELS)
            trim = cli_run(named + ["-sources", gap, "-save_dir",
                                    os.path.join(tmp, "trim"),
                                    "-convert_params", f"preprocess={pre}"],
                           CONVERT_KERNELS)
            n_gap = len(audio_io.load_wav(gap)[0])
            plain_len = check_outputs("the untrimmed convert", plain,
                                      outs("plain", [gap]), [n_gap], mel_cfg)
            trim_len = check_outputs("the trimmed convert", trim,
                                     outs("trim", [gap]), [len(host.wav)],
                                     mel_cfg)
            for run in (plain, trim):
                add(run)
            trimmed_s = len(host.wav) / host.sr
            res = {"phase": "cli trim", "seconds_in": len(gap_wav) / sr,
                   "silent_gap_s": 2.0, "trimmed_sr": host.sr,
                   "trimmed_s": trimmed_s,
                   "samples_out": {"untrimmed": plain_len[0],
                                   "trimmed": trim_len[0]},
                   "wall_s": {"untrimmed": plain["wall_s"],
                              "trimmed": trim["wall_s"]}, "card": card}
            log(res)
            # bar: the 2 s gap goes and the 6 s of signal stays, within
            # 0.25 s (the VAD's smoothing and dilation at 20 ms windows)
            if host.sr != 16000 or abs(trimmed_s - 6.0) > 0.25:
                raise AssertionError(f"trim_long_silences: {res}")

            # reference PyTorch files: held against their mirrors, then one
            # CLI convert with all three by path
            refs = reference_files(tmp, dev)
            hold_reference_files(refs, card, dev)
            ref = cli_run(["-mode", "convert", "-quiet",
                           "-auto_encoder", refs["auto_encoder"][1],
                           "-speaker_encoder", refs["speaker_encoder"][1],
                           "-vocoder", refs["vocoder"][1],
                           "-sources", srcs[0], "-targets", trg,
                           "-save_dir", os.path.join(tmp, "ref")],
                          CONVERT_KERNELS)
            require_launches("the CLI convert from reference files",
                             ref["launches"],
                             ("wavernn_sample", "lstm_stack_skewed"))
            check_outputs("the CLI convert from reference files", ref,
                          outs("ref", srcs[:1]), n_in[:1], mel_cfg)
            add(ref)
            log({"phase": "cli reference convert", "wall_s": ref["wall_s"],
                 "launches": ref["launches"], "card": card})

            # train the generator a few steps, then convert with the
            # checkpoint it saved, resolved by name in its save_dir
            data = os.path.join(tmp, "train_wavs")
            os.makedirs(data)
            for i in range(4):
                audio_io.save_wav(os.path.join(data, f"speaker{i}_{i}.wav"),
                                  synthetic_wav(22.5, sr, 120 + i), sr)
            train = cli_run(["-mode", "train", "-quiet", "-data_path", data,
                             "-model_type", "auto_encoder", "-n_epochs", "1",
                             "-batch_size", "16", "-model_name",
                             "ae_trained.ckpt", "-save_dir",
                             os.path.join(tmp, "trained")], TRAIN_KERNELS)
            require_launches("the CLI train", train["launches"],
                             TRAIN_KERNELS)
            add(train)
            after = cli_run(["-mode", "convert", "-quiet",
                             "-auto_encoder", "ae_trained.ckpt",
                             "-auto_encoder_params",
                             f"model_dir={os.path.join(tmp, 'trained')}",
                             "-sources", srcs[0], "-targets", trg,
                             "-save_dir", os.path.join(tmp, "after")],
                            CONVERT_KERNELS)
            require_launches("the CLI convert after training",
                             after["launches"],
                             ("wavernn_sample", "lstm_stack_skewed"))
            check_outputs("the CLI convert after training", after,
                          outs("after", srcs[:1]), n_in[:1], mel_cfg)
            add(after)
            log({"phase": "cli train then convert",
                 "train_wall_s": train["wall_s"],
                 "train_launches": train["launches"],
                 "convert_wall_s": after["wall_s"],
                 "convert_launches": after["launches"], "card": card})
        finally:
            os.chdir(cwd)
            if cache_env is None:
                os.environ.pop("AUTOVC_MODEL_CACHE", None)
            else:
                os.environ["AUTOVC_MODEL_CACHE"] = cache_env
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the reference-checkpoint scripts
# ---------------------------------------------------------------------------

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
# the weight the harness's failing run perturbs: every post-net mel frame
# moves by about it, ~100x the harness's atol
PERTURBED = ("decoder.linear_projection.linear_layer.bias", 1e-2)


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_reference_scripts(card: str, dev) -> dict:
    """Phase 12: the reference's three checkpoint formats, written from
    ``tests/torch_mirrors.py`` at full width (:func:`reference_files`),
    converted by ``scripts/convert_reference_checkpoints_torch.py`` to
    ``.ckpt`` files, each loaded onto the card and equal, leaf for leaf
    and in ``step``, to the ``.pt`` / ``.pyt`` file's own conversion;
    then ``scripts/eval_reference_parity_torch.py`` on the card over a
    1 s and a 3 s synthetic wav (the converted generator against the
    mirror, f32, TF32 off): ``allclose_rtol1e3`` must be true and kernel
    2 (lstm2, f32, 1 row) must launch; then the script's ``main`` (its
    command line) with a mirror file whose ``PERTURBED`` weight is moved:
    it must exit 1.  Returns the harness's launches."""
    from autovc_tpu_torch.models import load_model
    sr = 22050
    with tempfile.TemporaryDirectory() as tmp:
        refs = reference_files(tmp, dev)
        out_dir = os.path.join(tmp, "native")
        t0 = time.perf_counter()
        written = load_script("convert_reference_checkpoints_torch").main(
            [f"--{k}={p}" for k, (_, p) in refs.items()]
            + [f"--out_dir={out_dir}"])
        convert_s = time.perf_counter() - t0
        ckpts = dict(zip(refs, written))
        same = {}
        for k, (_, path) in refs.items():
            a = load_model(k, ckpts[k], verbose=False, device=dev)
            b = load_model(k, path, verbose=False, device=dev)
            la, lb = tree_leaves(a.params), tree_leaves(b.params)
            same[k] = (a.step == b.step and len(la) == len(lb) > 0
                       and all(x.dtype == y.dtype and torch.equal(x, y)
                               for x, y in zip(la, lb)))
        samples = os.path.join(tmp, "samples")
        os.makedirs(samples)
        for sec in (1.0, 3.0):
            audio_io.save_wav(os.path.join(samples, f"syn_{sec:g}s.wav"),
                              synthetic_wav(sec, sr, 300 + int(sec)), sr)
        harness = load_script("eval_reference_parity_torch")
        for spec in KERNELS.values():
            spec["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = harness.evaluate(ckpts["auto_encoder"], samples,
                                  mirror_pt=refs["auto_encoder"][1],
                                  device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        counts = {k: KERNELS[k]["kernel"].launches for k in CONVERT_KERNELS}

        bad_pt = os.path.join(tmp, "AutoVC_perturbed.pt")
        blob = torch.load(refs["auto_encoder"][1], map_location="cpu",
                          weights_only=False)
        name, delta = PERTURBED
        blob["model_state"][name] = blob["model_state"][name] + delta
        torch.save(blob, bad_pt)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            try:
                harness.main(["--auto_encoder", ckpts["auto_encoder"],
                              "--samples", samples, "--mirror_pt", bad_pt],
                             device=dev)
                exit_code = 0
            except SystemExit as e:
                exit_code = e.code
        bad_s = time.perf_counter() - t0
    try:
        bad_report = json.loads(printed.getvalue())
    except json.JSONDecodeError:
        bad_report = None
    res = {"phase": "reference scripts", "precision": "f32",
           "converted": {k: os.path.basename(p) for k, p in ckpts.items()},
           "ckpt_equals_reference_file": same, "convert_s": convert_s,
           "harness": report, "harness_s": eval_s, "launches": counts,
           "perturbed": {"weight": name, "delta": delta,
                         "exit_code": exit_code,
                         "mel_mse": (bad_report or {}).get("mel_mse"),
                         "allclose_rtol1e3": (bad_report or {}).get(
                             "allclose_rtol1e3"),
                         "wall_s": bad_s},
           "card": card}
    res["ok"] = (all(same.values()) and report["allclose_rtol1e3"]
                 and len(report["files"]) == 2
                 and report["device"].startswith("cuda")
                 and counts["lstm_stack_skewed"] >= 1
                 and exit_code == 1 and bad_report is not None
                 and bad_report["allclose_rtol1e3"] is False)
    log(res)
    if not res["ok"]:
        raise AssertionError(f"reference scripts phase failed: {res}")
    return counts


EXTRAS_KERNELS = CONVERT_KERNELS + TRAIN_KERNELS


def hist_records(logger) -> list:
    """(name, record, step) of every histogram line of a logger's JSONL."""
    with open(logger.jsonl_path) as f:
        return [(k, v, r.get("_step")) for r in map(json.loads, f)
                for k, v in r.items() if k.startswith("hist/")]


def hold_histograms(what: str, logger, expected: list) -> int:
    """The logger's histogram lines are exactly ``expected`` ((name,
    step) in order), each with a finite mean and its bins summing to its
    count.  Returns the count of values histogrammed."""
    recs = hist_records(logger)
    got = [(k, step) for k, _, step in recs]
    if got != expected:
        raise AssertionError(f"{what}: histogram lines {got[:4]}... "
                             f"({len(got)}) are not {expected[:4]}... "
                             f"({len(expected)})")
    for k, v, _ in recs:
        if not (math.isfinite(v["mean"]) and sum(v["bins"]) == v["count"]):
            raise AssertionError(f"{what}: bad histogram {k}: {v}")
    return sum(v["count"] for _, v, _ in recs)


def figure_status(logger, stem: str, modules) -> dict:
    """Whether the loop wrote its ``stem`` figures as PNGs beside the
    logger's JSONL, or why it could not (the first of ``modules`` that
    does not import).  A figure missing though every module imports
    fails."""
    out = os.path.dirname(logger.jsonl_path)
    pngs = sorted(f for f in os.listdir(out)
                  if f.startswith(stem) and f.endswith(".png"))
    if pngs:
        return {"figure": "written", "files": pngs}
    for name in modules:
        try:
            __import__(name)
        except ImportError as e:
            return {"figure": "skipped", "reason": str(e)}
    raise AssertionError(f"no {stem} figure written though {modules} "
                         f"import")


def extras_ae(tmp: str, data: str, sources, target: str, card: str) -> dict:
    """``VoiceConverter().train`` of the generator at the default config,
    bf16, 2 epochs of 2 steps of 16 x 400, every epoch a save epoch,
    with a JSONL ``MetricsLogger`` and the per-epoch conversion examples:
    kernels 1-3 (the examples: the 4 s wav at 1 chunk, the 24 s at 9)
    and 6/7 must launch; a ``params`` and a ``grads`` histogram of every
    leaf at each save epoch; each example finite, not silent and of its
    length; the figure written or reported skipped.  Measured: each save
    epoch's save stall (``block=False``) and histogram time, the wait at
    the end, then a blocking and an asynchronous save of the same payload
    in turns (wall, stall, wait, bytes).  Returns the launches."""
    mel_cfg = AutoEncoderConfig().spectrogram
    vc = VoiceConverter(verbose=False)
    logger = MetricsLogger(WandbConfig(mode="disabled"),
                           log_dir=os.path.join(tmp, "logs"))
    vc.logger = logger
    ckpt = os.path.join(tmp, "ckpt")
    with CallTimer(TRL, "save_checkpoint") as saves, \
            CallTimer(TRL, "wait_for_saves") as waits, \
            CallTimer(logger, "log_tree_histograms") as hists, \
            OutputTap() as tap:
        for name in EXTRAS_KERNELS:
            KERNELS[name]["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = vc.train(data, model_type="auto_encoder", n_epochs=2,
                        batch_size=16, log_freq=1, save_freq=1,
                        model_name="ae.ckpt", save_dir=ckpt,
                        source_examples=sources, target_examples=[target])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: KERNELS[k]["kernel"].launches for k in EXTRAS_KERNELS}
    require_launches("the generator's training with examples", counts,
                     EXTRAS_KERNELS)
    if info["step"] != 4:
        raise AssertionError(f"{info['step']} steps, not 4")
    names = leaf_names(vc.AE.params)
    values = hold_histograms("generator", logger, [
        (f"hist/{tree}/{n}", step) for step in (2, 4)
        for tree in ("params", "grads") for n in names])
    examples = []
    for path in sources:
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join("results", "training_examples",
                           f"{stem}_to_target.wav")
        wav = audio_io.load_wav(out)[0]
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        want = expected_samples(len(audio_io.load_wav(path)[0]), mel_cfg)
        if not (np.all(np.isfinite(wav)) and rms > 1e-4
                and len(wav) == want):
            raise AssertionError(f"example {out}: {len(wav)} samples "
                                 f"(want {want}), rms {rms}")
        examples.append({"file": out, "samples": len(wav), "rms": rms})
    if len(tap.outputs) != 2 * len(sources):
        raise AssertionError(f"{len(tap.outputs)} example conversions, "
                             f"not {2 * len(sources)}")

    payload = {"step": info["step"], "params": vc.AE.params,
               "ema_params": vc.AE.extras["ema_params"],
               "opt_state": info["opt_state"]}
    turns = []
    path = os.path.join(ckpt, "turn.ckpt")
    for _ in range(2):
        t0 = time.perf_counter()
        CK.save_checkpoint(path, payload, block=True)
        blocking = time.perf_counter() - t0
        t0 = time.perf_counter()
        CK.save_checkpoint(path, payload, block=False)
        stall = time.perf_counter() - t0
        t0 = time.perf_counter()
        CK.wait_for_saves()
        turns.append({"block_true_s": blocking, "block_false_stall_s": stall,
                      "then_wait_s": time.perf_counter() - t0})
    res = {"phase": "train_extras generator", "steps": info["step"],
           "epochs": 2, "batch": [16, 80, 400], "precision": "bf16",
           "wall_s": wall, "launches": counts,
           "histograms": len(hist_records(logger)),
           "values_histogrammed": values,
           "save_stall_s_by_epoch": saves.walls,
           "histogram_s_by_epoch": [sum(hists.walls[i:i + 2])
                                    for i in (0, 2)],
           "wait_for_saves_s": waits.walls,
           "example_conversions": len(tap.outputs), "examples": examples,
           "checkpoint_bytes": os.path.getsize(os.path.join(ckpt,
                                                            "ae.ckpt")),
           "save_turns": turns,
           **figure_status(logger, "mel_reconstruction", ("matplotlib",)),
           "card": card}
    log(res)
    shutil.rmtree(ckpt)            # ~0.9 GB of checkpoints
    return counts


EXAMPLE_BAR = 1.0 / 32767      # one int16 step of the written waveform


def extras_example_hold(tmp: str, data: str, source: str, target: str,
                        card: str) -> None:
    """The per-epoch example at f32 (``ae_precision`` and
    ``vocoder_precision``): the epoch-2 example of the 4 s wav equals
    ``convert`` by a fresh converter (same seed) loaded from the epoch-2
    checkpoint, within one int16 step, and differs from the epoch-1
    example."""
    kw = dict(verbose=False, ae_precision="f32", vocoder_precision="f32")
    vc = VoiceConverter(**kw)
    vc.logger = StepClock()
    ckpt = os.path.join(tmp, "ckpt_f32")
    with OutputTap() as tap:
        vc.train(data, model_type="auto_encoder", n_epochs=2, batch_size=16,
                 log_freq=1, save_freq=1, model_name="ae.ckpt",
                 save_dir=ckpt, source_examples=[source],
                 target_examples=[target])
    epoch1, epoch2 = (o.wav for o in tap.outputs)
    fresh = VoiceConverter(auto_encoder=os.path.join(ckpt, "ae.ckpt"), **kw)
    again = fresh.convert(source, target, save_name=False).wav
    shutil.rmtree(ckpt)
    err = float(np.abs(again - epoch2).max())
    moved = float(np.abs(epoch2 - epoch1).max())
    res = {"phase": "train_extras example hold", "precision": "f32",
           "samples": len(epoch2), "max_abs_err": err, "bar": EXAMPLE_BAR,
           "epoch1_vs_epoch2_max_abs": moved, "card": card}
    log(res)
    if not (len(again) == len(epoch2) and err <= EXAMPLE_BAR
            and moved > EXAMPLE_BAR):
        raise AssertionError(f"example hold failed: {res}")


def extras_se(tmp: str, card: str, dev) -> dict:
    """``train_speaker_encoder`` at the full-width config, GE2E 64 x 8 x
    160, 2 epochs of 2 steps, each a save epoch, with a JSONL logger: a
    ``params`` histogram of every leaf at each, the asynchronous
    checkpoint on disk at the end, the TSNE figure written or reported
    skipped.  Returns kernels 6/7's launches."""
    cfg = SpeakerEncoderConfig()
    params = from_jax_params(SE.init(torch.Generator().manual_seed(21), cfg),
                             dev)
    logger = MetricsLogger(WandbConfig(mode="disabled"),
                           log_dir=os.path.join(tmp, "se_logs"))
    with CallTimer(logger, "log_tree_histograms") as hists, \
            CallTimer(TRL, "save_checkpoint") as saves:
        for name in TRAIN_KERNELS:
            KERNELS[name]["kernel"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, info = TRL.train_speaker_encoder(
            params, SyntheticSpeakers(cfg.learn.batch_size, 160,
                                      cfg.input_size, 22), cfg,
            n_epochs=2, utterances_per_speaker=8, steps_per_epoch=2,
            log_freq=1, save_freq=1, model_name="se.ckpt",
            save_dir=os.path.join(tmp, "se_ckpt"), logger=logger,
            verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: KERNELS[k]["kernel"].launches for k in TRAIN_KERNELS}
    if any(c != 4 for c in counts.values()) or info["step"] != 4:
        raise AssertionError(f"SE extras: {info['step']} steps, {counts}")
    hold_histograms("speaker encoder", logger, [
        (f"hist/params/{n}", step) for step in (2, 4)
        for n in leaf_names(params)])
    blob = CK.load_checkpoint(os.path.join(tmp, "se_ckpt", "se.ckpt"))
    if blob["step"] != 4:
        raise AssertionError(f"SE checkpoint at step {blob['step']}")
    log({"phase": "train_extras speaker encoder", "steps": info["step"],
         "batch": [cfg.learn.batch_size, 8, 160], "wall_s": wall,
         "launches": counts, "save_stall_s_by_epoch": saves.walls,
         "histogram_s_by_epoch": hists.walls,
         **figure_status(logger, "embedding_tsne", ("matplotlib",
                                                    "sklearn")),
         "card": card})
    return counts


def extras_trace(tmp: str, card: str, dev) -> None:
    """One generator step (default config, bf16, 16 x 400) under
    ``profiling.trace``: a non-empty Chrome trace file."""
    cfg = AutoEncoderConfig()
    params = from_jax_params(AE.init(torch.Generator().manual_seed(5), cfg),
                             dev)
    tx = TRS.make_optimizer(cfg.optimizer, 1)
    step_fn = TRL.make_ae_step(cfg, tx, cfg.learn.ema_decay)
    opt_state, ema = tx.init(tree_leaves(params)), tree_clone(params)
    g = torch.Generator().manual_seed(6)
    x = torch.rand(16, 80, 400, generator=g).to(dev)
    c = torch.nn.functional.normalize(torch.randn(16, 256, generator=g),
                                      dim=1).to(dev)
    step_fn(params, opt_state, ema, x, c)      # warm-up
    out = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    with profiling.trace(out):
        profiling.sync(step_fn(params, opt_state, ema, x, c)[0])
    wall = time.perf_counter() - t0
    files = [os.path.join(out, f) for f in os.listdir(out)]
    sizes = [os.path.getsize(f) for f in files]
    log({"phase": "train_extras trace", "files": len(files),
         "bytes": sizes, "traced_wall_s": wall, "card": card})
    if len(files) != 1 or sizes[0] == 0:
        raise AssertionError(f"profiling.trace wrote {files} ({sizes})")


def phase_train_extras(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 10: the training extras at full width, from a scratch
    working directory (the examples land under ``results/`` there).
    Returns the launches of the generator's and the speaker encoder's
    runs."""
    sr = 22050
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            data = os.path.join(tmp, "data")
            os.mkdir(data)
            # 4 wavs of 22.5 s: 32 chunks of 400 frames, 2 steps of 16
            for i in range(4):
                audio_io.save_wav(os.path.join(data, f"speaker{i % 2}_{i}.wav"),
                                  synthetic_wav(22.5, sr, 300 + i), sr)
            sources = write_wavs(tmp, "example", (4.0, 24.0), sr)
            target = os.path.join(tmp, "target.wav")
            audio_io.save_wav(target, synthetic_wav(3.0, sr, 99), sr)
            launches = extras_ae(tmp, data, sources, target, card)
            extras_example_hold(tmp, data, sources[0], target, card)
            for name, count in extras_se(tmp, card, dev).items():
                launches[name] += count
            extras_trace(tmp, card, dev)
        finally:
            os.chdir(cwd)
    return launches


def phase_roofline(card: str, conversions, train, vocoder, se) -> list:
    """Phase 4's three conversions (their mel, generator and vocoder
    stages, the stage walls) and phases 5-7's median steps accounted
    through ``roofline`` against the card's peaks.  The vocoder stage's
    latency model is the sampling loop's own device time a step in the
    run whose stages were timed; the generator's is
    ``STREAM_STEP_FLOOR_US`` a frame.
    An entry whose time is below its throughput bound fails the run."""
    spec = RL.chip_spec()
    ae_cfg = AutoEncoderConfig()
    mel_cfg = ae_cfg.spectrogram
    N = mel_cfg.partial_utterance_n_frames
    entries = []
    for conv in conversions:
        sec, chunks, stage = conv["seconds_in"], conv["chunks"], \
            conv["stage_s"]
        frames = N + (chunks - 1) * (N // 2)
        # the vocoder at the geometry the picker gave this conversion
        pick = conv["vocoder_pick"]
        rows, steps = pick["rows"], pick["steps"]
        wr_cfg = WaveRNNConfig().with_overrides(
            generate={"target": pick["target"]})
        fl, by = RL.melspec_cost(frames, mel_cfg.n_fft, mel_cfg.n_mels,
                                 mel_cfg.window_length)
        entries.append(RL.account(f"mel {sec:g}s", fl, by, stage["mel"],
                                  spec))
        fl, by = RL.ae_forward_cost(ae_cfg, chunks, N)
        entries.append(RL.account(
            f"generator {sec:g}s ({chunks} rows)", fl, by,
            stage["autoencoder"], spec, compute_dtype="bf16",
            sequential_steps=N, step_floor_us=RL.STREAM_STEP_FLOOR_US))
        fl_c, by_c = RL.wavernn_conditioning_cost(
            wr_cfg, 1, (frames - 1) * wr_cfg.hop_length)
        fl_s, by_s = RL.wavernn_step_cost(wr_cfg, rows)
        fl_p, by_p = RL.wavernn_prologue_cost(wr_cfg, rows, steps)
        loop_ms, = conv["sampling_loop_ms"]
        floor_us = loop_ms * 1e3 / steps
        entries.append(RL.account(
            f"vocoder {sec:g}s ({rows} rows)", fl_c + fl_s * steps + fl_p,
            by_c + by_s * steps + by_p, stage["vocoder"], spec,
            compute_dtype="bf16", sequential_steps=steps,
            step_floor_us=floor_us))
    for name, (fl, by), res in (
            ("ae_train_step 16x400", RL.ae_train_cost(ae_cfg, 16, N), train),
            ("vocoder_train_step 8x2475",
             RL.vocoder_train_cost(WaveRNNConfig(), 8,
                                   9 * WaveRNNConfig().hop_length),
             vocoder),
            ("se_train_step 64x8x160", RL.se_train_cost(
                SpeakerEncoderConfig(), 64, 8, 160), se)):
        entries.append(RL.account(name, fl, by, res["median_step_s"], spec,
                                  compute_dtype="bf16"))
    log({"phase": "roofline", "spec": dataclasses.asdict(spec),
         "stream_step_floor_us": RL.STREAM_STEP_FLOOR_US,
         "entries": entries, "card": card})
    log({"phase": "roofline table",
         "lines": RL.format_table(entries).splitlines()})
    bad = [e["component"] for e in entries if not e["measurement_valid"]]
    if bad:
        raise AssertionError(f"roofline entries faster than their bound "
                             f"(a wrong count or clock): {bad}")
    return entries


# ---------------------------------------------------------------------------
# Phase 11: multi-device on one card
# ---------------------------------------------------------------------------

MULTI_BAR = 1e-4           # the chunk and ring paths' f32 mel holds
POSITIONS = [torch.device("cuda", 0)] * 2


class MelTap:
    """Keeps the mel every ``wavernn._generate_program`` call receives
    while it is entered: the post-mel a conversion hands its vocoder."""

    def __enter__(self):
        self.mels = []
        self._fn = fn = WR._generate_program

        def tap(params, mel, *args):
            self.mels.append(mel[0].detach().float().cpu())
            return fn(params, mel, *args)

        WR._generate_program = tap
        return self

    def __exit__(self, *exc):
        WR._generate_program = self._fn


def counted(kernels, fn):
    """``fn()`` with the launches of ``kernels`` set to 0 just before and
    read just after: (result, launches)."""
    for name in kernels:
        KERNELS[name]["kernel"].launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: KERNELS[k]["kernel"].launches for k in kernels}


def walls(fns: dict, reps: int = 3) -> dict:
    """Median wall (host clock to a device synchronise) of each function,
    the functions taken in turns ``reps`` times."""
    got = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            got[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in got.items()}


def multi_chunks(vc32, vc, target, card: str) -> dict:
    """``convert(parallel="chunks")`` of the 24 s wav over two positions on
    the card (9 chunks padded to 10, 5 rows a position: kernel 2): in f32
    its post-mel against the default path's, then bf16 walls beside the
    default path's; kernels 1 and 2 must launch."""
    sr = 22050
    wav = synthetic_wav(24.0, sr, 24)
    mesh = PSHD.make_mesh(devices=POSITIONS)

    def convert(conv, **kw):
        return conv.convert(Audio(wav.copy(), sr_org=sr),
                            Audio(target.copy(), sr_org=sr),
                            save_name=False, **kw)

    with MelTap() as tap:
        base = convert(vc32)
        par, counts = counted(CONVERT_KERNELS, lambda: convert(
            vc32, parallel="chunks", mesh=mesh))
    diff = (tap.mels[1] - tap.mels[0]).abs()
    err = float(diff.max())
    convert(vc)
    convert(vc, parallel="chunks", mesh=mesh)
    med = walls({"default": lambda: convert(vc),
                 "chunks": lambda: convert(vc, parallel="chunks", mesh=mesh)})
    _, bf16_counts = counted(CONVERT_KERNELS, lambda: convert(
        vc, parallel="chunks", mesh=mesh))
    res = {"phase": "multi_device chunks", "positions": [str(d) for d in
                                                         POSITIONS],
           "seconds_in": 24.0, "chunks": 9, "rows_a_position": 5,
           "f32_mel_max_abs_err": err,
           "f32_mel_mean_abs_err": float(diff.mean()),
           "f32_mel_max_abs": float(tap.mels[0].abs().max()),
           "tolerance": f"<= {MULTI_BAR}",
           "f32_samples": [len(base.wav), len(par.wav)],
           "f32_launches": counts, "bf16_launches": bf16_counts,
           "bf16_median_wall_s": med,
           "bf16_audio_s_per_s": {k: len(par.wav) / sr / v
                                  for k, v in med.items()},
           "card": card}
    log(res)
    if not err <= MULTI_BAR or len(par.wav) != len(base.wav):
        raise AssertionError(f"chunk-parallel convert disagrees: {res}")
    if not np.all(np.isfinite(par.wav)):
        raise AssertionError("chunk-parallel convert: non-finite output")
    require_launches("convert(parallel='chunks')", counts,
                     ("wavernn_sample", "lstm_stack_skewed"))
    return counts


def multi_ring(vc32, target, card: str) -> dict:
    """``convert(parallel="ring")`` of the 10 s wav over two positions, f32
    (no preprocessing, so the trimmed mel is the wav's): its post-mel
    against ``autoencoder.infer`` of the same trimmed mel, the wav finite
    and (frames - 1) * hop long."""
    sr = 22050
    wav = synthetic_wav(10.0, sr, 10)
    mesh = PSHD.make_mesh(devices=POSITIONS)
    with MelTap() as tap:
        t0 = time.perf_counter()
        (out, counts) = counted(CONVERT_KERNELS, lambda: vc32.convert(
            Audio(wav.copy(), sr_org=sr), Audio(target.copy(), sr_org=sr),
            save_name=False, preprocess=(), outprocess=(), parallel="ring",
            mesh=mesh))
        wall = time.perf_counter() - t0
    cfg = vc32.AE.config
    mel = dsp.mel_spec_auto_encoder(wav, cfg.spectrogram)
    Tn = mel.shape[-1] // 2 * 2
    dev = torch.device("cuda")
    c_src = torch.from_numpy(vc32._embed(Audio(wav.copy(), sr_org=sr))[None])
    c_trg = torch.from_numpy(vc32._embed(Audio(target.copy(),
                                               sr_org=sr))[None])
    with torch.inference_mode():
        one = AE.infer(vc32.AE.params, torch.from_numpy(np.ascontiguousarray(
            mel[None, :, :Tn], np.float32)).to(dev), c_src.to(dev),
            c_trg.to(dev), cfg, "f32", vc32._lstm2_packed)[0].cpu()
    diff = (tap.mels[0] - one).abs()
    err = float(diff.max())
    expected = (Tn - 1) * vc32.vocoder.config.hop_length
    res = {"phase": "multi_device ring", "seconds_in": 10.0,
           "frames": Tn, "frames_a_position": Tn // 2,
           "f32_mel_max_abs_err": err,
           "f32_mel_mean_abs_err": float(diff.mean()),
           "f32_mel_max_abs": float(one.abs().max()),
           "tolerance": f"<= {MULTI_BAR}",
           "samples_out": len(out.wav), "samples_expected": expected,
           "f32_wall_s": wall, "launches": counts, "card": card}
    log(res)
    if not (err <= MULTI_BAR and len(out.wav) == expected
            and np.all(np.isfinite(out.wav))):
        raise AssertionError(f"ring convert disagrees: {res}")
    return counts


def stream_overlap(prof, tags) -> dict:
    """From a profiled run, the device ms in which kernels of two streams
    ran at once: two persistent kernels (names holding one of ``tags``),
    a persistent kernel beside another kernel, and two other kernels."""
    ks = sorted((e.time_range.start, e.time_range.end, e.device_resource_id,
                 any(t in e.name for t in tags)) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    us = [0.0, 0.0, 0.0]           # by the number of persistent kernels
    for i, (a0, a1, sa, ta) in enumerate(ks):
        for b0, b1, sb, tb in ks[i + 1:]:
            if b0 >= a1:
                break
            if sa != sb:
                us[int(ta) + int(tb)] += min(a1, b1) - b0
    return {"streams": len({k[2] for k in ks}),
            "persistent_pair_overlap_ms": us[2] / 1e3,
            "persistent_with_other_overlap_ms": us[1] / 1e3,
            "other_overlap_ms": us[0] / 1e3}


def multi_pipeline(vc, target, tmp: str, card: str) -> dict:
    """``convert_batch(parallel="pipeline", devices=[cuda:0, cuda:0])`` on
    serve-8: bf16 walls (median of 3) beside the default
    ``convert_batch``; one serve under ``torch.profiler`` (kernels 1-3
    must launch; the stages share the card's lane, so the streams'
    overlap should be nil); in f32 with
    row-invariant pinned noise each utterance against ``convert(seed=
    seed + i)`` of its wav (phase 8's bar)."""
    sr = 22050
    paths = write_wavs(tmp, "pipe", SERVES["serve-8"], sr)

    def serve(conv, **kw):
        return conv.convert_batch(paths, Audio(target.copy(), sr_org=sr),
                                  **kw)

    def pipe(conv, **kw):
        return serve(conv, parallel="pipeline", devices=POSITIONS, **kw)

    outs = pipe(vc)
    serve(vc)
    med = walls({"default": lambda: serve(vc), "pipeline": lambda: pipe(vc)})
    audio_s = sum(len(o.wav) for o in outs) / sr
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, counts = counted(CONVERT_KERNELS, lambda: pipe(vc))
    by_tag = kernel_launch_ms(prof, tuple(SERVE_TAGS.values()))
    prof_launches = {k: len(by_tag.get(tag, []))
                     for k, tag in SERVE_TAGS.items()}
    overlap = stream_overlap(prof, tuple(SERVE_TAGS.values()))

    vc32 = VoiceConverter(verbose=False, ae_precision="f32",
                          vocoder_precision="f32")
    draw = WK.draw_noise

    def pinned(steps, rows, pick_dim, generator, device):
        g = torch.Generator().manual_seed(11)
        gumbel, logistic = draw(steps, 1, pick_dim, g, "cpu")
        lane = torch.randint(0, pick_dim, (steps, 1, 1), generator=g)
        gumbel = gumbel.scatter(-1, lane, 1e3)
        return (gumbel.expand(steps, rows, pick_dim).contiguous().to(device),
                logistic.expand(steps, rows).contiguous().to(device))

    WK.draw_noise = pinned
    try:
        held = pipe(vc32, outprocess=(), seed=5)
        singles = [vc32.convert(p, Audio(target.copy(), sr_org=sr),
                                outprocess=(), save_name=False, seed=5 + i)
                   for i, p in enumerate(paths)]
    finally:
        WK.draw_noise = draw
    errs = [float(np.max(np.abs(a.wav - b.wav))) if a.wav.shape ==
            b.wav.shape else float("inf") for a, b in zip(held, singles)]
    lens = [len(audio_io.load_wav(p)[0]) for p in paths]
    res = {"phase": "multi_device pipeline", "workload": "serve-8",
           "positions": [str(d) for d in POSITIONS], "audio_s": audio_s,
           "bf16_median_wall_s": med,
           "bf16_audio_s_per_s": {k: audio_s / v for k, v in med.items()},
           "launches": counts, "profiler_launches": prof_launches,
           "stream_overlap": overlap,
           "f32_max_abs_err": errs, "tolerance": "max |err| < 1e-3",
           "card": card}
    log(res)
    if max(errs) >= 1e-3:
        raise AssertionError(f"pipelined convert_batch disagrees: {res}")
    for o, n in zip(outs, lens):
        if not (np.all(np.isfinite(o.wav))
                and len(o.wav) == expected_samples(n, vc.AE.config.
                                                   spectrogram)):
            raise AssertionError(f"pipeline output wrong: {res}")
    require_launches("convert_batch(parallel='pipeline')", counts,
                     CONVERT_KERNELS)
    require_launches("convert_batch(parallel='pipeline') profiled",
                     prof_launches, CONVERT_KERNELS)
    return counts


# The data-parallel ranks' global batches: the generator 16 x 400 frames,
# the vocoder 8 x 2475 samples (9 frames), the speaker encoder phase 7's
# f32 block of 4 x 3 x 160; then bf16 generator steps of 16 x 400.
DP_STEPS = 6


def dp_inputs():
    """Every rank's (and the reference's) parameters and global batches,
    made from seeds."""
    ae_cfg, wr_cfg, se_cfg = (AutoEncoderConfig(), WaveRNNConfig(),
                              SpeakerEncoderConfig())
    rng = np.random.default_rng(31)
    x = rng.random((16, 80, 400), dtype=np.float32)
    c = rng.standard_normal((16, 256)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    frames = 9
    T = frames * wr_cfg.hop_length
    x_in = np.clip(0.3 * rng.standard_normal((8, T)), -1, 1).astype(
        np.float32)
    mels = rng.random((8, 80, frames + 2 * wr_cfg.pad), dtype=np.float32)
    block = next(SyntheticSpeakers(4, se_cfg.spectrogram.
                                   partial_utterance_n_frames,
                                   se_cfg.input_size, 23).batches(3, 1))
    return {
        "ae": (AE.init(torch.Generator().manual_seed(32), ae_cfg), ae_cfg,
               (x, c)),
        "vocoder": (WR.init(torch.Generator().manual_seed(33), wr_cfg),
                    wr_cfg, (x_in, np.roll(x_in, -1, 1), mels)),
        "se": (SE.init(torch.Generator().manual_seed(34), se_cfg), se_cfg,
               (block,)),
    }


class ArrayBatches:
    """A generator dataset of ``DP_STEPS`` seeded batches of 16 x 400."""

    def epoch_steps(self, batch_size):
        return DP_STEPS

    def batches(self, batch_size, shuffle=True, seed=0):
        rng = np.random.default_rng(seed)
        for _ in range(DP_STEPS):
            c = rng.standard_normal((batch_size, 256)).astype(np.float32)
            yield (rng.random((batch_size, 80, 400), dtype=np.float32),
                   c / np.linalg.norm(c, axis=1, keepdims=True))


def dp_rank(out_dir: str) -> int:
    """One rank of phase 11's data-parallel runs (``chip_smoke.py
    --dp-rank <dir>`` under the port's launcher): one f32 step of the
    generator, the vocoder and the speaker encoder on its rows
    (``make_sharded_*_step``), then ``train_autoencoder(mesh=)`` for
    ``DP_STEPS`` bf16 steps; rank 0 writes the f32 losses and gradients,
    every rank its kernels' launches."""
    from autovc_tpu_torch.parallel import steps as PSTEPS
    PREC.exact_f32()
    PSTEPS.initialize_distributed()
    mesh = PSHD.make_mesh()
    rank = mesh.rank
    inputs = dp_inputs()
    lr = 1e-4
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    for name in KERNELS:
        KERNELS[name]["kernel"].launches = 0
    for what, (params, cfg, arrays) in inputs.items():
        params = PSHD.shard_params(params, mesh)[0]
        tx = TRS.Optimizer(lambda count: lr, 0.9, 0.999, 1e-8, 1.0)
        state = tx.init(tree_leaves(params))
        mine = [PSTEPS.shard_batch(a, mesh) for a in arrays]
        if what == "ae":
            step = PSTEPS.make_sharded_ae_step(cfg, tx, 0.999, mesh,
                                               precision="f32",
                                               with_grads=True)
            *_, aux = step(params, state, tree_clone(params), *mine)
        elif what == "vocoder":
            step = PSTEPS.make_sharded_vocoder_step(cfg, tx, mesh,
                                                    precision="f32",
                                                    with_grads=True)
            *_, aux = step(params, state, *mine)
        else:
            step = PSTEPS.make_sharded_se_step(cfg, tx, mesh,
                                               precision="f32",
                                               with_grads=True)
            *_, aux = step(params, state, *mine)
        out[what] = {"loss": float(aux["loss"]),
                     "grad_norm": float(aux["grad_norm"])}
        if rank == 0:
            out[what]["grads"] = [g.cpu() for g in tree_leaves(aux["grads"])]
    torch.cuda.synchronize()
    out["f32_launches"] = {k: KERNELS[k]["kernel"].launches for k in KERNELS}
    clock = StepClock()
    params, cfg, _ = inputs["ae"]      # the steps above updated copies
    for name in KERNELS:
        KERNELS[name]["kernel"].launches = 0
    TRL.train_autoencoder(params, ArrayBatches(), cfg, n_epochs=1,
                          batch_size=16, log_freq=1, model_name="",
                          logger=clock, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    out["bf16_launches"] = {k: KERNELS[k]["kernel"].launches
                            for k in KERNELS}
    out["losses"] = [m["loss"] for _, m in clock.records]
    times = [t for t, _ in clock.records]
    out["step_s"] = [b - a for a, b in zip(times, times[1:])]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def single_process_holds(inputs: dict, outs: list) -> tuple:
    """Each f32 step of the ranks' results ``outs`` (rank 0's gradients,
    whole) held against the single-process step on the global batch on
    the card: loss and ``grad_norm`` rel 1e-4, gradients rtol 2e-3 / atol
    1e-3 (the JAX bars of tests/test_parallel.py), beside the largest
    reference gradient.  Returns (holds, failures)."""
    dev = torch.device("cuda")
    holds, failed = {}, []
    for what, (params, cfg, arrays) in inputs.items():
        params = from_jax_params(params, dev)
        if what == "ae":
            aux, grads = TRL.loss_and_grads(params, *arrays, cfg, "f32")
            loss = aux["loss"]
        elif what == "vocoder":
            loss, grads = TRL.vocoder_loss_and_grads(params, *arrays, cfg,
                                                     "f32")
        else:
            loss, grads = TRL.se_loss_and_grads(params, *arrays, "f32")
            scaled = {id(params["similarity_weight"]),
                      id(params["similarity_bias"])}
            grads = [g * 0.01 if id(p) in scaled else g
                     for p, g in zip(tree_leaves(params), grads)]
        loss = float(loss)
        loss_rel = max(abs(o[what]["loss"] - loss) / abs(loss) for o in outs)
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        norm_rel = max(abs(o[what]["grad_norm"] - norm) / norm for o in outs)
        worst, worst_leaf = 0.0, None
        for name, a, b in zip(leaf_names(params), outs[0][what]["grads"],
                              grads):
            b = b.cpu()
            excess = float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
            if excess > worst or worst_leaf is None:
                worst, worst_leaf = excess, name
        holds[what] = {"loss_single": loss, "loss_rel_err": loss_rel,
                       "grad_norm_single": norm,
                       "grad_norm_rel_err": norm_rel,
                       "ref_grad_max_abs": max(float(g.abs().max())
                                               for g in grads),
                       "grads_worst_leaf": worst_leaf,
                       "grads_worst_excess_over_bar": worst}
        if loss_rel > 1e-4:
            failed.append(f"{what}: loss rel err {loss_rel:.3g}")
        if norm_rel > 1e-4:
            failed.append(f"{what}: grad_norm rel err {norm_rel:.3g}")
        if worst > 0:
            failed.append(f"{what}: {worst_leaf} over rtol 2e-3 / atol 1e-3 "
                          f"by {worst:.3g}")
    return holds, failed


def multi_dp(card: str, phase5_step_s: float) -> dict:
    """Phase 11's data-parallel runs: two ranks on the card (``gloo``, the
    port's launcher), each f32 step held against the single-process step
    on the global batch on the card (loss and ``grad_norm`` rel 1e-4,
    gradients rtol 2e-3 / atol 1e-3, the JAX bars of
    tests/test_parallel.py, printed beside the largest reference
    gradient, which shows the bar could see a dropped all-reduce or a
    missing 1/N), the bf16 steps'
    losses falling and their median s/step beside phase 5's; then one
    rank on ``nccl`` (the multihost smoke).  Returns the ranks' launches,
    summed."""
    from autovc_tpu_torch.utils import launcher
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = launcher.launch_local_multiprocess(
            os.path.abspath(__file__), 2, args=["--dp-rank", tmp],
            timeout=420)
        dp_wall = time.perf_counter() - t0
        for r, (rc, text) in enumerate(ranks):
            if rc != 0:
                raise AssertionError(f"rank {r} exited {rc}:\n{text[-4000:]}")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    launches = {k: 0 for k in KERNELS}
    for o in outs:
        log({"phase": "multi_device dp rank", "rank": o["rank"],
             "backend": o["backend"], "f32_launches": o["f32_launches"],
             "bf16_launches": o["bf16_launches"], "card": card})
        for k in KERNELS:
            launches[k] += o["f32_launches"][k] + o["bf16_launches"][k]
        require_launches(f"rank {o['rank']}", o["f32_launches"],
                         TRAIN_KERNELS + VOCODER_KERNELS)
        require_launches(f"rank {o['rank']} bf16", o["bf16_launches"],
                         TRAIN_KERNELS)

    holds, failed = single_process_holds(dp_inputs(), outs)
    main = outs[0]
    losses = main["losses"]
    falling = (len(losses) == DP_STEPS and all(map(math.isfinite, losses))
               and (losses[-1] + losses[-2]) / 2 < losses[0])
    if not falling:
        failed.append(f"bf16 losses did not fall: {losses}")
    t0 = time.perf_counter()
    nccl = launcher.launch_local_multiprocess(
        "autovc_tpu_torch.parallel.multihost_smoke", 1, module=True,
        timeout=240)
    nccl_wall = time.perf_counter() - t0
    (rc, text), = nccl
    nccl_ok = rc == 0 and "MULTIHOST_OK" in text and "backend=nccl" in text
    if not nccl_ok:
        failed.append(f"1-rank nccl run: exit {rc}:\n{text[-3000:]}")
    res = {"phase": "multi_device dp", "ranks": 2, "backend":
           outs[0]["backend"], "global_batches": {
               "ae": [16, 80, 400], "vocoder": [8, 9 * 275],
               "se": [4, 3, 160]},
           "f32_holds": holds,
           "tolerance": "loss and grad_norm rel 1e-4; gradients rtol 2e-3 "
                        "/ atol 1e-3",
           "bf16_losses": losses,
           "bf16_median_step_s": statistics.median(main["step_s"]),
           "phase5_median_step_s": phase5_step_s,
           "ranks_wall_s": dp_wall,
           "nccl_1_rank": [ln for ln in text.splitlines()
                           if "MULTIHOST_OK" in ln],
           "nccl_wall_s": nccl_wall, "card": card, "failed": failed}
    log(res)
    if failed:
        raise AssertionError(f"data-parallel runs failed: {res}")
    return launches


# The tensor-parallel ranks' batches, full widths on short sequences (the
# per-step gate gathers go through the host): the generator 4 x 80 x 64
# frames, the vocoder 4 rows of 2 frames (550 samples), the speaker
# encoder 4 x 3 x 160; then TP_STEPS timed bf16 steps of each and a
# 2-step bf16 train_autoencoder(mesh=) that saves.
TP_FRAMES, TP_VOCODER_FRAMES, TP_STEPS = 64, 2, 3


def tp_inputs():
    """Every tensor-parallel rank's (and the reference's) full parameters
    and global batches, made from seeds."""
    ae_cfg, wr_cfg, se_cfg = (AutoEncoderConfig(), WaveRNNConfig(),
                              SpeakerEncoderConfig())
    rng = np.random.default_rng(41)
    x = rng.random((4, 80, TP_FRAMES), dtype=np.float32)
    c = rng.standard_normal((4, 256)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    T = TP_VOCODER_FRAMES * wr_cfg.hop_length
    x_in = np.clip(0.3 * rng.standard_normal((4, T)), -1, 1).astype(
        np.float32)
    mels = rng.random((4, 80, TP_VOCODER_FRAMES + 2 * wr_cfg.pad),
                      dtype=np.float32)
    block = next(SyntheticSpeakers(4, se_cfg.spectrogram.
                                   partial_utterance_n_frames,
                                   se_cfg.input_size, 43).batches(3, 1))
    return {
        "ae": (AE.init(torch.Generator().manual_seed(42), ae_cfg), ae_cfg,
               (x, c)),
        "vocoder": (WR.init(torch.Generator().manual_seed(43), wr_cfg),
                    wr_cfg, (x_in, np.roll(x_in, -1, 1), mels)),
        "se": (SE.init(torch.Generator().manual_seed(44), se_cfg), se_cfg,
               (block,)),
    }


class TPBatches:
    """A generator dataset of 2 seeded batches of 4 x 80 x TP_FRAMES."""

    def epoch_steps(self, batch_size):
        return 2

    def batches(self, batch_size, shuffle=True, seed=0):
        rng = np.random.default_rng(seed)
        for _ in range(2):
            c = rng.standard_normal((batch_size, 256)).astype(np.float32)
            yield (rng.random((batch_size, 80, TP_FRAMES), dtype=np.float32),
                   c / np.linalg.norm(c, axis=1, keepdims=True))


def tp_rank(out_dir: str) -> int:
    """One rank of phase 11's tensor-parallel runs (``chip_smoke.py
    --tp-rank <dir>`` under the port's launcher), on a (1, 2) ("data",
    "model") mesh: one f32 step of the generator, the vocoder and the
    speaker encoder from this rank's shards (``make_sharded_*_step``,
    ``with_grads``: the gradients gathered whole), then ``TP_STEPS``
    timed bf16 steps of each with the model group's gathers and reduces a
    step; then a 2-step bf16 ``train_autoencoder(mesh=)`` that saves, rank
    0 reading its checkpoint back.  Rank 0 writes the f32 losses and
    gradients, every rank its kernels' launches."""
    from autovc_tpu_torch.parallel import steps as PSTEPS
    from autovc_tpu_torch.parallel import tensor as PTP
    PREC.exact_f32()
    PSTEPS.initialize_distributed()
    mesh = PSHD.make_mesh((1, 2), ("data", "model"))
    rank = mesh.rank
    lr = 1e-4
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "bf16": {}}
    for name in KERNELS:
        KERNELS[name]["kernel"].launches = 0
    makers = {"ae": lambda cfg, tx, prec, grads: PSTEPS.make_sharded_ae_step(
                  cfg, tx, 0.999, mesh, precision=prec, with_grads=grads),
              "vocoder": lambda cfg, tx, prec, grads:
                  PSTEPS.make_sharded_vocoder_step(cfg, tx, mesh,
                                                   precision=prec,
                                                   with_grads=grads),
              "se": lambda cfg, tx, prec, grads:
                  PSTEPS.make_sharded_se_step(cfg, tx, mesh, precision=prec,
                                              with_grads=grads)}
    for what, (params, cfg, arrays) in tp_inputs().items():
        mine = [PSTEPS.shard_batch(a, mesh) for a in arrays]
        for prec in ("f32", "bf16"):
            local = PSHD.shard_params(tree_clone(params), mesh)[0]
            tx = TRS.Optimizer(lambda count: lr, 0.9, 0.999, 1e-8, 1.0)
            state = tx.init(tree_leaves(local))
            step = makers[what](cfg, tx, prec, prec == "f32")
            state_args = ((local, state, tree_clone(local)) if what == "ae"
                          else (local, state))
            times, losses, counts = [], [], []
            for _ in range(1 if prec == "f32" else TP_STEPS):
                before = dict(PTP.COUNTS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aux = step(*state_args, *mine)[-1]
                losses.append(float(aux["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts.append({k: PTP.COUNTS[k] - before[k]
                               for k in before})
            if prec == "f32":
                out[what] = {"loss": losses[0],
                             "grad_norm": float(aux["grad_norm"])}
                if rank == 0:
                    out[what]["grads"] = [g.cpu() for g in
                                          tree_leaves(aux["grads"])]
            else:
                out["bf16"][what] = {"step_s": times, "losses": losses,
                                     "collectives_per_step": counts[-1]}
    torch.cuda.synchronize()
    out["launches"] = {k: KERNELS[k]["kernel"].launches for k in KERNELS}
    params, cfg, _ = tp_inputs()["ae"]
    ckpt = os.path.join(out_dir, "ckpt")
    full, _, info = TRL.train_autoencoder(
        params, TPBatches(), cfg, n_epochs=1, batch_size=4, log_freq=1,
        model_name="tp", save_dir=ckpt, verbose=False, mesh=mesh)
    out["loop"] = {"step": info["step"],
                   "shapes": [list(t.shape) for t in tree_leaves(full)]}
    if rank == 0:
        path, = [os.path.join(ckpt, f) for f in os.listdir(ckpt)]
        blob = CK.load_checkpoint(path)
        saved = tree_leaves(from_jax_params(blob["params"], "cpu"))
        out["loop"]["read_back"] = {
            "step": int(blob["step"]),
            "equal": len(saved) == len(tree_leaves(full)) and all(
                torch.equal(a, b.cpu())
                for a, b in zip(saved, tree_leaves(full)))}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def multi_tp(card: str, step_s: dict) -> dict:
    """Phase 11's tensor-parallel runs: two ranks on the card (``gloo``,
    the port's launcher) as a (1, 2) ("data", "model") mesh, each f32
    step held against the single-process step on the card
    (:func:`single_process_holds`); the bf16 median s/step of each model
    beside phases 5-7's (at their own geometries), with the model group's
    gathers and reduces a step; the TP recurrences launch none of
    kernels 4-7 (the JAX sharded steps run scans, not their Pallas
    kernels); the 2-step loop's checkpoint read back whole.  Returns the
    ranks' launches, summed."""
    from autovc_tpu_torch.utils import launcher
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = launcher.launch_local_multiprocess(
            os.path.abspath(__file__), 2, args=["--tp-rank", tmp],
            timeout=420)
        tp_wall = time.perf_counter() - t0
        for r, (rc, text) in enumerate(ranks):
            if rc != 0:
                raise AssertionError(f"rank {r} exited {rc}:\n{text[-4000:]}")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    holds, failed = single_process_holds(tp_inputs(), outs)
    launches = {k: 0 for k in KERNELS}
    for o in outs:
        for k in KERNELS:
            launches[k] += o["launches"][k]
        used = [k for k in TRAIN_KERNELS + VOCODER_KERNELS
                if o["launches"][k]]
        if used:
            failed.append(f"rank {o['rank']}: the TP steps launched {used}")
        if o["loop"]["step"] != 2:
            failed.append(f"rank {o['rank']}: the loop ran "
                          f"{o['loop']['step']} steps")
    main = outs[0]
    full = [list(t.shape) for t in tree_leaves(tp_inputs()["ae"][0])]
    back = main["loop"]["read_back"]
    if not (back["equal"] and back["step"] == 2
            and all(o["loop"]["shapes"] == full for o in outs)):
        failed.append(f"the TP loop's checkpoint is not its full tree: "
                      f"{back}")
    bf16 = {what: {"median_step_s": statistics.median(r["step_s"]),
                   "phase_median_step_s": step_s[what],
                   "losses": r["losses"],
                   "collectives_per_step": r["collectives_per_step"]}
            for what, r in main["bf16"].items()}
    res = {"phase": "multi_device tp", "ranks": 2, "mesh": [1, 2],
           "backend": main["backend"], "global_batches": {
               "ae": [4, 80, TP_FRAMES],
               "vocoder": [4, TP_VOCODER_FRAMES * 275],
               "se": [4, 3, 160]},
           "f32_holds": holds,
           "tolerance": "loss and grad_norm rel 1e-4; gradients rtol 2e-3 "
                        "/ atol 1e-3",
           "bf16": bf16, "loop_read_back": back, "launches": launches,
           "ranks_wall_s": tp_wall, "card": card, "failed": failed}
    log(res)
    if failed:
        raise AssertionError(f"tensor-parallel runs failed: {res}")
    return launches


def phase_multi_device(card: str, step_s: dict) -> dict:
    """Phase 11 (see the module docstring); ``step_s``: phases 5-7's
    median s/step by model; returns its launches."""
    t0 = time.perf_counter()
    sr = 22050
    target = synthetic_wav(3.0, sr, 99)
    vc = VoiceConverter(verbose=False)
    vc32 = VoiceConverter(verbose=False, ae_precision="f32",
                          vocoder_precision="f32")
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for counts in (multi_chunks(vc32, vc, target, card),
                       multi_ring(vc32, target, card),
                       multi_pipeline(vc, target, tmp, card),
                       multi_dp(card, step_s["ae"]),
                       multi_tp(card, step_s)):
            for k, n in counts.items():
                launches[k] += n
    log({"phase": "multi_device", "seconds": time.perf_counter() - t0,
         "launches": launches, "card": card})
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the native host mel core
# ---------------------------------------------------------------------------


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native_mel(card: str) -> dict:
    """The native host mels (``autovc_tpu_torch.native``, built here with
    g++) of the 24 s synthetic wav, the AE's at 22.05 kHz and the SE's at
    16 kHz, against the port's numpy mels (rtol 1e-3 / atol 1e-4 and
    rtol 2e-3 / atol 1e-5 of the largest value, tests/test_native.py's
    bars), with their host ms at 1 thread and at all threads beside
    numpy's (median of 3)."""
    from autovc_tpu_torch import native
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    res = {"phase": "native mel", "seconds_in": 24.0, "build_s": build_s,
           "cpu_threads": os.cpu_count(), "card": card}
    failed = []
    for name, sr, rtol, fn, nat in (
            ("ae", 22050, 1e-3, dsp.mel_spec_auto_encoder,
             native.mel_spec_auto_encoder),
            ("se", 16000, 2e-3, dsp.mel_spec_speaker_encoder,
             native.mel_spec_speaker_encoder)):
        wav = synthetic_wav(24.0, sr, 24)
        dsp.USE_NATIVE = False
        try:
            ref = fn(wav)
            numpy_ms = host_ms(lambda: fn(wav))
        finally:
            dsp.USE_NATIVE = True
        out = nat(wav)
        atol = 1e-4 if name == "ae" else 1e-5 * float(np.abs(ref).max())
        excess = float((np.abs(out - ref) - (atol + rtol * np.abs(ref))
                        ).max())
        res[name] = {"shape": list(out.shape),
                     "max_abs_err": float(np.abs(out - ref).max()),
                     "tolerance": f"rtol {rtol:g} / atol {atol:.3g}",
                     "ok": out.shape == ref.shape and excess <= 0,
                     "numpy_ms": numpy_ms,
                     "native_1_thread_ms": host_ms(lambda: nat(
                         wav, n_threads=1)),
                     "native_all_threads_ms": host_ms(lambda: nat(wav))}
        if not res[name]["ok"]:
            failed.append(name)
    log(res)
    if failed:
        raise AssertionError(f"native mels disagree with numpy: {res}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(sys.argv[2])
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank(sys.argv[2])
    dev = torch.device("cuda")
    PREC.exact_f32()
    t_start = time.time()
    card = phase_environment()
    with phase_clock("build"):
        phase_build()
    gen = torch.Generator().manual_seed(0)
    with phase_clock("3 kernels 2/3"):
        k2, k3 = compare_inference_kernels(gen, dev, card)
    with phase_clock("3 kernels 6/7, 4/5"):
        k67, k45 = compare_training_kernels(gen, dev)
    # kernel 1 at every geometry the fold picker gives phases 4 and 8;
    # those phases then must run no other bf16 geometry
    geos = kernel1_geometries()
    with phase_clock("3 kernel 1"):
        k1 = compare_wavernn(gen, dev, geos)
    with Kernel1Geometries() as recorder:
        with phase_clock("4 end to end"):
            launches, conversions = phase_end_to_end(card, recorder)
        with phase_clock("8 batch serving"):
            for name, count in phase_batch_serving(card, recorder).items():
                launches[name] += count
    unheld = sorted(set(recorder.ran) - set(geos))
    log({"phase": "wavernn_sample geometries", "held": sorted(geos),
         "launches_by_geometry": {f"{r}x{f}": n for (r, f), n in sorted(
             recorder.ran.items())}, "ran_unheld": unheld})
    if unheld or not recorder.ran:
        raise AssertionError(f"phases 4 and 8 ran kernel 1 in bf16 at "
                             f"{unheld}, which phase 3 did not hold")
    with phase_clock("5 train"):
        train = phase_train(card)
        launches.update(train["launches"])
        phase_train_f32_vs_cpu(card)
    with phase_clock("6 vocoder train"):
        vocoder = phase_vocoder_train(card)
        launches.update(vocoder["launches"])
        phase_vocoder_f32_vs_cpu(card)
    with phase_clock("7 se train"):
        se = phase_se_train(card)
        for name, count in se["launches"].items():
            launches[name] += count
        phase_se_f32_vs_cpu(card)
    with phase_clock("9 cli"):
        for name, count in phase_cli(card).items():
            launches[name] += count
    with phase_clock("12 reference scripts"):
        for name, count in phase_reference_scripts(card, dev).items():
            launches[name] += count
    with phase_clock("10 train extras"):
        for name, count in phase_train_extras(card).items():
            launches[name] += count
    with phase_clock("11 multi device"):
        for name, count in phase_multi_device(card, {
                "ae": train["median_step_s"],
                "vocoder": vocoder["median_step_s"],
                "se": se["median_step_s"]}).items():
            launches[name] += count
    with phase_clock("13 native mel"):
        phase_native_mel(card)
    with phase_clock("roofline"):
        phase_roofline(card, conversions, train, vocoder, se)

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
        entry("lstm_stack_stream", k3, k3["max_abs_err"]),
        entry("gru_train_fwd", k45["fwd"], k45["fwd"]["max_abs_err"]),
        entry("gru_train_bwd", k45["bwd"], k45["bwd"]["max_abs_err"]),
        entry("lstm_train_fwd", k67["fwd"], k67["fwd"]["max_abs_err"]),
        entry("lstm_train_bwd", k67["bwd"], k67["bwd"]["max_abs_err"])]}
    for e in summary["kernels"]:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} never launched on the main "
                                 f"path")
        if not all(math.isfinite(e[k]) for k in ("ms", "plain_ms",
                                                  "bound_ms")):
            raise AssertionError(f"non-finite timing for {e['name']}")
    log({"phase": "phase seconds", **PHASE_SECONDS,
         "total": round(time.time() - t_start, 2)})
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
