"""Roofline accounting for the port's hot paths (counterpart of
``autovc_tpu/utils/roofline.py``): analytic FLOP and HBM-byte counts for
each pipeline component, an NVIDIA H100 peak table, and :func:`account` /
:func:`format_table`, so a measured time can be reported as achieved
TFLOP/s, GB/s, share of peak and the bound that binds.

The cost models are the JAX package's, formula for formula, so both
packages count the same work for the same configuration.  Conventions:

  * a matmul (M,K)x(K,N) counts 2*M*K*N FLOPs;
  * HBM bytes are the *minimum* traffic of the strategy modelled: e.g. the
    WaveRNN sampling kernel keeps its weights on chip (shared memory and
    registers of a persistent grid, ``csrc/wavernn_sample.cu``), so a
    step's traffic is the streamed noise block; the JAX package's XLA scan,
    which re-reads the weights each step, keeps its own model
    (:func:`wavernn_xla_step_cost`);
  * share of peak uses the peak of the dtype the component's matmuls run
    in (``compute_dtype=``): the bf16-policy steps score against the bf16
    tensor-core peak;
  * an entry whose achieved rate would beat its own throughput bound is
    marked ``measurement_valid: false``: its count or its clock is wrong.

For an autoregressive loop the roofline is not the ceiling: each step pays
a latency floor whatever its arithmetic intensity.  Callers pass
``step_floor_us`` (a measured time a step: kernel 1's own for the sampling
loop, :data:`STREAM_STEP_FLOOR_US` for the LSTM recurrences) and
:func:`account` reports that latency model as a third bound.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float      # dense tensor-core peak, bf16 inputs
    peak_f32_tflops: float       # f32 peak outside the tensor cores
    hbm_gbs: float               # HBM bandwidth, GB/s


# NVIDIA H100 Tensor Core GPU data sheet, per part, at the part's maximum
# power: dense rates (half the sheet's with-sparsity bf16 figure, rounded
# down), f32 outside the tensor cores (the parity mode runs with TF32
# off), HBM bandwidth.  A card set to a lower power limit runs below them.  Matched
# against torch.cuda.get_device_name(), the more specific names first.
_CHIPS = (
    ("h100 pcie", ChipSpec("NVIDIA H100 PCIe", 756.0, 51.0, 2000.0)),
    ("h100 nvl", ChipSpec("NVIDIA H100 NVL", 835.0, 60.0, 3900.0)),
    ("h100 80gb hbm3", ChipSpec("NVIDIA H100 SXM", 989.0, 67.0, 3350.0)),
    ("h100 sxm", ChipSpec("NVIDIA H100 SXM", 989.0, 67.0, 3350.0)),
)

# Kernel 2's measured time a round (us) at decoder lstm2 (2 x 1024), 1 row,
# bf16, T 400: 1.5578 ms / 401 rounds = 3.8847 us ("per_round_us" of
# chip_smoke.py phase 3's lstm_stack_skewed plan line; NVIDIA H100 80GB
# HBM3, 700.00 W).  The latency-model floor of the LSTM recurrences (the
# AutoVC generator's decoder chain): a round runs its layers' products from
# weights resident in shared memory and waits on one grid barrier,
# whatever its row count.
STREAM_STEP_FLOOR_US = 3.88


def chip_spec(device_name: str | None = None) -> ChipSpec:
    """The peaks of the card named ``device_name`` (by default
    ``torch.cuda.get_device_name()``).  A card outside the table raises:
    a made-up peak would give made-up shares of it."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name()
    kind = device_name.lower()
    for key, spec in _CHIPS:
        if key in kind:
            return spec
    raise ValueError(f"no peak table for {device_name!r}: roofline.chip_spec "
                     f"knows {[key for key, _ in _CHIPS]}")


# ---------------------------------------------------------------------------
# Component cost models (FLOPs, HBM bytes)
# ---------------------------------------------------------------------------


def matmul_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def conv1d_flops(batch: int, t: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * batch * t * c_in * c_out * k


def lstm_flops(batch: int, t: int, d_in: int, hidden: int) -> int:
    """Fused-gate LSTM layer: per step one (B,I)x(I,4H) + one (B,H)x(H,4H)."""
    return 2 * batch * t * (d_in * 4 * hidden + hidden * 4 * hidden)


def gru_flops(batch: int, t: int, d_in: int, hidden: int) -> int:
    return 2 * batch * t * (d_in * 3 * hidden + hidden * 3 * hidden)


def melspec_cost(n_frames: int, n_fft: int = 2048, n_mels: int = 80,
                 win: int = 1100):
    """Mel front-end counted as a DFT matmul: frame matrix (F, n_fft)
    against the (n_fft, 2*(n_fft//2+1)) DFT basis, then the mel projection.
    Bytes: wav in + frames materialised + DFT basis + mel out.  (The port's
    ``ops/melspec.py`` runs cuFFT, which needs fewer operations: the
    model is the JAX package's, an upper count.)"""
    n_freq = n_fft // 2 + 1
    flops = matmul_flops(n_frames, n_fft, 2 * n_freq)
    flops += matmul_flops(n_frames, n_freq, n_mels)
    flops += 6 * n_frames * n_freq          # |.|^2, sqrt, dB, normalise
    bytes_ = 4 * (n_frames * n_fft          # framed+windowed input
                  + n_fft * 2 * n_freq      # DFT basis (read once)
                  + n_frames * n_freq       # magnitude intermediate
                  + n_frames * n_mels)      # mel out
    return flops, bytes_


def ae_forward_cost(cfg, batch: int, t: int):
    """AutoVC generator forward (models/autoencoder.py): conv stacks + LSTMs.

    Weight bytes counted once (a kernel keeps its weights on chip), f32
    activations in/out per layer.
    """
    n, e, p = cfg.n_mels, cfg.dim_emb, cfg.dim_pre
    neck = cfg.dim_neck
    flops = 0
    # encoder: 3 convs + 2-layer BLSTM
    flops += conv1d_flops(batch, t, n + e, 512, 5)
    flops += 2 * conv1d_flops(batch, t, 512, 512, 5)
    flops += 2 * lstm_flops(batch, t, 512, neck)          # fwd+bwd layer 1
    flops += 2 * lstm_flops(batch, t, 2 * neck, neck)     # fwd+bwd layer 2
    # decoder: lstm1 + 3 convs + 2-layer lstm2 + proj
    flops += lstm_flops(batch, t, 2 * neck + e, p)
    flops += 3 * conv1d_flops(batch, t, p, p, 5)
    flops += lstm_flops(batch, t, p, 1024)
    flops += lstm_flops(batch, t, 1024, 1024)
    flops += matmul_flops(batch * t, 1024, n)
    # postnet: 5 convs
    flops += conv1d_flops(batch, t, n, 512, 5)
    flops += 3 * conv1d_flops(batch, t, 512, 512, 5)
    flops += conv1d_flops(batch, t, 512, n, 5)

    weight_bytes = 4 * (
        (n + e) * 512 * 5 + 2 * 512 * 512 * 5
        + 2 * 4 * neck * (512 + neck) + 2 * 4 * neck * (2 * neck + neck)
        + 4 * p * (2 * neck + e + p) + 3 * p * p * 5
        + 4 * 1024 * (p + 1024) + 4 * 1024 * 2048 + 1024 * n
        + n * 512 * 5 + 3 * 512 * 512 * 5 + 512 * n * 5)
    act_bytes = 4 * batch * t * (n + 512 * 3 + 2 * neck + p * 4
                                 + 1024 * 2 + n * 2 + 512 * 5)
    return flops, weight_bytes + act_bytes


def ae_train_cost(cfg, batch: int, t: int):
    """Train step ~= forward + content_codes(recon) + backward (2x)."""
    fwd_flops, fwd_bytes = ae_forward_cost(cfg, batch, t)
    # the loss re-encodes the reconstruction (autoencoder.loss): ~40% of fwd
    enc_flops = int(0.4 * fwd_flops)
    total = (fwd_flops + enc_flops) * 3
    return total, fwd_bytes * 3


def se_train_cost(cfg, speakers: int, utterances: int, t: int):
    """GE2E train step: 3-layer LSTM stack fwd + ~2x bwd over the
    (S*U, T, mels) block, plus the projection; similarity-matrix math is
    negligible.  Bytes: weights (3 passes) + activations in/out per layer
    per pass."""
    B = speakers * utterances
    H, M = cfg.hidden_size, cfg.input_size
    fwd = lstm_flops(B, t, M, H) + 2 * lstm_flops(B, t, H, H)
    fwd += matmul_flops(B, H, cfg.embedding_size)
    weight_bytes = 4 * (4 * H * (M + H) + 2 * 4 * H * 2 * H
                        + H * cfg.embedding_size)
    act_bytes = 4 * B * t * (M + 3 * H)
    return 3 * fwd, 3 * (weight_bytes + act_bytes)


def vocoder_train_cost(cfg, batch: int, t_samples: int):
    """WaveRNN teacher-forced train step: time-parallel GRUs + fc stack
    fwd + ~2x bwd (MelResNet at frame rate is negligible).  Bytes:
    weights (3 passes) + sample-rate activations per layer per pass."""
    rd, fc, d = cfg.rnn_dims, cfg.fc_dims, cfg.aux_dims
    fwd = gru_flops(batch, t_samples, rd, rd)
    fwd += gru_flops(batch, t_samples, rd + d, rd)
    fwd += 2 * batch * t_samples * (
        (1 + cfg.feat_dims + d) * rd + (rd + d) * fc + (fc + d) * fc
        + fc * cfg.n_classes)
    weight_bytes = 4 * (3 * rd * (2 * rd + d) * 2 + (rd + d) * fc
                       + (fc + d) * fc + fc * cfg.n_classes)
    act_bytes = 4 * batch * t_samples * (rd * 4 + fc * 2 + cfg.n_classes)
    return 3 * fwd, 3 * (weight_bytes + act_bytes)


def _band_reach(cfg) -> int:
    """One-sided frame reach J of the composite upsample kernel
    (models/wavernn._composite_upsample_kernel)."""
    S = 1
    for s in cfg.upsample_factors:
        S *= s
    reach, rem = 0, S
    for s in cfg.upsample_factors:
        rem //= s
        reach += s * rem                 # (2s+1 kernel) -> half-width s
    return -(-reach // S)


def wavernn_step_cost(cfg, batch: int):
    """ONE sampling step of the WaveRNN sampling kernel (kernel 1,
    ``csrc/wavernn_sample.cu``) over ``batch`` fold rows.

    FLOPs: 4 gate matmuls (rd x 3rd) + fc1 + fc2 + fc3(->128 lanes) + the
    banded frame->sample upsample (W vector FMAs on rd lanes).  HBM bytes:
    only the streamed noise block (the weights stay on chip and the
    conditioning is read at frame rate), compute dtype.
    """
    rd, fc = cfg.rnn_dims, cfg.fc_dims
    W = 2 * _band_reach(cfg) + 1
    flops = 2 * batch * (4 * rd * 3 * rd + rd * fc + fc * fc + fc * 128)
    flops += 2 * batch * W * rd
    bytes_ = batch * 128 * 2                          # bf16 noise stream
    return flops, bytes_


def wavernn_xla_step_cost(cfg, batch: int):
    """The same step under the JAX package's XLA scan: weights re-streamed
    from HBM each step (f32).  The port has no such path; the model is
    kept so both packages' tables agree."""
    rd, fc = cfg.rnn_dims, cfg.fc_dims
    flops, _ = wavernn_step_cost(cfg, batch)
    weight_bytes = 4 * (4 * rd * 3 * rd + rd * fc + fc * fc + fc * 128)
    d_stream = rd + 3 * rd + 2 * fc + 128
    return flops, weight_bytes + batch * d_stream * 4


def wavernn_conditioning_cost(cfg, batch: int, t: int):
    """Frame-rate conditioning for the sampling kernel (MelResNet + frame
    fold).  Nothing is materialised at sample rate: the banded upsample
    and the input projections run in the sampling program (see
    :func:`wavernn_prologue_cost`)."""
    feat, comp, ro = cfg.feat_dims, cfg.compute_dims, cfg.res_out_dims
    frames = t // cfg.total_scale
    flops = conv1d_flops(batch, frames, feat, comp, 2 * cfg.pad + 1)
    flops += cfg.res_blocks * 2 * conv1d_flops(batch, frames, comp, comp, 1)
    flops += conv1d_flops(batch, frames, comp, ro, 1)
    # bytes: mel read + aux frames written, then re-read/re-written by the
    # frame-rate overlap fold (resnet intermediates stay fused)
    g = cfg.generate
    dup = (g.target + 2 * g.overlap) / g.target
    bytes_ = 4 * batch * frames * (feat + ro) * (1 + 2 * dup)
    return flops, bytes_


def wavernn_prologue_cost(cfg, folds: int, t_steps: int):
    """Per-sampling-call prologue of the sampling loop: frame-rate input
    projections (small matmuls) + noise generation/packing.  The noise
    stream is the only sample-rate tensor the program ever writes."""
    rd, fc, d = cfg.rnn_dims, cfg.fc_dims, cfg.aux_dims
    feat = cfg.feat_dims
    frames = t_steps // cfg.total_scale
    Fq = frames + 2 * _band_reach(cfg)
    flops = 2 * folds * (Fq * feat * rd
                         + frames * d * (rd + 3 * rd + 2 * fc))
    # noise: threefry + 2 transcendentals per draw, ~32 flops/draw
    pick = cfg.n_classes if cfg.mode == "RAW" else cfg.n_classes // 3
    flops += 32 * folds * t_steps * (pick + 1)
    # noise: f32 intermediates (u, gumbel/logistic) + packed cdt write;
    # frame blocks: mf f32 + fblk cdt
    bytes_ = folds * t_steps * ((pick + 1) * 4 * 2 + 128 * 2)
    bytes_ += folds * (Fq * rd * 4 + frames * (4 * rd + 2 * fc) * 2)
    return flops, bytes_


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def account(name: str, flops: float, hbm_bytes: float, seconds: float,
            spec: ChipSpec, compute_dtype: str = "f32",
            sequential_steps: int | None = None,
            step_floor_us: float | None = None):
    """Return an accounting dict: achieved rates, %-of-peak, binding bound.

    ``sequential_steps`` + ``step_floor_us`` add the latency-model bound
    (steps x the measured per-step floor for the component class).  For
    sequential components this is usually the BINDING bound and becomes the
    reported ``sol_seconds``/``sol_fraction``; the throughput-only fraction
    rides along as ``throughput_sol_fraction``.  ``measurement_valid`` stays
    defined by the throughput bound alone — that one is physics (a timing
    below it is impossible), while the latency floor is an empirical table
    a faster kernel may legitimately beat.
    """
    peak_tf = (spec.peak_bf16_tflops if compute_dtype == "bf16"
               else spec.peak_f32_tflops)
    t_compute = flops / (peak_tf * 1e12)
    t_memory = hbm_bytes / (spec.hbm_gbs * 1e9)
    achieved_tf = flops / seconds / 1e12
    achieved_gbs = hbm_bytes / seconds / 1e9
    bound = "compute" if t_compute >= t_memory else "bandwidth"
    thr_sol = max(t_compute, t_memory)
    thr_fraction = round(thr_sol / seconds, 4) if seconds > 0 else 0.0
    # A component cannot beat its own (throughput) speed-of-light.
    # thr_fraction > 1 means the TIMING or the COST MODEL is wrong (a clock
    # that missed work, or modelled work the program does not do): publish
    # the entry as measurement-invalid rather than as a result.
    valid = thr_fraction <= 1.0
    sol, sol_fraction = thr_sol, thr_fraction
    lat_sol = None
    if sequential_steps and step_floor_us:
        lat_sol = sequential_steps * step_floor_us * 1e-6
        if lat_sol > thr_sol:
            bound = "latency"
            sol = lat_sol
            sol_fraction = round(sol / seconds, 4) if seconds > 0 else 0.0
    entry = {
        "component": name,
        "flops": int(flops),
        "hbm_bytes": int(hbm_bytes),
        "seconds": round(seconds, 6),
        "achieved_tflops": round(achieved_tf, 3),
        "achieved_gbs": round(achieved_gbs, 2),
        "mfu_pct": round(100 * achieved_tf / peak_tf, 2),
        "hbm_pct": round(100 * achieved_gbs / spec.hbm_gbs, 2),
        "bound": bound,
        "sol_seconds": round(sol, 6),
        "sol_fraction": sol_fraction,
        "throughput_sol_fraction": thr_fraction,
        "compute_dtype": compute_dtype,
        "measurement_valid": valid,
    }
    if lat_sol is not None:
        entry["latency_model_seconds"] = round(lat_sol, 6)
    if sequential_steps:
        # latency-bound autoregressive loop: amortised per-step time
        entry["us_per_step"] = round(1e6 * seconds / sequential_steps, 3)
    return entry


def format_table(entries) -> str:
    hdr = (f"{'component':<26}{'dt':>5}{'time':>9}{'TF/s':>8}{'GB/s':>8}"
           f"{'MFU%':>7}{'HBM%':>7}{'bound':>11}{'SoL%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for e in entries:
        flag = "" if e.get("measurement_valid", True) \
            else "  INVALID (>SoL: timing/model error)"
        lines.append(
            f"{e['component']:<26}{e['compute_dtype']:>5}"
            f"{e['seconds']*1e3:>7.2f}ms"
            f"{e['achieved_tflops']:>8.2f}{e['achieved_gbs']:>8.1f}"
            f"{e['mfu_pct']:>7.2f}{e['hbm_pct']:>7.2f}{e['bound']:>11}"
            f"{100*e['sol_fraction']:>6.1f}%{flag}")
    return "\n".join(lines)
