"""WaveRNN sampling loop: kernel 1, its plain version and the noise draw.

Counterpart of ``autovc_tpu/ops/wavernn_pallas.py:generate_rows_pallas``.
:func:`generate_rows` takes frame-rate conditioning for B fold rows —
mel rows (B, fpf + 2J, feat) with J zero-filled margin frames, MelResNet
rows (B, fpf, res_out) — and samples (B, fpf * total_scale) waveform rows:

  * the frame-rate input projections (``wavernn_pallas.py:211-229``) are
    plain f32 matmuls here;
  * the noise is pre-drawn by :func:`draw_noise` (Gumbel noise for
    ``pick_dim`` lanes, one logistic value per step and row, the draw order
    of ``wavernn.py:619-625``), with a ``torch.Generator`` on the device;
  * the loop itself — banded upsample, two GRUs, fc1..fc3, sampling and
    feedback — is kernel ``wavernn_sample_launch`` of
    ``csrc/wavernn_sample.cu`` for CUDA tensors, and
    :func:`sample_rows_plain`, the same arithmetic in PyTorch, for CPU
    tensors.

``fast_math=True`` follows ``wavernn_pallas.py:189,229,246``: bf16 weights,
the frame features ``base``/``pre_r2``/``pre_f1``/``pre_f2`` and the noise
rounded to bf16, activations rounded to bf16 only as matmul operands, f32
accumulation, state and sampling math.  ``mf`` stays f32.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops.mol import LOG_SCALE_MIN

MAX_TAPS = 9  # kMaxTaps of csrc/wavernn_sample.cu: W = 2J + 1 <= 9

SAMPLE = _build.Kernel(
    "wavernn_sample.cu", "wavernn_sample_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


@dataclass
class RowsInputs:
    """Everything the sampling loop reads, in the kernel's layouts."""
    mf: torch.Tensor       # (B, fpf + 2J, rd) f32
    base: torch.Tensor     # (B, fpf, rd) f32
    pre_r2: torch.Tensor   # (B, fpf, 3rd)
    pre_f1: torch.Tensor   # (B, fpf, fc)
    pre_f2: torch.Tensor   # (B, fpf, fc)
    ktab: torch.Tensor     # (W, S) f32: ktab[w, p] = K[2J - w, p]
    w_x: torch.Tensor      # (rd,) f32
    w_ih1: torch.Tensor    # (3rd, rd) weights are (out, in), f32 or bf16
    w_hh1: torch.Tensor    # (3rd, rd)
    w_ih2: torch.Tensor    # (3rd, rd)
    w_hh2: torch.Tensor    # (3rd, rd)
    w_fc1: torch.Tensor    # (fc, rd)
    w_fc2: torch.Tensor    # (fc, fc)
    w_fc3: torch.Tensor    # (n_classes, fc)
    b_ih1: torch.Tensor    # (3rd,) f32
    b_hh1: torch.Tensor
    b_hh2: torch.Tensor
    b_fc3: torch.Tensor    # (n_classes,)
    n_classes: int
    nr_mix: int
    pick_dim: int
    raw_mode: bool

    @property
    def rows(self) -> int:
        return self.mf.shape[0]

    @property
    def fpf(self) -> int:
        return self.base.shape[1]

    @property
    def steps(self) -> int:
        return self.fpf * self.ktab.shape[1]


def pack_weights(params, cfg, fast_math: bool) -> Dict[str, Any]:
    """The loop's weights in kernel layout: every :class:`RowsInputs`
    field that does not depend on the mel.  Built once per model and
    precision (``VoiceConverter`` does it at construction and again after
    vocoder training)."""
    from autovc_tpu_torch.models.wavernn import _composite_upsample_kernel
    rd, fc = cfg.rnn_dims, cfg.fc_dims
    n_classes = cfg.n_classes
    raw_mode = cfg.mode == "RAW"
    nr_mix = n_classes // 3
    cdt = torch.bfloat16 if fast_math else torch.float32
    f32 = torch.float32
    with torch.no_grad():
        K, _ = _composite_upsample_kernel(params["upsample"]["up_convs"],
                                          cfg.upsample_factors)
    wI = params["I"]["w"]                      # (rd, 1 + feat + aux)

    def weight(w):
        return w.to(cdt).contiguous()

    return dict(
        ktab=K.flip(0).to(wI.device, f32).contiguous(),
        w_x=wI[:, 0].to(f32).contiguous(),
        w_ih1=weight(params["rnn1"]["w_ih"].T),
        w_hh1=weight(params["rnn1"]["w_hh"].T),
        w_ih2=weight(params["rnn2"]["w_ih"][:rd].T),
        w_hh2=weight(params["rnn2"]["w_hh"].T),
        w_fc1=weight(params["fc1"]["w"][:, :rd]),
        w_fc2=weight(params["fc2"]["w"][:, :fc]),
        w_fc3=weight(params["fc3"]["w"]),
        b_ih1=params["rnn1"]["b_ih"].to(f32).contiguous(),
        b_hh1=params["rnn1"]["b_hh"].to(f32).contiguous(),
        b_hh2=params["rnn2"]["b_hh"].to(f32).contiguous(),
        b_fc3=params["fc3"]["b"].to(f32).contiguous(),
        n_classes=n_classes, nr_mix=nr_mix,
        pick_dim=n_classes if raw_mode else nr_mix, raw_mode=raw_mode)


def prepare_rows(params, mel_rows: torch.Tensor, aux_rows: torch.Tensor,
                 cfg, fast_math: bool,
                 packed: Dict[str, Any] | None = None) -> RowsInputs:
    """Frame-rate projections (``wavernn_pallas.py:182-263``) beside the
    kernel-layout weights ``packed`` (:func:`pack_weights`, built here when
    not given)."""
    if packed is None:
        packed = pack_weights(params, cfg, fast_math)
    feat = mel_rows.shape[-1]
    rd, fc, d = cfg.rnn_dims, cfg.fc_dims, cfg.aux_dims
    fpf = mel_rows.shape[1] - (packed["ktab"].shape[0] - 1)
    aux_rows = aux_rows[:, :fpf]
    a1, a2, a3, a4 = (aux_rows[..., i * d:(i + 1) * d] for i in range(4))
    wI = params["I"]["w"]                      # (rd, 1 + feat + aux)
    w_ih2 = params["rnn2"]["w_ih"]             # (rd + aux, 3rd)
    w_fc1 = params["fc1"]["w"]                 # (fc, rd + aux)
    w_fc2 = params["fc2"]["w"]                 # (fc, fc + aux)

    def frame_feature(x):
        x = x.float().contiguous()
        return PREC.round_bf16(x) if fast_math else x

    return RowsInputs(
        mf=torch.matmul(mel_rows, wI[:, 1:1 + feat].T).float().contiguous(),
        base=frame_feature(torch.matmul(a1, wI[:, 1 + feat:].T)
                           + params["I"]["b"]),
        pre_r2=frame_feature(torch.matmul(a2, w_ih2[rd:])
                             + params["rnn2"]["b_ih"]),
        pre_f1=frame_feature(torch.matmul(a3, w_fc1[:, rd:].T)
                             + params["fc1"]["b"]),
        pre_f2=frame_feature(torch.matmul(a4, w_fc2[:, fc:].T)
                             + params["fc2"]["b"]),
        **packed)


def draw_noise(steps: int, rows: int, pick_dim: int,
               generator: torch.Generator | None, device):
    """Sampling noise for ``steps`` x ``rows``: Gumbel (steps, rows,
    pick_dim) and logistic (steps, rows), from uniforms in
    [1e-5, 1 - 1e-5), drawn in that order (``wavernn.py:619-625``)."""
    lo, span = 1e-5, 1.0 - 2e-5
    u1 = torch.rand((steps, rows, pick_dim), generator=generator,
                    device=device) * span + lo
    gumbel = -torch.log(-torch.log(u1))
    u2 = torch.rand((steps, rows), generator=generator,
                    device=device) * span + lo
    logistic = torch.log(u2) - torch.log(1.0 - u2)
    return gumbel, logistic


def sample_rows_plain(inp: RowsInputs, gumbel: torch.Tensor,
                      logistic: torch.Tensor) -> torch.Tensor:
    """The kernel's loop in PyTorch (the CPU path and the kernel's
    oracle): (B, steps) samples."""
    B, S = inp.rows, inp.ktab.shape[1]
    W = inp.ktab.shape[0]
    rd = inp.w_x.shape[0]
    bf16 = inp.w_ih1.dtype == torch.bfloat16
    w = {k: getattr(inp, k).float().T for k in
         ("w_ih1", "w_hh1", "w_ih2", "w_hh2", "w_fc1", "w_fc2", "w_fc3")}

    def dot(a, name):
        return torch.matmul(PREC.round_bf16(a) if bf16 else a, w[name])

    def gru(h, xp, w_hh, b_hh):
        hp = dot(h, w_hh) + b_hh
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h

    nr_mix = inp.nr_mix
    rows = torch.arange(B, device=inp.mf.device)
    x = inp.mf.new_zeros(B, 1)
    h1 = inp.mf.new_zeros(B, rd)
    h2 = inp.mf.new_zeros(B, rd)
    out = []
    for q in range(inp.fpf):
        base = inp.base[:, q]
        mfw = [inp.mf[:, q + k] for k in range(W)]
        for p in range(S):
            t = q * S + p
            pre_I = base
            for k in range(W):
                pre_I = pre_I + mfw[k] * inp.ktab[k, p]
            xI = x * inp.w_x[None, :] + pre_I
            h1 = gru(h1, dot(xI, "w_ih1") + inp.b_ih1, "w_hh1", inp.b_hh1)
            x1 = xI + h1
            h2 = gru(h2, dot(x1, "w_ih2") + inp.pre_r2[:, q], "w_hh2",
                     inp.b_hh2)
            x2 = x1 + h2
            x3 = torch.relu(dot(x2, "w_fc1") + inp.pre_f1[:, q])
            x4 = torch.relu(dot(x3, "w_fc2") + inp.pre_f2[:, q])
            logits = dot(x4, "w_fc3") + inp.b_fc3
            # torch.argmax returns the first maximal index, as jnp.argmax
            pick = torch.argmax(logits[:, :inp.pick_dim] + gumbel[t], dim=-1)
            if inp.raw_mode:
                sample = 2.0 * pick.float() / (inp.n_classes - 1.0) - 1.0
            else:
                means = logits[rows, nr_mix + pick]
                log_scales = torch.clamp(logits[rows, 2 * nr_mix + pick],
                                         min=LOG_SCALE_MIN)
                sample = torch.clamp(
                    means + torch.exp(log_scales) * logistic[t], -1.0, 1.0)
            out.append(sample)
            x = sample[:, None]
    return torch.stack(out, dim=1)


def launch(inp: RowsInputs, gumbel: torch.Tensor,
           logistic: torch.Tensor) -> torch.Tensor:
    """Launch kernel 1 on CUDA tensors (checked here): (B, steps)."""
    B, steps = inp.rows, inp.steps
    rd, fc = inp.w_x.shape[0], inp.w_fc1.shape[0]
    if rd % 16 or fc % 16:
        raise ValueError(f"the sampling kernel needs rnn_dims and fc_dims "
                         f"divisible by 16, got {rd}, {fc}")
    if inp.ktab.shape[0] > MAX_TAPS:
        raise ValueError(f"the sampling kernel takes at most {MAX_TAPS} "
                         f"upsample taps, got {inp.ktab.shape[0]}")
    if tuple(gumbel.shape) != (steps, B, inp.pick_dim) \
            or tuple(logistic.shape) != (steps, B):
        raise ValueError("noise shapes do not match the rows")
    wdt = inp.w_ih1.dtype
    weights = (inp.w_ih1, inp.w_hh1, inp.w_ih2, inp.w_hh2, inp.w_fc1,
               inp.w_fc2, inp.w_fc3)
    if wdt not in (torch.float32, torch.bfloat16) or any(
            w.dtype != wdt for w in weights):
        raise ValueError("weights must all be f32 or all bf16")
    if wdt == torch.bfloat16 and rd % 128:
        raise ValueError(f"the bf16 sampling kernel splits rnn_dims over 8 "
                         f"warps of 16-deep tensor-core steps: rnn_dims % "
                         f"128 == 0, got {rd}")
    dev = inp.mf.device
    out = torch.empty(B, steps, device=dev)
    state = torch.empty(7 * B * rd + 2 * B * fc, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    tensors = (inp.mf, inp.base, inp.pre_r2, inp.pre_f1, inp.pre_f2,
               inp.ktab, inp.w_x) + weights + (
        inp.b_ih1, inp.b_hh1, inp.b_hh2, inp.b_fc3, gumbel, logistic,
        out, state, bar)
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"kernel input {i} is not a contiguous tensor "
                             f"on {dev}")
        if t.dtype not in (torch.float32, wdt, torch.int32):
            raise ValueError(f"kernel input {i} has dtype {t.dtype}")
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    W = inp.ktab.shape[0]
    ints = (ctypes.c_int * 10)(B, inp.fpf, inp.ktab.shape[1], W, rd, fc,
                               inp.n_classes, inp.nr_mix, inp.pick_dim,
                               int(inp.raw_mode))
    with torch.cuda.device(dev):      # the C side launches on the current device
        SAMPLE(ctypes.cast(ptrs, ctypes.c_void_p),
               ctypes.cast(ints, ctypes.c_void_p),
               int(wdt == torch.bfloat16),
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def sample_rows(inp: RowsInputs, gumbel: torch.Tensor,
                logistic: torch.Tensor) -> torch.Tensor:
    """Kernel 1 for CUDA tensors, the plain loop for CPU tensors."""
    if inp.mf.device.type == "cuda":
        return launch(inp, gumbel, logistic)
    if inp.mf.device.type == "cpu":
        return sample_rows_plain(inp, gumbel, logistic)
    raise ValueError(f"unsupported device {inp.mf.device}")


def generate_rows(params, mel_rows: torch.Tensor, aux_rows: torch.Tensor,
                  cfg, fast_math: bool = True,
                  generator: torch.Generator | None = None,
                  packed: Dict[str, Any] | None = None) -> torch.Tensor:
    """Sample (B, fpf * total_scale) waveform rows from frame-rate
    conditioning (the JAX ``generate_rows_pallas`` contract); ``packed``
    as for :func:`prepare_rows`."""
    inp = prepare_rows(params, mel_rows, aux_rows, cfg, fast_math, packed)
    gumbel, logistic = draw_noise(inp.steps, inp.rows, inp.pick_dim,
                                  generator, mel_rows.device)
    if fast_math:
        gumbel, logistic = PREC.round_bf16(gumbel), PREC.round_bf16(logistic)
    return sample_rows(inp, gumbel.contiguous(), logistic.contiguous())
