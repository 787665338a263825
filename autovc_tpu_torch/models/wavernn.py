"""WaveRNN vocoder (counterpart of ``autovc_tpu/models/wavernn.py``):
teacher-forced training and generation.

Training (:func:`loss`, :func:`forward`) is the JAX package's kernel branch
of ``forward`` (``wavernn.py:219-253``): the conditioning upsampler
(MelResNet, whose train-mode BatchNorm moves its running statistics in
place as :func:`autovc_tpu_torch.ops.conv.batchnorm1d` does, and the
[stretch, smoothing conv] chain, as one banded frame -> samples kernel
when ``pad >= J``), then the whole sample-rate chain time-major around
the GRU pair (:func:`autovc_tpu_torch.ops.gru_train_kernels.gru_pair`:
kernels 4/5 on the GPU), with layer 2's projection split into the hoisted
``base2`` and the in-kernel ``h1 W_ih2x``, and the fc layers as split
matmuls.  ``mode`` is the precision policy ("f32" or "bf16"), which the
JAX functions read from their context.

Generation follows the JAX package's accelerator path
(``_generate_program``, its pallas branch): MelResNet conditioning at
frame rate, the fold of the mel frames into overlapping rows
(``_fold_rows``, J zero-filled margin frames each side), the rows padded to
a row bucket, the sampling loop
(:func:`autovc_tpu_torch.ops.wavernn_kernels.generate_rows`: kernel 1 on
the GPU), then crossfade-unfold, trim and fade (:func:`_finish`).
``batched=False`` is the same kernel at one row.

Batch serving (:func:`generate_many`) runs one MelResNet pass over every
utterance, joins all utterances' fold rows, samples them in slabs of at
most ``_MAX_SLAB_ROWS`` rows (one kernel-1 pass a slab) and finishes each
utterance into one flat int16 array (:func:`_finish_many`).

Both programs are spans of :mod:`autovc_tpu_torch.utils.profiling`:
``vocoder/condition``, ``vocoder/sample`` (one a sampling pass) and
``vocoder/finish``; the counters ``k1.row_steps`` (rows x steps of each
pass, padding rows included) and ``k1.samples`` (the samples returned)
give the sampling loop's useful share.

``auto_target`` picks the fold length (:func:`auto_fold_target`) with the
JAX package's wall model over kernel 1's time a step measured on an H100
(``_ROWS_US``).

Known deviations from the JAX package: a fold geometry that is not a
multiple of ``total_scale`` raises (the JAX package falls back to its XLA
scan there; the port has no second sampling path).  The JAX package caps
its single-generate pass and its batch slab at the rows that fit the TPU
kernel's VMEM budget (``_pallas_max_rows``); the port has no such cap,
since kernel 1 takes any row count, so the picker prices a single
generate as one pass at its row bucket.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import gru_train_kernels as GT
from autovc_tpu_torch.ops import mol as MOL
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.parallel import tensor as TP
from autovc_tpu_torch.utils import profiling, resolve_device

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: WaveRNNConfig = WaveRNNConfig()) -> Params:
    """Fresh parameters with the JAX ``wavernn.init`` shapes and layout."""
    cd, rd, ad = cfg.compute_dims, cfg.rnn_dims, cfg.aux_dims
    resnet = {
        "conv_in": C.init_conv1d(gen, cfg.feat_dims, cd, cfg.pad * 2 + 1,
                                 bias=False),
        "bn_in": C.init_batchnorm(cd),
        "blocks": [
            {"conv1": C.init_conv1d(gen, cd, cd, 1, bias=False),
             "bn1": C.init_batchnorm(cd),
             "conv2": C.init_conv1d(gen, cd, cd, 1, bias=False),
             "bn2": C.init_batchnorm(cd)}
            for _ in range(cfg.res_blocks)],
        "conv_out": C.init_conv1d(gen, cd, cfg.res_out_dims, 1),
    }
    up_convs = [torch.full((1, 1, 1, 2 * s + 1), 1.0 / (2 * s + 1))
                for s in cfg.upsample_factors]
    return {
        "upsample": {"resnet": resnet, "up_convs": up_convs},
        "I": C.init_linear(gen, cfg.feat_dims + ad + 1, rd),
        "rnn1": R.init_gru_layer(gen, rd, rd),
        "rnn2": R.init_gru_layer(gen, rd + ad, rd),
        "fc1": C.init_linear(gen, rd + ad, cfg.fc_dims),
        "fc2": C.init_linear(gen, cfg.fc_dims + ad, cfg.fc_dims),
        "fc3": C.init_linear(gen, cfg.fc_dims, cfg.n_classes),
    }


def _mel_resnet(params: Params, m: torch.Tensor, train: bool = False,
                mode: str = "f32", group=None) -> torch.Tensor:
    """(B, feat, F) -> (B, res_out, F - 2*pad): valid conv, then 1x1
    residual blocks.  ``train``: batch-statistics BatchNorm whose running
    statistics move in place; ``group``: over a process group's global
    batch (sync BatchNorm, ``conv.batchnorm1d``)."""
    def conv_bn(conv, bn, x):
        return C.batchnorm1d(bn, C.conv1d(conv, x, mode=mode), train,
                             group=group)

    x = torch.relu(conv_bn(params["conv_in"], params["bn_in"], m))
    for blk in params["blocks"]:
        h = torch.relu(conv_bn(blk["conv1"], blk["bn1"], x))
        x = x + conv_bn(blk["conv2"], blk["bn2"], h)
    return C.conv1d(params["conv_out"], x, mode=mode)


def _upsample_margin(up_convs, factors) -> int:
    """J, the frames a side that one output frame's samples depend on
    through the upsample chain (from the conv widths alone)."""
    S = int(np.prod(factors))
    reach, rem = 0, S
    for w, s in zip(up_convs, factors):
        rem //= s
        reach += ((w.shape[-1] - 1) // 2) * rem
    return -(-reach // S)


def _composite_upsample_kernel(up_convs, factors):
    """The [stretch x s, (1, 2s+1) conv] upsample chain as one banded
    frame->samples kernel: out[q*S + p] = sum_j K[j, p] * mel[q - j + J].

    Returns (K (2J+1, S) f32, J): the chain's impulse response
    (``wavernn.py:116-149``), on the weights' device and differentiable in
    them, as the JAX function is."""
    S = int(np.prod(factors))
    J = _upsample_margin(up_convs, factors)
    x = up_convs[0].new_zeros(1, 1, 1, 2 * J + 1, dtype=torch.float32)
    x[..., J] = 1.0
    for w, s in zip(up_convs, factors):
        x = torch.repeat_interleave(x, s, dim=-1)
        x = F.conv2d(x, w.float(), padding=(0, s))
    r = x[0, 0, 0]
    K = torch.stack([r[(J + j) * S:(J + j + 1) * S] for j in range(-J, J + 1)])
    return K, J


def upsample(params: Params, m: torch.Tensor, cfg: WaveRNNConfig,
             train: bool = False, mode: str = "f32", group=None):
    """Conditioning upsampler: m (B, feat, F), pad-extended by ``pad``
    frames a side -> (mels (B, T, feat), aux (B, T, res_out)) with
    T = (F - 2*pad) * total_scale (``wavernn.py:152-191``).  The smoothing
    chain runs in f32 under both policies, as in the JAX package.
    ``group`` as for :func:`_mel_resnet`."""
    aux = _mel_resnet(params["resnet"], m, train, mode, group)
    aux = torch.repeat_interleave(aux, cfg.total_scale, dim=-1)
    K, J = _composite_upsample_kernel(params["up_convs"],
                                      cfg.upsample_factors)
    pad = cfg.pad
    if pad >= J:
        # the banded path: one small contraction per frame
        B, Cc, Fr = m.shape
        Fp = Fr - 2 * pad
        wins = torch.stack([m[:, :, pad - j:pad - j + Fp]
                            for j in range(-J, J + 1)])   # (2J+1, B, C, Fp)
        out = torch.einsum("jp,jbcf->bfpc", K, wins)
        return out.reshape(B, Fp * cfg.total_scale, Cc), aux.transpose(1, 2)
    x = m[:, None]                                    # (B, 1, feat, F)
    for w, s in zip(params["up_convs"], cfg.upsample_factors):
        x = torch.repeat_interleave(x, s, dim=-1)
        x = F.conv2d(x, w.float(), padding=(0, s))
    indent = pad * cfg.total_scale
    mels = x[:, 0, :, indent:-indent]                 # (B, feat, T)
    return mels.transpose(1, 2), aux.transpose(1, 2)


def _split_fc(params: Params, x: torch.Tensor, a: torch.Tensor, n: int,
              mode: str, model) -> torch.Tensor:
    """``relu([x, a] @ w.T + b)`` as two products over the split input
    (x: its first ``n`` features); column-parallel when ``w`` is a shard,
    the ReLU on this rank's columns before the gather."""
    w = params["w"]
    model = TP.of(model, w)
    x, a = TP.copy_to_model(x, model), TP.copy_to_model(a, model)
    out = torch.relu(PREC.dot(x, w[:, :n].T, mode)
                     + PREC.dot(a, w[:, n:].T, mode) + params["b"])
    return TP.gather_from_model(out, -1, model)


def forward(params: Params, x: torch.Tensor, mels: torch.Tensor,
            cfg: WaveRNNConfig, train: bool = False,
            mode: str = "f32", group=None, model=None) -> torch.Tensor:
    """Teacher-forced pass: previous samples x (B, T) and mels (B, feat, F)
    with T = (F - 2*pad) * total_scale -> logits (B, T, n_classes).
    ``group`` as for :func:`_mel_resnet`.  ``model`` (a
    ``parallel.tensor.ModelAxis``): tensor parallelism where a weight is
    one of this rank's shards (``I``, both GRUs' gate columns, ``fc1``,
    ``fc2``, and ``fc3`` when its width divides the axis): the
    projections column-parallel, the GRU pair the per-step loop
    ``rnn.gru_pair_tp`` on this rank's columns of the hoisted ``xp1`` and
    ``base2``; the MelResNet and the upsampler stay whole."""
    cond, aux = upsample(params["upsample"], mels, cfg, train, mode, group)
    d, rd, fcd = cfg.aux_dims, cfg.rnn_dims, cfg.fc_dims
    inp = torch.cat([x[..., None], cond, aux[..., :d]], dim=-1)
    # time-major from here to the logits
    a2, a3, a4 = (aux[..., i * d:(i + 1) * d].transpose(0, 1)
                  for i in (1, 2, 3))
    xI = C.linear(params["I"], inp.transpose(0, 1), mode, model)  # (T, B, rd)
    w2 = params["rnn2"]["w_ih"]
    rec = TP.of(model, params["rnn1"]["w_hh"])
    xIc, a2c = TP.copy_to_model(xI, rec), TP.copy_to_model(a2, rec)
    xp1 = R.gru_project_inputs(params["rnn1"], xIc, mode)
    base2 = (PREC.dot(xIc, w2[:rd], mode) + PREC.dot(a2c, w2[rd:], mode)
             + params["rnn2"]["b_ih"])
    h1, h2 = GT.gru_pair(xp1, base2, w2[:rd], params["rnn1"]["w_hh"],
                         params["rnn1"]["b_hh"], params["rnn2"]["w_hh"],
                         params["rnn2"]["b_hh"], mode, rec)
    x1 = h1 + xI
    x2 = h2 + x1
    x3 = _split_fc(params["fc1"], x2, a3, rd, mode, model)
    x4 = _split_fc(params["fc2"], x3, a4, fcd, mode, model)
    return C.linear(params["fc3"], x4, mode, model).transpose(0, 1)


def encode_mu_law(x: torch.Tensor, mu: int) -> torch.Tensor:
    """mu-law companding of a [-1, 1] signal (the encode side of
    :func:`_finish`'s expand)."""
    mu = mu - 1
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)


def loss(params: Params, x_in: torch.Tensor, y_target: torch.Tensor,
         mels: torch.Tensor, cfg: WaveRNNConfig, train: bool = True,
         mode: str = "f32", group=None, model=None) -> torch.Tensor:
    """Vocoder training loss (``wavernn.py:279-304``): the MOL negative
    log-likelihood (mode 'MOL') or the cross-entropy over quantised classes
    (mode 'RAW', in the mu-law companded domain when
    ``cfg.generate.mu_law``).  ``group``: sync BatchNorm over a process
    group (the loss stays a mean over this rank's rows); ``model`` as for
    :func:`forward`."""
    if cfg.mode == "RAW" and cfg.generate.mu_law:
        x_in = encode_mu_law(x_in, cfg.n_classes)
        y_target = encode_mu_law(y_target, cfg.n_classes)
    logits = forward(params, x_in, mels, cfg, train, mode, group, model)
    if cfg.mode == "MOL":
        return MOL.discretized_mix_logistic_loss(logits, y_target[..., None])
    n = cfg.n_classes
    classes = torch.clamp(((y_target + 1.0) * (n - 1) / 2.0 + 0.5).long(),
                          0, n - 1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, classes[..., None]))


def pad_mel(mel: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the mel time axis on both sides."""
    return F.pad(mel, (pad, pad))


# Fold-length ladder of the auto geometry (the JAX package's): a small
# discrete set of geometric steps, all near-multiples of the reference's
# 550-sample crossfade overlap.
_TARGET_LADDER = (1_375, 2_750, 5_500, 11_000, 22_000)

# Kernel 1's measured time a step (us) against its row count: bf16 (the
# default fast_math), rd = fc = 512, MOL, 12100-step folds, pinned noise,
# the mean of two runs; one table for both precisions, as the JAX package
# keeps.  NVIDIA H100 80GB HBM3, power limit 700.00 W, `python3
# scripts/wavernn_rows.py --rows 8 16 24 32 48 64 72 80 ... 320 384
# --frames 44` (every 8 rows from 64), 2026-10-18.  A step stages its rows
# in ceil(rows / 64) passes, each padded to 16-row tiles, so the time is
# flat between the points below and jumps at the next one: the table keeps
# the ends of each such segment (the rows between are within 4% of the
# line), and 320 -> 384 (one pass more) sets the slope beyond.  Between
# 2475- and 23100-step folds (`--frames 9` / `84`) the time a step moves
# by 4.2% at 8 rows and < 2% from 16, so one table serves every ladder
# entry.
_ROWS_US = ((8, 15.16), (16, 15.69), (24, 19.59), (32, 21.26), (48, 27.77),
            (64, 32.57), (72, 48.45), (96, 51.92), (104, 60.16),
            (128, 62.54), (136, 75.64), (144, 76.69), (152, 87.72),
            (192, 91.37), (200, 116.38), (256, 123.56), (264, 147.62),
            (320, 155.25), (384, 193.1))
_ROW_BUCKETS = (8, 16, 24, 32, 48, 64)


def _row_bucket(rows: int) -> int:
    """Row count the sampling loop runs for ``rows`` fold rows: the JAX
    package's bucket ladder, then multiples of 8 (``wavernn.py:336-345``).
    Bucketed rows are zero rows, dropped after sampling; the noise is drawn
    for the bucketed rows."""
    for b in _ROW_BUCKETS:
        if rows <= b:
            return b
    return -(-rows // 8) * 8


def _us_per_step(rows: int) -> float:
    """Piecewise-linear interpolation of the measured time a step, linear
    extrapolation beyond the table's last row count."""
    if rows <= _ROWS_US[0][0]:
        return _ROWS_US[0][1]
    for (r0, u0), (r1, u1) in zip(_ROWS_US, _ROWS_US[1:]):
        if rows <= r1:
            return u0 + (u1 - u0) * (rows - r0) / (r1 - r0)
    r1, u1 = _ROWS_US[-1]
    r0, u0 = _ROWS_US[-2]
    return u1 + (u1 - u0) / (r1 - r0) * (rows - r1)


def _fold_count(total_len: int, target: int, overlap: int) -> int:
    num_folds = max(0, (total_len - overlap) // (target + overlap))
    if total_len - (num_folds * (overlap + target) + overlap) != 0:
        num_folds += 1
    return max(num_folds, 1)


def _sampling_wall_model(total_len: int, target: int, overlap: int,
                         cfg: WaveRNNConfig | None = None,
                         cap: int | None = None) -> float:
    """Predicted kernel-1 time (us) of the geometry the caller runs:
    ``seq`` steps times the time a step of each pass.  With ``cap``, full
    ``cap``-row passes plus the row bucket of the remainder (batch
    serving's slabs: ``cap=_MAX_SLAB_ROWS``).  With ``cfg`` and no ``cap``,
    one pass at the fold rows' bucket, as :func:`_generate_program` runs
    it (kernel 1 takes any row count in one launch; the JAX package caps
    that pass at its TPU kernel's VMEM rows instead, ``_pallas_max_rows``,
    which has no counterpart here: ROADMAP, Queue 3, deliberate
    deviations).  With neither, passes of the table's last row count."""
    seq = target + 2 * overlap
    folds = _fold_count(total_len, target, overlap)
    if cap is None:
        if cfg is not None:
            return seq * _us_per_step(_row_bucket(folds))
        cap = _ROWS_US[-1][0]
    full, rem = divmod(folds, cap)
    us = full * _us_per_step(cap)
    if rem:
        us += _us_per_step(_row_bucket(rem))
    return seq * us


def auto_fold_target(total_len: int, overlap: int = 550,
                     cfg: WaveRNNConfig | None = None,
                     cap: int | None = None) -> int:
    """The ladder's fold length that minimises :func:`_sampling_wall_model`
    for ``total_len`` samples (the JAX ``auto_fold_target`` on this card's
    table): short audio folds shorter (more rows, fewer sequential steps),
    long audio keeps long folds.  ``cfg``: the single-generate caller's
    one pass; slab callers pass ``cap=_MAX_SLAB_ROWS``."""
    if total_len <= 0:
        return _TARGET_LADDER[0]
    return min(_TARGET_LADDER,
               key=lambda t: _sampling_wall_model(total_len, t, overlap,
                                                  cfg, cap))


def _fold_rows(x: torch.Tensor, target_f: int, overlap_f: int, margin: int):
    """(1, F, C) -> (num_folds, target_f + 2*overlap_f + 2*margin, C): the
    frame-rate image of the sample-rate fold, with ``margin`` extra frames
    a side (zero outside the sequence)."""
    _, Fr, Cc = x.shape
    base = max(0, (Fr - overlap_f) // (target_f + overlap_f))
    num_folds = _fold_count(Fr, target_f, overlap_f)
    if num_folds != base:
        remaining = Fr - (base * (overlap_f + target_f) + overlap_f)
        x = F.pad(x, (0, 0, 0, target_f + 2 * overlap_f - remaining))
    x = F.pad(x, (0, 0, margin, margin))
    length = target_f + 2 * overlap_f + 2 * margin
    return torch.stack([x[0, s:s + length]
                        for s in range(0, num_folds * (target_f + overlap_f),
                                       target_f + overlap_f)])


def _prepare_frame_conditioning(params: Params, mel: torch.Tensor,
                                cfg: WaveRNNConfig, target: int,
                                overlap: int, batched: bool,
                                aux_pre: torch.Tensor | None = None):
    """(mel_rows (B, fpf + 2J, feat), aux_rows (B, fpf, res_out)) for the
    sampling loop (``wavernn.py:762-794``).  ``aux_pre``: the utterance's
    MelResNet features (1, res_out, F), computed beforehand (batch serving
    runs one MelResNet pass over every utterance), else computed here."""
    S = cfg.total_scale
    J = _upsample_margin(params["upsample"]["up_convs"], cfg.upsample_factors)
    if aux_pre is None:
        aux = _mel_resnet(params["upsample"]["resnet"], pad_mel(mel, cfg.pad))
    else:
        aux = aux_pre
    aux = aux.transpose(1, 2)                         # (1, F, res_out)
    melT = mel.transpose(1, 2)                        # (1, F, feat)
    if not batched:
        return F.pad(melT, (0, 0, J, J)), aux
    if target % S or overlap % S:
        raise ValueError(
            f"fold geometry target={target}, overlap={overlap} must be a "
            f"multiple of total_scale={S} for the sampling kernel")
    return (_fold_rows(melT, target // S, overlap // S, J),
            _fold_rows(aux, target // S, overlap // S, 0))


def xfade_and_unfold_device(y: torch.Tensor, overlap: int) -> torch.Tensor:
    """Equal-power crossfade overlap-add of fold rows (num_folds, length):
    rows overlap their successor by ``overlap`` samples."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    stride = target + overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = torch.linspace(-1.0, 1.0, fade_len, dtype=y.dtype, device=y.device)
    fade_in = torch.cat([y.new_zeros(silence_len), torch.sqrt(0.5 * (1.0 + t))])
    fade_out = torch.cat([y.new_ones(silence_len), torch.sqrt(0.5 * (1.0 - t))])
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, length - overlap:] *= fade_out
    main = y[:, :stride].reshape(num_folds * stride)
    tails = F.pad(y[:, stride:], (0, stride - overlap, 0, 0))
    tails = F.pad(tails, (0, 0, 1, 0)).reshape(-1)
    return F.pad(main, (0, overlap)) + tails[:main.numel() + overlap]


def _finish(samples: torch.Tensor, overlap: int, wave_len: int, hop: int,
            batched: bool, mu_law: bool, n_classes: int) -> torch.Tensor:
    """mu-law expand -> unfold -> trim -> 20-hop linear fade-out."""
    if mu_law:
        samples = torch.sign(samples) / (n_classes - 1) * (
            n_classes ** torch.abs(samples) - 1)
    out = xfade_and_unfold_device(samples, overlap) if batched else samples[0]
    out = out[:wave_len].clone()
    L = int(out.shape[0])
    fade_n = min(20 * hop, L)
    fade = torch.linspace(1.0, 0.0, fade_n, dtype=out.dtype, device=out.device)
    out[L - fade_n:] *= fade
    return out


def _pcm16(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> int16 PCM (round, clip to +-32767)."""
    return torch.clamp(torch.round(x * 32767.0), -32767, 32767).to(
        torch.int16)


def _finish_many(samples: torch.Tensor, counts: tuple, wave_lens: tuple,
                 overlap: int, hop: int) -> torch.Tensor:
    """Batch serving's finish: per utterance (``counts[u]`` fold rows of
    ``samples``) crossfade-unfold, trim to ``wave_lens[u]`` and the 20-hop
    fade, then all utterances back to back as ONE flat int16 PCM array.
    As the JAX ``_finish_many``, no mu-law expand (``_finish`` has one)."""
    outs, row = [], 0
    for n_folds, wl in zip(counts, wave_lens):
        outs.append(_finish(samples[row:row + n_folds], overlap, wl, hop,
                            True, False, 0))
        row += n_folds
    return _pcm16(torch.cat(outs))


def _generate_program(params: Params, mel: torch.Tensor,
                      generator: torch.Generator | None, cfg: WaveRNNConfig,
                      target: int, overlap: int, batched: bool, mu_law: bool,
                      fast_math: bool, packed=None) -> torch.Tensor:
    """The mel (1, feat, F) -> waveform chain, on ``mel``'s device;
    ``packed``: the loop's weights from ``wavernn_kernels.pack_weights``
    (built per call when None)."""
    wave_len = (mel.shape[-1] - 1) * cfg.hop_length
    with profiling.span("vocoder/condition"):
        mel_rows, aux_rows = _prepare_frame_conditioning(
            params, mel, cfg, target, overlap, batched)
        n_folds = mel_rows.shape[0]
        bucket = _row_bucket(n_folds)
        if bucket != n_folds:
            mel_rows = F.pad(mel_rows, (0, 0, 0, 0, 0, bucket - n_folds))
            aux_rows = F.pad(aux_rows, (0, 0, 0, 0, 0, bucket - n_folds))
    samples = _sample(params, mel_rows, aux_rows, cfg, fast_math, generator,
                      packed)
    profiling.count("k1.samples", wave_len)
    with profiling.span("vocoder/finish"):
        return _finish(samples[:n_folds], overlap, wave_len, cfg.hop_length,
                       batched, mu_law, cfg.n_classes)


def _sample(params: Params, mel_rows: torch.Tensor, aux_rows: torch.Tensor,
            cfg: WaveRNNConfig, fast_math: bool,
            generator: torch.Generator | None, packed) -> torch.Tensor:
    """One pass of the sampling loop (``WK.generate_rows``) as span
    ``vocoder/sample``, counting its rows x steps (padding rows included)
    under ``k1.row_steps``."""
    with profiling.span("vocoder/sample"):
        samples = WK.generate_rows(params, mel_rows, aux_rows, cfg,
                                   fast_math, generator, packed)
    profiling.count("k1.row_steps", samples.shape[0] * samples.shape[1])
    return samples


def generate(params: Params, mel, cfg: WaveRNNConfig = WaveRNNConfig(),
             generator: torch.Generator | None = None,
             batched: bool | None = None, target: int | None = None,
             overlap: int | None = None, mu_law: bool | None = None,
             fast_math: bool = True, device=None, packed=None) -> np.ndarray:
    """Waveform (float32, length (F - 1) * hop_length) from a (1, feat, F)
    or (feat, F) mel.  Runs on the GPU unless ``device="cpu"``; ``params``
    must live on that device.  ``packed``: the loop's weights at
    ``fast_math`` (``wavernn_kernels.pack_weights``; built per call when
    None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        PREC.exact_f32()
    g = cfg.generate
    batched = g.batched if batched is None else batched
    overlap = g.overlap if overlap is None else overlap
    mu_law = (g.mu_law if mu_law is None else mu_law) and cfg.mode == "RAW"
    mel = torch.as_tensor(np.asarray(mel, np.float32)
                          if not isinstance(mel, torch.Tensor) else mel)
    mel = mel.to(dev, torch.float32)
    if mel.dim() == 2:
        mel = mel[None]
    if target == "auto" or (target is None and g.auto_target):
        target = auto_fold_target((mel.shape[-1] - 1) * cfg.hop_length,
                                  overlap, cfg)
    elif target is None:
        target = g.target
    out = _generate_program(params, mel, generator, cfg, target, overlap,
                            batched, mu_law, fast_math, packed)
    return out.cpu().numpy().astype(np.float32)


# Fold rows a sampling pass of batch serving takes at most: the JAX
# package's default slab, kept so that the slab geometry (and with it the
# noise drawn for each slab) is the JAX one; not a measurement of this
# port.
_MAX_SLAB_ROWS = 64


def _generate_many_program(params: Params, mels: tuple,
                           generator: torch.Generator | None,
                           cfg: WaveRNNConfig, target: int, overlap: int,
                           fast_math: bool, slab_rows: int | None = None,
                           packed=None) -> torch.Tensor:
    """Batch serving's vocoder pass (``wavernn.py:921-1003``): one
    MelResNet pass over every utterance (padded to the longest mel; valid
    convs and eval-mode BatchNorm make it exact per utterance), each
    utterance's frame-rate fold rows, the union of all folds padded to
    ``n_slabs x SLAB`` rows, one sampling pass a slab (the noise drawn slab
    by slab from ``generator``), then :func:`_finish_many`: the flat int16
    PCM of every utterance."""
    slab_rows = _MAX_SLAB_ROWS if slab_rows is None else slab_rows
    if not (slab_rows > 0 and slab_rows % 8 == 0):
        raise ValueError(f"slab_rows must be a positive multiple of 8, "
                         f"got {slab_rows}")
    with profiling.span("vocoder/condition"):
        aux_all = None
        if len(mels) > 1:
            Fmax = max(int(m.shape[-1]) for m in mels)
            stacked = torch.cat([F.pad(m, (0, Fmax - m.shape[-1]))
                                 for m in mels], dim=0)
            aux_all = _mel_resnet(params["upsample"]["resnet"],
                                  pad_mel(stacked, cfg.pad))
        conds, auxs, counts, wave_lens = [], [], [], []
        for u, mel in enumerate(mels):
            wave_lens.append((int(mel.shape[-1]) - 1) * cfg.hop_length)
            aux_pre = (None if aux_all is None
                       else aux_all[u:u + 1, :, :mel.shape[-1]])
            cond, aux = _prepare_frame_conditioning(
                params, mel, cfg, target, overlap, True, aux_pre)
            conds.append(cond)
            auxs.append(aux)
            counts.append(int(cond.shape[0]))
        cond = torch.cat(conds, dim=0)
        aux = torch.cat(auxs, dim=0)
        total_folds = int(cond.shape[0])
        SLAB = min(slab_rows, _row_bucket(total_folds))
        n_slabs = max(1, -(-total_folds // SLAB))
        padded = n_slabs * SLAB
        if padded != total_folds:
            cond = F.pad(cond, (0, 0, 0, 0, 0, padded - total_folds))
            aux = F.pad(aux, (0, 0, 0, 0, 0, padded - total_folds))
    slab_outs = [_sample(params, cond[s * SLAB:(s + 1) * SLAB],
                         aux[s * SLAB:(s + 1) * SLAB], cfg, fast_math,
                         generator, packed)
                 for s in range(n_slabs)]
    profiling.count("k1.samples", sum(wave_lens))
    with profiling.span("vocoder/finish"):
        samples = torch.cat(slab_outs, dim=0)[:total_folds]
        return _finish_many(samples, tuple(counts), tuple(wave_lens),
                            overlap, cfg.hop_length)


def generate_many(params: Params, mels, cfg: WaveRNNConfig = WaveRNNConfig(),
                  generator: torch.Generator | None = None,
                  target: int | None = None, overlap: int | None = None,
                  fast_math: bool = True, block: bool = True,
                  slab_rows: int | None = None, device=None, packed=None):
    """Vocode several utterances in one sampling loop over the union of
    their folds (the JAX ``generate_many``, with ``generator`` in place of
    ``key``; its ``unroll``, ``backend`` and ``interpret`` have no
    counterpart: the port has one sampling path).

    ``mels``: (feat, F) or (1, feat, F) arrays or tensors.  ``slab_rows``:
    fold rows a sampling pass (default ``_MAX_SLAB_ROWS``); ``packed`` as
    for :func:`generate`.  Runs on the GPU unless ``device="cpu"``;
    ``params`` live there.  Returns the float32 waveforms (length (F_i -
    1) * hop_length each), or with ``block=False`` a collector that returns
    them: the int16 copy to pinned host memory is then started behind a
    CUDA event (on the CPU it is immediate), so that the caller can
    dispatch the next batch before collecting this one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        PREC.exact_f32()
    g = cfg.generate
    overlap = g.overlap if overlap is None else overlap
    mels = tuple(
        (m if isinstance(m, torch.Tensor)
         else torch.from_numpy(np.asarray(m, np.float32))).to(
            dev, torch.float32).reshape(1, m.shape[-2], m.shape[-1])
        for m in mels)
    wave_lens = [(int(m.shape[-1]) - 1) * cfg.hop_length for m in mels]
    if target == "auto" or (target is None and g.auto_target):
        # pooled: every utterance's folds join one sampling batch in
        # slabs of _MAX_SLAB_ROWS rows, so price that tiling
        target = auto_fold_target(sum(wave_lens), overlap,
                                  cap=_MAX_SLAB_ROWS)
    elif target is None:
        target = g.target
    flat = _generate_many_program(params, mels, generator, cfg, target,
                                  overlap, fast_math, slab_rows, packed)
    if dev.type == "cuda":
        host = torch.empty(flat.shape, dtype=torch.int16, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(dev))
    else:
        host, copied = flat, None

    def collect():
        if copied is not None:
            copied.synchronize()
        pcm = host.numpy().astype(np.float32) / 32767.0
        offsets = np.cumsum([0] + wave_lens)
        return [pcm[a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    return collect() if block else collect
