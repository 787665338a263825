"""WaveRNN vocoder, generation only (counterpart of
``autovc_tpu/models/wavernn.py``).

The chain is the JAX package's accelerator path (``_generate_program``,
its pallas branch): MelResNet conditioning at frame rate, the fold of the
mel frames into overlapping rows (``_fold_rows``, J zero-filled margin
frames each side), the rows padded to a row bucket, the sampling loop
(:func:`autovc_tpu_torch.ops.wavernn_kernels.generate_rows`: kernel 1 on
the GPU), then crossfade-unfold, trim and fade (:func:`_finish`).
``batched=False`` is the same kernel at one row.

Known deviations from the JAX package: ``auto_target`` takes the fixed
reference geometry (the JAX fold picker scores fold lengths with TPU
timings), and a fold geometry that is not a multiple of ``total_scale``
raises (the JAX package falls back to its XLA scan there; the port has no
second sampling path).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.utils import resolve_device

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


def _mel_resnet(params: Params, m: torch.Tensor) -> torch.Tensor:
    """(B, feat, F) -> (B, res_out, F - 2*pad): valid conv, then 1x1
    residual blocks (eval-mode BatchNorm)."""
    x = torch.relu(C.batchnorm1d(params["bn_in"],
                                 C.conv1d(params["conv_in"], m)))
    for blk in params["blocks"]:
        h = torch.relu(C.batchnorm1d(blk["bn1"], C.conv1d(blk["conv1"], x)))
        h = C.batchnorm1d(blk["bn2"], C.conv1d(blk["conv2"], h))
        x = x + h
    return C.conv1d(params["conv_out"], x)


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

    Returns (K (2J+1, S) f32 on the CPU, J), the chain's impulse response
    (``wavernn.py:116-149``)."""
    S = int(np.prod(factors))
    J = _upsample_margin(up_convs, factors)
    x = torch.zeros(1, 1, 2 * J + 1)
    x[..., J] = 1.0
    for w, s in zip(up_convs, factors):
        x = torch.repeat_interleave(x, s, dim=-1)
        x = F.conv1d(x, w.detach().float().cpu().reshape(1, 1, -1), padding=s)
    r = x[0, 0]
    K = torch.stack([r[(J + j) * S:(J + j + 1) * S] for j in range(-J, J + 1)])
    return K, J


def pad_mel(mel: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the mel time axis on both sides."""
    return F.pad(mel, (pad, pad))


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


def _fold_count(total_len: int, target: int, overlap: int) -> int:
    num_folds = max(0, (total_len - overlap) // (target + overlap))
    if total_len - (num_folds * (overlap + target) + overlap) != 0:
        num_folds += 1
    return max(num_folds, 1)


def auto_fold_target(total_len: int, overlap: int = 550,
                     cfg: WaveRNNConfig | None = None) -> int:
    """Fold length for ``total_len`` samples.  The JAX package picks it
    with a TPU timing table; until the GPU has its own table this returns
    the reference's fixed ``target`` (11000 by default)."""
    return (cfg or WaveRNNConfig()).generate.target


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
                                overlap: int, batched: bool):
    """(mel_rows (B, fpf + 2J, feat), aux_rows (B, fpf, res_out)) for the
    sampling loop (``wavernn.py:762-794``)."""
    S = cfg.total_scale
    J = _upsample_margin(params["upsample"]["up_convs"], cfg.upsample_factors)
    aux = _mel_resnet(params["upsample"]["resnet"], pad_mel(mel, cfg.pad))
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


def _generate_program(params: Params, mel: torch.Tensor,
                      generator: torch.Generator | None, cfg: WaveRNNConfig,
                      target: int, overlap: int, batched: bool, mu_law: bool,
                      fast_math: bool, packed=None) -> torch.Tensor:
    """The mel (1, feat, F) -> waveform chain, on ``mel``'s device;
    ``packed``: the loop's weights from ``wavernn_kernels.pack_weights``
    (built per call when None)."""
    wave_len = (mel.shape[-1] - 1) * cfg.hop_length
    mel_rows, aux_rows = _prepare_frame_conditioning(
        params, mel, cfg, target, overlap, batched)
    n_folds = mel_rows.shape[0]
    bucket = _row_bucket(n_folds)
    if bucket != n_folds:
        mel_rows = F.pad(mel_rows, (0, 0, 0, 0, 0, bucket - n_folds))
        aux_rows = F.pad(aux_rows, (0, 0, 0, 0, 0, bucket - n_folds))
    samples = WK.generate_rows(params, mel_rows, aux_rows, cfg, fast_math,
                               generator, packed)
    return _finish(samples[:n_folds], overlap, wave_len, cfg.hop_length,
                   batched, mu_law, cfg.n_classes)


def generate(params: Params, mel, cfg: WaveRNNConfig = WaveRNNConfig(),
             generator: torch.Generator | None = None,
             batched: bool | None = None, target: int | None = None,
             overlap: int | None = None, mu_law: bool | None = None,
             fast_math: bool = True, device=None) -> np.ndarray:
    """Waveform (float32, length (F - 1) * hop_length) from a (1, feat, F)
    or (feat, F) mel.  Runs on the GPU unless ``device="cpu"``; ``params``
    must live on that device."""
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
                            batched, mu_law, fast_math)
    return out.cpu().numpy().astype(np.float32)
