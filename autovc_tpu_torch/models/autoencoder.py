"""AutoVC generator, inference only (counterpart of
``autovc_tpu/models/autoencoder.py``): content encoder + bottleneck +
decoder + postnet, channel-first (B, n_mels, T), eval-mode BatchNorm.

The decoder's lstm2 (2 x 1024) is the kernel path: at most
``_LATENCY_KERNEL_MAX_ROWS`` rows go to kernel 2
(:func:`autovc_tpu_torch.ops.lstm_kernels.lstm_stack_latency`), more rows to
kernel 3 (:func:`~autovc_tpu_torch.ops.lstm_kernels.lstm_stack_stream`),
as ``autoencoder.py:174-185`` routes them on the TPU.  The encoder BLSTM
and lstm1 are plain recurrences (:mod:`autovc_tpu_torch.ops.rnn`).
``mode`` is the matmul/conv precision policy ("f32" or "bf16").
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from autovc_tpu_torch.config import AutoEncoderConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R

Params = Dict[str, Any]

_LATENCY_KERNEL_MAX_ROWS = LK.LATENCY_MAX_ROWS


def init(gen: torch.Generator,
         cfg: AutoEncoderConfig = AutoEncoderConfig()) -> Params:
    """Fresh parameters with the JAX ``autoencoder.init`` shapes and
    layout."""
    n_mels = cfg.n_mels
    enc_convs = [
        C.init_conv_bn(gen, n_mels + cfg.dim_emb, 512, 5, "relu"),
        C.init_conv_bn(gen, 512, 512, 5, "relu"),
        C.init_conv_bn(gen, 512, 512, 5, "relu"),
    ]
    enc_blstm = R.init_bilstm_stack(gen, 512, cfg.dim_neck, 2)
    dec_in = 2 * cfg.dim_neck + cfg.dim_emb
    dec_lstm1 = R.init_lstm_stack(gen, dec_in, cfg.dim_pre, 1)
    dec_convs = [C.init_conv_bn(gen, cfg.dim_pre, cfg.dim_pre, 5, "relu")
                 for _ in range(3)]
    dec_lstm2 = R.init_lstm_stack(gen, cfg.dim_pre, 1024, 2)
    dec_proj = C.init_linear(gen, 1024, n_mels)
    post_convs = [
        C.init_conv_bn(gen, n_mels, 512, 5, "tanh"),
        C.init_conv_bn(gen, 512, 512, 5, "tanh"),
        C.init_conv_bn(gen, 512, 512, 5, "tanh"),
        C.init_conv_bn(gen, 512, 512, 5, "tanh"),
        C.init_conv_bn(gen, 512, n_mels, 5, "linear"),
    ]
    return {
        "encoder": {"convs": enc_convs, "blstm": enc_blstm},
        "decoder": {"lstm1": dec_lstm1, "convs": dec_convs,
                    "lstm2": dec_lstm2, "proj": dec_proj},
        "postnet": {"convs": post_convs},
    }


def encoder(params: Params, x: torch.Tensor, c_org: torch.Tensor,
            freq: int, dim_neck: int, mode: str = "f32"):
    """(B, n_mels, T), (B, emb) -> (codes_fwd (B, n_fwd, neck),
    codes_bwd (B, n_bwd, neck))."""
    T = x.shape[-1]
    h = torch.cat([x, c_org[:, :, None].expand(*c_org.shape, T)], dim=1)
    for p in params["convs"]:
        h = C.conv_bn(p, h, 5, activation=torch.relu, mode=mode)
    out = R.bilstm_stack(params["blstm"], h.transpose(1, 2))
    out_f, out_b = out[..., :dim_neck], out[..., dim_neck:]
    return out_f[:, freq - 1::freq, :], out_b[:, ::freq, :]


def upsample_codes(codes_fwd: torch.Tensor, codes_bwd: torch.Tensor,
                   freq: int, T: int) -> torch.Tensor:
    """Repeat each code over ``freq`` frames, extend the last forward code
    over the tail, truncate the backward expansion to T: (B, T, 2*neck)."""
    up_f = torch.repeat_interleave(codes_fwd, freq, dim=1)
    tail = T - up_f.shape[1]
    if tail > 0:
        up_f = torch.cat([up_f, codes_fwd[:, -1:, :].expand(
            -1, tail, -1)], dim=1)
    up_b = torch.repeat_interleave(codes_bwd, freq, dim=1)[:, :T, :]
    return torch.cat([up_f, up_b], dim=-1)


def decoder(params: Params, x: torch.Tensor, mode: str = "f32",
            lstm2_packed=None):
    """(B, T, 2*neck+emb) -> (B, T, n_mels).  ``lstm2_packed``: lstm2's
    kernel weights, ``lstm_kernels.pack(params["lstm2"], mode)`` (built per
    call when None)."""
    h, _, _ = R.lstm_stack(params["lstm1"], x)
    h = h.transpose(1, 2)
    for p in params["convs"]:
        h = C.conv_bn(p, h, 5, activation=torch.relu, mode=mode)
    h = h.transpose(1, 2)
    if h.shape[0] <= _LATENCY_KERNEL_MAX_ROWS:
        h = LK.lstm_stack_latency(params["lstm2"], h, mode, lstm2_packed)
    else:
        h = LK.lstm_stack_stream(params["lstm2"], h, mode, lstm2_packed)
    return C.linear(params["proj"], h, mode)


def postnet(params: Params, x: torch.Tensor, mode: str = "f32"):
    """(B, n_mels, T) -> residual (B, n_mels, T); tanh on all but the last
    conv."""
    h = x
    n = len(params["convs"])
    for i, p in enumerate(params["convs"]):
        h = C.conv_bn(p, h, 5, activation=torch.tanh if i < n - 1 else None,
                      mode=mode)
    return h


def _flatten_codes(codes_fwd, codes_bwd) -> torch.Tensor:
    B = codes_fwd.shape[0]
    return torch.cat([codes_fwd.reshape(B, -1), codes_bwd.reshape(B, -1)],
                     dim=-1)


def forward(params: Params, x: torch.Tensor, c_org: torch.Tensor,
            c_trg: torch.Tensor, cfg: AutoEncoderConfig, mode: str = "f32",
            lstm2_packed=None):
    """Full generator pass: (mel_decoder, mel_postnet, content_codes) with
    mels (B, n_mels, T); ``lstm2_packed`` as for :func:`decoder`."""
    T = x.shape[-1]
    codes_fwd, codes_bwd = encoder(params["encoder"], x, c_org, cfg.freq,
                                   cfg.dim_neck, mode)
    up = upsample_codes(codes_fwd, codes_bwd, cfg.freq, T)
    dec_in = torch.cat([up, c_trg[:, None, :].expand(x.shape[0], T, -1)],
                       dim=-1)
    mel_dec = decoder(params["decoder"], dec_in, mode,
                      lstm2_packed).transpose(1, 2)
    mel_post = mel_dec + postnet(params["postnet"], mel_dec, mode)
    return mel_dec, mel_post, _flatten_codes(codes_fwd, codes_bwd)


def batch_forward(params: Params, chunks: torch.Tensor, c_org: torch.Tensor,
                  c_trg: torch.Tensor, cfg: AutoEncoderConfig,
                  overlap: float = 0.5, precision: str = "f32",
                  lstm2_packed=None):
    """Convert overlapping mel chunks (M, n_mels, N) as one batch and merge
    them by mean overlap-add: (n_mels, N + (M - 1) * N * (1 - overlap)).
    ``precision``: "f32", "bf16" or "auto" (bf16 on the GPU);
    ``lstm2_packed`` as for :func:`decoder`, at that precision."""
    M, n_mels, N = chunks.shape
    mode = PREC.resolve(precision, chunks.device)
    c_org = c_org.expand(M, c_org.shape[-1])
    c_trg = c_trg.expand(M, c_trg.shape[-1])
    _, mel_post, _ = forward(params, chunks, c_org, c_trg, cfg, mode,
                             lstm2_packed)
    step = int(N * (1 - overlap))
    total = N + (M - 1) * step
    acc = mel_post.new_zeros(n_mels, total)
    cnt = mel_post.new_zeros(1, total)
    for i in range(M):
        acc[:, i * step:i * step + N] += mel_post[i]
        cnt[:, i * step:i * step + N] += 1.0
    return acc / cnt
