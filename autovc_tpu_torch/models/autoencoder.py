"""AutoVC generator (counterpart of ``autovc_tpu/models/autoencoder.py``):
content encoder + bottleneck + decoder + postnet, channel-first
(B, n_mels, T).

Inference (``train=False``, eval-mode BatchNorm): the decoder's lstm2
(2 x 1024) is the kernel path: at most ``_LATENCY_KERNEL_MAX_ROWS`` rows go
to kernel 2 (:func:`autovc_tpu_torch.ops.lstm_kernels.lstm_stack_latency`),
more rows to kernel 3
(:func:`~autovc_tpu_torch.ops.lstm_kernels.lstm_stack_stream`), as
``autoencoder.py:174-185`` routes them on the TPU; lstm1 runs at the JAX
scan's compute dtype (:func:`~autovc_tpu_torch.ops.lstm_kernels.
lstm_stack_rec`: kernels 2/3 where that is bf16, else ``torch.lstm``).  Training (``train=True``): batch-statistics BatchNorm whose
running statistics move in place (:func:`autovc_tpu_torch.ops.conv.
batchnorm1d`), and both decoder stacks go through the training kernels 6
and 7 (:func:`autovc_tpu_torch.ops.lstm_train_kernels.lstm_stack_train`).
The encoder BLSTM is a plain recurrence in both.  ``mode`` is the
matmul/conv precision policy ("f32" or "bf16").

Batch serving (:func:`batch_forward_packed`) cuts every utterance's chunks
into slabs of the ladder ``_SLAB_LADDER`` on the plan of least measured
cost (:func:`_slab_plan` over ``_SLAB_MS``, the H100's own table), runs
each slab through :func:`convert_slab` (lstm2 on kernel 2 at 8 rows,
kernel 3 above) and merges the rows into one packed timeline at data
offsets (:func:`merge_rows`, ``index_add_``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from autovc_tpu_torch.config import AutoEncoderConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import lstm_train_kernels as LT
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
            freq: int, dim_neck: int, mode: str = "f32",
            train: bool = False, group=None):
    """(B, n_mels, T), (B, emb) -> (codes_fwd (B, n_fwd, neck),
    codes_bwd (B, n_bwd, neck)).  ``group``: sync BatchNorm over a
    process group's ranks in training (``conv.batchnorm1d``)."""
    T = x.shape[-1]
    h = torch.cat([x, c_org[:, :, None].expand(*c_org.shape, T)], dim=1)
    for p in params["convs"]:
        h = C.conv_bn(p, h, 5, activation=torch.relu, mode=mode, train=train,
                      group=group)
    out = R.bilstm_stack(params["blstm"], h.transpose(1, 2), mode)
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
            lstm2_packed=None, train: bool = False, group=None):
    """(B, T, 2*neck+emb) -> (B, T, n_mels).  ``lstm2_packed``: lstm2's
    inference kernel weights, ``lstm_kernels.pack(params["lstm2"], mode)``
    (built per call when None); ``group`` as for :func:`encoder`."""
    if train:
        h, _ = LT.lstm_stack_train(params["lstm1"], x, mode)
    else:
        h = LK.lstm_stack_rec(params["lstm1"], x, mode)
    h = h.transpose(1, 2)
    for p in params["convs"]:
        h = C.conv_bn(p, h, 5, activation=torch.relu, mode=mode, train=train,
                      group=group)
    h = h.transpose(1, 2)
    if train:
        h, _ = LT.lstm_stack_train(params["lstm2"], h, mode)
    elif h.shape[0] <= _LATENCY_KERNEL_MAX_ROWS:
        h = LK.lstm_stack_latency(params["lstm2"], h, mode, lstm2_packed)
    else:
        h = LK.lstm_stack_stream(params["lstm2"], h, mode, lstm2_packed)
    return C.linear(params["proj"], h, mode)


def postnet(params: Params, x: torch.Tensor, mode: str = "f32",
            train: bool = False, group=None):
    """(B, n_mels, T) -> residual (B, n_mels, T); tanh on all but the last
    conv; ``group`` as for :func:`encoder`."""
    h = x
    n = len(params["convs"])
    for i, p in enumerate(params["convs"]):
        h = C.conv_bn(p, h, 5, activation=torch.tanh if i < n - 1 else None,
                      mode=mode, train=train, group=group)
    return h


def _flatten_codes(codes_fwd, codes_bwd) -> torch.Tensor:
    B = codes_fwd.shape[0]
    return torch.cat([codes_fwd.reshape(B, -1), codes_bwd.reshape(B, -1)],
                     dim=-1)


def content_codes(params: Params, x: torch.Tensor, c_org: torch.Tensor,
                  cfg: AutoEncoderConfig, mode: str = "f32",
                  train: bool = False, group=None) -> torch.Tensor:
    """Encoder-only pass (the reference's ``forward(..., c_trg=None)``):
    the flattened content codes (B, (n_fwd + n_bwd) * neck)."""
    return _flatten_codes(*encoder(params["encoder"], x, c_org, cfg.freq,
                                   cfg.dim_neck, mode, train, group))


def forward(params: Params, x: torch.Tensor, c_org: torch.Tensor,
            c_trg: torch.Tensor, cfg: AutoEncoderConfig, mode: str = "f32",
            lstm2_packed=None, train: bool = False, group=None):
    """Full generator pass: (mel_decoder, mel_postnet, content_codes) with
    mels (B, n_mels, T); ``lstm2_packed`` as for :func:`decoder`,
    ``group`` as for :func:`encoder`."""
    T = x.shape[-1]
    codes_fwd, codes_bwd = encoder(params["encoder"], x, c_org, cfg.freq,
                                   cfg.dim_neck, mode, train, group)
    up = upsample_codes(codes_fwd, codes_bwd, cfg.freq, T)
    dec_in = torch.cat([up, c_trg[:, None, :].expand(x.shape[0], T, -1)],
                       dim=-1)
    mel_dec = decoder(params["decoder"], dec_in, mode, lstm2_packed,
                      train, group).transpose(1, 2)
    mel_post = mel_dec + postnet(params["postnet"], mel_dec, mode, train,
                                 group)
    return mel_dec, mel_post, _flatten_codes(codes_fwd, codes_bwd)


def loss(params: Params, x: torch.Tensor, c_org: torch.Tensor,
         cfg: AutoEncoderConfig, mu: float = 1.0, lambd: float = 1.0,
         mode: str = "f32", train: bool = True, group=None):
    """Three-term AutoVC loss (``autoencoder.py:274-294``):
    MSE(postnet, x) + mu * MSE(decoder, x) + lambd * L1(codes(recon),
    codes), the reconstruction's codes from the encoder re-run on the
    postnet output.  In training the BatchNorm statistics move twice, in
    the JAX package's order: the forward's, then the encoder's again on
    the re-run.  ``group``: sync BatchNorm over a process group (the
    terms stay means over this rank's rows).  Returns (loss, aux dict of
    device scalars)."""
    mel_dec, mel_post, codes = forward(params, x, c_org, c_org, cfg, mode,
                                       train=train, group=group)
    recon_codes = content_codes(params, mel_post, c_org, cfg, mode, train,
                                group)
    l_post = torch.mean((mel_post - x) ** 2)
    l_dec = torch.mean((mel_dec - x) ** 2)
    l_content = torch.mean(torch.abs(recon_codes - codes))
    total = l_post + mu * l_dec + lambd * l_content
    aux = {"loss": total, "loss_recon": l_post, "loss_recon0": l_dec,
           "loss_content": l_content}
    return total, aux


def _merge_chunks(mel_post: torch.Tensor, step: int) -> torch.Tensor:
    """Mean overlap-add of one utterance's converted chunks (M, n_mels, N)
    at hop ``step``: (n_mels, N + (M - 1) * step)."""
    M, n_mels, N = mel_post.shape
    total = N + (M - 1) * step
    acc = mel_post.new_zeros(n_mels, total)
    cnt = mel_post.new_zeros(1, total)
    for i in range(M):
        acc[:, i * step:i * step + N] += mel_post[i]
        cnt[:, i * step:i * step + N] += 1.0
    return acc / cnt


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
    return _merge_chunks(mel_post, int(N * (1 - overlap)))


def batch_forward_many(params: Params, chunks: torch.Tensor,
                       c_orgs: torch.Tensor, c_trg: torch.Tensor,
                       counts: tuple, cfg: AutoEncoderConfig,
                       overlap: float = 0.5, precision: str = "f32",
                       lstm2_packed=None):
    """Several utterances' chunks in one forward: ``chunks`` (rows, n_mels,
    N) stacks every utterance's chunks (rows beyond ``sum(counts)`` are
    padding), ``c_orgs`` (rows, emb) the source embedding of each row,
    ``c_trg`` (1, emb) the shared target.  Returns the list of merged
    (n_mels, T_i) mels, one per utterance."""
    rows, _, N = chunks.shape
    mode = PREC.resolve(precision, chunks.device)
    c_trg_b = c_trg.expand(rows, c_trg.shape[-1])
    _, mel_post, _ = forward(params, chunks, c_orgs, c_trg_b, cfg, mode,
                             lstm2_packed)
    step = int(N * (1 - overlap))
    outs, row = [], 0
    for M in counts:
        outs.append(_merge_chunks(mel_post[row:row + M], step))
        row += M
    return outs


# ---------------------------------------------------------------------------
# Batch serving: fixed-row slabs and a packed merge at data offsets
# ---------------------------------------------------------------------------


def convert_slab(params: Params, chunks: torch.Tensor, c_orgs: torch.Tensor,
                 c_trgs: torch.Tensor, cfg: AutoEncoderConfig,
                 precision: str = "f32", lstm2_packed=None) -> torch.Tensor:
    """One slab of chunk rows through the generator in eval mode:
    (S, n_mels, N) -> (S, n_mels, N) postnet mels.  Decoder lstm2 runs
    kernel 2 at a slab of at most 8 rows and kernel 3 above (the routing of
    :func:`decoder`); ``lstm2_packed`` as there."""
    mode = PREC.resolve(precision, chunks.device)
    _, mel_post, _ = forward(params, chunks, c_orgs, c_trgs, cfg, mode,
                             lstm2_packed)
    return mel_post


def merge_rows(mel_rows: torch.Tensor, offsets: torch.Tensor,
               out_frames: int) -> torch.Tensor:
    """Mean overlap-add of converted chunk rows (R, n_mels, N) at frame
    offsets (R,) (data, on the rows' device) into one (n_mels,
    out_frames) timeline.  Padding rows point at the trash window
    [out_frames, out_frames + N), which never reaches the output; frames
    no row covers stay 0."""
    R, n_mels, N = mel_rows.shape
    dev = mel_rows.device
    idx = (offsets.to(dev, torch.long)[:, None]
           + torch.arange(N, device=dev)[None, :]).reshape(-1)
    acc = mel_rows.new_zeros(n_mels, out_frames + N)
    acc.index_add_(1, idx, mel_rows.transpose(0, 1).reshape(n_mels, R * N))
    cnt = mel_rows.new_zeros(out_frames + N)
    cnt.index_add_(0, idx, mel_rows.new_ones(R * N))
    merged = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0),
                         torch.zeros_like(acc))
    return merged[:, :out_frames]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Slab sizes of batch serving: a workload is cut into slabs of these row
# counts, each one :func:`convert_slab` call.
_SLAB_LADDER = (8, 16, 32, 64, 128, 256)

# convert_slab wall (ms) at each ladder size: bf16, T = 400, full width,
# fresh seeded weights; chip_smoke.py's ``ae_slab_ms`` line (median of 5
# after a warm-up) on an NVIDIA H100 80GB HBM3, 700.00 W.  The cost a row
# falls to 64 rows (645 us) and is near flat beyond (612 at 128, 592 at
# 256): kernel 3 runs the row groups of 64 one after another.
_SLAB_MS = {8: 10.04, 16: 16.00, 32: 24.17, 64: 41.30, 128: 78.31,
            256: 151.63}


def _pick_slab(rows: int) -> int:
    """The uniform slab size of least measured cost ceil(rows / s) *
    _SLAB_MS[s]; ties go to the larger slab (fewer calls)."""
    return min(_SLAB_LADDER,
               key=lambda s: (-(-rows // s) * _SLAB_MS[s], -s))


@functools.lru_cache(maxsize=512)
def _slab_plan(rows: int) -> tuple:
    """The multiset of ladder slab sizes of least measured cost that covers
    at least ``rows`` rows (descending): a coin-change DP over 8-row
    quanta of the whole row count."""
    if rows <= 0:
        return (_SLAB_LADDER[0],)
    q = -(-rows // 8)
    INF = float("inf")
    best = [0.0] + [INF] * q
    choice = [0] * (q + 1)
    for n in range(1, q + 1):
        for s in _SLAB_LADDER:
            prev = max(0, n - s // 8)
            c = best[prev] + _SLAB_MS[s]
            if c < best[n]:
                best[n], choice[n] = c, s
    plan, n = [], q
    while n > 0:
        s = choice[n]
        plan.append(s)
        n = max(0, n - s // 8)
    return tuple(sorted(plan, reverse=True))


def batch_forward_packed(params: Params, chunk_sets, c_orgs, c_trg,
                         cfg: AutoEncoderConfig, overlap: float = 0.5,
                         precision: str = "f32", slab_rows: int | None = None,
                         gap: int = 0, frame_bucket: int = 256,
                         lstm2_packed=None):
    """Several utterances' chunks through slabs of the mixed plan
    (:func:`_slab_plan`, or ``slab_rows``-row slabs), merged into one
    packed mel timeline on the chunks' device.

    ``chunk_sets``: list of (M_i, n_mels, N) chunk tensors (hop N * (1 -
    overlap)); ``c_orgs``: list of (emb,) source embeddings (numpy) or one
    (n_utts, emb) tensor on the device; ``c_trg``: (1, emb) shared target.
    Padding rows get zero chunks and zero source embeddings.  ``gap`` zero
    frames sit before and after each utterance and the timeline is rounded
    up to ``frame_bucket`` frames.  Returns (packed (n_mels, Fp_b),
    starts, lengths): utterance u is packed[:, starts[u]:starts[u] +
    lengths[u]]."""
    n_mels, N = chunk_sets[0].shape[1:]
    dev = chunk_sets[0].device
    counts = [int(ch.shape[0]) for ch in chunk_sets]
    if slab_rows is None:
        plan = _slab_plan(sum(counts))
    else:
        if not (0 < slab_rows and slab_rows % 8 == 0):
            raise ValueError(f"slab_rows must be a positive multiple of 8, "
                             f"got {slab_rows}")
        plan = (slab_rows,) * max(1, -(-sum(counts) // slab_rows))
    step = int(N * (1 - overlap))
    lengths = [N + (m - 1) * step for m in counts]
    starts, o = [], gap
    for L in lengths:
        starts.append(o)
        o += L + 2 * gap
    Fp = starts[-1] + lengths[-1] + gap
    Fp_b = _round_up(Fp, frame_bucket)

    rows, R_b = sum(counts), sum(plan)
    stacked = torch.cat([ch.float() for ch in chunk_sets], dim=0)
    if R_b != rows:
        stacked = F.pad(stacked, (0, 0, 0, 0, 0, R_b - rows))
    offsets = np.full((R_b,), Fp_b, np.int64)          # the trash window
    r = 0
    for u, m in enumerate(counts):
        offsets[r:r + m] = starts[u] + np.arange(m) * step
        r += m
    if not isinstance(c_orgs, torch.Tensor):
        c_orgs = torch.as_tensor(np.stack(c_orgs), dtype=torch.float32,
                                 device=dev)
    # the per-row block is built on the device: with device embeddings the
    # speaker encoder -> generator chain never reads back
    c_rows = F.pad(torch.cat([c_orgs[u].float()[None].expand(m, -1)
                              for u, m in enumerate(counts)]),
                   (0, 0, 0, R_b - rows))
    c_trg_row = torch.as_tensor(c_trg, dtype=torch.float32,
                                device=dev).reshape(1, -1)
    mel_rows, s = [], 0
    for sz in plan:
        mel_rows.append(convert_slab(
            params, stacked[s:s + sz], c_rows[s:s + sz],
            c_trg_row.expand(sz, -1), cfg, precision, lstm2_packed))
        s += sz
    mel_rows = torch.cat(mel_rows, dim=0)
    packed = merge_rows(mel_rows, torch.from_numpy(offsets).to(dev), Fp_b)
    return packed, starts, lengths


def infer(params: Params, x: torch.Tensor, c_org: torch.Tensor,
          c_trg: torch.Tensor, cfg: AutoEncoderConfig,
          precision: str = "f32", lstm2_packed=None) -> torch.Tensor:
    """The eval-mode postnet mel of whole (unchunked) mels (B, n_mels, T),
    the ``cut=False`` path; ``lstm2_packed`` as for :func:`decoder`."""
    mode = PREC.resolve(precision, x.device)
    _, mel_post, _ = forward(params, x, c_org, c_trg, cfg, mode,
                             lstm2_packed)
    return mel_post
