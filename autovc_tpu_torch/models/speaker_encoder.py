"""GE2E speaker encoder, inference only (counterpart of
``autovc_tpu/models/speaker_encoder.py``): 3-layer LSTM(40 -> 256) ->
Linear(256 -> 256) -> ReLU -> L2-normalise on the last layer's final h.

Embedding follows the JAX package's device path (``speaker_encoder.py:
155-182``) on every device: the wav padded to its partial slices and to a
1 s bucket, uploaded as PCM16, the power mel on the device, the partial
windows gathered at the utterance's true slice starts, rows padded to a
multiple of 32, one forward, and the per-utterance mean + L2-normalise.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import SpeakerEncoderConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import melspec as M
from autovc_tpu_torch.ops import rnn as R

Params = Dict[str, Any]


def init(gen: torch.Generator,
         cfg: SpeakerEncoderConfig = SpeakerEncoderConfig()) -> Params:
    """Fresh parameters with the JAX ``speaker_encoder.init`` layout."""
    return {
        "lstm": R.init_lstm_stack(gen, cfg.input_size, cfg.hidden_size,
                                  cfg.num_layers),
        "linear": C.init_linear(gen, cfg.hidden_size, cfg.embedding_size),
        "similarity_weight": torch.tensor(10.0),
        "similarity_bias": torch.tensor(-5.0),
    }


def forward(params: Params, utterances: torch.Tensor) -> torch.Tensor:
    """(B, n_frames, n_mels) -> L2-normalised embeddings (B, emb), f32."""
    _, (h, _), _ = R.lstm_stack_skewed(params["lstm"], utterances)
    raw = torch.relu(C.linear(params["linear"], h))
    return raw / torch.linalg.norm(raw, dim=-1, keepdim=True)


@functools.lru_cache(maxsize=64)
def _bucket_partials(n_samples: int, sr: int, n_frames: int,
                     mel_window_step: float) -> int:
    """Partial count of a full bucket-length wav."""
    _, mel_slices = dsp.compute_partial_slices(
        n_samples, sr, partial_utterance_n_frames=n_frames,
        mel_window_step=mel_window_step)
    return len(mel_slices)


def _partial_rows(wav: np.ndarray, cfg: SpeakerEncoderConfig, device):
    """(n_partials, frames, n_mels) partial windows of one utterance."""
    sp = cfg.spectrogram
    n = sp.partial_utterance_n_frames
    wav_slices, mel_slices = dsp.compute_partial_slices(
        len(wav), sp.sr, partial_utterance_n_frames=n,
        mel_window_step=sp.mel_window_step)
    wav_p = dsp.pad_for_slices(np.asarray(wav, np.float32), wav_slices)
    Lb = -(-len(wav_p) // sp.sr) * sp.sr              # 1 s buckets
    p_max = _bucket_partials(Lb, sp.sr, n, sp.mel_window_step)
    starts = np.zeros(p_max, np.int64)
    true = [int(s.start) for s in mel_slices]
    starts[:len(true)] = true
    wav_i16 = M.pcm16_quantise(np.pad(wav_p, (0, Lb - len(wav_p))))
    mel = M.mel_spec_speaker_encoder(
        torch.from_numpy(wav_i16).to(device), sp)        # (F, n_mels)
    idx = torch.from_numpy(starts).to(device)[:, None] + torch.arange(
        n, device=device)[None, :]
    return mel[idx][:len(true)]


def embed_utterances(params: Params, wavs,
                     cfg: SpeakerEncoderConfig = SpeakerEncoderConfig(),
                     device="cpu"):
    """d-vectors for several utterances (at the SE's sample rate) in one
    forward.  Returns a list of (emb,) float32 numpy arrays."""
    blocks = [_partial_rows(w, cfg, device) for w in wavs]
    counts = [int(b.shape[0]) for b in blocks]
    rows = torch.cat(blocks, dim=0)
    R_ = int(rows.shape[0])
    Rb = -(-R_ // 32) * 32
    if Rb != R_:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, Rb - R_))
    emb = forward(params, rows).cpu().numpy()
    outs, r = [], 0
    for n in counts:
        raw = emb[r:r + n].mean(axis=0)
        r += n
        outs.append(raw / np.linalg.norm(raw, 2))
    return outs


def embed_utterance(params: Params, wav: np.ndarray,
                    cfg: SpeakerEncoderConfig = SpeakerEncoderConfig(),
                    device="cpu") -> np.ndarray:
    """Embedding of one utterance: :func:`embed_utterances` of one."""
    return embed_utterances(params, [wav], cfg, device)[0]
