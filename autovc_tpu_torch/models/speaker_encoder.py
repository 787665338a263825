"""GE2E speaker encoder: d-vector embedder and GE2E loss (counterpart of
``autovc_tpu/models/speaker_encoder.py``): 3-layer LSTM(40 -> 256) ->
Linear(256 -> 256) -> ReLU -> L2-normalise on the last layer's final h.

Embedding follows the JAX package's device path (``speaker_encoder.py:
155-182``) on every device: the wav padded to its partial slices and to a
1 s bucket, uploaded as PCM16, the power mel on the device, the partial
windows gathered at the utterance's true slice starts, rows padded to a
multiple of 32, one forward, and the per-utterance mean + L2-normalise.
:func:`learn_speaker` takes the JAX package's host path instead
(``embed_utterance(use_native=False)``): the numpy mel of
:func:`dsp.mel_spec_speaker_encoder_sliced`, then the forward on the
device.

Training (GE2E, section 2.1 of Wan et al., ICASSP 2018) runs the stack
through :func:`lstm_train_kernels.lstm_stack_train`: kernel 6 forward and
kernel 7 backward on CUDA, their plain versions on the CPU.  There is one
route, so a stack deeper than kernel 7's ``MAX_LAYERS`` raises on CUDA.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import SpeakerEncoderConfig
from autovc_tpu_torch.ops import conv as C
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import lstm_train_kernels as LT
from autovc_tpu_torch.ops import melspec as M
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.utils import resolve_device

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


def forward(params: Params, utterances: torch.Tensor,
            mode: str = "f32") -> torch.Tensor:
    """(B, n_frames, n_mels) -> L2-normalised embeddings (B, emb), f32.
    ``mode`` is the precision policy, which the JAX forward reads from its
    context: under bf16 the projections take bf16 operands and the stack
    runs at the scan's compute dtype (``lstm_kernels.lstm_stack_rec``)."""
    h = LK.lstm_stack_rec(params["lstm"], utterances, mode)[:, -1]
    raw = torch.relu(C.linear(params["linear"], h, mode))
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
                     device=None, block: bool = True):
    """d-vectors for several utterances (at the SE's sample rate) in one
    forward on ``device`` (None: the GPU, or raise; ``"cpu"`` on request).
    Returns a list of (emb,) float32 numpy arrays; with ``block=False``
    one (n_utts, emb) tensor on ``device`` instead (the per-utterance mean
    and L2-normalise on the device, nothing read back), which batch
    serving hands straight to the auto-encoder."""
    device = resolve_device(device)
    blocks = [_partial_rows(w, cfg, device) for w in wavs]
    counts = [int(b.shape[0]) for b in blocks]
    rows = torch.cat(blocks, dim=0)
    R_ = int(rows.shape[0])
    Rb = -(-R_ // 32) * 32
    if Rb != R_:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, Rb - R_))
    emb = forward(params, rows)
    if not block:
        raws = torch.stack([seg.mean(dim=0)
                            for seg in torch.split(emb[:R_], counts)])
        return raws / torch.linalg.norm(raws, dim=-1, keepdim=True)
    emb = emb.cpu().numpy()
    outs, r = [], 0
    for n in counts:
        raw = emb[r:r + n].mean(axis=0)
        r += n
        outs.append(raw / np.linalg.norm(raw, 2))
    return outs


def embed_utterance(params: Params, wav: np.ndarray,
                    cfg: SpeakerEncoderConfig = SpeakerEncoderConfig(),
                    device=None) -> np.ndarray:
    """Embedding of one utterance: :func:`embed_utterances` of one."""
    return embed_utterances(params, [wav], cfg, device)[0]


def similarity_matrix(params: Params, embeds: torch.Tensor) -> torch.Tensor:
    """GE2E similarity matrix, vectorised.  ``embeds`` (speakers S,
    utterances U, emb E), L2-normalised.  Returns (S, U, S) scaled cosine
    similarities: entry [j, u, k] compares utterance u of speaker j with
    the centroid of speaker k, the k == j case with the centroid that
    leaves the utterance out."""
    S, U, _ = embeds.shape
    incl = embeds.mean(dim=1)
    incl = incl / torch.linalg.norm(incl, dim=-1, keepdim=True)
    excl = (embeds.sum(dim=1, keepdim=True) - embeds) / (U - 1)
    excl = excl / torch.linalg.norm(excl, dim=-1, keepdim=True)
    sim_all = torch.einsum("jue,ke->juk", embeds, incl)
    sim_diag = torch.sum(embeds * excl, dim=-1)                # (S, U)
    eye = torch.eye(S, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(eye, sim_diag[:, :, None], sim_all)
    return sim * params["similarity_weight"] + params["similarity_bias"]


def ge2e_loss(params: Params, embeds: torch.Tensor) -> torch.Tensor:
    """GE2E softmax loss: cross-entropy of each utterance's similarity row
    against its speaker."""
    S, U, _ = embeds.shape
    sim = similarity_matrix(params, embeds).reshape(S * U, S)
    targets = torch.arange(S, device=embeds.device).repeat_interleave(U)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp[torch.arange(S * U, device=embeds.device), targets].mean()


def _forward_train(params: Params, utterances: torch.Tensor,
                   mode: str = "f32", model=None) -> torch.Tensor:
    """Training forward, the same function as :func:`forward`: the stack
    through ``lstm_stack_train`` (kernels 6/7 on CUDA; the compute dtype is
    ``PREC.lstm_kernel_dtype(mode, H)``), the last layer's final h, then
    ``relu(linear)`` and L2-normalise.  ``model`` (a
    ``parallel.tensor.ModelAxis``): the stack's per-step tensor-parallel
    loop and a column-parallel projection where their weights are this
    rank's shards; the similarity weight and bias stay whole."""
    _, (h, _) = LT.lstm_stack_train(params["lstm"], utterances, mode, model)
    raw = torch.relu(C.linear(params["linear"], h, mode, model))
    return raw / torch.linalg.norm(raw, dim=-1, keepdim=True)


def batch_ge2e_loss(params: Params, batch: torch.Tensor,
                    mode: str = "f32") -> torch.Tensor:
    """Loss of a mel block (S, U, frames, mels): every utterance embedded
    as one flat batch of S * U rows, then GE2E."""
    S, U, T, M = batch.shape
    embeds = _forward_train(params, batch.reshape(S * U, T, M),
                            mode).reshape(S, U, -1)
    return ge2e_loss(params, embeds)


def equal_error_rate(sim: np.ndarray) -> float:
    """Equal error rate of a similarity matrix (S, U, S): the false
    acceptance rate where it meets the false rejection rate (numpy copy of
    the JAX package's)."""
    S, U, _ = sim.shape
    labels = np.zeros((S, U, S), dtype=bool)
    for j in range(S):
        labels[j, :, j] = True
    scores = sim.reshape(-1)
    truth = labels.reshape(-1)
    order = np.argsort(-scores)
    truth = truth[order]
    tpr = np.cumsum(truth) / max(truth.sum(), 1)
    fpr = np.cumsum(~truth) / max((~truth).sum(), 1)
    return float(fpr[np.argmin(np.abs(fpr - (1 - tpr)))])


def learn_speaker(params: Params, wav_files,
                  cfg: SpeakerEncoderConfig = SpeakerEncoderConfig(),
                  device=None) -> np.ndarray:
    """Mean speaker embedding over wav files: each file loaded at the SE's
    sample rate, sliced into partials by the host mel, its rows embedded
    in f32 on ``device`` (None: the GPU, or raise; ``"cpu"`` on request;
    ``params`` live there), averaged and L2-normalised; then the mean of
    the files' d-vectors, not renormalised, as in the JAX package."""
    from autovc_tpu_torch.audio import io
    device = resolve_device(device)
    embeds = []
    for f in wav_files:
        wav, _ = io.load_wav(f, sr=cfg.spectrogram.sr)
        frames, _, _ = dsp.mel_spec_speaker_encoder_sliced(wav,
                                                           cfg.spectrogram)
        with torch.no_grad():
            rows = forward(params, torch.from_numpy(frames).to(device))
        raw = rows.cpu().numpy().mean(axis=0)
        embeds.append(raw / np.linalg.norm(raw, 2))
    return np.mean(np.stack(embeds), axis=0)
