"""The benchmark's yardstick: the H100's published peaks and the operation
and byte counts of the work a cell asks for, from the shapes alone.

Conventions: a (M, K) x (K, N) product counts 2 M K N operations; an FFT
of n points 5 n log2(n); bytes are each input read once and each output
written once.  The counts are of the work the inputs need: fold overlap,
row padding and repeated reads are the program's choices and are not
counted.  Nothing here reads a clock or a table of measured times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    name: str
    bf16_flops: float      # dense tensor-core rate, bf16 operands
    f32_flops: float       # float32 outside the tensor cores
    hbm_bytes: float       # HBM bytes a second


# NVIDIA H100 SXM data sheet, at its maximum power: dense rates (half the
# with-sparsity figure), float32 without TF32, HBM bandwidth.  Matched
# against torch.cuda.get_device_name(); the cells run on this part alone.
_PEAKS = (
    ("h100 80gb hbm3", Peaks("NVIDIA H100 SXM", 989e12, 67e12, 3.35e12)),
    ("h100 sxm", Peaks("NVIDIA H100 SXM", 989e12, 67e12, 3.35e12)),
)


def peaks(device_name: str) -> Peaks:
    """The peaks of the card named ``device_name``; a card outside the
    table raises (a made-up peak gives made-up shares)."""
    kind = device_name.lower()
    for key, p in _PEAKS:
        if key in kind:
            return p
    raise ValueError(f"no peak table for {device_name!r}")


def matmul(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def conv1d(batch: int, t: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * batch * t * c_in * c_out * k


def lstm(batch: int, t: int, d_in: int, hidden: int) -> int:
    return 2 * batch * t * 4 * hidden * (d_in + hidden)


def gru(batch: int, t: int, d_in: int, hidden: int) -> int:
    return 2 * batch * t * 3 * hidden * (d_in + hidden)


def fft(n: int) -> float:
    return 5.0 * n * math.log2(n)


def mel_flops(frames: int, n_fft: int, n_mels: int) -> float:
    """A mel front-end over ``frames`` frames: window, real FFT (half of a
    complex one), magnitude, mel projection, log."""
    bins = n_fft // 2 + 1
    return frames * (n_fft + fft(n_fft) / 2 + 4 * bins
                     + 2 * bins * n_mels + 4 * n_mels)


def encoder_flops(ae: dict, batch: int, t: int) -> int:
    """The AutoVC content encoder: three 5-wide convs and the 2-layer
    BLSTM."""
    n, e, neck = ae["n_mels"], ae["dim_emb"], ae["dim_neck"]
    return (conv1d(batch, t, n + e, 512, 5) + 2 * conv1d(batch, t, 512, 512, 5)
            + 2 * lstm(batch, t, 512, neck) + 2 * lstm(batch, t, 2 * neck,
                                                       neck))


def generator_flops(ae: dict, batch: int, t: int) -> int:
    """The AutoVC generator's forward over (batch, n_mels, t)."""
    n, e, p, neck = ae["n_mels"], ae["dim_emb"], ae["dim_pre"], ae["dim_neck"]
    return (encoder_flops(ae, batch, t)
            + lstm(batch, t, 2 * neck + e, p) + 3 * conv1d(batch, t, p, p, 5)
            + lstm(batch, t, p, 1024) + lstm(batch, t, 1024, 1024)
            + matmul(batch * t, 1024, n)
            + conv1d(batch, t, n, 512, 5) + 3 * conv1d(batch, t, 512, 512, 5)
            + conv1d(batch, t, 512, n, 5))


def generator_params(ae: dict) -> int:
    n, e, p, neck = ae["n_mels"], ae["dim_emb"], ae["dim_pre"], ae["dim_neck"]

    def lstm_p(i, h):
        return 4 * h * (i + h) + 8 * h

    def conv_p(i, o):
        return i * o * 5 + o + 4 * o

    return (conv_p(n + e, 512) + 2 * conv_p(512, 512)
            + 2 * lstm_p(512, neck) + 2 * lstm_p(2 * neck, neck)
            + lstm_p(2 * neck + e, p) + 3 * conv_p(p, p) + lstm_p(p, 1024)
            + lstm_p(1024, 1024) + 1024 * n + n + conv_p(n, 512)
            + 3 * conv_p(512, 512) + conv_p(512, n))


def train_step_flops(ae: dict, batch: int, t: int) -> int:
    """One generator training step: the forward, the re-encode of the
    postnet output, their backward at twice their forward, and Adam with
    the global-norm clip (about 16 operations a parameter)."""
    fwd = generator_flops(ae, batch, t) + encoder_flops(ae, batch, t)
    return 3 * fwd + 16 * generator_params(ae)


def decoder_lstm_kernel_flops(ae: dict, batch: int, t: int) -> int:
    """What kernels 6 and 7 (with their dW tiles) compute in one training
    step: decoder lstm1 (1 x dim_pre) and lstm2 (2 x 1024), forward and
    backward, without layer 0's hoisted input projection and its
    gradient.  Forward: the recurrent product of every layer and the input
    product of layers >= 1; backward: the same two products for dh and the
    dW of each."""
    out = 0
    for layers, h in ((1, ae["dim_pre"]), (2, 1024)):
        fwd = layers * matmul(batch * t, h, 4 * h) + (layers - 1) * matmul(
            batch * t, h, 4 * h)
        out += 3 * fwd
    return out


def decoder_lstm_kernel_bytes(ae: dict, batch: int, t: int) -> int:
    """Bytes of the same work, each read once and written once: the bf16
    weights, layer 0's f32 pre-activations and the outputs; the saved f32
    h and c and the bf16 gates written forward and read backward; the
    output cotangents read, the input cotangents and the f32 gradients
    written."""
    out = 0
    for layers, h in ((1, ae["dim_pre"]), (2, 1024)):
        weights = 2 * (layers * 4 * h * h + (layers - 1) * 4 * h * h)
        rows = batch * t
        saved = layers * rows * h * (4 + 4 + 2 * 4)
        out += (2 * weights + rows * 4 * h * 4 + rows * h * 4 + 2 * saved
                + rows * h * 4 + rows * 4 * h * 4 + 2 * weights)
    return out


def speaker_encoder_flops(se: dict, rows: int, t: int) -> int:
    h, i, e = se["hidden_size"], se["input_size"], se["embedding_size"]
    return (lstm(rows, t, i, h) + (se["num_layers"] - 1) * lstm(rows, t, h, h)
            + matmul(rows, h, e))


def n_classes(voc: dict) -> int:
    return 30 if voc["mode"] == "MOL" else 2 ** voc["bits"]


def pick_lanes(voc: dict) -> int:
    return n_classes(voc) if voc["mode"] == "RAW" else n_classes(voc) // 3


def band_taps(voc: dict) -> int:
    """W = 2J + 1, the frames one sample's conditioning reads through the
    upsample chain of (1, 2s + 1) smoothing convolutions."""
    S = math.prod(voc["upsample_factors"])
    reach, rem = 0, S
    for s in voc["upsample_factors"]:
        rem //= s
        reach += s * rem
    return 2 * (-(-reach // S)) + 1


def wavernn_sample_flops(voc: dict) -> int:
    """One output sample of the sampling loop: GRU1 and GRU2 (input and
    hidden products), fc1, fc2, fc3 at the configuration's classes, and the
    banded upsample of the mel projection."""
    rd, fc = voc["rnn_dims"], voc["fc_dims"]
    return (2 * (4 * rd * 3 * rd + rd * fc + fc * fc + fc * n_classes(voc))
            + 2 * band_taps(voc) * rd)


def wavernn_frame_flops(voc: dict) -> int:
    """One mel frame of the vocoder's frame-rate work: the MelResNet and
    the frame projections (mel, and the four aux slices into I, GRU2,
    fc1, fc2)."""
    feat, cd, ro = voc["feat_dims"], voc["compute_dims"], voc["res_out_dims"]
    rd, fc, ad = voc["rnn_dims"], voc["fc_dims"], voc["res_out_dims"] // 4
    pad = voc["pad"]
    return (conv1d(1, 1, feat, cd, 2 * pad + 1)
            + voc["res_blocks"] * 2 * conv1d(1, 1, cd, cd, 1)
            + conv1d(1, 1, cd, ro, 1)
            + matmul(1, feat, rd) + matmul(1, ad, rd) + matmul(1, ad, 3 * rd)
            + 2 * matmul(1, ad, fc))


def kernel1_bytes(voc: dict, rows: int, steps: int) -> int:
    """Kernel 1 over ``rows`` rows x ``steps`` steps, each byte once: the
    bf16 weights; the f32 frame inputs of the rows; the f32 noise (pick
    lanes and one logistic value a step and row) and the f32 samples."""
    rd, fc, nc = voc["rnn_dims"], voc["fc_dims"], n_classes(voc)
    S = math.prod(voc["upsample_factors"])
    frames = steps // S + band_taps(voc) - 1
    weights = 2 * (4 * rd * 3 * rd + rd * fc + fc * fc + fc * nc)
    frame_in = 4 * rows * (frames * rd + (steps // S) * (4 * rd + 2 * fc))
    return (weights + frame_in + 4 * rows * steps * (pick_lanes(voc) + 1)
            + 4 * rows * steps)


def embed_flops(cfg: dict, frames: int, partials: int) -> float:
    """A speaker embedding: the power mel of ``frames`` frames and the
    encoder over ``partials`` partial windows."""
    se = cfg["speaker_encoder"]
    ssp = se["spectrogram"]
    se_fft = int(ssp["sr"] * ssp["mel_window_length"] / 1000)
    return (mel_flops(frames, se_fft, ssp["n_mels"])
            + speaker_encoder_flops(se, partials, ssp["partial_utterance_n_frames"]))


def conversion_flops(cfg: dict, mel_frames: int, chunks: int,
                     samples_out: int, se_frames: int,
                     se_partials: int) -> float:
    """Useful operations of converting one utterance: the AE mel of its
    chunked span (``mel_frames``), the source's speaker embedding, the
    generator over its ``chunks`` chunks, and the vocoder over every
    output sample and frame."""
    ae, voc = cfg["auto_encoder"], cfg["vocoder"]
    sp = ae["spectrogram"]
    frames_out = samples_out // voc["hop_length"] + 1
    return (mel_flops(mel_frames, sp["n_fft"], sp["n_mels"])
            + embed_flops(cfg, se_frames, se_partials)
            + generator_flops(ae, chunks, sp["partial_utterance_n_frames"])
            + samples_out * wavernn_sample_flops(voc)
            + frames_out * wavernn_frame_flops(voc))


def roofline_seconds(flops: float, nbytes: float, p: Peaks) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM rate."""
    return max(flops / p.bf16_flops, nbytes / p.hbm_bytes)
