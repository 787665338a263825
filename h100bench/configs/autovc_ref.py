"""Plain reference of the AutoVC voice converter, for the benchmark's
output checks: the host audio tools, the two mel front-ends, the GE2E
speaker encoder, the AutoVC generator, the WaveRNN vocoder (conditioning
and a teacher-forced pass) and the batch finish, in float32 PyTorch
modules (NumPy / SciPy on the host), with no kernels, caches or batching
tricks.  It imports nothing of the program under test.

Layouts follow the published code: the AutoVC generator of Qian et al.
(arXiv:1905.05879, ``model_vc.py``), the GE2E encoder of Wan et al.
(3 LSTM layers, a linear projection, ReLU, L2 norm) and fatchord's
WaveRNN (``models/fatchord_version.py``: MelResNet, upsample network,
I / rnn1 / rnn2 / fc1-3).  Departures, each also in the program:

* the content codes take every ``freq``-th forward output from
  ``freq - 1`` and every ``freq``-th backward output from 0, and the
  forward codes are extended over a tail that ``freq`` does not divide
  (the published code needs T divisible by ``freq``);
* the speaker encoder embeds 160-frame partials of a 16 kHz PCM16 copy of
  the wav and averages the normalised partial embeddings;
* the generator converts 400-frame chunks at half overlap and merges them
  by their mean.

``precision="fp8"`` builds the control: every weight and every input of a
linear, convolution or recurrent layer rounded to float8 e4m3 with a
per-tensor scale (recurrent states stay float32).

The module is also the benchmark's one source of what is particular to
this configuration's models (``harness.REFERENCE_TABLE`` lists the names;
the last section of this file holds those that are not the mathematics
itself): the models and their groups, the program's parameter trees, the
vocoder's useful operations, its sample pick, its teacher-forced pass and
the points of the program that the benchmark taps and plants faults in.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.ndimage as ndimage
import scipy.signal as signal
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench import costs, weights

LOG_SCALE_MIN = float(math.log(1e-14))


def exact_f32() -> None:
    """float32 products on the GPU: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale (amax -> 448); the
    gradient passes straight through."""
    with torch.no_grad():
        amax = x.abs().max()
        if not torch.isfinite(amax) or float(amax) == 0.0:
            return x
        scale = 448.0 / amax
        q = (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to a configuration's precision ("f32", "bf16")."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def to_fp8(module: nn.Module) -> nn.Module:
    """The control of ``module``: weights rounded to fp8 in place, and
    the inputs of every linear, convolution and recurrent layer rounded
    by a forward pre-hook."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("weight"):
                p.copy_(fp8_round(p))

    def hook(_, args):
        return (fp8_round(args[0]),) + tuple(args[1:])

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.LSTM, nn.GRU)):
            m.register_forward_pre_hook(hook)
    return module


# ---------------------------------------------------------------------------
# Host audio (NumPy / SciPy)
# ---------------------------------------------------------------------------


def load_wav(path: str, sr: int) -> np.ndarray:
    """int16 wav file -> float32 in [-1, 1], resampled to ``sr``."""
    import scipy.io.wavfile as wavfile
    file_sr, data = wavfile.read(path)
    wav = data.astype(np.float32) / 32768.0
    return resample(wav, file_sr, sr)


def resample(wav: np.ndarray, orig_sr: int, sr: int) -> np.ndarray:
    """Polyphase resampling (SciPy's Kaiser FIR), float32."""
    if orig_sr == sr:
        return wav
    g = math.gcd(int(orig_sr), int(sr))
    return signal.resample_poly(np.asarray(wav, np.float32), sr // g,
                                orig_sr // g).astype(np.float32)


def normalize_volume(wav: np.ndarray, target_dbfs: float) -> np.ndarray:
    change = target_dbfs - 10 * np.log10(np.mean(wav ** 2) + 1e-12)
    return (wav * (10 ** (change / 20))).astype(np.float32)


def hann(n_fft: int, win: int) -> np.ndarray:
    """Periodic Hann window of ``win`` samples centred in ``n_fft``."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    lpad = (n_fft - win) // 2
    return np.pad(w, (lpad, n_fft - win - lpad))


def remove_noise(wav: np.ndarray, sr: int, n_fft: int = 1024,
                 hop: int = 256, quantile: float = 0.1,
                 gate_db: float = 6.0) -> np.ndarray:
    """Stationary spectral gating: a noise floor from the quietest tenth of
    the frames, a soft gain clip(snr_db / 6, 0, 1) smoothed over 3 frames
    x 5 bins, overlap-add resynthesis normalised by the squared window."""
    del sr
    wav = np.asarray(wav, np.float32)
    if len(wav) < n_fft:
        return wav
    window = hann(n_fft, n_fft).astype(np.float32)
    padded = np.pad(wav, n_fft // 2, mode="reflect")
    T = 1 + (len(padded) - n_fft) // hop
    frames = padded[np.arange(n_fft)[None] + hop * np.arange(T)[:, None]]
    spec = np.fft.rfft(frames * window, axis=-1)
    mag = np.abs(spec)
    energy = mag.sum(axis=1)
    k = max(1, int(T * quantile))
    floor = mag[np.argsort(energy)[:k]].mean(axis=0) + 1e-12
    gain = np.clip(20 * np.log10((mag + 1e-12) / floor) / gate_db, 0.0, 1.0)
    gain = ndimage.uniform_filter(gain, size=(3, 5))
    out_frames = np.fft.irfft(spec * gain, n=n_fft, axis=-1) * window
    out = np.zeros(T * hop + n_fft)
    wsum = np.zeros_like(out)
    for t in range(T):
        out[t * hop:t * hop + n_fft] += out_frames[t]
        wsum[t * hop:t * hop + n_fft] += window ** 2
    out = out / np.maximum(wsum, 1e-8)
    return out[n_fft // 2:n_fft // 2 + len(wav)].astype(np.float32)


def pcm16(wav: np.ndarray) -> np.ndarray:
    """float -> int16 PCM values (round, clip to +-32767), as float64."""
    return np.clip(np.round(np.asarray(wav, np.float64) * 32767.0),
                   -32767, 32767)


def partial_slices(n_samples: int, sr: int, n_frames: int, step_ms: float,
                   overlap: float = 0.5, min_coverage: float = 0.75):
    """Mel-frame starts of the overlapping partial windows of an
    utterance, and the samples it is padded to."""
    spf = int(sr * step_ms / 1000)
    total = int(np.ceil((n_samples + 1) / spf))
    step = max(int(np.round(n_frames * (1 - overlap))), 1)
    starts = list(range(0, max(1, total - n_frames + step + 1), step))
    last = starts[-1] * spf
    coverage = (n_samples - last) / (n_frames * spf)
    if coverage < min_coverage and len(starts) > 1:
        starts = starts[:-1]
    return starts, (starts[-1] + n_frames) * spf


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float) -> np.ndarray:
    """Slaney mel filterbank (librosa ``filters.mel``, htk=False, slaney
    area normalisation): (n_mels, 1 + n_fft // 2)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4)
                                                               / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0,
                        1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3))

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def _stft_mag(wav: torch.Tensor, n_fft: int, hop: int, win: int):
    """|STFT| (frames, bins) in float64, centred, reflect-padded."""
    wav = wav.double()
    padded = F.pad(wav[None, None], (n_fft // 2, n_fft // 2),
                   mode="reflect")[0, 0]
    frames = padded.unfold(0, n_fft, hop)
    window = torch.from_numpy(hann(n_fft, win)).to(wav.device)
    return torch.fft.rfft(frames * window, dim=-1).abs()


def ae_mel(pcm: torch.Tensor, c: dict) -> torch.Tensor:
    """Auto-encoder mel of PCM16 values: (n_mels, frames) in [0, 1]."""
    mag = _stft_mag(pcm / 32767.0, c["n_fft"], c["hop_length"],
                    c["window_length"])
    fb = torch.from_numpy(mel_filterbank(c["sr"], c["n_fft"], c["n_mels"],
                                         c["fmin"])).to(mag.device)
    db = 20.0 * torch.log10(torch.clamp(mag @ fb.T, min=1e-5))
    return torch.clamp((db + 100.0) / 100.0, 0.0, 1.0).T.float()


def se_mel(pcm: torch.Tensor, c: dict) -> torch.Tensor:
    """Speaker-encoder power mel of PCM16 values: (frames, n_mels)."""
    n_fft = int(c["sr"] * c["mel_window_length"] / 1000)
    hop = int(c["sr"] * c["mel_window_step"] / 1000)
    mag = _stft_mag(pcm / 32767.0, n_fft, hop, n_fft)
    fb = torch.from_numpy(mel_filterbank(c["sr"], n_fft, c["n_mels"],
                                         0.0)).to(mag.device)
    return ((mag * mag) @ fb.T).float()


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


class SpeakerEncoder(nn.Module):
    """GE2E d-vector model: LSTM stack, linear, ReLU, L2 norm of the last
    frame's output."""

    def __init__(self, c: dict):
        super().__init__()
        self.lstm = nn.LSTM(c["input_size"], c["hidden_size"],
                            c["num_layers"], batch_first=True)
        self.linear = nn.Linear(c["hidden_size"], c["embedding_size"])

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(mels)
        raw = torch.relu(self.linear(out[:, -1]))
        return raw / torch.linalg.norm(raw, dim=-1, keepdim=True)


def conv_bn(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(cin, cout, 5, padding=2),
                         nn.BatchNorm1d(cout))


class Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.freq, self.neck = c["freq"], c["dim_neck"]
        self.convolutions = nn.ModuleList(
            [conv_bn(c["n_mels"] + c["dim_emb"], 512), conv_bn(512, 512),
             conv_bn(512, 512)])
        self.lstm = nn.LSTM(512, c["dim_neck"], 2, batch_first=True,
                            bidirectional=True)

    def forward(self, x, c_org):
        x = torch.cat([x, c_org[:, :, None].expand(-1, -1, x.shape[-1])], 1)
        for conv in self.convolutions:
            x = torch.relu(conv(x))
        out, _ = self.lstm(x.transpose(1, 2))
        f, b = out[..., :self.neck], out[..., self.neck:]
        return f[:, self.freq - 1::self.freq], b[:, ::self.freq]


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.lstm1 = nn.LSTM(2 * c["dim_neck"] + c["dim_emb"], c["dim_pre"],
                             1, batch_first=True)
        self.convolutions = nn.ModuleList(
            [conv_bn(c["dim_pre"], c["dim_pre"]) for _ in range(3)])
        self.lstm2 = nn.LSTM(c["dim_pre"], 1024, 2, batch_first=True)
        self.linear_projection = nn.Linear(1024, c["n_mels"])

    def forward(self, x):
        x, _ = self.lstm1(x)
        x = x.transpose(1, 2)
        for conv in self.convolutions:
            x = torch.relu(conv(x))
        out, _ = self.lstm2(x.transpose(1, 2))
        return self.linear_projection(out)


class Postnet(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        n = c["n_mels"]
        self.convolutions = nn.ModuleList(
            [conv_bn(n, 512)] + [conv_bn(512, 512) for _ in range(3)]
            + [conv_bn(512, n)])

    def forward(self, x):
        for conv in self.convolutions[:-1]:
            x = torch.tanh(conv(x))
        return self.convolutions[-1](x)


class Generator(nn.Module):
    """AutoVC: content encoder, decoder, postnet on (B, n_mels, T)."""

    def __init__(self, c: dict):
        super().__init__()
        self.freq = c["freq"]
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)
        self.postnet = Postnet(c)

    @staticmethod
    def flat(f, b):
        return torch.cat([f.reshape(f.shape[0], -1),
                          b.reshape(b.shape[0], -1)], -1)

    def forward(self, x, c_org, c_trg):
        T = x.shape[-1]
        f, b = self.encoder(x, c_org)
        up_f = torch.repeat_interleave(f, self.freq, dim=1)
        if up_f.shape[1] < T:
            up_f = torch.cat([up_f, f[:, -1:].expand(
                -1, T - up_f.shape[1], -1)], 1)
        up_b = torch.repeat_interleave(b, self.freq, dim=1)[:, :T]
        dec_in = torch.cat([up_f, up_b, c_trg[:, None].expand(-1, T, -1)],
                           -1)
        mel = self.decoder(dec_in).transpose(1, 2)
        post = mel + self.postnet(mel)
        return mel, post, self.flat(f, b)

    def loss(self, x, c_org):
        """The three-term AutoVC loss: MSE(postnet, x) + MSE(decoder, x) +
        L1 of the content codes of the postnet output against x's."""
        mel, post, codes = self(x, c_org, c_org)
        recon = self.flat(*self.encoder(post, c_org))
        return (torch.mean((post - x) ** 2) + torch.mean((mel - x) ** 2)
                + torch.mean(torch.abs(recon - codes)))


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = nn.BatchNorm1d(dims)
        self.batch_norm2 = nn.BatchNorm1d(dims)

    def forward(self, x):
        h = torch.relu(self.batch_norm1(self.conv1(x)))
        return x + self.batch_norm2(self.conv2(h))


class MelResNet(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        cd = c["compute_dims"]
        self.conv_in = nn.Conv1d(c["feat_dims"], cd, 2 * c["pad"] + 1,
                                 bias=False)
        self.batch_norm = nn.BatchNorm1d(cd)
        self.layers = nn.ModuleList(ResBlock(cd)
                                    for _ in range(c["res_blocks"]))
        self.conv_out = nn.Conv1d(cd, c["res_out_dims"], 1)

    def forward(self, x):
        x = torch.relu(self.batch_norm(self.conv_in(x)))
        for layer in self.layers:
            x = layer(x)
        return self.conv_out(x)


class UpsampleNetwork(nn.Module):
    """MelResNet features stretched to the sample rate, and the mel
    stretched and smoothed by one (1, 2s + 1) convolution per factor."""

    def __init__(self, c: dict):
        super().__init__()
        self.factors = tuple(c["upsample_factors"])
        self.pad = c["pad"]
        self.resnet = MelResNet(c)
        self.up_layers = nn.ModuleList(
            nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s), bias=False)
            for s in self.factors)

    def forward(self, m):
        """m (B, feat, F + 2 pad) -> mels (B, T, feat), aux (B, T, res)."""
        scale = int(np.prod(self.factors))
        aux = torch.repeat_interleave(self.resnet(m), scale, dim=-1)
        x = m[:, None]
        for s, conv in zip(self.factors, self.up_layers):
            x = conv(torch.repeat_interleave(x, s, dim=-1))
        indent = self.pad * scale
        return (x[:, 0, :, indent:-indent].transpose(1, 2),
                aux.transpose(1, 2))


class WaveRNN(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        rd, fc, ad = c["rnn_dims"], c["fc_dims"], c["res_out_dims"] // 4
        self.aux_dims = ad
        self.upsample = UpsampleNetwork(c)
        self.I = nn.Linear(c["feat_dims"] + ad + 1, rd)
        self.rnn1 = nn.GRU(rd, rd, batch_first=True)
        self.rnn2 = nn.GRU(rd + ad, rd, batch_first=True)
        self.fc1 = nn.Linear(rd + ad, fc)
        self.fc2 = nn.Linear(fc + ad, fc)
        self.fc3 = nn.Linear(fc, n_classes(c))

    def sample_rate_pass(self, x_prev, mels, aux):
        """Teacher-forced logits (B, T, n_classes) from the previous
        samples (B, T) and the sample-rate conditioning."""
        d = self.aux_dims
        a1, a2, a3, a4 = (aux[..., i * d:(i + 1) * d] for i in range(4))
        x = self.I(torch.cat([x_prev[..., None], mels, a1], -1))
        h, _ = self.rnn1(x)
        x = x + h
        h, _ = self.rnn2(torch.cat([x, a2], -1))
        x = x + h
        x = torch.relu(self.fc1(torch.cat([x, a3], -1)))
        x = torch.relu(self.fc2(torch.cat([x, a4], -1)))
        return self.fc3(x)


def n_classes(c: dict) -> int:
    return 30 if c["mode"] == "MOL" else 2 ** c["bits"]


def build(kind: str, c: dict, precision: str = "f32", device=None,
          state=None) -> nn.Module:
    """A reference model ("speaker_encoder", "generator", "vocoder") of
    config group ``c``, in eval mode, its weights from ``state`` (a state
    dict), at ``precision`` ("f32", or "fp8": the control)."""
    model = MODELS[kind][0](c)
    if state is not None:
        model.load_state_dict(state)
    model = model.to(device).eval()
    return to_fp8(model) if precision == "fp8" else model


# ---------------------------------------------------------------------------
# Conversion: the stages of convert / convert_batch
# ---------------------------------------------------------------------------


def embed(se: nn.Module, wav: np.ndarray, sr: int, c: dict,
          device) -> torch.Tensor:
    """d-vector of an utterance at ``sr``: resampled to the encoder's rate,
    PCM16, power mel, the partials' normalised embeddings averaged and
    normalised."""
    w = resample(wav, sr, c["sr"])
    n = c["partial_utterance_n_frames"]
    starts, stop = partial_slices(len(w), c["sr"], n, c["mel_window_step"])
    w = np.pad(w, (0, max(0, stop - len(w))))
    mel = se_mel(torch.from_numpy(pcm16(w)).to(device), c)
    rows = torch.stack([mel[s:s + n] for s in starts])
    e = se(rows).mean(dim=0)
    return e / torch.linalg.norm(e)


def generator_mel(gen: nn.Module, wav: np.ndarray, c_org, c_trg, c: dict,
                  device, overlap: float = 0.5) -> torch.Tensor:
    """The converted mel of an utterance (cut into half-overlapping chunks
    of PCM16 mel, each through the generator, merged by their mean):
    (n_mels, frames)."""
    sp = c["spectrogram"]
    n = sp["partial_utterance_n_frames"]
    starts, stop = partial_slices(len(wav), sp["sr"], n, sp["mel_window_step"],
                                  overlap)
    w = np.pad(wav, (0, max(0, stop - len(wav))))
    mel = ae_mel(torch.from_numpy(pcm16(w)).to(device), sp)
    chunks = torch.stack([mel[:, s:s + n] for s in starts])
    M = len(starts)
    _, post, _ = gen(chunks, c_org.expand(M, -1), c_trg.expand(M, -1))
    step = int(n * (1 - overlap))
    total = n + (M - 1) * step
    acc = post.new_zeros(post.shape[1], total)
    cnt = post.new_zeros(1, total)
    for i in range(M):
        acc[:, i * step:i * step + n] += post[i]
        cnt[:, i * step:i * step + n] += 1.0
    return acc / cnt


def fold(x: torch.Tensor, target: int, overlap: int) -> torch.Tensor:
    """(T, C) -> (folds, target + 2 overlap, C) overlapping rows, the tail
    padded with zeros (fatchord's ``fold_with_overlap``)."""
    T = x.shape[0]
    n = max(0, (T - overlap) // (target + overlap))
    if T - (n * (overlap + target) + overlap) != 0:
        n += 1
        x = F.pad(x, (0, 0, 0, n * (target + overlap) + overlap - T))
    n = max(n, 1)
    return torch.stack([x[i * (target + overlap):
                          i * (target + overlap) + target + 2 * overlap]
                        for i in range(n)])


def conditioning(voc: WaveRNN, mel: torch.Tensor, c: dict):
    """Sample-rate conditioning of a (n_mels, frames) mel: (mels (T, feat),
    aux (T, res_out)), T = frames x hop."""
    m = F.pad(mel[None], (c["pad"], c["pad"]))
    mels, aux = voc.upsample(m)
    return mels[0], aux[0]


def xfade_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """Equal-power crossfade of fold rows (folds, length) into one signal
    (fatchord's ``xfade_and_unfold``)."""
    folds, length = y.shape
    target = length - 2 * overlap
    silence = overlap // 2
    t = np.linspace(-1, 1, overlap - silence, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silence), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.ones(silence), np.sqrt(0.5 * (1 - t))])
    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(folds * (target + overlap) + overlap)
    for i in range(folds):
        s = i * (target + overlap)
        out[s:s + length] += y[i]
    return out


def finish(rows: np.ndarray, overlap: int, wave_len: int, hop: int,
           mu_law_classes: int | None, outprocess: dict) -> np.ndarray:
    """Fold rows of samples -> the served waveform: mu-law expansion
    (RAW with mu-law), crossfade, trim, a 20-hop fade-out, PCM16, then the
    outprocessing (volume normalisation, spectral gating)."""
    rows = np.asarray(rows, np.float64)
    if mu_law_classes:
        mu = mu_law_classes - 1
        rows = np.sign(rows) / mu * ((1 + mu) ** np.abs(rows) - 1)
    out = xfade_unfold(rows, overlap)[:wave_len]
    n = min(20 * hop, len(out))
    out[len(out) - n:] *= np.linspace(1.0, 0.0, n)
    wav = (pcm16(out) / 32767.0).astype(np.float32)
    wav = normalize_volume(wav, outprocess["target_dBFS"])
    if outprocess.get("remove_noise"):
        wav = remove_noise(wav, outprocess["sr"])
    return wav


def pick_costs(logits: torch.Tensor, gumbel: torch.Tensor,
               logistic: torch.Tensor, served: torch.Tensor, mode: str,
               n_cls: int) -> torch.Tensor:
    """How far each served sample is from one the reference would serve
    with the same noise, in noise units: the least, over the picks that
    could have served it, of the pick's shortfall below the best
    noise-perturbed score (Gumbel) plus, for MOL, the shift of the
    logistic noise that its mean and scale need to give the served value.
    ``logits`` (..., n_classes), ``gumbel`` (..., pick lanes),
    ``logistic`` and ``served`` (...)."""
    if mode == "RAW":
        z = logits + gumbel
        pick = torch.clamp(torch.round((served + 1.0) * (n_cls - 1) / 2.0),
                           0, n_cls - 1).long()
        return z.max(dim=-1).values - torch.gather(
            z, -1, pick[..., None])[..., 0]
    k = logits.shape[-1] // 3
    z = logits[..., :k] + gumbel
    gap = z.max(dim=-1, keepdim=True).values - z
    means = logits[..., k:2 * k]
    scales = torch.exp(torch.clamp(logits[..., 2 * k:], min=LOG_SCALE_MIN))
    value = means + scales * logistic[..., None]
    s = served[..., None]
    shift = torch.where(s >= 1.0, torch.clamp(1.0 - value, min=0.0),
                        torch.where(s <= -1.0,
                                    torch.clamp(value + 1.0, min=0.0),
                                    (s - value).abs())) / scales
    return (gap + shift).min(dim=-1).values


def control_samples(logits: torch.Tensor, gumbel: torch.Tensor,
                    logistic: torch.Tensor, mode: str,
                    n_cls: int) -> torch.Tensor:
    """The samples a model with these logits serves with this noise."""
    if mode == "RAW":
        pick = torch.argmax(logits + gumbel, dim=-1)
        return 2.0 * pick.float() / (n_cls - 1) - 1.0
    k = logits.shape[-1] // 3
    pick = torch.argmax(logits[..., :k] + gumbel, dim=-1, keepdim=True)
    mean = torch.gather(logits[..., k:2 * k], -1, pick)[..., 0]
    log_scale = torch.clamp(torch.gather(logits[..., 2 * k:], -1, pick),
                            min=LOG_SCALE_MIN)[..., 0]
    return torch.clamp(mean + torch.exp(log_scale) * logistic, -1.0, 1.0)


def draw_noise(gen: torch.Generator, steps: int, rows: int, lanes: int,
               device):
    """Gumbel (steps, rows, lanes) and logistic (steps, rows) noise from
    uniforms in [1e-5, 1 - 1e-5), drawn in that order."""
    lo, span = 1e-5, 1.0 - 2e-5
    u1 = torch.rand((steps, rows, lanes), generator=gen,
                    device=device) * span + lo
    gumbel = -torch.log(-torch.log(u1))
    u2 = torch.rand((steps, rows), generator=gen, device=device) * span + lo
    return gumbel, torch.log(u2) - torch.log(1.0 - u2)


# ---------------------------------------------------------------------------
# What the benchmark asks of this configuration's models
# ---------------------------------------------------------------------------

# Each model kind: its reference class and the configuration's group it is
# built from.
MODELS = {"speaker_encoder": (SpeakerEncoder, "speaker_encoder"),
          "generator": (Generator, "auto_encoder"),
          "vocoder": (WaveRNN, "vocoder")}

# The points of the program (module, attribute) that the benchmark wraps:
# "rows" returns each block of fold rows of served samples (rows, steps);
# "mel" takes the converted mel as the vocoder gets it, as its second
# argument; "pick" returns the samples each sampling pass picks (rows,
# steps); "pcm" returns an utterance's served PCM; "vocoder" (the vocoder's
# pass over a call's utterances) and "noise" (its noise draw) label the
# idle gaps of a traced run.
POINTS = {
    "rows": ("autovc_tpu_torch.ops.wavernn_kernels", "generate_rows"),
    "mel": ("autovc_tpu_torch.models.wavernn", "_prepare_frame_conditioning"),
    "pick": ("autovc_tpu_torch.ops.wavernn_kernels", "sample_rows"),
    "pcm": ("autovc_tpu_torch.models.wavernn", "_pcm16"),
    "vocoder": ("autovc_tpu_torch.models.wavernn", "_generate_many_program"),
    "noise": ("autovc_tpu_torch.ops.wavernn_kernels", "draw_noise"),
}


def program_tree(kind: str, state: dict, cfg: dict, names=None):
    """The program's parameter tree of model ``kind`` from its reference
    ``state``; ``names``, when given, is filled with state name -> the
    program's tensor."""
    if kind == "speaker_encoder":
        return weights.speaker_encoder_tree(
            state, cfg["speaker_encoder"]["num_layers"], names)
    if kind == "generator":
        return weights.generator_tree(state, names)
    v = cfg["vocoder"]
    return weights.vocoder_tree(state, v["res_blocks"],
                                len(v["upsample_factors"]), names)


def vocoder_flops(cfg: dict) -> tuple:
    """The vocoder's useful operations for one output sample and for one
    mel frame."""
    voc = cfg["vocoder"]
    return costs.wavernn_sample_flops(voc), costs.wavernn_frame_flops(voc)


def pick(cfg: dict) -> dict:
    """The vocoder's sample pick as the output check reads it: ``lanes``,
    the Gumbel lanes a row and step (:func:`draw_noise`); ``costs(logits,
    gumbel, logistic, served)`` (:func:`pick_costs`) and ``samples(logits,
    gumbel, logistic)`` (:func:`control_samples`) at the configuration's
    mode and classes; ``mu_law``, the classes the finish expands mu-law by,
    or None."""
    voc = cfg["vocoder"]
    mode, n = voc["mode"], n_classes(voc)
    raw = mode == "RAW"
    return {"lanes": n if raw else n // 3,
            "mu_law": n if raw and voc["generate"]["mu_law"] else None,
            "costs": lambda logits, gumbel, logistic, served: pick_costs(
                logits, gumbel, logistic, served, mode, n),
            "samples": lambda logits, gumbel, logistic: control_samples(
                logits, gumbel, logistic, mode, n)}


def teacher_forced(model: WaveRNN, x_prev: torch.Tensor,
                   cond: tuple) -> torch.Tensor:
    """Logits (B, T, classes) of the previous samples ``x_prev`` (B, T) and
    the folded rows of each part of :func:`conditioning`, (B, T, ...)."""
    return model.sample_rate_pass(x_prev, *cond)
