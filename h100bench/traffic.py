"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes that mix's inputs from the seed.

A mix has a ``kind``:

* ``serve_batch``: calls of ``convert_batch``, each over one stratified
  set of utterance lengths (``lengths_s``) in an order of the seed's, with
  files of their own from a pool written at set-up (``pool_calls`` calls'
  worth; the first is the warm-up's);
* ``convert``: one client calling ``convert`` on single utterances whose
  lengths run through the stratified set in the seed's order, a file of
  its own per request from a pool of ``pool_requests`` (after the
  warm-up's, one of each length);
* ``train_ae``: batches of ``batch`` rows of ``frames``-frame mels and
  speaker embeddings, drawn from a pool of ``pool_rows`` rows made on the
  device, every row of a batch distinct.

Speech is synthetic: a gliding harmonic tone with a syllable-rate envelope
and a little noise, its pitch and rates drawn per file, made on the
device in one pass per pool and written as 16-bit PCM at ``file_sr``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from h100bench.weights import stream_seed


def load_mix(root: Path, name: str) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def synth_speech(lengths_s, sr: int, seed: int, device,
                 block: int = 16) -> list:
    """One synthetic utterance per length, float32 numpy arrays, made
    ``block`` utterances at a time from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for b in range(0, len(lengths_s), block):
        n = [int(round(s * sr)) for s in lengths_s[b:b + block]]
        k, L = len(n), max(n)
        p = torch.rand(k, 6, generator=gen, device=device,
                       dtype=torch.float64)
        t = torch.arange(L, device=device, dtype=torch.float64)[None] / sr
        f0 = (100.0 + 120.0 * p[:, :1]) * (1.0 + 0.2 * torch.sin(
            2 * np.pi * (0.2 + 0.4 * p[:, 1:2]) * t))
        phase = 2 * np.pi * torch.cumsum(f0, dim=1) / sr
        tone = sum(torch.sin(h * phase) / h for h in range(1, 6))
        env = 0.3 + 0.7 * torch.sin(np.pi * (2.0 + 3.0 * p[:, 2:3]) * t
                                    + 6.0 * p[:, 3:4]) ** 2
        noise = torch.randn(k, L, generator=gen, device=device,
                            dtype=torch.float64)
        wav = ((0.15 + 0.1 * p[:, 4:5]) * tone * env + 0.01 * noise).float()
        wav = wav.cpu().numpy()
        out += [wav[i, :m].copy() for i, m in enumerate(n)]
    return out


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    import scipy.io.wavfile as wavfile
    pcm = np.clip(np.round(wav * 32767.0), -32767, 32767).astype(np.int16)
    wavfile.write(path, sr, pcm)


@dataclass
class Plan:
    """A mix's inputs: files (with their lengths) grouped into the
    requests or calls of a run, and the per-request seeds."""
    target: str = ""
    target_s: float = 0.0
    groups: list = field(default_factory=list)      # [[(path, seconds)]]
    seeds: list = field(default_factory=list)
    tmp: str = ""

    def group(self, i: int) -> list:
        """The files of request / call i; the pool's groups cycle when a
        window needs more than it holds (each call keeps a seed of its
        own)."""
        return self.groups[i % len(self.groups)]

    def seed(self, i: int) -> int:
        return self.seeds[i % len(self.seeds)]

    def close(self) -> None:
        if self.tmp and os.path.isdir(self.tmp):
            for f in os.listdir(self.tmp):
                os.remove(os.path.join(self.tmp, f))
            os.rmdir(self.tmp)


def plan(mix: dict, seed: int, device, tmp_root: str) -> Plan:
    """Make a mix's inputs from ``seed``: for the audio kinds, the pool of
    wav files under a fresh directory of ``tmp_root``; each group's
    lengths are the whole stratified set (``serve_batch``) or one length
    each, every length equally often (``convert``), in an order drawn from
    the seed."""
    kind = mix["kind"]
    out = Plan()
    if kind == "train_ae":
        return out
    rng = np.random.default_rng(stream_seed(seed, "traffic"))
    lengths = list(mix["lengths_s"])
    if kind == "serve_batch":
        groups = [list(rng.permutation(lengths))
                  for _ in range(mix["pool_calls"])]
    elif kind == "convert":
        reps = -(-mix["pool_requests"] // len(lengths))
        order = np.concatenate([rng.permutation(lengths)
                                for _ in range(reps)])
        # the warm-up's requests first: one of each length
        groups = [[float(s)] for s in sorted(lengths)] + [
            [float(s)] for s in order[:mix["pool_requests"]]]
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    out.seeds = [int(s) for s in rng.integers(0, 2 ** 31, len(groups))]
    sr = mix["file_sr"]
    flat = [mix["target_s"]] + [s for g in groups for s in g]
    wavs = synth_speech(flat, sr, stream_seed(seed, "speech"), device)
    import tempfile
    out.tmp = tempfile.mkdtemp(prefix="h100bench-", dir=tmp_root)
    out.target = os.path.join(out.tmp, "target.wav")
    out.target_s = mix["target_s"]
    write_wav(out.target, wavs[0], sr)
    i = 1
    for gi, g in enumerate(groups):
        files = []
        for ui, s in enumerate(g):
            path = os.path.join(out.tmp, f"g{gi:04d}_u{ui:02d}.wav")
            write_wav(path, wavs[i], sr)
            files.append((path, float(s)))
            i += 1
        out.groups.append(files)
    return out


def train_pool(mix: dict, seed: int, n_mels: int, emb: int, device):
    """``pool_rows`` synthetic mels (rows, n_mels, frames) in [0, 1] —
    smooth spectral envelopes with a moving formant pattern and noise —
    and unit speaker embeddings (rows, emb), made on the device."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "train"))
    R, T = mix["pool_rows"], mix["frames"]
    p = torch.rand(R, 4, 1, 1, generator=gen, device=device)
    f = torch.arange(n_mels, device=device)[None, None, :, None] / n_mels
    t = torch.arange(T, device=device)[None, None, None, :] / T
    centre = 0.2 + 0.6 * p[:, 0:1] + 0.1 * torch.sin(
        2 * np.pi * (1 + 3 * p[:, 1:2]) * t)
    env = torch.exp(-((f - centre) ** 2) / (0.02 + 0.05 * p[:, 2:3]))
    noise = torch.rand(R, 1, n_mels, T, generator=gen, device=device)
    mels = torch.clamp(0.3 + 0.5 * env + 0.1 * noise, 0.0, 1.0)[:, 0]
    e = torch.randn(R, emb, generator=gen, device=device)
    return mels.contiguous(), e / torch.linalg.norm(e, dim=-1, keepdim=True)


def train_batches(mix: dict, seed: int, steps: int) -> list:
    """Row indices of each step's batch: every row of a batch distinct,
    and the first ``reference_steps`` batches share no row."""
    rng = np.random.default_rng(stream_seed(seed, "batches"))
    R, B = mix["pool_rows"], mix["batch"]
    out = []
    while len(out) < steps:
        perm = rng.permutation(R)
        out += [perm[i:i + B] for i in range(0, R - B + 1, B)]
    return out[:steps]
