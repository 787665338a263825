"""Typed, frozen configuration for the PyTorch/CUDA AutoVC port.

A copy of ``autovc_tpu/config.py`` (same groups, same defaults), kept in this
package so that it imports nothing of the JAX package.

The reference keeps five module-level *mutable* dicts in
``autovc/utils/hparams.py:4-153`` and mutates them in place from user kwargs
(``voice_converter.py:67-70``), which leaks state across instances.  Here each
group is an immutable dataclass with an explicit ``replace``-style override
merge (``with_overrides``), so configuration is a pure value.

Groups mirror the reference contract:
  * ``MelConfig`` / ``AutoEncoderConfig``  <- AutoEncoderParams (hparams.py:4-48)
  * ``SpeakerEncoderConfig``               <- SpeakerEncoderParams (hparams.py:50-90)
  * ``WaveRNNConfig``                      <- WaveRNNParams (hparams.py:92-115)
  * ``WandbConfig``                        <- WandbParams (hparams.py:118-128)
  * ``ConverterConfig``                    <- VoiceConverterParams (hparams.py:131-153)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


def _merge(cfg, overrides: Mapping[str, Any]):
    """Return a copy of ``cfg`` with ``overrides`` applied.

    Nested dataclass fields accept nested dicts.  Unknown keys raise, matching
    the reference's strict kwarg routing (voice_converter.py:260-270).
    """
    if not overrides:
        return cfg
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(cfg)}
    for key, value in overrides.items():
        if key not in names:
            raise ValueError(
                f"'{key}' is not a valid option for {type(cfg).__name__}; "
                f"valid options: {sorted(names)}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            kwargs[key] = _merge(current, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


@dataclass(frozen=True)
class MelConfig:
    """Mel front-end for the auto-encoder path (hparams.py:6-15).

    Semantics match ``spectrogram.mel_spec_auto_encoder`` (spectrogram.py:62-142):
    amplitude mel -> dB -> [0, 1] normalisation.
    """
    sr: int = 22050
    n_mels: int = 80
    n_fft: int = 2048
    hop_length: int = 275           # 12.5 ms, Tacotron-2 aligned
    window_length: int = 1100       # 50 ms
    fmin: float = 40.0
    mel_window_step: float = 12.5   # ms; drives compute_partial_slices
    partial_utterance_n_frames: int = 400  # ~5 s slices

    def with_overrides(self, **kw) -> "MelConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class SpeakerMelConfig:
    """Mel front-end for the speaker-encoder path (hparams.py:52-58).

    Power mel, float32, no dB / no normalisation
    (``mel_spec_speaker_encoder``, spectrogram.py:144-219).
    """
    sr: int = 16000
    n_mels: int = 40
    mel_window_length: float = 25.0  # ms -> n_fft = 400 samples at 16 kHz
    mel_window_step: float = 10.0    # ms -> hop = 160 samples
    partial_utterance_n_frames: int = 160

    @property
    def n_fft(self) -> int:
        return int(self.sr * self.mel_window_length / 1000)

    @property
    def hop_length(self) -> int:
        return int(self.sr * self.mel_window_step / 1000)

    def with_overrides(self, **kw) -> "SpeakerMelConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam + schedule knobs (hparams.py:30-38, 74-82)."""
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    lr_scheduler: str = "exponential"   # the reference effectively uses
                                        # ExponentialLR(0.95) stepped per epoch
                                        # (auto_encoder/model.py:293,359)
    gamma: float = 0.95
    n_warmup_steps: int = 256
    grad_clip_norm: float = 1.0         # auto_encoder/model.py:314

    def with_overrides(self, **kw) -> "OptimizerConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class LearnConfig:
    """Training-loop knobs (hparams.py:22-29, 66-73)."""
    n_epochs: int = 1
    log_freq: int = 8
    save_freq: int = 16
    model_name: str = "model.ckpt"
    save_dir: str = "models/AutoVC"
    ema_decay: float = 0.9999
    batch_size: int = 16
    # Matmul/conv compute policy for the train step: "bf16" (bf16
    # operands, f32 accumulation + f32 master weights/opt-state/BN stats)
    # or "f32" (exact f32 everywhere, reference parity).  See
    # ops/precision.py.
    precision: str = "bf16"

    def with_overrides(self, **kw) -> "LearnConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class AutoEncoderConfig:
    """AutoVC generator (hparams.py:16-21)."""
    dim_neck: int = 32
    dim_emb: int = 256
    dim_pre: int = 512
    freq: int = 32
    n_mels: int = 80
    model_dir: str = "models/AutoVC"
    spectrogram: MelConfig = field(default_factory=MelConfig)
    learn: LearnConfig = field(default_factory=LearnConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    def with_overrides(self, **kw) -> "AutoEncoderConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """GE2E d-vector model (hparams.py:59-65)."""
    input_size: int = 40
    hidden_size: int = 256
    embedding_size: int = 256
    num_layers: int = 3
    model_dir: str = "models/SpeakerEncoder"
    spectrogram: SpeakerMelConfig = field(default_factory=SpeakerMelConfig)
    learn: LearnConfig = field(default_factory=lambda: LearnConfig(
        n_epochs=1, log_freq=1, save_freq=1, save_dir="models/SpeakerEncoder",
        batch_size=64))
    optimizer: OptimizerConfig = field(default_factory=lambda: OptimizerConfig(
        n_warmup_steps=64, grad_clip_norm=3.0))

    def with_overrides(self, **kw) -> "SpeakerEncoderConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class WaveRNNGenerateConfig:
    """Batched-generation geometry (hparams.py:108-113).

    ``target``/``overlap`` reproduce the reference's fixed fold geometry.
    The JAX package scores fold lengths with a TPU timing table when
    ``auto_target=True``; this port has no timing table for its GPU yet,
    so ``auto_target`` takes the fixed ``target``/``overlap`` here (see
    :func:`autovc_tpu_torch.models.wavernn.auto_fold_target`)."""
    batched: bool = True
    target: int = 11_000
    overlap: int = 550
    mu_law: bool = False
    auto_target: bool = True

    def with_overrides(self, **kw) -> "WaveRNNGenerateConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class WaveRNNConfig:
    """WaveRNN vocoder (hparams.py:94-107)."""
    hop_length: int = 275
    rnn_dims: int = 512
    res_out_dims: int = 128
    feat_dims: int = 80
    fc_dims: int = 512
    bits: int = 9
    upsample_factors: Tuple[int, ...] = (5, 5, 11)
    compute_dims: int = 128
    pad: int = 2
    res_blocks: int = 10
    mode: str = "MOL"   # 'RAW' (softmax over 2**bits) or 'MOL'
    model_dir: str = "models/WaveRNN"
    generate: WaveRNNGenerateConfig = field(default_factory=WaveRNNGenerateConfig)

    @property
    def aux_dims(self) -> int:
        return self.res_out_dims // 4

    @property
    def n_classes(self) -> int:
        # NOTE: the reference computes 2*bits for RAW (wavernn/model.py:149),
        # which for bits=9 gives 18 classes; upstream WaveRNN used 2**bits.
        # We keep 2**bits as the correct RAW behaviour (the default mode is MOL
        # so this path is rarely exercised).
        return 30 if self.mode == "MOL" else 2 ** self.bits

    @property
    def total_scale(self) -> int:
        out = 1
        for s in self.upsample_factors:
            out *= s
        return out

    def with_overrides(self, **kw) -> "WaveRNNConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class WandbConfig:
    """Experiment tracking (hparams.py:118-128). Falls back to JSONL when wandb
    is unavailable or mode == 'disabled'."""
    entity: str = "deep_voice_inc"
    project: str = "DefaultProject"
    mode: str = "disabled"
    save_code: bool = True
    reinit: bool = True

    def with_overrides(self, **kw) -> "WandbConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class ConvertConfig:
    """Conversion pipeline knobs (hparams.py:137-145)."""
    sr: int = 22050
    save_name: str | None = None
    save_dir: str | None = None
    preprocess: Tuple[str, ...] = ("normalize_volume",)
    preprocess_args: Mapping[str, Any] = field(
        default_factory=lambda: {"target_dBFS": -20})
    outprocess: Tuple[str, ...] = ("normalize_volume", "remove_noise")
    outprocess_args: Mapping[str, Any] = field(
        default_factory=lambda: {"target_dBFS": -20})

    def with_overrides(self, **kw) -> "ConvertConfig":
        return _merge(self, kw)


@dataclass(frozen=True)
class ConverterConfig:
    """Top-level VoiceConverter config (hparams.py:131-153)."""
    auto_encoder: AutoEncoderConfig = field(default_factory=AutoEncoderConfig)
    speaker_encoder: SpeakerEncoderConfig = field(
        default_factory=SpeakerEncoderConfig)
    vocoder: WaveRNNConfig = field(default_factory=WaveRNNConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    convert: ConvertConfig = field(default_factory=ConvertConfig)

    def with_overrides(self, **kw) -> "ConverterConfig":
        return _merge(self, kw)
