"""Audio container + preprocessing pipeline (a copy of
``autovc_tpu/audio/__init__.py``'s ``Audio``, dispatching through this
package's tool registry)."""
from __future__ import annotations

import numpy as np

from autovc_tpu_torch.audio import dsp, io, tools

__all__ = ["Audio", "dsp", "io", "tools"]


class Audio:
    def __init__(self, wav, sr: int | None = None, sr_org: int | None = None):
        """Load or wrap audio data: ``wav`` is a path or an array; ``sr``
        triggers a resample; ``sr_org`` declares the rate of array input."""
        if isinstance(wav, str):
            self.wav_path = wav
            self.wav, self.sr = io.load_wav(wav, sr=sr_org)
        else:
            if sr_org is None:
                raise ValueError("sr_org must be given for array input")
            self.wav_path = None
            self.wav = np.asarray(wav, dtype=np.float32)
            self.sr = sr_org
        if sr is not None:
            self.resample(sr)

    def save(self, save_path: str = "example_audio.wav"):
        io.save_wav(save_path, self.wav, self.sr)

    def resample(self, sr: int):
        if sr != self.sr:
            self.wav = io.resample(self.wav, self.sr, sr)
            self.sr = sr
        return self

    @property
    def duration(self) -> float:
        return len(self.wav) / self.sr

    def preprocess(self, *pipeline, **kwargs):
        """Apply named tools from :mod:`autovc_tpu_torch.audio.tools` in
        order; shared kwargs are routed to every tool that accepts them."""
        for name in pipeline:
            if name is None:
                continue
            if name not in tools.PIPELINE_FUNCS:
                raise ValueError(
                    f"'{name}' is not a known audio tool; options: "
                    f"{sorted(tools.PIPELINE_FUNCS)}")
            func, allowed = tools.PIPELINE_FUNCS[name]
            func_kwargs = {k: v for k, v in kwargs.items() if k in allowed}
            if "sr" in allowed:
                func_kwargs["sr"] = self.sr
            self.wav = np.asarray(func(self.wav, **func_kwargs),
                                  dtype=np.float32)
        return self
