"""autovc_tpu_torch — the PyTorch/CUDA port of autovc_tpu.

Zero-shot voice conversion (AutoVC generator + GE2E speaker encoder +
WaveRNN vocoder) on an NVIDIA GPU, with hand-written CUDA kernels for the
WaveRNN sampling loop and the decoder LSTM stack.  The JAX package
``autovc_tpu`` is the reference this port is held against; this package
imports nothing of it, and nothing of JAX.
"""
from autovc_tpu_torch.audio import Audio
from autovc_tpu_torch.config import ConverterConfig
from autovc_tpu_torch.models import load_model
from autovc_tpu_torch.voice_converter import VoiceConverter

__all__ = ["Audio", "ConverterConfig", "VoiceConverter", "load_model"]
