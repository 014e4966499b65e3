"""qwen3_tts_tpu_torch — the PyTorch/CUDA port of qwen3_tts_tpu.

Runs offline preset-speaker synthesis on an NVIDIA H100 through kernels
written by hand for Hopper (`csrc/*.cu`, `ops/elementwise_triton.py`), with
a plain PyTorch version beside each kernel for CPU tensors. Imports torch,
never JAX; the JAX package `qwen3_tts_tpu` is the reference it is tested
against.
"""

from .core.config import (  # noqa: F401
    EngineConfig,
    PredictorConfig,
    SamplerConfig,
    TalkerConfig,
    VocoderConfig,
    tiny_engine_config,
)
from .tts.engine import TtsEngine  # noqa: F401
from .utils.audio import AudioSample  # noqa: F401
from .utils.tokenizer import ByteTokenizer, Tokenizer  # noqa: F401
from .utils.voice_file import VoiceFile  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "TtsEngine",
    "SamplerConfig",
    "AudioSample",
    "Tokenizer",
    "ByteTokenizer",
    "VoiceFile",
    "EngineConfig",
    "TalkerConfig",
    "PredictorConfig",
    "VocoderConfig",
    "tiny_engine_config",
]
