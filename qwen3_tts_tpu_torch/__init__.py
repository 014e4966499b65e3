"""qwen3_tts_tpu_torch — the PyTorch/CUDA port of qwen3_tts_tpu.

Runs preset-speaker synthesis and voice cloning from reference audio,
offline and streaming, on an NVIDIA H100 through kernels written by hand
for Hopper (`csrc/*.cu`, `ops/elementwise_triton.py`), with a plain
PyTorch version beside each kernel for CPU tensors. Imports torch, never JAX; the JAX package
`qwen3_tts_tpu` is the reference it is tested against.

The public facade of the JAX package: TtsEngine, SamplerConfig,
PromptBuilder, AudioSample, Tokenizer, VoiceFile, cleanup().
"""

from .core.config import (  # noqa: F401
    EngineConfig,
    PredictorConfig,
    SamplerConfig,
    TalkerConfig,
    VocoderConfig,
    tiny_engine_config,
)
from .tts import prompt as _prompt
from .tts.engine import TtsEngine, cleanup  # noqa: F401
from .utils.audio import AudioSample  # noqa: F401
from .utils.tokenizer import ByteTokenizer, Tokenizer  # noqa: F401
from .utils.voice_file import VoiceFile  # noqa: F401

__version__ = "0.1.0"


class PromptBuilder:
    """Static facade over `tts.prompt` (reference PromptBuilder,
    src/tts/prompt.rs:24-278)."""

    build_core = staticmethod(_prompt.build_core)
    build_clone_prompt = staticmethod(_prompt.build_clone_prompt)
    build_custom_prompt = staticmethod(_prompt.build_custom_prompt)


__all__ = [
    "TtsEngine",
    "SamplerConfig",
    "PromptBuilder",
    "AudioSample",
    "Tokenizer",
    "ByteTokenizer",
    "VoiceFile",
    "EngineConfig",
    "TalkerConfig",
    "PredictorConfig",
    "VocoderConfig",
    "tiny_engine_config",
    "cleanup",
]
