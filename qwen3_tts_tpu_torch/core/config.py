"""Model / engine configuration.

A copy of `qwen3_tts_tpu/core/config.py` (numpy-free, framework-free): the
port carries its own copy because importing any submodule of the JAX package
runs its `__init__`, which imports JAX. All configs are frozen dataclasses
(hashable, so they can key caches). Geometry defaults mirror what the reference loads from GGUF
metadata at runtime (`src/models/llama/mod.rs:337-365` reads n_embd / n_head /
n_layer / n_vocab from the file): talker hidden is 2048 and predictor hidden
1024 with a 16x2048 output head (`SURVEY.md` §2). Layer/head counts that the
reference only discovers from the GGUF are configurable here; real-weight
loading overrides them from checkpoint metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import protocol


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """Qwen3 decoder that consumes 2048-d embedding inputs (never token ids)
    and emits codec-codebook-0 logits. Reference context setup at
    `src/tts/engine.rs:133` (n_ctx=4096, embeddings on, M-RoPE n_pos_per_embd=4).
    """

    hidden: int = 2048
    n_layers: int = 28
    n_q_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 6144
    vocab: int = 2176           # head rows; sampling slices [0, 2160)
    max_seq: int = 4096
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    # M-RoPE: rotary frequency budget (head_dim // 2) split across the four
    # position streams (temporal, height, width, channel). The reference feeds
    # t == h == w == seq index and channel == 0 (`src/tts/engine.rs:306-314`),
    # so any split with a zero channel section reduces to standard RoPE; the
    # sections stay configurable for checkpoints that ship real metadata.
    mrope_sections: Tuple[int, int, int, int] = (24, 20, 20, 0)
    dtype: str = "bfloat16"
    # layer-scan unroll factor (measured slower >1 on v5e; kept as a knob)
    scan_unroll: int = 1
    # TP head interleave: wqkv columns permuted into this many device
    # blocks [q_d | k_d | v_d] so GSPMD's contiguous column shards align
    # with the q/k/v head split (parallel/sharding.interleave_wqkv). 1 =
    # flat reference layout. Set by parallel/run from the mesh.
    tp_interleave: int = 1

    def __post_init__(self):
        assert sum(self.mrope_sections) == self.head_dim // 2, (
            "mrope sections must cover head_dim//2 rotary frequencies"
        )


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Small 1024-d decoder that autoregressively emits codebooks 1..15 for
    each frame. Output head is 16 x 2048 = 32768 logits; codebook q samples
    the slice [(q-1)*2048, q*2048) (`src/tts/engine.rs:587-597`). Context
    n_ctx=512 in the reference (`src/tts/engine.rs:136`), but each frame only
    ever uses 17 positions (prefill of 2 + 15 feedback steps).
    """

    hidden: int = 1024
    n_layers: int = 8
    n_q_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 3072
    vocab: int = protocol.NUM_CODEBOOKS * protocol.CODE_VOCAB  # 32768
    max_seq: int = 32           # 2 prefill + 15 steps, padded
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    # Standard RoPE (reference feeds `normal_position`, src/tts/engine.rs:316):
    # all rotary freqs on the temporal stream.
    mrope_sections: Tuple[int, int, int, int] = (64, 0, 0, 0)
    dtype: str = "bfloat16"
    # layer-scan unroll factor (measured slower >1 on v5e; kept as a knob)
    scan_unroll: int = 1
    # TP head interleave: wqkv columns permuted into this many device
    # blocks [q_d | k_d | v_d] so GSPMD's contiguous column shards align
    # with the q/k/v head split (parallel/sharding.interleave_wqkv). 1 =
    # flat reference layout. Set by parallel/run from the mesh.
    tp_interleave: int = 1

    def __post_init__(self):
        assert sum(self.mrope_sections) == self.head_dim // 2


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """Streaming codec decoder (codes -> 24 kHz waveform).

    The reference runs this as an opaque ONNX graph (`src/models/onnx.rs:
    324-496`); the carried state it threads through (pre_conv_history
    [1,512,T], latent_buffer [1,1024,T], conv_history [1,1024,T], 8 KV pairs
    [1,16,T,64]) pins the architecture: code-embedding sum -> pre-conv stack
    (512 ch) -> 8-layer/16-head/64-head-dim transformer with carried KV ->
    post-conv stack (1024 ch) -> upsampling head emitting 2000 samples/frame.
    """

    code_vocab: int = protocol.CODE_VOCAB
    num_codebooks: int = protocol.NUM_CODEBOOKS
    embed_dim: int = 512        # pre_conv_history channel count
    hidden: int = 1024          # latent/conv_history channel count
    n_layers: int = 8
    n_heads: int = 16
    head_dim: int = 64
    ffn_dim: int = 4096
    pre_conv_kernel: int = 3    # causal conv over frames, embed -> hidden
    post_conv_kernel: int = 3   # causal post-net conv, hidden -> hidden
    # centered post-conv lookahead (frames): the source of the reference's
    # variable `valid_samples` / `is_last` flush (src/models/onnx.rs:398-405)
    lookahead: int = 2
    # frame-local transposed-conv upsampler strides (product == 2000
    # samples/frame, src/models/onnx.rs:108-119); kernel == stride, so each
    # stage is a pure matmul
    upsample_factors: Tuple[int, ...] = (5, 5, 5, 4, 4)
    frame_samples: int = protocol.FRAME_SAMPLES
    max_frames: int = 1024      # KV capacity in streaming state (covers the
                                # long-text max-steps=1024 config)
    rms_eps: float = 1e-6
    dtype: str = "float32"
    # conv-stack / upsampler activation. "gelu" is the derived architecture;
    # "snake" (x + sin^2(alpha*x)/alpha, per-channel alpha — the BigVGAN-
    # family codec activation) is supported end-to-end (init, decode,
    # ONNX conversion) in case the real release uses it
    activation: str = "gelu"
    # ---- general upsampler family (BigVGAN/DAC lineage) ----
    # Setting upsample_kernels selects the GENERAL streaming upsampler:
    # per-stage ConvTranspose1d with kernel != stride (overlap-add across
    # frames, so chunk boundaries carry state), optional residual dilated
    # conv units after each stage (DAC ResidualUnit: act -> dilated
    # Conv(k=resblock_kernel) -> act -> Conv(k=1) -> +skip), and a final
    # output conv -> tanh. None keeps the kernel==stride matmul fast path.
    upsample_kernels: Optional[Tuple[int, ...]] = None
    # left output trim per stage (ONNX ConvTranspose pads[0]); right trim is
    # implied as kernel - stride - left. None = (k - s + 1) // 2 per stage.
    upsample_pads: Optional[Tuple[int, ...]] = None
    # per-stage output channels. None = halving schedule (floor 32).
    upsample_channels: Optional[Tuple[int, ...]] = None
    resblock_kernel: int = 7
    # dilations of the residual units after EVERY stage (empty = none)
    resblock_dilations: Tuple[int, ...] = ()
    # output conv kernel (general path only), C_last -> 1, centered padding
    final_conv_kernel: int = 7

    @property
    def general_upsampler(self) -> bool:
        return self.upsample_kernels is not None

    def __post_init__(self):
        if self.upsample_kernels is not None:
            n = len(self.upsample_factors)
            assert len(self.upsample_kernels) == n
            for k, s in zip(self.upsample_kernels, self.upsample_factors):
                assert k >= s, f"upsample kernel {k} < stride {s}"
            if self.upsample_pads is not None:
                assert len(self.upsample_pads) == n
                for p, k, s in zip(self.upsample_pads,
                                   self.upsample_kernels,
                                   self.upsample_factors):
                    assert 0 <= p <= k - s, (
                        f"pad {p} outside [0, kernel-stride={k - s}]")
            if self.upsample_channels is not None:
                assert len(self.upsample_channels) == n


def save_vocoder_config(path: str, cfg: "VocoderConfig") -> None:
    """Persist a (possibly graph-derived) vocoder architecture next to its
    checkpoint, so loading deserializes against the right config."""
    import json
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def load_vocoder_config(path: str) -> "VocoderConfig":
    import json
    with open(path) as f:
        raw = json.load(f)

    def detuple(v):
        return tuple(v) if isinstance(v, list) else v

    known = {f.name for f in dataclasses.fields(VocoderConfig)}
    return VocoderConfig(**{k: detuple(v) for k, v in raw.items()
                            if k in known})


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Librosa-aligned mel frontend (reference: src/models/onnx.rs:167-320)."""

    sample_rate: int = protocol.SAMPLE_RATE
    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float = 12000.0


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Mel [1,F,128] -> speaker embedding [2048]
    (reference: src/models/onnx.rs:140-163). Conv subsampling + transformer
    + attentive statistics pooling."""

    n_mels: int = 128
    hidden: int = 512
    n_layers: int = 6
    n_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 2048
    subsample_factors: Tuple[int, ...] = (2, 2)   # mel frames -> tokens
    out_dim: int = protocol.EMBED_DIM
    rms_eps: float = 1e-6
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Waveform [N] -> codes [N // 2000, 16] (reference:
    src/models/onnx.rs:97-121). Mirror image of the vocoder: strided
    downsampling stack (reverse of its upsample_factors) -> transformer ->
    512-d latent -> 16-stage RVQ against the shared codebooks."""

    frame_samples: int = protocol.FRAME_SAMPLES
    num_codebooks: int = protocol.NUM_CODEBOOKS
    code_vocab: int = protocol.CODE_VOCAB
    hidden: int = 1024
    latent_dim: int = 512        # == VocoderConfig.embed_dim (shared RVQ)
    n_layers: int = 8
    n_heads: int = 16
    head_dim: int = 64
    ffn_dim: int = 4096
    downsample_factors: Tuple[int, ...] = (4, 4, 5, 5, 5)  # product = 2000
    rms_eps: float = 1e-6
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Mirror of the reference `SamplerConfig` (src/tts/engine.rs:13-45)."""

    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.9
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    talker: TalkerConfig = TalkerConfig()
    predictor: PredictorConfig = PredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    mel: MelConfig = MelConfig()
    speaker_encoder: SpeakerEncoderConfig = SpeakerEncoderConfig()
    audio_encoder: AudioEncoderConfig = AudioEncoderConfig()
    max_steps: int = 512        # generation frames cap (CLI --max-steps)
    lang_id: int = protocol.DEFAULT_LANG_ID


def tiny_engine_config(max_steps: int = 16) -> EngineConfig:
    """Small geometry for CPU tests: same protocol, toy transformer sizes."""
    return EngineConfig(
        talker=TalkerConfig(
            hidden=64, n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=16,
            ffn_dim=128, vocab=2176, max_seq=512,
            mrope_sections=(4, 2, 2, 0), dtype="float32",
        ),
        predictor=PredictorConfig(
            hidden=32, n_layers=2, n_q_heads=2, n_kv_heads=2, head_dim=16,
            ffn_dim=64, max_seq=32, mrope_sections=(8, 0, 0, 0), dtype="float32",
        ),
        vocoder=VocoderConfig(
            embed_dim=16, hidden=32, n_layers=2, n_heads=2, head_dim=16,
            ffn_dim=64, lookahead=2, upsample_factors=(5, 5, 5, 4, 4),
            max_frames=32,
        ),
        speaker_encoder=SpeakerEncoderConfig(
            hidden=32, n_layers=1, n_heads=2, head_dim=16, ffn_dim=64,
        ),
        audio_encoder=AudioEncoderConfig(
            hidden=32, latent_dim=16, n_layers=1, n_heads=2, head_dim=16,
            ffn_dim=64,
        ),
        max_steps=max_steps,
    )
