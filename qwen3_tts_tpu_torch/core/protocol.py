"""Qwen3-TTS generation-protocol constants.

Single source of truth for every magic id used by the prompt / decode
protocol. The reference scatters these across `src/tts/prompt.rs:5-16`,
`src/tts/engine.rs:267,555,558` and `src/models/onnx.rs` — here they live in
one module so the whole framework (prompt assembly, samplers, tests) agrees.

All ids are *codec-codebook-0 vocabulary* ids unless suffixed `_TOKEN`
(text-vocabulary ids).

A copy of `qwen3_tts_tpu/core/protocol.py` (no framework imports).
"""

from __future__ import annotations

# --- codec-0 vocabulary control ids (reference: src/tts/prompt.rs:5-13) ---
PAD = 2148          # codec pad row, summed onto text-token embeddings
BOS = 2149          # generation-activation id (prompt suffix)
EOS = 2150          # talker end-of-speech code (src/tts/engine.rs:558)
THINK = 2154        # language-conditioning preamble (with lang id)
NOTHINK = 2155      # preamble without language conditioning
THINK_BOS = 2156
THINK_EOS = 2157
CODEC_BOS = 2160    # start-of-reference-audio marker (src/tts/prompt.rs:68)

# --- text-vocabulary ids (reference: src/tts/prompt.rs:8-9,16) ---
BOS_TOKEN = 151672          # wraps task / reference text
EOS_TOKEN = 151673          # also accepted as talker EOS (src/tts/engine.rs:558)
TEXT_AUDIO_MARKER = 151671  # "tts_pad" text row, summed onto codec embeddings

# chat-template text ids (reference: src/tts/prompt.rs:156-175)
IM_START = 151644
IM_END = 151645
ROLE_USER = 872
ROLE_ASSISTANT = 77091
NEWLINE = 198

# --- sampling / decode-loop constants ---
CODE_VOCAB = 2048            # acoustic codes per codebook are in [0, 2048)
TALKER_SAMPLE_LIMIT = 2160   # talker code_0 sampled from logits[0:2160]
                             # (src/tts/engine.rs:555)
NUM_CODEBOOKS = 16           # codes per frame (src/models/onnx.rs:108-119)
FRAME_SAMPLES = 2000         # waveform samples per frame at 24 kHz -> 12 fps
SAMPLE_RATE = 24000
STREAM_CHUNK_FRAMES = 4      # 64-code streaming chunk (src/tts/engine.rs:510)
STREAM_CHUNK_CODES = STREAM_CHUNK_FRAMES * NUM_CODEBOOKS

# EOS ids accepted from the talker head (src/tts/engine.rs:558-561)
TALKER_EOS_IDS = (EOS, EOS_TOKEN)

# --- language conditioning ---
# The reference hardcodes Chinese (2055) at src/tts/engine.rs:267. We expose
# the id and keep it overridable end-to-end (SURVEY.md §5 config note).
LANG_CHINESE = 2055
DEFAULT_LANG_ID = LANG_CHINESE

# Speaker ids live inside the codec-0 vocabulary (speakers/index.json):
# 2861..3066 for the nine shipped preset voices.
PRESET_SPEAKER_ID_RANGE = (2861, 3066)

# Embedding-table geometry (reference: src/assets_manager.rs:244-250)
TEXT_VOCAB = 151936
EMBED_DIM = 2048
PROJ_DIM = 1024
