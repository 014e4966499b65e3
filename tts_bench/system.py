"""The system under test: `qwen3_tts_tpu_torch` built from a configuration
file and the master weights.

This is the one module of the benchmark, beside the drivers, that imports
the program. It maps a configs/*.json onto the program's `EngineConfig`,
wraps the master tables in the program's `Assets`, quantises the decoders
on the device through the program's own `quantize_decoder_params` where
the configuration serves them quantised, and builds a `TtsEngine` on the
result.
"""

from __future__ import annotations

import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEAKERS = os.path.join(ROOT, "speakers")


def engine_config(config: dict, max_steps: int = 512):
    from qwen3_tts_tpu_torch.core.config import (EngineConfig,
                                                 PredictorConfig,
                                                 TalkerConfig, VocoderConfig)

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    v = tup(config["vocoder"])
    if v.get("activation", "gelu") != "gelu" \
            or v.get("upsample_kernels") is not None:
        raise ValueError("the reference vocodes the kernel == stride "
                         "upsampler with gelu only")
    return EngineConfig(talker=TalkerConfig(**tup(config["talker"])),
                        predictor=PredictorConfig(**tup(config["predictor"])),
                        vocoder=VocoderConfig(**v), max_steps=max_steps,
                        lang_id=config["lang_id"])


def build(config: dict, master: dict, device) -> "object":
    """A `TtsEngine` serving `master` as `config["weights"]` states: the
    talker's and the predictor's kinds ("dense", "int8", "int4"). A
    quantised decoder's dense master leaves are dropped once quantised,
    as a deployment holds only the quantised weights."""
    from qwen3_tts_tpu_torch.assets.tables import Assets
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.tts.engine import TtsEngine

    models = {"assets": Assets(**master["assets"])}
    for part in ("talker", "predictor"):
        kind = config["weights"][part]
        tree = master[part]
        if kind != "dense":
            with torch.no_grad():
                tree = quant.quantize_decoder_params(tree, kind=kind)
            master[part] = None
        models[part] = tree
    return TtsEngine(config=engine_config(config), weights=(
        models, master["vocoder"]), speakers_dir=SPEAKERS, device=device)


def sampler(traffic: dict, request):
    """The request's sampler: the traffic's `sampler` (temperature, top_k,
    top_p; the program's default `SamplerConfig` in every cell so far),
    seeded per request."""
    from qwen3_tts_tpu_torch.core.config import SamplerConfig
    return SamplerConfig(**traffic["sampler"], seed=request.sampler_seed)
