"""Sharded end-to-end step: build models on a mesh and run generation. The
port of `qwen3_tts_tpu/parallel/run.py`.

Each rank holds its shard of the talker and the predictor
(`sharding.models_specs`: heads, ffn columns and the head's vocabulary
over `model`) and its rows of the batch (`data`). A model group runs the
offline loop of `tts/generate.py` with its group (`tp`), every rank on the
same rows; data ranks run their own rows and share no collective until the
results are gathered at the end.

Deliberate divergences from the JAX package:
  * the vocoder is replicated on every rank, each data rank decoding its
    own rows (JAX splits its upsampler's columns over `model`,
    `sharding.vocoder_param_specs`): EngineConfig()'s vocoder holds
    0.66 GB of f32 weights (657,858,064 bytes) on every rank, against the
    talker's 2.83 GB of bf16 split over `model`, and runs once an
    utterance offline;
  * w_gu is permuted into [gate_d | up_d] blocks besides wqkv's [q_d |
    k_d | v_d] (`sharding.interleave_gate_up`), since no resharding
    follows the product;
  * `sharded_generate_step` takes the prompt as an optional argument: the
    port draws it from a seeded torch.Generator, and a comparison with
    the JAX package hands JAX's numbers in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.config import (EngineConfig, PredictorConfig, TalkerConfig,
                           VocoderConfig)
from ..ops import quant
from ..tts import generate
from . import mesh as mesh_lib
from . import sharding
from .mesh import DATA_AXIS, MODEL_AXIS


def parallel_test_config(max_steps: int = 4) -> EngineConfig:
    """Tiny geometry whose head/ffn dims divide a 4-way model axis."""
    return EngineConfig(
        talker=TalkerConfig(
            hidden=64, n_layers=2, n_q_heads=8, n_kv_heads=4, head_dim=16,
            ffn_dim=128, vocab=2176, max_seq=256,
            mrope_sections=(4, 2, 2, 0), dtype="float32",
        ),
        predictor=PredictorConfig(
            hidden=32, n_layers=2, n_q_heads=4, n_kv_heads=4, head_dim=16,
            ffn_dim=64, max_seq=32, mrope_sections=(8, 0, 0, 0),
            dtype="float32",
        ),
        vocoder=VocoderConfig(
            embed_dim=16, hidden=32, n_layers=2, n_heads=4, head_dim=8,
            ffn_dim=64, lookahead=2, max_frames=16,
        ),
        max_steps=max_steps,
    )


def tp_interleave_factor(mesh, cfg) -> int:
    """Head-interleave factor for this mesh's model axis (1 = flat layout).
    Must be applied identically at weight-placement and at run time —
    both shard_models and sharded_generate_step derive it from the mesh
    so callers cannot desynchronise the two."""
    m = mesh_lib.axis_size(mesh, MODEL_AXIS)
    if m > 1 and cfg.n_q_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return m
    return 1


def tp_config(mesh, cfg: EngineConfig) -> EngineConfig:
    """EngineConfig with tp_interleave set for this mesh."""
    return dataclasses.replace(
        cfg,
        talker=dataclasses.replace(
            cfg.talker,
            tp_interleave=tp_interleave_factor(mesh, cfg.talker)),
        predictor=dataclasses.replace(
            cfg.predictor,
            tp_interleave=tp_interleave_factor(mesh, cfg.predictor)),
    )


def shard_models(mesh, cfg: EngineConfig, models: Dict, vocoder_params,
                 quant_kinds: Optional[Dict[str, str]] = None):
    """This rank's shard of full models (`TtsEngine`'s layout: "talker",
    "predictor", "assets"; dense) and the vocoder, replicated. Where the
    mesh's model axis has m > 1 ranks, wqkv and w_gu are interleaved into
    m blocks first (`sharding`), which needs m to divide both head counts.
    `quant_kinds` ({"talker": "int8" | "int4", "predictor": ...})
    quantizes a decoder: int8 after the interleave and before the split
    (per-column int8 commutes with a column split but not with a row split
    of wo / w_down, so each shard holds the whole weight's quantization,
    exactly the single-device model's); int4 after the split (its rows
    pack in pairs and groups of 128: a row shard must be a multiple of 256
    rows)."""
    m = mesh_lib.axis_size(mesh, MODEL_AXIS)
    quant_kinds = quant_kinds or {}
    out = {}
    for name, part in (("talker", cfg.talker), ("predictor", cfg.predictor)):
        p = models[name]
        if m > 1:
            if tp_interleave_factor(mesh, part) != m:
                raise ValueError(f"{name}: a model axis of {m} must divide "
                                 f"{part.n_q_heads} q and {part.n_kv_heads} "
                                 "kv heads")
            lw = dict(p["layers"])
            lw["wqkv"] = sharding.interleave_wqkv(lw["wqkv"], part, m)
            lw["w_gu"] = sharding.interleave_gate_up(lw["w_gu"], part, m)
            p = dict(p, layers=lw)
        kind = quant_kinds.get(name)
        if kind == "int8":
            p = quant.quantize_decoder_params(p, kind="int8")
        p = mesh_lib.shard(mesh, p, sharding.decoder_param_specs())
        if kind == "int4":
            p = quant.quantize_decoder_params(p, kind="int4")
        elif kind not in (None, "int8"):
            raise ValueError(f"{name}: quantization {kind!r}: int8 or int4")
        out[name] = p
    out["assets"] = mesh_lib.shard(mesh, models["assets"],
                                   sharding.assets_specs())
    return out, mesh_lib.replicated(mesh, vocoder_params)


def build_sharded_models(mesh, cfg: EngineConfig, seed: int = 0):
    """Random weights (`TtsEngine(random_weights=True, seed)`'s, drawn on
    this rank's device) placed with TP/DP specs on the mesh: every rank
    draws the whole models and keeps its shard (`shard_models`)."""
    from ..tts.engine import random_weights

    models, voc = random_weights(cfg, seed, mesh_lib.device(mesh))
    return shard_models(mesh, cfg, models, voc)


def sharded_generate_step(
    mesh,
    cfg: EngineConfig,
    models: Dict,
    vocoder_params: Dict,
    batch: int,
    prompt_len: int,
    max_steps: int,
    seed: int = 0,
    *,
    prompt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sharded pipeline: DP prompt batch -> generation loop (greedy)
    -> vocoder decode. `models` / `vocoder_params` are this rank's
    (`shard_models`). `prompt` [batch, prompt_len, talker hidden]
    (default 0.1 x normal from a generator seeded seed + 1) is the whole
    batch, the same on every rank. Returns (wav [B, T], n_frames [B]) of
    the whole batch on every rank."""
    dev = mesh_lib.device(mesh)
    if prompt is None:
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        prompt = 0.1 * torch.randn(batch, prompt_len, cfg.talker.hidden,
                                   generator=g, device=dev)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rows = mesh_lib.local_slice(prompt.to(dev), sharding.batch_spec(),
                                shape, mesh_lib.coordinates(mesh))
    pad = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
    cfg = tp_config(mesh, cfg)      # match shard_models' layout
    wav, n_frames = generate.generate_audio(
        models, vocoder_params, cfg.talker, cfg.predictor, cfg.vocoder,
        rows, pad, None, 0.0, 0, 1.0, max_steps,
        tp=mesh_lib.group(mesh, MODEL_AXIS))
    data = mesh_lib.group(mesh, DATA_AXIS)
    if data is not None:
        wav = mesh_lib.all_gather(wav, data, dim=0)
        n_frames = mesh_lib.all_gather(n_frames, data, dim=0)
    return wav, n_frames
