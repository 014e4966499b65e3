"""Weight bridge: the JAX package's parameters (as numpy arrays) -> the
port's tensors.

Parameters may come as the nested trees the JAX package builds (dicts and
lists of arrays) or as the flat `.npz` dicts written by
`qwen3_tts_tpu/assets/checkpoint.py`, keyed by tree paths such as
`layers/wqkv` or `up/0/w`. The layouts are the same in both packages
([in, out] matrices, [L, ...] stacks, the int8 / int4 dicts of
`ops/quant.py`), so the bridge only moves arrays: float leaves take the
model dtype, except a quantized weight's f32 `scale`; integer leaves keep
their type.
The port's own random init draws from a `torch.Generator` and does not
reproduce JAX's numbers: a comparison of the two packages goes through
this bridge.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .assets.tables import Assets, build_assets


def unflatten(flat: Dict[str, Any]) -> Any:
    """{"a/0/b": x} -> {"a": [{"b": x}]}: numeric path parts become lists."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def _tree(tree):
    if isinstance(tree, dict) and any("/" in k for k in tree):
        return unflatten(tree)
    return tree


def _to_torch(tree, device, dtype: Optional[torch.dtype]):
    if isinstance(tree, dict):
        # a quantized weight's per-channel scale stays f32, as the JAX
        # package keeps it (its integer q / q4 / m8 stay int8 below)
        quantized = "scale" in tree and ("q" in tree or "q4" in tree)
        return {k: _to_torch(v, device,
                             None if quantized and k == "scale" else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(np.array(arr)).to(device)
    # floats, bfloat16 included, go through f32; np.array copies (arrays
    # viewed from JAX buffers are read-only)
    t = torch.from_numpy(np.array(arr, np.float32))
    return t.to(device=device, dtype=dtype or torch.float32)


def decoder_from_numpy(tree, device="cpu",
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """A `models/decoder` parameter tree (nested or flat npz keys)."""
    return _to_torch(_tree(tree), device, dtype)


def assets_from_numpy(text_table, codec_tables, proj_weight, proj_bias,
                      device="cpu", dtype: torch.dtype = torch.float32
                      ) -> Assets:
    """Assets from the JAX `Assets` fields (codec tables stacked
    [16, rows, dim] or a list of [rows_q, dim])."""
    codecs = list(np.asarray(codec_tables)) \
        if not isinstance(codec_tables, (list, tuple)) else codec_tables
    return build_assets(text_table, codecs, proj_weight, proj_bias,
                        device=device, dtype=dtype)


def vocoder_from_numpy(tree, device="cpu") -> Dict[str, Any]:
    """A `models/vocoder` parameter tree of either upsampler family (the
    kernel == stride stages' `w` / `b`, or the general family's `wt` /
    `b` / `res` units and `final` conv) with or without snake alphas;
    float leaves become f32."""
    return _to_torch(_tree(tree), device, None)


def encoders_from_numpy(audio_tree, speaker_tree, config, device="cpu"):
    """(AudioEncoder, SpeakerEncoder) holding the JAX package's encoder
    parameters (`models/encoders.py` trees, nested or flat npz keys), f32,
    for `config` (an EngineConfig)."""
    from .models.encoders import AudioEncoder, SpeakerEncoder

    return (AudioEncoder(_to_torch(_tree(audio_tree), device, None),
                         config.audio_encoder),
            SpeakerEncoder(_to_torch(_tree(speaker_tree), device, None),
                           config.speaker_encoder, config.mel))


def engine_from_jax_arrays(models: Dict[str, Any], vocoder_params,
                           config, *, device=None, speakers_dir=None):
    """A port `TtsEngine` holding the JAX engine's weights.

    `models` has "talker" and "predictor" trees and "assets" (an object or
    dict with the `Assets` fields), all numpy-convertible;
    `vocoder_params` is the vocoder tree. `device=None` means the CUDA card,
    as for `TtsEngine`, and raises where there is none; CPU use passes
    `device="cpu"`."""
    from .tts.engine import TtsEngine, default_device

    device = torch.device(device) if device is not None else default_device()

    a = models["assets"]
    get = a.get if isinstance(a, dict) else (lambda k: getattr(a, k))
    assets = assets_from_numpy(get("text_table"), get("codec_tables"),
                               get("proj_weight"), get("proj_bias"),
                               device=device)
    ported = {
        "talker": decoder_from_numpy(models["talker"], device,
                                     getattr(torch, config.talker.dtype)),
        "predictor": decoder_from_numpy(
            models["predictor"], device,
            getattr(torch, config.predictor.dtype)),
        "assets": assets,
    }
    vtree = _tree(vocoder_params)
    voc = vocoder_from_numpy(vtree, device)
    voc["transformer"] = decoder_from_numpy(
        vtree["transformer"], device,
        getattr(torch, config.vocoder.dtype))
    return TtsEngine(config=config, device=device, speakers_dir=speakers_dir,
                     weights=(ported, voc))
