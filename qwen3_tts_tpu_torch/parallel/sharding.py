"""Partition specs: how every weight / activation maps onto the mesh. The
port of `qwen3_tts_tpu/parallel/sharding.py`.

Megatron-style tensor parallelism for the decoder stacks: the QKV and MLP
up-projections are column-split over `model` (heads and ffn columns
split), the output and down projections row-split, so each of those two
products is followed by one all_reduce (`models/decoder.forward`). KV
caches split over the kv-head axis, utterance batches over `data`.
Embedding tables and the small projection stay replicated. The spec type
is the port's own (`mesh.PartitionSpec`, a tuple of axis names or None).

Deliberate divergence from the JAX package: `interleave_gate_up`. Both
packages split the fused gate/up product into halves [gate | up] after
the product; contiguous column shards of w_gu would give rank 0 only gate
columns. JAX's GSPMD reshards the product to fix that; the port has no
resharding, so it permutes w_gu's columns into m device blocks [gate_d |
up_d] before the split (`parallel/run.shard_models`), as
`interleave_wqkv` does for q / k / v.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..assets.tables import Assets
from .mesh import DATA_AXIS, MODEL_AXIS, P


def interleave_perm(nq: int, nk: int, hd: int, m: int):
    """Column permutation taking the flat fused-qkv layout [q | k | v] to
    `m` device blocks [q_d | k_d | v_d] (d = 0..m-1), where block d holds
    the original contiguous head ranges d*nq/m.. and d*nk/m.. — so
    contiguous column shards of the permuted matrix align exactly with the
    per-device q/k/v split, while the recomposed global head order is
    unchanged (decoder.forward ni-split).
    """
    assert nq % m == 0 and nk % m == 0, (nq, nk, m)
    nqm, nkm = nq // m, nk // m
    q_off, k_off, v_off = 0, nq * hd, (nq + nk) * hd
    perm = []
    for d in range(m):
        perm.append(np.arange(q_off + d * nqm * hd,
                              q_off + (d + 1) * nqm * hd))
        perm.append(np.arange(k_off + d * nkm * hd,
                              k_off + (d + 1) * nkm * hd))
        perm.append(np.arange(v_off + d * nkm * hd,
                              v_off + (d + 1) * nkm * hd))
    return np.concatenate(perm)


def interleave_wqkv(wqkv, cfg, m: int):
    """Apply interleave_perm to a stacked dense wqkv [L, H, (nq+2nk)*hd]."""
    assert not isinstance(wqkv, dict), \
        "TP interleave applies to dense weights (quantize after)"
    perm = interleave_perm(cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim, m)
    return wqkv[..., torch.as_tensor(perm, device=wqkv.device)]


def gate_up_perm(ffn: int, m: int):
    """Column permutation taking the fused [gate | up] layout (ffn columns
    each) to `m` device blocks [gate_d | up_d], block d holding columns
    d*ffn/m .. (d+1)*ffn/m of both halves: a rank's contiguous column
    shard then splits into halves as the whole product does."""
    assert ffn % m == 0, (ffn, m)
    f = ffn // m
    return np.concatenate([
        np.concatenate([np.arange(d * f, (d + 1) * f),
                        ffn + np.arange(d * f, (d + 1) * f)])
        for d in range(m)])


def interleave_gate_up(w_gu, cfg, m: int):
    """Apply gate_up_perm to a stacked dense w_gu [L, H, 2F]."""
    assert not isinstance(w_gu, dict), \
        "TP interleave applies to dense weights (quantize after)"
    perm = gate_up_perm(cfg.ffn_dim, m)
    return w_gu[..., torch.as_tensor(perm, device=w_gu.device)]


def decoder_param_specs() -> Dict[str, Any]:
    """Specs matching models.decoder init_decoder's tree layout
    ([L, ...] stacked layers)."""
    return {
        "layers": {
            "ln1": P(),
            "wqkv": P(None, None, MODEL_AXIS),   # column: heads split
            "q_norm": P(),
            "k_norm": P(),
            "wo": P(None, MODEL_AXIS, None),     # row: all_reduce after
            "ln2": P(),
            "w_gu": P(None, None, MODEL_AXIS),
            "w_down": P(None, MODEL_AXIS, None),
        },
        "final_norm": P(),
        "head": P(None, MODEL_AXIS),             # vocab-split logits
    }


def assets_specs() -> Assets:
    # the same type as the real Assets, so the trees match field by field
    return Assets(
        text_table=P(),
        codec_tables=P(),
        proj_weight=P(),
        proj_bias=P(),
    )


def models_specs() -> Dict[str, Any]:
    """Specs for the engine's `models` dict (talker/predictor/assets)."""
    return {
        "talker": decoder_param_specs(),
        "predictor": decoder_param_specs(),
        "assets": assets_specs(),
    }


def kv_cache_specs() -> Dict[str, Any]:
    # [L, B, n_kv_heads, T, head_dim] (head-major layout)
    spec = P(None, DATA_AXIS, MODEL_AXIS, None, None)
    return {"k": spec, "v": spec}


def batch_spec() -> P:
    """Utterance-batch activations: [B, S, H]."""
    return P(DATA_AXIS)


def vocoder_param_specs() -> Dict[str, Any]:
    """JAX's vocoder placement, kept for reference: the port runs the
    vocoder replicated (`parallel/run.shard_models`)."""
    conv = {"w": P(), "b": P()}
    return {
        "embed": P(),
        "pre_conv": conv,
        "transformer": decoder_param_specs(),
        "post_a": conv,
        "post_b": conv,
        # transposed-conv matmul stages: shard the wide output columns
        "up": [{"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}
               for _ in range(5)],
    }
