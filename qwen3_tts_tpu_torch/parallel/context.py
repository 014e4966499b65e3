"""Long-context / sequence-parallel prefill: the port of
`qwen3_tts_tpu/parallel/context.py`.

Prefill is where long prompts cost: O(S^2) attention plus O(S) products
over every layer (a long clone reference plus its text can fill most of
the talker's 4096-slot window). This module splits the SEQUENCE of a
prefill over the mesh's data axis: each data rank runs every qkv / wo /
mlp product, norm and rope on its S/D tokens, and each layer gathers K/V
once (`models/decoder.forward`'s `sp`), so every rank attends its queries
causally at their offset over all keys and writes every token to its
cache. The gather is O(S) memory, the right trade at the 4096-token cap
(ring attention's O(S/D) working set pays only far above it).

Composes with tensor parallelism: weights stay split over `model` (this
rank's shard, `parallel/run.shard_models`) while activations split over
`data`. The cache comes back in the decode layout: heads over `model`,
batch replicated (a long-context prefill is one utterance, so the data
axis carries the sequence and nothing after it).

Deliberate divergence from the JAX package: JAX constrains global arrays
and XLA places the gather; here x and positions are the whole prompt on
every rank, each rank takes its block, and the hidden states and logits
of all blocks are gathered back (in rank order) before returning.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models import decoder
from . import mesh as mesh_lib
from .mesh import DATA_AXIS, MODEL_AXIS, P


def seq_spec() -> P:
    """Prefill activations [B, S, H]: sequence over the data axis."""
    return P(None, DATA_AXIS, None)


def prefill_cache_specs() -> Dict[str, P]:
    """KV cache layout for sequence-parallel prefill: heads over `model`
    only (the decode spec also splits batch over `data`,
    sharding.kv_cache_specs; one utterance has no batch to split)."""
    spec = P(None, None, MODEL_AXIS, None, None)
    return {"k": spec, "v": spec}


def prefill_sequence_sharded(
    mesh,
    params: Dict,
    cfg,
    x: torch.Tensor,           # [B, S, H] prompt embeddings, whole
    positions: torch.Tensor,   # [B, S]
    cache: Dict[str, torch.Tensor],
    cache_len,
    *,
    kv_valid_from: Optional[torch.Tensor] = None,
    with_logits: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """decoder.forward with the sequence split over `data`. `params` and
    `cache` are this rank's (heads over `model`, `prefill_cache_specs`);
    `cfg` carries the mesh's tp_interleave (`run.tp_config`) where the
    model axis splits. Output contract matches decoder.forward: hidden
    [B, S, H] and logits [B, S, vocab] of the whole sequence, the cache
    with every token, in the decode layout."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = mesh_lib.coordinates(mesh)
    xs = mesh_lib.local_slice(x, seq_spec(), shape, coords)
    ps = mesh_lib.local_slice(positions, P(None, DATA_AXIS), shape, coords)
    sp = mesh_lib.group(mesh, DATA_AXIS)
    h, logits, cache = decoder.forward(
        params, cfg, xs, ps, cache, cache_len, kv_valid_from=kv_valid_from,
        with_logits=with_logits, tp=mesh_lib.group(mesh, MODEL_AXIS), sp=sp)
    if sp is not None:
        h = mesh_lib.all_gather(h, sp, dim=1)
        if logits is not None:
            logits = mesh_lib.all_gather(logits, sp, dim=1)
    return h, logits, cache
