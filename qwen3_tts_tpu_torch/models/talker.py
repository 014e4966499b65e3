"""Talker: the decoder that emits codec-codebook-0 logits. Port of
`qwen3_tts_tpu/models/talker.py`.

Ragged prompt batches are LEFT-padded: row b's prompt occupies cache slots
[pad_offset[b], prompt_slots); RoPE positions are max(slot - pad_offset, 0)
and pad slots are masked out of attention through `kv_valid_from`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops import fused_talker
from . import decoder


def prefill(params: decoder.DecoderParams, cfg, prompt_embeds: torch.Tensor,
            pad_offset: torch.Tensor, cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt [B, S, H] through the talker. Returns (hidden of the last
    position [B, H], its logits [B, vocab], cache)."""
    S = prompt_embeds.shape[1]
    slots = torch.arange(S, device=prompt_embeds.device)[None]
    positions = (slots - pad_offset.long()[:, None]).clamp_min(0)
    h, logits, cache = decoder.forward(
        params, cfg, prompt_embeds, positions, cache, 0,
        kv_valid_from=pad_offset)
    return h[:, -1], logits[:, -1], cache


def step(params: decoder.DecoderParams, cfg, feedback: torch.Tensor,
         slot, pad_offset: torch.Tensor,
         cache: Dict[str, torch.Tensor], plain: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step at cache slot `slot`: a host int shared by
    the rows (one stream or an offline batch), or a device int32 [B], one
    slot a row (continuous batching). It runs through the fused step;
    `plain` runs the plain versions of its kernels instead (the on-card
    baseline). The step takes the slot, the positions and the prefix
    bounds as device int32 [B]. Returns (hidden [B, H], logits [B, vocab],
    cache updated in place)."""
    B = feedback.shape[0]
    if isinstance(slot, torch.Tensor):
        slot_b = slot.to(torch.int32).reshape(B)
    else:
        slot_b = torch.full((B,), slot, dtype=torch.int32,
                            device=feedback.device)
    fn = fused_talker.talker_step_fused_plain if plain \
        else fused_talker.talker_step_fused
    h, logits, k, v = fn(
        params, cfg, feedback, slot_b - pad_offset, slot_b, slot_b,
        pad_offset, cache["k"], cache["v"])
    return h, logits, {"k": k, "v": v}
