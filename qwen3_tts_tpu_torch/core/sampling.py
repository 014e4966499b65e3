"""Reference-semantics token sampling. Port of
`qwen3_tts_tpu/core/sampling.py`.

    greedy (temperature <= 0):  argmax over the slice, lowest index on ties
    otherwise:                  sort desc -> top-k truncate
                                -> softmax((l - max) / T)
                                -> top-p truncate (inclusive of the
                                   probability that crosses the threshold)
                                -> renormalise -> multinomial draw

The draw comes from an explicit `torch.Generator`; it reproduces the
reference's distribution, not the JAX package's random bits.
"""

from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis; ties resolve to the lowest index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Index into logits[..., :] (int32, leading shape of logits[..., 0])."""
    if temperature <= 0:
        return greedy_sample(logits)
    vocab = logits.shape[-1]
    k = vocab if top_k <= 0 else min(top_k, vocab)
    # a stable descending sort keeps the lowest index first among ties
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    probs = torch.softmax((vals - vals[..., :1]) / temperature, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True              # never drop the argmax candidate
    masked = torch.where(keep, probs, torch.zeros_like(probs))
    lead = masked.shape[:-1]
    draw = torch.multinomial(masked.reshape(-1, k), 1, generator=generator)
    return torch.gather(idx, -1, draw.reshape(*lead, 1))[..., 0].to(
        torch.int32)
