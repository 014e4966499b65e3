"""GQA attention over a KV cache, as plain tensor math.

Port of `qwen3_tts_tpu/ops/attention.py::gqa_attention`: the prefill path of
the talker and the vocoder trunk. It is written out in matmuls and a softmax
(no fused attention operator), so it is the same math as the JAX version.
All math accumulates in float32 regardless of the cache dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def per_row(x, batch: int, device) -> torch.Tensor:
    """Scalar-or-[B] position -> [B] int64 tensor."""
    x = torch.as_tensor(x, device=device).to(torch.long)
    if x.dim() == 0:
        x = x.expand(batch)
    return x


def gqa_attention(
    q: torch.Tensor,          # [B, S, nq, hd]
    k: torch.Tensor,          # [B, nk, T, hd] (full cache buffer)
    v: torch.Tensor,          # [B, nk, T, hd]
    q_start,                  # scalar or [B]: cache slot of query 0
    kv_len,                   # scalar or [B]: valid cache entries (incl. new)
    kv_valid_from=None,       # [B]: first valid cache slot
) -> torch.Tensor:
    """Query i of row b attends cache slots j with
    kv_valid_from[b] <= j <= q_start[b] + i and j < kv_len[b].
    Returns [B, S, nq, hd] in q.dtype."""
    B, S, nq, hd = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk
    dev = q.device

    qf = q.float().reshape(B, S, nk, g, hd)
    scores = torch.einsum("bskgh,bkth->bkgst", qf, k.float()) / math.sqrt(hd)

    t_idx = torch.arange(T, device=dev)
    q_pos = per_row(q_start, B, dev)[:, None] + torch.arange(S, device=dev)
    kv_len_b = per_row(kv_len, B, dev)
    mask = ((t_idx[None, None, :] <= q_pos[:, :, None])
            & (t_idx[None, None, :] < kv_len_b[:, None, None]))   # [B, S, T]
    if kv_valid_from is not None:
        vf = per_row(kv_valid_from, B, dev)
        mask = mask & (t_idx[None, :] >= vf[:, None])[:, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bkth->bskgh", probs, v.float())
    return out.reshape(B, S, nq, hd).to(q.dtype)
