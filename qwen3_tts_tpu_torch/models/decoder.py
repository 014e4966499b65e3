"""Qwen3-style decoder shared by the talker, the predictor and the vocoder
trunk: the port of `qwen3_tts_tpu/models/decoder.py`.

Embedding inputs (never token ids), RMSNorm + QK-norm, GQA with M-RoPE,
SwiGLU MLP, final norm + head. Weights are a plain dict of stacked
tensors in the JAX layout ([in, out] matrices, [L, ...] stacks):

  layers/ln1 [L,H], wqkv [L,H,(nq+2nk)*hd], q_norm [L,hd], k_norm [L,hd],
  wo [L,nq*hd,H], ln2 [L,H], w_gu [L,H,2F], w_down [L,F,H]
  final_norm [H], head [H, vocab]

The four layer matmuls and the head may instead be int8 or int4 dicts
(`ops/quant.py`, from `quant.quantize_decoder_params`); every product goes
through `quant.linear`, so an int8 prefill runs kernel A on the card.

The KV cache is {"k", "v": [L, B, nk, T, hd]}, written in place (the JAX
version returns an updated copy; in place saves a cache-sized copy per
call). `forward` at S == 1 attends through `ops/flash_decode` (the
pre-update formulation, as the JAX package does on the TPU); at S > 1 it
writes the cache then runs the dense masked attention of `ops/attention`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops import attention, flash_decode, quant, rope
from ..ops.elementwise import rms_norm_plain, silu_mul_plain
from ..ops.quant import linear

DecoderParams = Dict[str, Any]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Single-rounding form: all f32 math, one cast to x.dtype."""
    return rms_norm_plain(x, scale, eps, x.dtype)


def init_decoder(generator: torch.Generator, cfg, *, device="cpu",
                 scale: float = 0.02) -> DecoderParams:
    """Seeded random weights with the JAX package's shapes and init rule
    (norms 1, matrices 0.02 * normal), drawn from `generator`."""
    L, H, F = cfg.n_layers, cfg.hidden, cfg.ffn_dim
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)

    def w(*shape):
        # drawn one layer at a time: an f32 temporary of a whole stack
        # would be 2.8 GB for the flagship gate/up
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            out[i] = scale * torch.randn(shape[1:], generator=generator,
                                         device=device)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return {
        "layers": {
            "ln1": ones(L, H),
            "wqkv": w(L, H, (nq + 2 * nk) * hd),
            "q_norm": ones(L, hd),
            "k_norm": ones(L, hd),
            "wo": w(L, nq * hd, H),
            "ln2": ones(L, H),
            "w_gu": w(L, H, 2 * F),
            "w_down": w(L, F, H),
        },
        "final_norm": ones(H),
        "head": w(H, cfg.vocab),
    }


def init_kv_cache(cfg, batch: int, dtype=None, length: int | None = None,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Zeros [L, B, nk, T, hd]; `length` overrides cfg.max_seq."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, length or cfg.max_seq,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_layer_cache(cache_all: torch.Tensor, new: torch.Tensor, layer: int,
                      start) -> None:
    """In place: new [B, S, nk, hd] into cache_all [L, B, nk, T, hd] at
    (layer, b, :, start[b]:start[b]+S, :); `start` int or [B]."""
    B, S = new.shape[:2]
    if isinstance(start, int):
        cache_all[layer, :, :, start:start + S] = \
            new.transpose(1, 2).to(cache_all.dtype)
        return
    start = attention.per_row(start, B, new.device)
    idx = start[:, None] + torch.arange(S, device=new.device)      # [B, S]
    rows = torch.arange(B, device=new.device)[:, None]
    cache_all[layer, rows, :, idx] = new.to(cache_all.dtype)


def head_logits(params: DecoderParams, h: torch.Tensor, start: int,
                width: int) -> torch.Tensor:
    """f32 logits of the head's column slice [start, start + width), for
    dense, int8 and int4 heads (column slices are packing-transparent: the
    int4 nibbles pair rows, not columns)."""
    head = params["head"]
    cols = slice(start, start + width)
    if isinstance(head, dict):
        return linear(h, {k: v[..., cols] for k, v in head.items()}).float()
    return (h @ head[:, cols]).float()


def forward(
    params: DecoderParams,
    cfg,
    x: torch.Tensor,            # [B, S, H] embedding inputs
    positions: torch.Tensor,    # [B, S] sequence positions
    cache: Dict[str, torch.Tensor],
    cache_len,                  # int or [B]: tokens already in the cache
    *,
    kv_valid_from=None,         # [B] first valid cache slot
    with_logits: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor | None, Dict[str, torch.Tensor]]:
    """Run S new tokens. Returns (hidden [B,S,H], logits [B,S,vocab] f32 or
    None, cache) — the cache is updated in place and returned."""
    B, S, H = x.shape
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    dev = x.device
    lw = params["layers"]
    k_all, v_all = cache["k"], cache["v"]

    cos, sin = rope.rope_angles(rope.mrope_positions(positions),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    if S == 1:
        kv_len_b = attention.per_row(cache_len, B, dev).to(torch.int32)
        vfrom_b = (attention.per_row(kv_valid_from, B, dev).to(torch.int32)
                   if kv_valid_from is not None
                   else torch.zeros(B, dtype=torch.int32, device=dev))
    else:
        kv_len = attention.per_row(cache_len, B, dev) + S

    h = x.to(dt)
    for l in range(cfg.n_layers):
        a_in = rms_norm(h, lw["ln1"][l], cfg.rms_eps)
        qkv = linear(a_in, quant.layer(lw["wqkv"], l))
        q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
        k = qkv[..., nq * hd: (nq + nk) * hd].reshape(B, S, nk, hd)
        v = qkv[..., (nq + nk) * hd:].reshape(B, S, nk, hd)
        q = rope.apply_rope(rms_norm(q, lw["q_norm"][l], cfg.rms_eps),
                            cos, sin)
        k = rope.apply_rope(rms_norm(k, lw["k_norm"][l], cfg.rms_eps),
                            cos, sin)
        if S == 1:
            # pre-update cache: the current token's k/v go in directly, the
            # cache write follows the attention
            attn = flash_decode.decode_attention_stacked(
                q[:, 0].contiguous(), k_all, v_all,
                k[:, 0].contiguous().to(q.dtype),
                v[:, 0].contiguous().to(q.dtype), l, kv_len_b, vfrom_b,
            )[:, None]
            write_layer_cache(k_all, k, l, cache_len)
            write_layer_cache(v_all, v, l, cache_len)
        else:
            write_layer_cache(k_all, k, l, cache_len)
            write_layer_cache(v_all, v, l, cache_len)
            attn = attention.gqa_attention(q, k_all[l], v_all[l], cache_len,
                                           kv_len, kv_valid_from)
        h = h + linear(attn.reshape(B, S, nq * hd),
                       quant.layer(lw["wo"], l))
        m_in = rms_norm(h, lw["ln2"][l], cfg.rms_eps)
        gu = linear(m_in, quant.layer(lw["w_gu"], l))
        # silu in f32 with a single rounding to the model dtype
        h = h + linear(silu_mul_plain(gu, gu.dtype),
                       quant.layer(lw["w_down"], l))

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = linear(h, params["head"]).float() if with_logits else None
    return h, logits, cache
