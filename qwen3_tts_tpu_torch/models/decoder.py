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

A `wqkv` in the tensor-parallel layout (`cfg.tp_interleave` = ni > 1,
`parallel/sharding.interleave_wqkv`) holds ni column blocks [q_d | k_d |
v_d]; `forward` splits it block by block, as JAX's does.

Tensor parallelism (`parallel/`): `forward`, `head_logits` and
`init_kv_cache` take `tp`, this rank's process group of the mesh's model
axis, and then hold this rank's shard (`parallel/sharding`): the heads
of its wqkv column block and of its cache [L, B, nk/m, T, hd], its rows
of wo and w_down, its gate/up columns, its head columns. The partial
products of wo and w_down are summed by one all_reduce each on the group
(two a layer, JAX's two psums), in f32 and rounded once to the model
dtype, as the whole product is; the talker's logits are gathered
over the vocabulary; a head slice (`head_logits`) is computed by the rank
whose columns hold it and broadcast. `sp`, the data axis's group, runs a
prefill with the sequence split over it (`parallel/context.py`): each
rank's x is its block of S tokens, and each layer gathers K/V once. With
`tp` and `sp` None nothing changes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..ops import attention, flash_decode, quant, rope
from ..parallel import mesh as mesh_lib
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


def local_heads(cfg, tp=None) -> Tuple[int, int]:
    """(q heads, kv heads) of this rank: all of them, or with `tp` (a
    model group of m ranks) the m-th part of each."""
    nq, nk = cfg.n_q_heads, cfg.n_kv_heads
    if tp is None:
        return nq, nk
    m = dist.get_world_size(tp)
    if nq % m or nk % m:
        raise ValueError(f"tensor parallel over {m} ranks: {nq} q and {nk} "
                         "kv heads must both divide")
    return nq // m, nk // m


def init_kv_cache(cfg, batch: int, dtype=None, length: int | None = None,
                  device="cpu", tp=None) -> Dict[str, torch.Tensor]:
    """Zeros [L, B, nk, T, hd] (nk this rank's kv heads with `tp`);
    `length` overrides cfg.max_seq."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, local_heads(cfg, tp)[1],
             length or cfg.max_seq, cfg.head_dim)
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


def _cols(w) -> int:
    """Output columns of a dense, int8 or int4 weight."""
    return w["scale"].shape[-1] if isinstance(w, dict) else w.shape[-1]


def head_logits(params: DecoderParams, h: torch.Tensor, start: int,
                width: int, tp=None) -> torch.Tensor:
    """f32 logits of the head's column slice [start, start + width), for
    dense, int8 and int4 heads (column slices are packing-transparent: the
    int4 nibbles pair rows, not columns). With `tp` the head is this
    rank's block of columns: the rank whose block holds the slice computes
    it and broadcasts it to the group."""
    head = params["head"]
    if tp is not None:
        return _owned_slice(params, h, start, width, tp)
    cols = slice(start, start + width)
    if isinstance(head, dict):
        return linear(h, {k: v[..., cols] for k, v in head.items()}).float()
    return (h @ head[:, cols]).float()


def _owned_slice(params, h, start: int, width: int, tp) -> torch.Tensor:
    n = _cols(params["head"])                  # this rank's head columns
    owner = start // n
    if (start + width - 1) // n != owner:
        raise ValueError(f"head slice [{start}, {start + width}) crosses a "
                         f"shard of {n} columns")
    if dist.get_rank(tp) == owner:
        out = head_logits(params, h, start - owner * n, width).contiguous()
    else:
        out = torch.empty(*h.shape[:-1], width, dtype=torch.float32,
                          device=h.device)
    dist.broadcast(out, src=dist.get_global_rank(tp, owner), group=tp)
    return out


def split_qkv(qkv: torch.Tensor, nq: int, nk: int, hd: int, ni: int = 1):
    """q [B, S, nq, hd], k and v [B, S, nk, hd] from the fused product: the
    flat layout [q | k | v], or with ni > 1 ni column blocks [q_d | k_d |
    v_d] (`parallel/sharding.interleave_wqkv`), each block the original
    contiguous head range, so the head order (and the GQA grouping) is the
    flat layout's."""
    B, S = qkv.shape[:2]
    if ni > 1:
        nqm, nkm = nq // ni, nk // ni
        qkv4 = qkv.reshape(B, S, ni, (nqm + 2 * nkm) * hd)
        q = qkv4[..., : nqm * hd].reshape(B, S, nq, hd)
        k = qkv4[..., nqm * hd: (nqm + nkm) * hd].reshape(B, S, nk, hd)
        v = qkv4[..., (nqm + nkm) * hd:].reshape(B, S, nk, hd)
        return q, k, v
    q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
    k = qkv[..., nq * hd: (nq + nk) * hd].reshape(B, S, nk, hd)
    v = qkv[..., (nq + nk) * hd:].reshape(B, S, nk, hd)
    return q, k, v


def _reduced_product(x: torch.Tensor, w, tp) -> torch.Tensor:
    """x @ w for a row-split weight (wo, w_down): this rank's partial
    product in f32 (kernel A's f32 output for int8), summed over the model
    group by one all_reduce, then rounded once to x.dtype, as the whole
    product is on one device."""
    if quant.is_quantized(w):
        part = quant.qmatmul(x, w)
    elif quant.is_quantized4(w):
        part = quant.qmatmul4(x, w)
    else:
        part = x.float() @ w.float()
    dist.all_reduce(part, group=tp)
    return part.to(x.dtype)


def _blocks(cfg, tp) -> int:
    """Column blocks of this rank's wqkv: cfg.tp_interleave over the model
    group's size (each rank holds whole blocks)."""
    ni = getattr(cfg, "tp_interleave", 1)
    if tp is None:
        return ni
    m = dist.get_world_size(tp)
    if m > 1 and ni % m:
        raise ValueError(f"tensor parallel over {m} ranks needs the "
                         f"interleaved wqkv (tp_interleave a multiple of "
                         f"{m}, got {ni}): parallel/run.tp_config")
    return ni // m


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
    tp=None,                    # the model axis's process group
    sp=None,                    # the data axis's group: S split over it
) -> Tuple[torch.Tensor, torch.Tensor | None, Dict[str, torch.Tensor]]:
    """Run S new tokens. Returns (hidden [B,S,H], logits [B,S,vocab] f32 or
    None, cache) — the cache is updated in place and returned. With `sp`,
    x and positions are this rank's block of the sequence (rank r of the
    group holds tokens [r S, (r + 1) S) of the call), and so are the
    hidden and the logits returned; the cache gets every token."""
    B, S, H = x.shape
    nq, nk = local_heads(cfg, tp)
    hd = cfg.head_dim
    ni = _blocks(cfg, tp)
    # the products of the row-split weights: one all_reduce each under TP
    row_linear = linear if tp is None else (
        lambda t, w: _reduced_product(t, w, tp))
    dt = getattr(torch, cfg.dtype)
    dev = x.device
    lw = params["layers"]
    k_all, v_all = cache["k"], cache["v"]
    if tp is not None and _cols(lw["wqkv"]) != (nq + 2 * nk) * hd:
        raise ValueError(f"wqkv has {_cols(lw['wqkv'])} columns, this "
                         f"rank's {nq} + 2 x {nk} heads of {hd} need "
                         f"{(nq + 2 * nk) * hd}")

    cos, sin = rope.rope_angles(rope.mrope_positions(positions),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    decode = S == 1 and sp is None
    if decode:
        kv_len_b = attention.per_row(cache_len, B, dev).to(torch.int32)
        vfrom_b = (attention.per_row(kv_valid_from, B, dev).to(torch.int32)
                   if kv_valid_from is not None
                   else torch.zeros(B, dtype=torch.int32, device=dev))
    elif sp is None:
        kv_len = attention.per_row(cache_len, B, dev) + S
        q_start = cache_len
    else:
        n_sp = dist.get_world_size(sp)
        kv_len = attention.per_row(cache_len, B, dev) + n_sp * S
        q_start = (attention.per_row(cache_len, B, dev)
                   + dist.get_rank(sp) * S)

    h = x.to(dt)
    for l in range(cfg.n_layers):
        a_in = rms_norm(h, lw["ln1"][l], cfg.rms_eps)
        qkv = linear(a_in, quant.layer(lw["wqkv"], l))
        q, k, v = split_qkv(qkv, nq, nk, hd, ni)
        q = rope.apply_rope(rms_norm(q, lw["q_norm"][l], cfg.rms_eps),
                            cos, sin)
        k = rope.apply_rope(rms_norm(k, lw["k_norm"][l], cfg.rms_eps),
                            cos, sin)
        if decode:
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
            if sp is not None:
                # the layer's one K/V gather: every rank writes every token
                kv = mesh_lib.all_gather(torch.stack([k, v]), sp, dim=2)
                k, v = kv[0], kv[1]
            write_layer_cache(k_all, k, l, cache_len)
            write_layer_cache(v_all, v, l, cache_len)
            attn = attention.gqa_attention(q, k_all[l], v_all[l], q_start,
                                           kv_len, kv_valid_from)
        h = h + row_linear(attn.reshape(B, S, nq * hd),
                           quant.layer(lw["wo"], l))
        m_in = rms_norm(h, lw["ln2"][l], cfg.rms_eps)
        gu = linear(m_in, quant.layer(lw["w_gu"], l))
        # silu in f32 with a single rounding to the model dtype
        h = h + row_linear(silu_mul_plain(gu, gu.dtype),
                           quant.layer(lw["w_down"], l))

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = None
    if with_logits:
        logits = linear(h, params["head"]).float()
        if tp is not None:
            logits = mesh_lib.all_gather(logits, tp, dim=-1)
    return h, logits, cache
