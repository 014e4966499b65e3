"""Single-token GQA decode attention: kernel A (`csrc/decode_attention.cu`).

Port of `qwen3_tts_tpu/ops/flash_decode.py::decode_attention_stacked`.
Contract (the same as the TPU kernel's):

  out[b, r] = softmax_j(q[b, r] . k_j / sqrt(hd)) v_j over the slots
              valid_from[b] <= j < kv_len[b] of layer `layer` of the
              PRE-update stacked cache [L, B, nk, T, hd], plus the current
              token's own k_new/v_new, which is always valid.

The caller writes k_new/v_new into the cache after the call; the current
token never comes from the cache. Serves the attention of the talker step,
of every predictor pass, and of `decoder.forward` at S == 1.

On a CPU tensor it runs `decode_attention_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                  # kTile of csrc/decode_attention.cu
_TARGET_BLOCKS = 264       # two waves over the H100's 132 SMs


def split_plan(B: int, nk: int, T: int):
    """(n_splits, tiles_per_split): split the cache's T slots into ranges of
    whole tiles so that B * nk * n_splits blocks fill the card. Planned from
    the capacity T, not the device-side kv_len, so no host sync is needed;
    ranges past a row's kv_len do no work."""
    n_tiles = max(1, -(-T // TILE))
    want = max(1, -(-_TARGET_BLOCKS // (B * nk)))
    per = -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles // per), per


def decode_attention_plain(q, k_all, v_all, k_new, v_new, layer: int,
                           kv_len, valid_from) -> torch.Tensor:
    """Plain version: masked softmax over [cache slots | current token]."""
    B, nq, hd = q.shape
    nk, T = k_all.shape[2], k_all.shape[3]
    g = nq // nk
    qf = q.float().reshape(B, nk, g, hd) / math.sqrt(hd)
    k = k_all[layer].float()
    v = v_all[layer].float()
    t = torch.arange(T, device=q.device)
    ok = ((t[None] < kv_len.long()[:, None])
          & (t[None] >= valid_from.long()[:, None]))             # [B, T]
    s = torch.einsum("bkgh,bkth->bkgt", qf, k)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bkgh,bkh->bkg", qf, k_new.float())[..., None]
    s_all = torch.cat([s, s_new], dim=-1)
    m = s_all.amax(dim=-1, keepdim=True)
    keep = torch.cat([ok, torch.ones_like(ok[:, :1])], dim=-1)
    # explicit mask: a fully masked prefix must contribute nothing
    p = torch.exp(s_all - m) * keep[:, None, None].float()
    l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (torch.einsum("bkgt,bkth->bkgh", p[..., :T], v)
           + p[..., T:] * v_new.float()[:, :, None]) / l_sum
    return out.reshape(B, nq, hd).to(q.dtype)


def decode_attention_stacked(q, k_all, v_all, k_new, v_new, layer: int,
                             kv_len, valid_from) -> torch.Tensor:
    """q [B, nq, hd]; k_all/v_all [L, B, nk, T, hd] pre-update; k_new/v_new
    [B, nk, hd] in q.dtype; layer a host int; kv_len/valid_from [B] int32.
    Returns [B, nq, hd] in q.dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, k_new, v_new, layer,
                                      kv_len, valid_from)
    B, nq, hd = q.shape
    L, Bc, nk, T, hdc = k_all.shape
    for name, t in (("k_all", k_all), ("v_all", v_all), ("k_new", k_new),
                    ("v_new", v_new), ("kv_len", kv_len),
                    ("valid_from", valid_from)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q is not contiguous")
    if (Bc != B or hdc != hd or v_all.shape != k_all.shape
            or tuple(k_new.shape) != (B, nk, hd)
            or v_new.shape != k_new.shape or nq % nk
            or tuple(kv_len.shape) != (B,)
            or tuple(valid_from.shape) != (B,) or not 0 <= layer < L):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache "
            f"{tuple(k_all.shape)}, k_new {tuple(k_new.shape)}, layer {layer}")
    if hd > 128 or nq // nk > 4:
        raise ValueError("decode_attention: head_dim <= 128 and at most 4 "
                         "q heads per kv head")
    if (q.dtype not in _DTYPES or k_all.dtype not in _DTYPES
            or v_all.dtype != k_all.dtype or k_new.dtype != q.dtype
            or v_new.dtype != q.dtype or kv_len.dtype != torch.int32
            or valid_from.dtype != torch.int32):
        raise TypeError("decode_attention: q/k_new/v_new and the cache must "
                        "be float32 or bfloat16, kv_len/valid_from int32")

    from ..kernels import build
    n_splits, per = split_plan(B, nk, T)
    out = torch.empty_like(q)
    part = torch.empty(B * nk * n_splits * (nq // nk) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    err = build.lib().decode_attention_launch(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), kv_len.data_ptr(), valid_from.data_ptr(),
        out.data_ptr(), part.data_ptr(), layer, B, nq, nk, T, hd, n_splits,
        per, _DTYPES[q.dtype], _DTYPES[k_all.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention_stacked.launches += 1
    return out


decode_attention_stacked.launches = 0
