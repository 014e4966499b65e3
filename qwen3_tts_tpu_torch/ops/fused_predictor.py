"""The predictor's 16-code expansion of a frame: the port of
`qwen3_tts_tpu/ops/fused_predictor.py::frame_codes_fused` and `make_ptab`.

On the TPU this is one Pallas kernel. Here it is a chain of the port's
kernels (`ops/chain.py`), driven from Python:

  pass 0   x = h1024 (rounded to the model dtype) at position 0
  pass 1   x = ptab[0][sel(code_0)] at position 1; head slice 0
  q=1..15  code_q = argmax of the f32 head slice [(q-1)*2048, q*2048)
           (lowest index on ties) -> codes[:, q]; for q < 15 the same
           kernel gathers x = ptab[q][sel(code_q)] for pass q+1 at position
           q+1, then head slice q.

Each pass runs all layers for one token; the frame-local KV cache
[L, B, nk, max_seq, hd] is f32 (holding values rounded to the model dtype,
as the TPU kernel's is) and is written in place after each layer's
attention. Codes stay on the device: no `.item()`, no host sync inside the
frame. Codes out of range select the bias row of ptab; negative codes
clamp to 0 (`qwen3_tts_tpu/ops/fused_predictor.py:651-659`).

Deliberate divergence from the TPU kernel: the residual stream is f32 (the
TPU predictor kernel keeps it in the model dtype), the same as the talker
step; with f32 weights the two are the same.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core import protocol
from . import chain, rope
from .elementwise import sel_rows
from .gemv import EPI_F32_ROUND_DT
from .quant import require_dense


def _frame(ops, params: Dict[str, Any], cfg, ptab: torch.Tensor,
           ptab_rows: int, h1024: torch.Tensor,
           code_0: torch.Tensor) -> torch.Tensor:
    lw = params["layers"]
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        require_dense(lw[name])
    head = require_dense(params["head"])
    B = code_0.shape[0]
    dev = h1024.device
    L, nq, nk, hd = cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    T = cfg.max_seq
    NB, CV = protocol.NUM_CODEBOOKS, protocol.CODE_VOCAB
    dt = getattr(torch, cfg.dtype)
    if T < NB:
        raise ValueError(f"predictor max_seq {T} < {NB} positions per frame")

    # per-position RoPE tables and prefix lengths, made once per frame
    pos = torch.arange(T, device=dev)
    cos, sin = rope.rope_angles(rope.mrope_positions(pos[None]),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    cos_t = cos[0][:, None].expand(T, B, hd).contiguous()
    sin_t = sin[0][:, None].expand(T, B, hd).contiguous()
    kv_len_t = pos.to(torch.int32)[:, None].expand(T, B).contiguous()
    valid_from = torch.zeros(B, dtype=torch.int32, device=dev)

    k_cache = torch.zeros(L, B, nk, T, hd, dtype=torch.float32, device=dev)
    v_cache = torch.zeros_like(k_cache)
    q_buf = torch.empty(B, nq, hd, dtype=dt, device=dev)
    k_new = torch.empty(B, nk, hd, dtype=dt, device=dev)
    v_new = torch.empty(B, nk, hd, dtype=dt, device=dev)
    logits = torch.empty(B, CV, dtype=torch.float32, device=dev)
    codes = torch.zeros(B, NB, dtype=torch.int32, device=dev)
    codes[:, 0] = code_0.to(torch.int32)
    x_res = h1024.to(dt).to(torch.float32, copy=True)

    def stack_pass(p: int) -> None:
        for l in range(L):
            chain.layer_pass(ops, lw, l, cfg, x_res, cos_t[p], sin_t[p],
                             k_cache, v_cache, q_buf, k_new, v_new,
                             kv_len_t[p], valid_from)
            # this token's k/v into the frame-local cache, in place, after
            # the layer's attention read it
            k_cache[l, :, :, p] = k_new
            v_cache[l, :, :, p] = v_new

    def head_slice(qi: int) -> None:
        h = ops.rms_norm(x_res, params["final_norm"], cfg.rms_eps, dt)
        ops.gemv(h, head, col0=qi * CV, n=CV, epilogue=EPI_F32_ROUND_DT,
                 out=logits)

    stack_pass(0)
    x_res.copy_(ptab[0][sel_rows(code_0.long(), ptab_rows, ptab.shape[1])])
    stack_pass(1)
    head_slice(0)
    for qi in range(1, NB):
        last = qi == NB - 1
        ops.argmax_gather(logits, codes, qi, ptab, ptab_rows,
                          None if last else x_res)
        if not last:
            stack_pass(qi + 1)
            head_slice(qi)
    return codes


def frame_codes_fused(params: Dict[str, Any], cfg, ptab: torch.Tensor,
                      ptab_rows: int, h1024: torch.Tensor,
                      code_0: torch.Tensor) -> torch.Tensor:
    """h1024 [B, H] f32 projected talker hidden; code_0 [B]; ptab from
    `make_ptab`. Returns codes [B, 16] int32 with code_0 in column 0."""
    return _frame(chain.KERNELS, params, cfg, ptab, ptab_rows, h1024, code_0)


def frame_codes_fused_plain(params, cfg, ptab, ptab_rows, h1024, code_0):
    """The same expansion through the plain PyTorch versions of every op."""
    return _frame(chain.PLAIN, params, cfg, ptab, ptab_rows, h1024, code_0)


def make_ptab(assets, cfg) -> Tuple[torch.Tensor, int]:
    """Pre-projected codebook tables ptab[q, c] = codec_embedding_1024(q, c),
    computed in f32 and stored in cfg.dtype, with rows padded as the JAX
    package pads them and at least one bias row (the value of an
    out-of-range code: zero codec row -> projection -> bias).
    Returns (ptab [16, R, H], real row count)."""
    tabs = assets.codec_tables.float()
    pt = torch.einsum("qrd,pd->qrp", tabs, assets.proj_weight.float())
    pt = pt + assets.proj_bias.float()
    rows = pt.shape[1]
    rw = min(512, rows + 1)
    r_pad = -(-(rows + 1) // rw) * rw
    bias = assets.proj_bias.float().expand(pt.shape[0], r_pad - rows,
                                           pt.shape[2])
    pt = torch.cat([pt, bias], dim=1)
    return pt.to(getattr(torch, cfg.dtype)).contiguous(), rows
