"""One talker decode step over all layers: the port of
`qwen3_tts_tpu/ops/fused_talker.py::talker_step_fused`.

On the TPU this is one Pallas kernel. Here it is a chain, driven per layer
from Python, of the port's hand-written kernels (`ops/chain.py`), five
launches a layer: gemv for every product, with the elementwise work in the
product's launch (ln1 as the norm prologue and QK-norm + RoPE as the qk
epilogue of the qkv product, ln2 as the norm prologue of gate/up, SwiGLU
as the silu prologue of down), and decode attention over the pre-update
cache; then the Triton `rms_norm` for the final norm and the head's gemv.
Semantics are the TPU kernel's:

  * the residual stream stays f32 across layers; matmul inputs are rounded
    to the model dtype (rms outputs, attention output, silu*up);
  * the current token's k/v fold into the attention last, and the cache is
    written after the whole step, in place, at the row's slot (the
    pre-update contract of `qwen3_tts_tpu/ops/fused_talker.py:575-596`;
    the qk epilogue writes k_new / v_new only, no KV store);
  * logits are f32 rounded through the model dtype, for dense and
    quantized heads alike.

Weights are dense, int8 or int4, split per layer as the TPU kernel's
`_split_w` splits them (`qwen3_tts_tpu/ops/fused_talker.py:72-82`): values
to gemv B / B8 / B4, the f32 per-channel scales into their epilogues.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import chain, rope
from .gemv import EPI_F32_ROUND_DT


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _step(ops, params: Dict[str, Any], cfg, x, positions, slot, kv_len,
          valid_from, k_cache, v_cache):
    chain.check_weights(params, cfg, "talker")
    lw = params["layers"]
    B = x.shape[0]
    dev = x.device
    L, nq, nk, hd = cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)

    positions = torch.as_tensor(positions, device=dev).reshape(B)
    cos, sin = rope.rope_angles(rope.mrope_positions(positions[:, None]),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    kv_len = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(B)
    valid_from = torch.as_tensor(valid_from, device=dev).to(
        torch.int32).reshape(B)

    x_res = x.to(dtype=torch.float32, copy=True)
    k_new = torch.empty(L, B, nk, hd, dtype=dt, device=dev)
    v_new = torch.empty(L, B, nk, hd, dtype=dt, device=dev)
    q_buf = torch.empty(B, nq, hd, dtype=dt, device=dev)
    for l in range(L):
        chain.layer_pass(ops, lw, l, cfg, x_res, cos, sin, k_cache, v_cache,
                         q_buf, k_new[l], v_new[l], kv_len, valid_from)
    # the final norm stays a launch of its own: its output is also the
    # step's returned hidden, which a product's prologue would not keep
    h = ops.rms_norm(x_res, params["final_norm"], cfg.rms_eps, dt)
    logits = chain.matmul(ops, h, params["head"], epilogue=EPI_F32_ROUND_DT)

    # the cache write after the step, in place at each row's slot
    slot_b = torch.as_tensor(slot, device=dev).to(torch.long).expand(B)
    rows = torch.arange(B, device=dev)
    k_cache[:, rows, :, slot_b] = k_new.transpose(0, 1).to(k_cache.dtype)
    v_cache[:, rows, :, slot_b] = v_new.transpose(0, 1).to(v_cache.dtype)
    return h, logits, k_cache, v_cache


def talker_step_fused(
    params: Dict[str, Any],
    cfg,
    x: torch.Tensor,            # [B, H] embedding input (cfg.dtype)
    positions,                  # [B] RoPE positions (slot - pad_offset)
    slot,                       # int or [B]: cache write slot
    kv_len,                     # [B] tokens already cached (pre-update)
    valid_from,                 # [B] first valid cache slot (left pad)
    k_cache: torch.Tensor,      # [L, B, nk, T, hd], updated in place
    v_cache: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hidden [B, H] cfg.dtype post final-norm, logits [B, vocab]
    f32, k_cache, v_cache). On CUDA tensors every op is one of the port's
    kernels."""
    return _step(chain.KERNELS, params, cfg, x, positions, slot, kv_len,
                 valid_from, k_cache, v_cache)


def talker_step_fused_plain(params, cfg, x, positions, slot, kv_len,
                            valid_from, k_cache, v_cache):
    """The same step through the plain PyTorch versions of every op."""
    return _step(chain.PLAIN, params, cfg, x, positions, slot, kv_len,
                 valid_from, k_cache, v_cache)
