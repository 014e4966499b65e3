"""One decoder layer for a single token, as a chain of the port's kernels.

Shared by `ops/fused_talker.py` and `ops/fused_predictor.py`: the layer
body of both TPU kernels (rms(ln1), qkv, QK-norm and RoPE, attention over
the pre-update cache, wo into the f32 residual, rms(ln2), gate/up, silu*up,
down into the residual). The chain runs with one of two op sets:

  KERNELS  the wrappers, which launch the kernels on CUDA tensors (and take
           their plain versions on CPU tensors);
  PLAIN    the plain PyTorch versions, on any device (the card's reference
           in `chip_smoke.py`).

Host code here only makes views and hands buffers to the kernels; every
FLOP of the layer runs in one of the ops.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import elementwise as el
from . import flash_decode
from .gemv import EPI_ADD_F32, EPI_F32, gemv, gemv_plain

KERNELS = SimpleNamespace(
    gemv=gemv,
    rms_norm=el.rms_norm,
    qk_norm_rope=el.qk_norm_rope,
    silu_mul=el.silu_mul,
    decode_attention=flash_decode.decode_attention_stacked,
    argmax_gather=el.argmax_gather,
)

PLAIN = SimpleNamespace(
    gemv=gemv_plain,
    rms_norm=el.rms_norm_plain,
    qk_norm_rope=el.qk_norm_rope_plain,
    silu_mul=el.silu_mul_plain,
    decode_attention=flash_decode.decode_attention_plain,
    argmax_gather=el.argmax_gather_plain,
)


def layer_pass(ops, lw, l: int, cfg, x_res: torch.Tensor, cos, sin,
               k_cache, v_cache, q_buf, k_new, v_new, kv_len,
               valid_from) -> None:
    """Layer `l` for one token per row, in place on the f32 residual
    x_res [B, H]. k_new/v_new [B, nk, hd] receive this token's key and
    value (the caller writes them into the cache after the pass);
    k_cache/v_cache [L, B, nk, T, hd] are read pre-update."""
    B = x_res.shape[0]
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = q_buf.dtype
    eps = cfg.rms_eps
    a = ops.rms_norm(x_res, lw["ln1"][l], eps, dt)
    qkv = ops.gemv(a, lw["wqkv"][l])
    ops.qk_norm_rope(qkv, lw["q_norm"][l], lw["k_norm"][l], cos, sin, nq, nk,
                     eps, out=(q_buf, k_new, v_new))
    attn = ops.decode_attention(q_buf, k_cache, v_cache, k_new, v_new, l,
                                kv_len, valid_from)
    ops.gemv(attn.view(B, nq * hd), lw["wo"][l], epilogue=EPI_ADD_F32,
             out=x_res)
    m = ops.rms_norm(x_res, lw["ln2"][l], eps, dt)
    gu = ops.gemv(m, lw["w_gu"][l], epilogue=EPI_F32)
    act = ops.silu_mul(gu, dt)
    ops.gemv(act, lw["w_down"][l], epilogue=EPI_ADD_F32, out=x_res)


def reset_launch_counts() -> None:
    for fn in vars(KERNELS).values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in vars(KERNELS).items()}
