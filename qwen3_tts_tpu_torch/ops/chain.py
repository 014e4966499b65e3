"""One decoder layer for a single token, as a chain of the port's kernels.

Shared by `ops/fused_talker.py` and `ops/fused_predictor.py`: the layer
body of both TPU kernels (rms(ln1), qkv, QK-norm and RoPE, the predictor's
k/v store into its frame cache, attention over the pre-update cache, wo
into the f32 residual, rms(ln2), gate/up, silu*up, down into the
residual). As inside the TPU kernels, the elementwise work runs in the
launch of the product it feeds or follows (`ops/gemv.py`), so a layer is
five launches:

  qkv        gemv with ln1 as its norm prologue and the qk epilogue
             (QK-norm, RoPE, q/k/v split; the predictor's KV store)
  attention  decode attention
  wo         gemv, added into the residual
  gate/up    gemv with ln2 as its norm prologue, f32 out
  down       gemv with silu*up as its prologue, added into the residual

The chain runs with one of two op sets:

  KERNELS  the wrappers, which launch the kernels on CUDA tensors (and take
           their plain versions on CPU tensors);
  PLAIN    the plain PyTorch versions, on any device (the card's reference
           in `chip_smoke.py`).

Weights are dense, int8 or int4 (`ops/quant.py` layouts); `matmul` hands
each to its gemv variant (B, B8, B4). `qmatmul` (kernel A) is in the sets
for its launch counter and its plain version: it runs in the talker
prefill (`models/decoder.forward` through `quant.linear`), not here.

Host code here only makes views and hands buffers to the kernels; every
FLOP of the layer runs in one of the ops.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import elementwise as el
from . import flash_decode
from . import gemv as G
from . import quant

KERNELS = SimpleNamespace(
    gemv=G.gemv,
    gemv_int8=G.gemv_int8,
    gemv_int4=G.gemv_int4,
    qmatmul=quant.qmatmul_kernel,
    rms_norm=el.rms_norm,
    decode_attention=flash_decode.decode_attention_stacked,
)

PLAIN = SimpleNamespace(
    gemv=G.gemv_plain,
    gemv_int8=G.gemv_int8_plain,
    gemv_int4=G.gemv_int4_plain,
    qmatmul=quant.qmatmul_kernel_plain,
    rms_norm=el.rms_norm_plain,
    decode_attention=flash_decode.decode_attention_plain,
)


def matmul(ops, x: torch.Tensor, w: quant.Weight, **kw) -> torch.Tensor:
    """x @ w through the gemv variant of w's kind (keywords: col0, n,
    epilogue, out, norm, act, qk, kv, argmax, dt)."""
    if quant.is_quantized4(w):
        return ops.gemv_int4(x, w["q4"], w["m8"], w["scale"], **kw)
    if quant.is_quantized(w):
        return ops.gemv_int8(x, w["q"], w["scale"], **kw)
    return ops.gemv(x, w, **kw)


def check_weights(params, cfg, what: str) -> None:
    """Refuse what the TPU kernels refuse: int4 mixed with other kinds
    (`qwen3_tts_tpu/ops/fused_talker.py:467-470`), and int4 stacks whose
    widths do not split into whole packed groups (H, F and nq*hd multiples
    of 2 * GROUP4)."""
    ws = [params["layers"][n] for n in quant.DECODER_MATMULS] \
        + [params["head"]]
    n4 = sum(quant.is_quantized4(w) for w in ws)
    if n4 == 0:
        return
    if n4 != len(ws):
        raise ValueError(f"mixed int4/non-int4 {what} weights are not "
                         "supported")
    g2 = 2 * quant.GROUP4
    if cfg.hidden % g2 or cfg.ffn_dim % g2 \
            or (cfg.n_q_heads * cfg.head_dim) % g2:
        raise ValueError(f"int4 {what} weights need hidden, ffn_dim and "
                         f"n_q_heads * head_dim in multiples of {g2}")


def layer_pass(ops, lw, l: int, cfg, x_res: torch.Tensor, cos, sin,
               k_cache, v_cache, q_buf, k_new, v_new, kv_len, valid_from,
               kv=None) -> None:
    """Layer `l` for one token per row, in place on the f32 residual
    x_res [B, H]. k_new/v_new [B, nk, hd] receive this token's key and
    value; k_cache/v_cache [L, B, nk, T, hd] are read pre-update, slots
    [valid_from, kv_len). `kv`, the slot views (k_cache[l, :, :, p],
    v_cache[l, :, :, p]) with p = kv_len, has the qkv launch store k and v
    there too, before the attention, which never reads slot p (the
    predictor's frame cache); without it the caller writes the cache after
    the pass (the talker's step)."""
    eps = cfg.rms_eps
    dt = q_buf.dtype
    matmul(ops, x_res, quant.layer(lw["wqkv"], l), norm=(lw["ln1"][l], eps),
           qk=(lw["q_norm"][l], lw["k_norm"][l], cos, sin, cfg.n_q_heads,
               cfg.n_kv_heads, eps),
           out=(q_buf, k_new, v_new), kv=kv, dt=dt)
    attn = ops.decode_attention(q_buf, k_cache, v_cache, k_new, v_new, l,
                                kv_len, valid_from)
    matmul(ops, attn.view(x_res.shape[0], -1), quant.layer(lw["wo"], l),
           epilogue=G.EPI_ADD_F32, out=x_res)
    gu = matmul(ops, x_res, quant.layer(lw["w_gu"], l), epilogue=G.EPI_F32,
                norm=(lw["ln2"][l], eps), dt=dt)
    matmul(ops, gu, quant.layer(lw["w_down"], l), epilogue=G.EPI_ADD_F32,
           out=x_res, act="silu", dt=dt)


_GEMVS = (G.gemv, G.gemv_int8, G.gemv_int4)
# fused counts of `launch_counts`: name -> the gemv wrappers' counter
_FUSED = {"rms_norm_gemv": "norm_launches", "silu_gemv": "silu_launches",
          "qk_rope_gemv": "qk_launches", "kv_store_gemv": "kv_launches",
          "argmax_gather_gemv": "argmax_launches"}


def reset_launch_counts() -> None:
    for fn in vars(KERNELS).values():
        fn.launches = 0
    for fn in _GEMVS:
        for counter in G.COUNTERS:
            setattr(fn, counter, 0)


def launch_counts() -> dict:
    """Launches per kernel wrapper, and the gemv launches (counted in their
    gemv too) that ran the norm prologue (`rms_norm_gemv`), the silu
    prologue (`silu_gemv`), the qk epilogue (`qk_rope_gemv`) and, of these,
    the KV store (`kv_store_gemv`), and the argmax epilogue of the
    predictor's head slice (`argmax_gather_gemv`)."""
    counts = {name: fn.launches for name, fn in vars(KERNELS).items()}
    for name, counter in _FUSED.items():
        counts[name] = sum(getattr(fn, counter) for fn in _GEMVS)
    return counts
