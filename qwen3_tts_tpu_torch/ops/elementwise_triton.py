"""Triton kernels of `ops/elementwise.py`.

This module imports `triton` at its top, so only the launch functions in
`ops/elementwise.py` import it, at their first launch on a CUDA tensor.
Each kernel is one block-per-row pass, replacing an elementwise pass or a
row reduction inside `qwen3_tts_tpu/ops/fused_talker.py::_kernel_body` and
`qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body` (see each kernel).

Bound: memory. Each touches a row of at most 12288 elements once and has
at most one reduction; there is no tensor-core work. A program per row
issues coalesced vector loads of the whole row, reduces in registers and
writes once, so each pass costs one read and one write of its row.
"""

import triton
import triton.language as tl


@triton.jit
def rms_norm_kernel(x_ptr, w_ptr, out_ptr, H, eps, BLOCK: tl.constexpr):
    """Replaces `rms2` of both TPU kernels: f32 math, one rounding."""
    row = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    mask = offs < H
    x = tl.load(x_ptr + row * H + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / H
    r = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * r * w
    tl.store(out_ptr + row * H + offs, y.to(out_ptr.dtype.element_ty),
             mask=mask)


@triton.jit
def qk_norm_rope_kernel(qkv_ptr, qn_ptr, kn_ptr, cos_ptr, sin_ptr,
                        q_ptr, k_ptr, v_ptr, nq, nk, eps,
                        HD: tl.constexpr, HALF: tl.constexpr):
    """Replaces `rms3` + `rope` of both TPU kernels and the q/k/v split.

    Program (b, head) over the fused qkv row: q and k heads get a per-head
    rms (rounded once to the model dtype) then rotate-half RoPE with cos/sin
    rounded to the model dtype (f32 math, one rounding); v heads are copied
    out unchanged."""
    b = tl.program_id(0)
    hh = tl.program_id(1)
    nqkv = (nq + 2 * nk) * HD
    offs = tl.arange(0, HALF)
    base = qkv_ptr + b * nqkv + hh * HD
    lo_raw = tl.load(base + offs)
    hi_raw = tl.load(base + HALF + offs)
    dt = q_ptr.dtype.element_ty
    if hh < nq + nk:
        lo = lo_raw.to(tl.float32)
        hi = hi_raw.to(tl.float32)
        var = (tl.sum(lo * lo, axis=0) + tl.sum(hi * hi, axis=0)) / HD
        r = 1.0 / tl.sqrt(var + eps)
        is_q = hh < nq
        w_lo = tl.where(is_q, tl.load(qn_ptr + offs), tl.load(kn_ptr + offs))
        w_hi = tl.where(is_q, tl.load(qn_ptr + HALF + offs),
                        tl.load(kn_ptr + HALF + offs))
        n_lo = (lo * r * w_lo.to(tl.float32)).to(dt).to(tl.float32)
        n_hi = (hi * r * w_hi.to(tl.float32)).to(dt).to(tl.float32)
        c_lo = tl.load(cos_ptr + b * HD + offs).to(dt).to(tl.float32)
        c_hi = tl.load(cos_ptr + b * HD + HALF + offs).to(dt).to(tl.float32)
        s_lo = tl.load(sin_ptr + b * HD + offs).to(dt).to(tl.float32)
        s_hi = tl.load(sin_ptr + b * HD + HALF + offs).to(dt).to(tl.float32)
        o_lo = (n_lo * c_lo - n_hi * s_lo).to(dt)
        o_hi = (n_hi * c_hi + n_lo * s_hi).to(dt)
        if hh < nq:
            dst = q_ptr + (b * nq + hh) * HD
        else:
            dst = k_ptr + (b * nk + hh - nq) * HD
        tl.store(dst + offs, o_lo)
        tl.store(dst + HALF + offs, o_hi)
    else:
        dst = v_ptr + (b * nk + hh - nq - nk) * HD
        tl.store(dst + offs, lo_raw.to(dt))
        tl.store(dst + HALF + offs, hi_raw.to(dt))


@triton.jit
def silu_mul_kernel(gu_ptr, out_ptr, F, BLOCK: tl.constexpr):
    """Replaces the SwiGLU activation of both TPU kernels: silu(g) * u in
    f32 from the fused gate/up row, one rounding."""
    row = tl.program_id(0)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < F
    g = tl.load(gu_ptr + row * 2 * F + offs, mask=mask,
                other=0.0).to(tl.float32)
    u = tl.load(gu_ptr + row * 2 * F + F + offs, mask=mask,
                other=0.0).to(tl.float32)
    y = g / (1.0 + tl.exp(-g)) * u
    tl.store(out_ptr + row * F + offs, y.to(out_ptr.dtype.element_ty),
             mask=mask)


@triton.jit
def argmax_gather_kernel(logits_ptr, codes_ptr, ptab_ptr, x_ptr, q, R0, R,
                         H, NCODES, CV: tl.constexpr, HB: tl.constexpr,
                         GATHER: tl.constexpr):
    """Replaces `argmax_row` and the ptab row gather of
    `fused_predictor._kernel_body`: greedy code over the 2048-wide f32
    logit slice (lowest index on ties) into codes[b, q]; then, for the next
    pass, x[b] = ptab[q][sel(code)] where codes past the real rows select
    the bias row R - 1."""
    b = tl.program_id(0)
    offs = tl.arange(0, CV)
    lg = tl.load(logits_ptr + b * CV + offs)
    m = tl.max(lg, axis=0)
    idx = tl.min(tl.where(lg >= m, offs, CV), axis=0)
    tl.store(codes_ptr + b * NCODES + q, idx.to(codes_ptr.dtype.element_ty))
    if GATHER:
        sel = tl.where(idx < R0, idx, R - 1).to(tl.int64)
        h = tl.arange(0, HB)
        mh = h < H
        row = tl.load(ptab_ptr + (q * R + sel) * H + h, mask=mh, other=0.0)
        tl.store(x_ptr + b * H + h, row.to(x_ptr.dtype.element_ty), mask=mh)
