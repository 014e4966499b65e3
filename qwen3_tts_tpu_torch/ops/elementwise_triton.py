"""Triton kernels of `ops/elementwise.py`.

This module imports `triton` at its top, so only the launch functions in
`ops/elementwise.py` import it, at their first launch on a CUDA tensor.
Each kernel is one block-per-row pass, replacing an elementwise pass or a
row reduction inside `qwen3_tts_tpu/ops/fused_talker.py::_kernel_body` and
`qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body` (see each kernel).

Bound: memory. Each touches a row of at most 2048 elements once and has
at most one reduction; there is no tensor-core work. A program per row
issues coalesced vector loads of the whole row, reduces in registers and
writes once, so each pass costs one read and one write of its row.
"""

import triton
import triton.language as tl


@triton.jit
def rms_norm_kernel(x_ptr, w_ptr, out_ptr, H, eps, BLOCK: tl.constexpr):
    """Replaces `rms2` of the TPU talker kernel where its output is kept
    (the final norm, the step's hidden): f32 math, one rounding. The other
    norms run as the prologue of their gemv (`csrc/gemv.cu`)."""
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
