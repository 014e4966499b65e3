"""The Triton kernel of `ops/elementwise.py`.

This module imports `triton` at its top, so only the launch function in
`ops/elementwise.py` imports it, at its first launch on a CUDA tensor.
The kernel is one block-per-row pass, replacing an elementwise pass inside
`qwen3_tts_tpu/ops/fused_talker.py::_kernel_body`.

Bound: memory. It touches a row of at most 2048 elements once and has one
reduction; there is no tensor-core work. A program per row issues
coalesced vector loads of the whole row, reduces in registers and writes
once, so the pass costs one read and one write of its row.
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

