"""The fused elementwise pass of the talker step as a Triton kernel
(`ops/elementwise_triton.py`) with its plain PyTorch version beside it, and
the plain halves of the elementwise work that runs inside a gemv launch.

  rms_norm        x [M, H] (f32 or dt) -> dt; f32 math, one rounding. On
                  the main path only the talker's final norm (its output
                  is the step's hidden); every other norm of the chain is
                  the prologue of the gemv it feeds (`ops/gemv.py`), which
                  takes `rms_norm_plain` as its plain prologue

The wrapper takes its plain version for a tensor on the CPU; on a CUDA
tensor it launches its kernel (importing `triton` at the first launch) or
raises.

Three plain functions have no kernel of their own here: on the card their
work runs inside a gemv launch (`csrc/gemv.cu`), and they are the plain
halves of those fused products (`ops/gemv.py`):

  qk_norm_rope_plain  fused qkv row -> q, k (per-head rms + rotate-half
                      RoPE) and v, each [B, heads, hd] in dt: the qkv
                      product's qk epilogue
  silu_mul_plain      gate/up [M, 2F] (f32 or dt) -> dt; f32 math, one
                      rounding: the down product's silu prologue (and the
                      prefill's SwiGLU, `models/decoder.py`)
  argmax_gather_plain the predictor's greedy code and its next input row:
                      the argmax epilogue of the head slice (`argmax=`)
"""

from __future__ import annotations

import torch

_FLOATS = (torch.float32, torch.bfloat16)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _triton():
    from . import elementwise_triton
    return elementwise_triton


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ------------------------------------------------------------------ rms_norm
def rms_norm_plain(x, w, eps: float, dtype: torch.dtype,
                   out=None) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * w.float()).to(dtype)
    return y if out is None else out.copy_(y)


def rms_norm(x, w, eps: float, dtype: torch.dtype, out=None) -> torch.Tensor:
    """rms-normalise the rows of x [M, H] with weight w [H], output dtype."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps, dtype, out)
    M, H = x.shape
    if out is None:
        out = torch.empty(M, H, dtype=dtype, device=x.device)
    _check_cuda("rms_norm", x, w, out)
    if w.shape != (H,) or out.shape != (M, H) or out.dtype != dtype \
            or x.dtype not in _FLOATS:
        raise ValueError("rms_norm: shapes or dtypes do not match")
    _triton().rms_norm_kernel[(M,)](x, w, out, H, eps,
                                    BLOCK=_next_pow2(H), num_warps=4)
    rms_norm.launches += 1
    return out


rms_norm.launches = 0


# -------------------------------------------------------------- qk_norm_rope
def qk_norm_rope_plain(qkv, q_norm, k_norm, cos, sin, nq: int, nk: int,
                       eps: float, out=None):
    """qkv [B, (nq+2nk)*hd] dt; cos/sin [B, hd] f32.
    Returns (q [B, nq, hd], k [B, nk, hd], v [B, nk, hd]) in qkv.dtype, or
    writes them into the `out` triple. The plain half of the qkv product's
    qk epilogue (`ops/gemv.py`, `qk=`)."""
    B = qkv.shape[0]
    dt = qkv.dtype
    hd = q_norm.shape[0]
    heads = qkv.reshape(B, nq + 2 * nk, hd)
    c = cos.to(dt).float()[:, None]
    s = sin.to(dt).float()[:, None]
    half = hd // 2

    def norm_rope(x, w):
        n = rms_norm_plain(x, w, eps, dt).float()
        rot = torch.cat([-n[..., half:], n[..., :half]], dim=-1)
        return (n * c + rot * s).to(dt)

    q = norm_rope(heads[:, :nq], q_norm)
    k = norm_rope(heads[:, nq:nq + nk], k_norm)
    v = heads[:, nq + nk:]
    if out is None:
        return q, k, v.contiguous()
    for dst, src in zip(out, (q, k, v)):
        dst.copy_(src)
    return out


# ------------------------------------------------------------------ silu_mul
def silu_mul_plain(gu, dtype: torch.dtype, out=None) -> torch.Tensor:
    """silu(gu[:, :F]) * gu[:, F:] for gu [M, 2F] -> dtype, f32 math, one
    rounding. The plain half of the down product's silu prologue
    (`ops/gemv.py`, `act="silu"`)."""
    F = gu.shape[-1] // 2
    g = gu[..., :F].float()
    y = (g / (1.0 + torch.exp(-g)) * gu[..., F:].float()).to(dtype)
    return y if out is None else out.copy_(y)


# ------------------------------------------------------------- argmax_gather
def sel_rows(code, ptab_rows: int, rows: int):
    """ptab row of a code: negative codes clamp to 0, codes past the real
    rows select the bias row `rows - 1`."""
    clamped = code.clamp_min(0)
    return torch.where(clamped < ptab_rows, clamped,
                       torch.full_like(clamped, rows - 1))


def argmax_gather_plain(logits, codes, q: int, ptab, ptab_rows: int,
                        x_out=None) -> None:
    """codes[:, q] = the greedy code of logits [B, CV], in place: JAX's
    `argmax_row` (`qwen3_tts_tpu/ops/fused_predictor.py:465-469`), the
    largest value with the lowest index on ties, and CV for a row holding
    any NaN (its max is NaN and no element is >= it). Then, when x_out is
    given, x_out[b] = ptab[q][sel(code_b)]: a NaN row's code CV is past
    the real rows, so it selects the bias row when ptab_rows <= CV."""
    code = torch.argmax(logits, dim=-1)
    code = torch.where(torch.isnan(logits).any(dim=-1),
                       torch.full_like(code, logits.shape[-1]), code)
    codes[:, q] = code.to(codes.dtype)
    if x_out is not None:
        x_out.copy_(ptab[q][sel_rows(code, ptab_rows, ptab.shape[1])])
