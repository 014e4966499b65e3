"""Fused elementwise passes and row reductions of the talker step and the
predictor frame, as Triton kernels (`ops/elementwise_triton.py`) with their
plain PyTorch versions beside them.

  rms_norm        x [M, H] (f32 or dt) -> dt; f32 math, one rounding. On
                  the main path only the talker's final norm (its output
                  is the step's hidden); every other norm of the chain is
                  the prologue of the gemv it feeds (`ops/gemv.py`), which
                  takes `rms_norm_plain` as its plain prologue
  qk_norm_rope    fused qkv row -> q, k (per-head rms + rotate-half RoPE)
                  and v, each [B, heads, hd] contiguous in dt
  silu_mul        gate/up [M, 2F] (f32 or dt) -> dt; f32 math, one rounding
  argmax_gather   the predictor's greedy code + next input row

Each wrapper takes its plain version for a tensor on the CPU; on a CUDA
tensor it launches its kernel (importing `triton` at the first launch) or
raises.
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
    Returns (q [B, nq, hd], k [B, nk, hd], v [B, nk, hd]) in qkv.dtype."""
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


def qk_norm_rope(qkv, q_norm, k_norm, cos, sin, nq: int, nk: int,
                 eps: float, out=None):
    """Split the fused qkv row into q, k, v; rms + RoPE on q and k.
    `out` is an optional (q, k, v) triple of contiguous buffers (k and v
    may be slices of the step's stacked new-k/v buffers)."""
    if qkv.device.type == "cpu":
        return qk_norm_rope_plain(qkv, q_norm, k_norm, cos, sin, nq, nk, eps,
                                  out)
    B = qkv.shape[0]
    hd = q_norm.shape[0]
    if out is None:
        out = (torch.empty(B, nq, hd, dtype=qkv.dtype, device=qkv.device),
               torch.empty(B, nk, hd, dtype=qkv.dtype, device=qkv.device),
               torch.empty(B, nk, hd, dtype=qkv.dtype, device=qkv.device))
    q, k, v = out
    _check_cuda("qk_norm_rope", qkv, q_norm, k_norm, cos, sin, q, k, v)
    if (qkv.shape != (B, (nq + 2 * nk) * hd) or k_norm.shape != (hd,)
            or cos.shape != (B, hd) or sin.shape != (B, hd)
            or cos.dtype != torch.float32 or sin.dtype != torch.float32
            or q.shape != (B, nq, hd) or k.shape != (B, nk, hd)
            or v.shape != (B, nk, hd) or hd % 2 or hd & (hd - 1)
            or any(t.dtype != qkv.dtype for t in (q, k, v))):
        raise ValueError("qk_norm_rope: shapes or dtypes do not match")
    _triton().qk_norm_rope_kernel[(B, nq + 2 * nk)](
        qkv, q_norm, k_norm, cos, sin, q, k, v, nq, nk, eps,
        HD=hd, HALF=hd // 2, num_warps=1)
    qk_norm_rope.launches += 1
    return out


qk_norm_rope.launches = 0


# ------------------------------------------------------------------ silu_mul
def silu_mul_plain(gu, dtype: torch.dtype, out=None) -> torch.Tensor:
    F = gu.shape[-1] // 2
    g = gu[..., :F].float()
    y = (g / (1.0 + torch.exp(-g)) * gu[..., F:].float()).to(dtype)
    return y if out is None else out.copy_(y)


_SILU_BLOCK = 1024


def silu_mul(gu, dtype: torch.dtype, out=None) -> torch.Tensor:
    """silu(gu[:, :F]) * gu[:, F:] for gu [M, 2F] (f32 or dt) -> dtype."""
    if gu.device.type == "cpu":
        return silu_mul_plain(gu, dtype, out)
    M, F2 = gu.shape
    F = F2 // 2
    if out is None:
        out = torch.empty(M, F, dtype=dtype, device=gu.device)
    _check_cuda("silu_mul", gu, out)
    if F2 % 2 or out.shape != (M, F) or out.dtype != dtype \
            or gu.dtype not in _FLOATS:
        raise ValueError("silu_mul: shapes or dtypes do not match")
    grid = (M, -(-F // _SILU_BLOCK))
    _triton().silu_mul_kernel[grid](gu, out, F, BLOCK=_SILU_BLOCK,
                                    num_warps=4)
    silu_mul.launches += 1
    return out


silu_mul.launches = 0


# ------------------------------------------------------------- argmax_gather
def sel_rows(code, ptab_rows: int, rows: int):
    """ptab row of a code: negative codes clamp to 0, codes past the real
    rows select the bias row `rows - 1`."""
    clamped = code.clamp_min(0)
    return torch.where(clamped < ptab_rows, clamped,
                       torch.full_like(clamped, rows - 1))


def argmax_gather_plain(logits, codes, q: int, ptab, ptab_rows: int,
                        x_out=None) -> None:
    """codes[:, q] = argmax(logits) (lowest index on ties); then, when
    x_out is given, x_out[b] = ptab[q][sel(code_b)]. In place."""
    code = torch.argmax(logits, dim=-1)
    codes[:, q] = code.to(codes.dtype)
    if x_out is not None:
        x_out.copy_(ptab[q][sel_rows(code, ptab_rows, ptab.shape[1])])


def argmax_gather(logits, codes, q: int, ptab, ptab_rows: int,
                  x_out=None) -> None:
    if logits.device.type == "cpu":
        return argmax_gather_plain(logits, codes, q, ptab, ptab_rows, x_out)
    B, CV = logits.shape
    H = ptab.shape[2]
    gather = x_out is not None
    x_arg = x_out if gather else logits
    _check_cuda("argmax_gather", logits, codes, ptab, x_arg)
    if (logits.dtype != torch.float32 or CV & (CV - 1)
            or codes.dim() != 2 or codes.shape[0] != B
            or not 0 <= q < codes.shape[1]
            or (gather and x_out.shape != (B, H))):
        raise ValueError("argmax_gather: shapes or dtypes do not match")
    _triton().argmax_gather_kernel[(B,)](
        logits, codes, ptab, x_arg, q, ptab_rows, ptab.shape[1], H,
        codes.shape[1], CV=CV, HB=_next_pow2(H), GATHER=gather, num_warps=4)
    argmax_gather.launches += 1


argmax_gather.launches = 0
