"""Skinny matmul for decode batches: kernel B (`csrc/gemv.cu`).

The building block of both fused ports, `ops/fused_talker.py` and
`ops/fused_predictor.py`: every qkv / wo / gate-up / down / head product of
a talker step or a predictor pass. It is the counterpart of the
`stream_matmul` helpers inside the two TPU kernels
(`qwen3_tts_tpu/ops/fused_talker.py:136`,
`qwen3_tts_tpu/ops/fused_predictor.py:153`).

`gemv(x, w, ...)` computes f32( x[M, K] @ w[:, col0:col0 + n] ) with f32
accumulation and applies one epilogue:

  EPI_STORE_DT        store in x.dtype (the model dtype),
  EPI_F32             store f32,
  EPI_F32_ROUND_DT    store f32 rounded through x.dtype (logits),
  EPI_ADD_F32         add into an f32 residual buffer `out` (in place).

On a CPU tensor it runs `gemv_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

EPI_STORE_DT = 0
EPI_F32 = 1
EPI_F32_ROUND_DT = 2
EPI_ADD_F32 = 3

MAX_M = 32
MAX_CHUNK = 256            # kMaxChunk of csrc/gemv.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 264       # two waves over the H100's 132 SMs


def _finish(acc: torch.Tensor, dt: torch.dtype, epilogue: int,
            out: torch.Tensor | None) -> torch.Tensor:
    if epilogue == EPI_ADD_F32:
        if out is None:
            raise ValueError("EPI_ADD_F32 needs the residual buffer `out`")
        out += acc
        return out
    if epilogue == EPI_STORE_DT:
        y = acc.to(dt)
    elif epilogue == EPI_F32:
        y = acc
    elif epilogue == EPI_F32_ROUND_DT:
        y = acc.to(dt).float()
    else:
        raise ValueError(f"unknown epilogue {epilogue}")
    if out is None:
        return y
    out.copy_(y)
    return out


def gemv_plain(x, w, *, col0: int = 0, n: int | None = None,
               epilogue: int = EPI_STORE_DT, out=None) -> torch.Tensor:
    """Plain version: the product in f32, then the same epilogue."""
    n = w.shape[1] - col0 if n is None else n
    acc = x.float() @ w[:, col0:col0 + n].float()
    return _finish(acc, x.dtype, epilogue, out)


def k_chunk(M: int, K: int, N: int) -> int:
    """K rows per block: halve from MAX_CHUNK until the grid (column tiles
    x row chunks x K chunks) has two waves of blocks for 132 SMs."""
    chunk = MAX_CHUNK
    col_tiles = -(-N // 256) * -(-M // 8)
    while chunk > 32 and col_tiles * -(-K // chunk) < _TARGET_BLOCKS:
        chunk //= 2
    return chunk


def gemv(x, w, *, col0: int = 0, n: int | None = None,
         epilogue: int = EPI_STORE_DT, out=None) -> torch.Tensor:
    """y = x @ w[:, col0:col0+n] with an epilogue (see module docstring).

    x [M, K] contiguous, M <= 32; w [K, ldw] with unit column stride (a
    layer slice of a stacked [L, K, N] weight is such a view).
    """
    if x.device.type == "cpu":
        return gemv_plain(x, w, col0=col0, n=n, epilogue=epilogue, out=out)
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"gemv: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gemv: x {x.dtype} / w {w.dtype}; both must be "
                        "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or not x.is_contiguous() \
            or w.stride(1) != 1:
        raise ValueError("gemv: x must be contiguous [M, K] and w [K, N] "
                         "with unit column stride")
    M, K = x.shape
    ldw = w.stride(0)
    n = w.shape[1] - col0 if n is None else n
    if not (1 <= M <= MAX_M) or w.shape[0] != K or col0 < 0 \
            or col0 + n > w.shape[1]:
        raise ValueError(f"gemv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"cols [{col0}, {col0 + n})")
    if n % 8 or col0 % 8 or ldw % 8 or w.data_ptr() % 16:
        raise ValueError("gemv: columns, column offset and row stride must "
                         "be multiples of 8 and w 16-byte aligned")
    out_dtype = x.dtype if epilogue == EPI_STORE_DT else torch.float32
    if out is None:
        if epilogue == EPI_ADD_F32:
            raise ValueError("EPI_ADD_F32 needs the residual buffer `out`")
        out = torch.empty(M, n, dtype=out_dtype, device=x.device)
    elif (out.dtype != out_dtype or tuple(out.shape) != (M, n)
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"gemv: out {out.dtype} {tuple(out.shape)} does "
                         f"not match {out_dtype} {(M, n)}")

    from ..kernels import build
    chunk = k_chunk(M, K, n)
    part = torch.empty(-(-K // chunk), M, n, dtype=torch.float32,
                       device=x.device)
    err = build.lib().gemv_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
        M, K, n, ldw, col0, chunk, _DTYPES[x.dtype], epilogue,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "gemv")
    gemv.launches += 1
    return out


gemv.launches = 0
