"""Skinny matmul for decode batches: kernels B, B8 and B4 (`csrc/gemv.cu`).

The building block of both fused ports, `ops/fused_talker.py` and
`ops/fused_predictor.py`: every qkv / wo / gate-up / down / head product of
a talker step or a predictor pass. They are the counterpart of the
`stream_matmul` helpers inside the two TPU kernels
(`qwen3_tts_tpu/ops/fused_talker.py:136`,
`qwen3_tts_tpu/ops/fused_predictor.py:153`), one wrapper per weight kind:

  gemv(x, w)                    B   dense w in the model dtype
  gemv_int8(x, q, scale)        B8  int8 q, per-column f32 scale
  gemv_int4(x, q4, m8, scale)   B4  packed biased int4 q4 + m8 + scale, in
                                    the panel order of `quant.panel_matmul4`

Each computes acc = f32( x[M, K] @ deq(w)[:, col0:col0 + n] ) with f32
accumulation, multiplies the quantized kinds' acc by scale[col0:col0 + n]
(the TPU kernels' `sc_*`), and applies one epilogue:

  EPI_STORE_DT        store in the model dtype dt,
  EPI_F32             store f32,
  EPI_F32_ROUND_DT    store f32 rounded through dt (logits),
  EPI_ADD_F32         add into an f32 residual buffer `out` (in place).

With `norm=(w_ln, eps)` the rms norm of x is the product's prologue, as
`rms2` is inside the TPU kernels: x is then the f32 residual [M, K] and the
product takes rms_norm(x, w_ln, eps) rounded once to dt (`dt` must be
given). Without it x is in dt (dt defaults to x.dtype).

Column slices are packing-transparent: `col0` selects the same columns of
q, q4, m8 and scale. On a CPU tensor each wrapper runs its plain version
(`rms_norm_plain` first, with the norm); on a CUDA tensor it launches its
kernel or raises.

B, B8 and B4 are one CUDA kernel per product: the K split of a column tile
is a thread block cluster that reduces through distributed shared memory
(`gemv_splits`, `gemv4_splits`), and the norm is a prologue inside the same
launch. Each wrapper counts its launches in `.launches` and, of those, the
ones with the norm in `.norm_launches`.
"""

from __future__ import annotations

import torch

from .elementwise import rms_norm_plain
from .quant import GROUP4, panel_matmul4_plain

EPI_STORE_DT = 0
EPI_F32 = 1
EPI_F32_ROUND_DT = 2
EPI_ADD_F32 = 3

MAX_M = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# weight kinds of `gemv_blocks_per_sm`
DENSE, INT8, INT4 = 0, 1, 2
# launch (csrc/gemv.cu): 128-column tiles, the K split a thread block
# cluster of at most 8 (the portable size); B / B8 at least 32 KB of
# weights per block, B4 at least one packed group (2 * GROUP4 k's)
TILE_N = 128
MAX_SPLITS = 8
MIN_BLOCK_BYTES = 32 * 1024


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


def _cols(w, col0: int, n: int | None) -> int:
    return w.shape[1] - col0 if n is None else n


def _model_dtype(x, norm, dt) -> torch.dtype:
    if norm is None:
        return x.dtype if dt is None else dt
    if dt is None:
        raise ValueError("a product with the norm prologue needs the model "
                         "dtype `dt`")
    return dt


def _prologue(x, norm, dt):
    """The plain prologue: x in the model dtype, rms-normed with `norm`."""
    if norm is None:
        return x
    w_ln, eps = norm
    return rms_norm_plain(x, w_ln, eps, dt)


def gemv_plain(x, w, *, col0: int = 0, n: int | None = None,
               epilogue: int = EPI_STORE_DT, out=None, norm=None,
               dt=None) -> torch.Tensor:
    """Plain version of B: the product in f32, then the same epilogue."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt))
    n = _cols(w, col0, n)
    acc = x.float() @ w[:, col0:col0 + n].float()
    return _finish(acc, x.dtype, epilogue, out)


def gemv_int8_plain(x, q, scale, *, col0: int = 0, n: int | None = None,
                    epilogue: int = EPI_STORE_DT, out=None, norm=None,
                    dt=None) -> torch.Tensor:
    """Plain version of B8: (x @ q) in f32, times the column scales."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt))
    n = _cols(q, col0, n)
    acc = (x.float() @ q[:, col0:col0 + n].float()) * scale[col0:col0 + n]
    return _finish(acc, x.dtype, epilogue, out)


def gemv_int4_plain(x, q4, m8, scale, *, col0: int = 0,
                    n: int | None = None, epilogue: int = EPI_STORE_DT,
                    out=None, norm=None, dt=None) -> torch.Tensor:
    """Plain version of B4: `panel_matmul4`'s order, times the scales."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt))
    n = _cols(q4, col0, n)
    cols = slice(col0, col0 + n)
    acc = panel_matmul4_plain(x, q4[:, cols], m8[:, cols]) * scale[cols]
    return _finish(acc, x.dtype, epilogue, out)


def row_tile(M: int, most: int = 8) -> int:
    """x rows a block stages: the smallest of 1, 2, 4, 8 that covers M, at
    most `most` (8 for B / B8, 4 for B4), as csrc/gemv.cu picks them."""
    return 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 or most == 4 \
        else 8


def _double_splits(tiles: int, most: int, sms: int, per_sm: int) -> int:
    splits = 1
    while (splits * 2 <= most and tiles * splits < sms * 7 // 8
           and tiles * splits * 2 <= sms * per_sm):
        splits *= 2
    return splits


def gemv_splits(M: int, K: int, N: int, w_bytes: int, sms: int,
                per_sm: int) -> int:
    """The K split of B / B8, the cluster size: the grid is (column tiles *
    splits, x row chunks), rank q of a cluster taking K rows [q * rows,
    (q + 1) * rows), rows = ceil(K / splits). Split in two until about one
    block runs on each SM (7/8 of the SMs busy): at most MAX_SPLITS ways,
    never below MIN_BLOCK_BYTES of weights per block, and never past one
    wave of the resident blocks (sms * per_sm). More, smaller blocks
    measured slower on the H100 (each pays its x staging, reduction and
    cluster barriers; `chip_smoke.py split_times`)."""
    tiles = -(-N // TILE_N) * -(-M // row_tile(M))
    most = max(1, min(MAX_SPLITS,
                      K * TILE_N * w_bytes // MIN_BLOCK_BYTES))
    return _double_splits(tiles, most, sms, per_sm)


def gemv4_splits(M: int, K: int, N: int, sms: int, per_sm: int) -> int:
    """The K split of B4, as `gemv_splits` doubles it, over whole packed
    groups: rank q takes groups [q * per, (q + 1) * per) of the K / (2 *
    GROUP4), per = ceil(groups / splits), so never more splits than
    groups (a group is never split; a rank past the last group sums
    nothing)."""
    tiles = -(-N // TILE_N) * -(-M // row_tile(M, 4))
    most = max(1, min(MAX_SPLITS, K // (2 * GROUP4)))
    return _double_splits(tiles, most, sms, per_sm)


_per_sm: dict = {}


def launch_splits(x, w, M, K, n, kind, dt, norm) -> int:
    """The split plan on x's card: its SM count and the kernel's resident
    blocks per SM (queried once per card, dtype, weight kind, M and norm
    prologue)."""
    from ..kernels import build
    key = (x.device.index, dt, kind, M, norm)
    if key not in _per_sm:
        per_sm = build.lib().gemv_blocks_per_sm(_DTYPES[dt], kind, M,
                                                int(norm))
        if per_sm <= 0:
            build.check(-per_sm or 1, "gemv_blocks_per_sm")
        _per_sm[key] = per_sm
    sms = build.sm_count(x.device)
    if kind == INT4:
        return gemv4_splits(M, K, n, sms, _per_sm[key])
    return gemv_splits(M, K, n, w.element_size(), sms, _per_sm[key])


def _check(name, x, w, col0, n, epilogue, out, norm, dt, *, align,
           packed=False):
    """Validate a launch (w has K rows, K/2 when `packed`); returns
    (M, K, n, out, ln pointer, eps)."""
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if dt not in _DTYPES:
        raise TypeError(f"{name}: model dtype {dt}; float32 or bfloat16")
    want_x = torch.float32 if norm is not None else dt
    if x.dtype != want_x:
        raise TypeError(f"{name}: x {x.dtype}, expected {want_x} (the f32 "
                        "residual with the norm, else the model dtype)")
    if x.dim() != 2 or w.dim() != 2 or not x.is_contiguous() \
            or w.stride(1) != 1:
        raise ValueError(f"{name}: x must be contiguous [M, K] and w "
                         "[rows, N] with unit column stride")
    M, K = x.shape
    n = _cols(w, col0, n)
    rows = K // 2 if packed else K
    if not (1 <= M <= MAX_M) or w.shape[0] != rows or col0 < 0 \
            or col0 + n > w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"cols [{col0}, {col0 + n})")
    if n % 8 or col0 % 8 or w.stride(0) % 8 or w.data_ptr() % align:
        raise ValueError(f"{name}: columns, column offset and row stride "
                         f"must be multiples of 8 and w {align}-byte "
                         "aligned (each lane loads 8 columns of a row as "
                         "one vector)")
    ln, eps = 0, 0.0
    if norm is not None:
        w_ln, eps = norm
        if w_ln.dtype != dt or tuple(w_ln.shape) != (K,) \
                or not w_ln.is_contiguous() or w_ln.device != x.device:
            raise ValueError(f"{name}: norm weight {w_ln.dtype} "
                             f"{tuple(w_ln.shape)}, expected contiguous "
                             f"{dt} ({K},) on {x.device}")
        ln = w_ln.data_ptr()
    out_dtype = dt if epilogue == EPI_STORE_DT else torch.float32
    if out is None:
        if epilogue == EPI_ADD_F32:
            raise ValueError("EPI_ADD_F32 needs the residual buffer `out`")
        out = torch.empty(M, n, dtype=out_dtype, device=x.device)
    elif (out.dtype != out_dtype or tuple(out.shape) != (M, n)
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"{name}: out {out.dtype} {tuple(out.shape)} does "
                         f"not match {out_dtype} {(M, n)}")
    return M, K, n, out, ln, float(eps)


def _check_scale(name, scale, w):
    if scale.dtype != torch.float32 or scale.dim() != 1 \
            or scale.shape[0] != w.shape[1] or not scale.is_contiguous() \
            or scale.device != w.device:
        raise ValueError(f"{name}: scale must be contiguous f32 "
                         f"[{w.shape[1]}] on {w.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(fn, norm) -> None:
    fn.launches += 1
    if norm is not None:
        fn.norm_launches += 1


def gemv(x, w, *, col0: int = 0, n: int | None = None,
         epilogue: int = EPI_STORE_DT, out=None, norm=None,
         dt=None) -> torch.Tensor:
    """B: y = x @ w[:, col0:col0+n] with an epilogue (module docstring).

    x [M, K] contiguous, M <= 32; w [K, ldw] in the model dtype with unit
    column stride (a layer slice of a stacked [L, K, N] weight is such a
    view).
    """
    if x.device.type == "cpu":
        return gemv_plain(x, w, col0=col0, n=n, epilogue=epilogue, out=out,
                          norm=norm, dt=dt)
    dt = _model_dtype(x, norm, dt)
    if w.dtype != dt:
        raise TypeError(f"gemv: w {w.dtype} must be the model dtype {dt}")
    M, K, n, out, ln, eps = _check("gemv", x, w, col0, n, epilogue, out,
                                   norm, dt, align=16)
    from ..kernels import build
    err = build.lib().gemv_launch(
        x.data_ptr(), w.data_ptr(), ln, out.data_ptr(), M, K, n,
        w.stride(0), col0,
        launch_splits(x, w, M, K, n, DENSE, dt, norm is not None),
        _DTYPES[dt], epilogue, eps, _stream(x))
    build.check(err, "gemv")
    _count(gemv, norm)
    return out


def gemv_int8(x, q, scale, *, col0: int = 0, n: int | None = None,
              epilogue: int = EPI_STORE_DT, out=None, norm=None,
              dt=None) -> torch.Tensor:
    """B8: y = (x @ q[:, col0:col0+n]) * scale[col0:col0+n], epilogue.
    q int8 [K, ldq], scale f32 [ldq]."""
    if x.device.type == "cpu":
        return gemv_int8_plain(x, q, scale, col0=col0, n=n,
                               epilogue=epilogue, out=out, norm=norm, dt=dt)
    if q.dtype != torch.int8:
        raise TypeError(f"gemv_int8: q {q.dtype}, not int8")
    dt = _model_dtype(x, norm, dt)
    _check_scale("gemv_int8", scale, q)
    M, K, n, out, ln, eps = _check("gemv_int8", x, q, col0, n, epilogue,
                                   out, norm, dt, align=8)
    from ..kernels import build
    err = build.lib().gemv_int8_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), ln, out.data_ptr(), M,
        K, n, q.stride(0), col0,
        launch_splits(x, q, M, K, n, INT8, dt, norm is not None),
        _DTYPES[dt], epilogue, eps, _stream(x))
    build.check(err, "gemv_int8")
    _count(gemv_int8, norm)
    return out


def gemv_int4(x, q4, m8, scale, *, col0: int = 0, n: int | None = None,
              epilogue: int = EPI_STORE_DT, out=None, norm=None,
              dt=None) -> torch.Tensor:
    """B4: y = panel_matmul4(x, q4, m8)[:, cols] * scale[cols], epilogue.
    q4 int8 [K//2, ldq] packed, m8 int8 [K//GROUP4, ldm], scale f32
    [ldq]; K a multiple of 2 * GROUP4. Each rank of the K split takes
    whole packed groups (GROUP4 packed rows = two whole k-groups), so
    groups are never split."""
    if x.device.type == "cpu":
        return gemv_int4_plain(x, q4, m8, scale, col0=col0, n=n,
                               epilogue=epilogue, out=out, norm=norm, dt=dt)
    if q4.dtype != torch.int8 or m8.dtype != torch.int8:
        raise TypeError(f"gemv_int4: q4 {q4.dtype} / m8 {m8.dtype}, "
                        "not int8")
    dt = _model_dtype(x, norm, dt)
    _check_scale("gemv_int4", scale, q4)
    M, K, n, out, ln, eps = _check("gemv_int4", x, q4, col0, n, epilogue,
                                   out, norm, dt, align=8, packed=True)
    if K % (2 * GROUP4) or m8.dim() != 2 \
            or tuple(m8.shape) != (K // GROUP4, q4.shape[1]) \
            or m8.stride(1) != 1 or m8.stride(0) % 8 \
            or m8.data_ptr() % 8 or m8.device != q4.device:
        raise ValueError(f"gemv_int4: K {K} must be a multiple of "
                         f"{2 * GROUP4}, m8 {tuple(m8.shape)} "
                         f"[K // {GROUP4}, {q4.shape[1]}] with unit "
                         "column stride, 8-byte aligned rows")
    from ..kernels import build
    err = build.lib().gemv_int4_launch(
        x.data_ptr(), q4.data_ptr(), m8.data_ptr(), scale.data_ptr(), ln,
        out.data_ptr(), M, K, n, q4.stride(0), m8.stride(0), col0,
        launch_splits(x, q4, M, K, n, INT4, dt, norm is not None),
        _DTYPES[dt], epilogue, eps, _stream(x))
    build.check(err, "gemv_int4")
    _count(gemv_int4, norm)
    return out


gemv.launches = gemv.norm_launches = 0
gemv_int8.launches = gemv_int8.norm_launches = 0
gemv_int4.launches = gemv_int4.norm_launches = 0
