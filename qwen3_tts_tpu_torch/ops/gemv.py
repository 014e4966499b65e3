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

As inside the TPU kernels, the elementwise work around a product runs in
its launch (each is optional, `dt` is then required):

  norm=(w_ln, eps)    prologue: x is the f32 residual [M, K] and the
                      product takes rms_norm(x, w_ln, eps) rounded once to
                      dt (`rms2`; ln1 -> qkv, ln2 -> gate/up, the final
                      norm -> the predictor's head slice);
  act="silu"          prologue: x is the f32 gate/up product [M, 2K] and the
                      product takes silu(g) * u rounded once to dt (the
                      SwiGLU, into the down product);
  qk=(q_norm, k_norm, cos, sin, nq, nk, eps)
                      the qk epilogue of the qkv product, after the norm
                      prologue only, over the whole (nq + 2 nk) * hd width:
                      the product rounded to dt, QK-norm and rotate-half
                      RoPE on the q and k heads (`rms3` + `rope`), q, k, v
                      stored into `out=(q [M, nq, hd], k, v [M, nk, hd])` in
                      dt (the fused qkv row is not stored); returns `out`;
  kv=(k_slot, v_slot) with `qk`: also store f32(k), f32(v) into two [M,
                      nk, hd] f32 views (the predictor's frame cache at
                      slot p, `k_cache[l, :, :, p]`; any strides with unit
                      stride along hd);
  argmax=(codes, q, ptab, ptab_rows, x_out)
                      the argmax epilogue of the predictor's head slice,
                      after the norm prologue, with EPI_F32_ROUND_DT and n
                      a power of two (CV): codes[:, q] = each row's greedy
                      code over the logits (JAX's `argmax_row`: the lowest
                      index on ties, n for a row holding a NaN) and, with
                      x_out [M, H] f32 (may be x itself), x_out[b] =
                      ptab[q][sel(code_b)] (`argmax_gather_plain`); codes
                      int32 [M, ncodes], ptab [ncodes', R, H] in dt; the
                      logits are stored only into a given `out`.

Without a prologue x is in dt (dt defaults to x.dtype). Each plain version
composes the plain ops (`rms_norm_plain` or `silu_mul_plain`, the product,
`qk_norm_rope_plain` and the slot copies, `argmax_gather_plain`), so the
CPU path computes what the unfused chain computed, bit for bit.

Column slices are packing-transparent: `col0` selects the same columns of
q, q4, m8 and scale. Each wrapper checks its fusion arguments (raising
ValueError) on every device, then takes its plain version on a CPU tensor;
on a CUDA tensor it launches its kernel or raises.

B, B8 and B4 are one CUDA kernel per product: the K split of a column tile
is a thread block cluster that reduces through distributed shared memory
(`gemv_splits`, `gemv4_splits`), and the prologue and the epilogue run
inside the same launch. Each wrapper counts its launches in `.launches`
and, of those, the ones with the norm in `.norm_launches`, with silu in
`.silu_launches`, with the qk epilogue in `.qk_launches` and, of these,
with the KV store in `.kv_launches`, and with the argmax epilogue in
`.argmax_launches`. The argmax epilogue's workspace (a key a row, a ticket
a row chunk; the kernel leaves both zero) is allocated once per device and
stream (`_argmax_workspace`, which says how CUDA graphs must use it).
"""

from __future__ import annotations

import ctypes

import torch

from .elementwise import (argmax_gather_plain, qk_norm_rope_plain,
                          rms_norm_plain, silu_mul_plain)
from .quant import GROUP4, panel_matmul4_plain

EPI_STORE_DT = 0
EPI_F32 = 1
EPI_F32_ROUND_DT = 2
EPI_ADD_F32 = 3
EPI_QK = 4              # the qk epilogue's code in csrc/gemv.cu (`qk=`)
EPI_ARGMAX = 5          # the argmax epilogue's (`argmax=`)
# prologue codes of csrc/gemv.cu
PRO_NONE, PRO_NORM, PRO_SILU = 0, 1, 2

MAX_M = 32
MAX_HD = 128            # a 128-column tile holds whole heads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# weight kinds of `gemv_blocks_per_sm`
DENSE, INT8, INT4 = 0, 1, 2
# launch (csrc/gemv.cu): 128-column tiles, the K split a thread block
# cluster of at most 8 (the portable size); B / B8 at least 32 KB of
# weights per block, B4 at least one packed group (2 * GROUP4 k's)
TILE_N = 128
MAX_SPLITS = 8
MIN_BLOCK_BYTES = 32 * 1024


class _QkArgs(ctypes.Structure):
    """`QkArgs` of csrc/gemv.cuh, field for field."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "q_norm", "k_norm", "cos", "sin", "q", "k", "v", "kc", "vc")] \
        + [(f, ctypes.c_longlong) for f in ("kc_sb", "kc_sh", "vc_sb",
                                            "vc_sh")] \
        + [("nq", ctypes.c_int), ("nk", ctypes.c_int), ("hd", ctypes.c_int),
           ("eps", ctypes.c_float)]


class _ArgmaxArgs(ctypes.Structure):
    """`ArgmaxArgs` of csrc/gemv.cuh, field for field."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "codes", "ptab", "x_out", "keys", "tickets")] \
        + [(f, ctypes.c_int) for f in ("ncodes", "q", "rows0", "R", "H")]


def _qk_plain(y, qk, out, kv):
    """The plain qk epilogue of y [M, (nq + 2 nk) * hd] in dt: QK-norm and
    RoPE into (q, k, v), then the KV store."""
    q_norm, k_norm, cos, sin, nq, nk, eps = qk
    res = qk_norm_rope_plain(y, q_norm, k_norm, cos, sin, nq, nk, eps, out)
    if kv is not None:
        for dst, src in zip(kv, res[1:]):
            dst.copy_(src)
    return res


def _finish(acc: torch.Tensor, dt: torch.dtype, epilogue: int,
            out, qk=None, kv=None, argmax=None):
    if qk is not None:
        return _qk_plain(acc.to(dt), qk, out, kv)
    if argmax is not None:
        logits = acc.to(dt).float()
        if out is not None:
            out.copy_(logits)
        argmax_gather_plain(logits, *argmax)
        return out
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


def _model_dtype(x, norm, dt, act=None) -> torch.dtype:
    if norm is None and act is None:
        return x.dtype if dt is None else dt
    if dt is None:
        raise ValueError("a product with the norm or silu prologue needs "
                         "the model dtype `dt`")
    return dt


def _prologue(x, norm, dt, act=None):
    """The plain prologue: x in the model dtype, rms-normed with `norm`, or
    silu(g) * u of the gate/up row with `act`."""
    if act is not None:
        return silu_mul_plain(x, dt)
    if norm is None:
        return x
    w_ln, eps = norm
    return rms_norm_plain(x, w_ln, eps, dt)


def gemv_plain(x, w, *, col0: int = 0, n: int | None = None,
               epilogue: int = EPI_STORE_DT, out=None, norm=None, act=None,
               qk=None, kv=None, argmax=None, dt=None):
    """Plain version of B: the product in f32, then the same epilogue."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt, act), act)
    n = _cols(w, col0, n)
    acc = x.float() @ w[:, col0:col0 + n].float()
    return _finish(acc, x.dtype, epilogue, out, qk, kv, argmax)


def gemv_int8_plain(x, q, scale, *, col0: int = 0, n: int | None = None,
                    epilogue: int = EPI_STORE_DT, out=None, norm=None,
                    act=None, qk=None, kv=None, argmax=None, dt=None):
    """Plain version of B8: (x @ q) in f32, times the column scales."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt, act), act)
    n = _cols(q, col0, n)
    acc = (x.float() @ q[:, col0:col0 + n].float()) * scale[col0:col0 + n]
    return _finish(acc, x.dtype, epilogue, out, qk, kv, argmax)


def gemv_int4_plain(x, q4, m8, scale, *, col0: int = 0,
                    n: int | None = None, epilogue: int = EPI_STORE_DT,
                    out=None, norm=None, act=None, qk=None, kv=None,
                    argmax=None, dt=None):
    """Plain version of B4: `panel_matmul4`'s order, times the scales."""
    x = _prologue(x, norm, _model_dtype(x, norm, dt, act), act)
    n = _cols(q4, col0, n)
    cols = slice(col0, col0 + n)
    acc = panel_matmul4_plain(x, q4[:, cols], m8[:, cols]) * scale[cols]
    return _finish(acc, x.dtype, epilogue, out, qk, kv, argmax)


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


def launch_splits(x, w, M, K, n, kind, dt, pro) -> int:
    """The split plan on x's card: its SM count and the kernel's resident
    blocks per SM (queried once per card, dtype, weight kind, M and
    prologue code)."""
    from ..kernels import build
    key = (x.device.index, dt, kind, M, pro)
    if key not in _per_sm:
        per_sm = build.lib().gemv_blocks_per_sm(_DTYPES[dt], kind, M, pro)
        if per_sm <= 0:
            build.check(-per_sm or 1, "gemv_blocks_per_sm")
        _per_sm[key] = per_sm
    sms = build.sm_count(x.device)
    if kind == INT4:
        return gemv4_splits(M, K, n, sms, _per_sm[key])
    return gemv_splits(M, K, n, w.element_size(), sms, _per_sm[key])


def _check_qk(name, x, ncols, col0, n, epilogue, out, norm, qk, kv, dt):
    """Refuse a qk epilogue the kernels do not take; returns its (q, k, v)
    outputs, allocated when `out` is None."""
    if norm is None:
        raise ValueError(f"{name}: the qk epilogue follows the norm prologue "
                         "(norm=)")
    if epilogue != EPI_STORE_DT or col0 or n not in (None, ncols):
        raise ValueError(f"{name}: the qk epilogue covers the whole qkv row "
                         "and cannot be combined with col0 / n or another "
                         "epilogue")
    q_norm, k_norm, cos, sin, nq, nk, _ = qk
    hd = q_norm.shape[0] if q_norm.dim() == 1 else 0
    if not 2 <= hd <= MAX_HD or hd & (hd - 1):
        raise ValueError(f"{name}: head_dim {tuple(q_norm.shape)} must be a "
                         f"power of two in [2, {MAX_HD}] (a {TILE_N}-column "
                         "tile holds whole heads)")
    dev, M = x.device, x.shape[0]
    if any(t.dtype != dt or tuple(t.shape) != (hd,) or t.device != dev
           for t in (q_norm, k_norm)):
        raise ValueError(f"{name}: q_norm / k_norm must be {dt} ({hd},) on "
                         f"{dev}")
    if any(t.dtype != torch.float32 or tuple(t.shape) != (M, hd)
           or not t.is_contiguous() or t.device != dev for t in (cos, sin)):
        raise ValueError(f"{name}: cos / sin must be contiguous float32 "
                         f"[{M}, {hd}] on {dev}")
    if nq <= 0 or nk <= 0 or ncols != (nq + 2 * nk) * hd:
        raise ValueError(f"{name}: the qkv width {ncols} is not (nq + 2 nk) "
                         f"* hd = ({nq} + 2 * {nk}) * {hd}")
    shapes = ((M, nq, hd), (M, nk, hd), (M, nk, hd))
    if out is None:
        out = tuple(torch.empty(sh, dtype=dt, device=dev) for sh in shapes)
    elif len(out) != 3 or any(
            t.dtype != dt or tuple(t.shape) != sh or not t.is_contiguous()
            or t.device != dev for t, sh in zip(out, shapes)):
        raise ValueError(f"{name}: out must be contiguous (q, k, v) {dt} "
                         f"{shapes} on {dev}")
    if kv is not None and (len(kv) != 2 or any(
            t.dtype != torch.float32 or tuple(t.shape) != shapes[1]
            or t.stride(2) != 1 or t.device != dev for t in kv)):
        raise ValueError(f"{name}: kv must be two float32 {shapes[1]} views "
                         f"with unit stride along hd on {dev}")
    return out


def _check_argmax(name, x, ncols, col0, n, epilogue, out, norm, act, qk,
                  argmax, dt):
    """Refuse an argmax epilogue the kernels do not take."""
    if qk is not None or act is not None or norm is None \
            or epilogue != EPI_F32_ROUND_DT:
        raise ValueError(f"{name}: the argmax epilogue follows the norm "
                         "prologue (norm=) with EPI_F32_ROUND_DT, and takes "
                         "no silu prologue or qk epilogue")
    codes, q, ptab, ptab_rows, x_out = argmax
    n = ncols - col0 if n is None else n
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{name}: the argmax epilogue takes a power-of-two "
                         f"number of columns (the code vocabulary), got {n}")
    dev, M = x.device, x.shape[0]
    if codes.dtype != torch.int32 or codes.dim() != 2 \
            or codes.shape[0] != M or not codes.is_contiguous() \
            or codes.device != dev or not 0 <= q < codes.shape[1]:
        raise ValueError(f"{name}: codes must be contiguous int32 [{M}, "
                         f"ncodes] on {dev} with 0 <= q < ncodes, got "
                         f"{codes.dtype} {tuple(codes.shape)}, q {q}")
    if ptab.dtype != dt or ptab.dim() != 3 or not ptab.is_contiguous() \
            or ptab.device != dev or not 0 <= q < ptab.shape[0] \
            or not 0 <= ptab_rows <= ptab.shape[1]:
        raise ValueError(f"{name}: ptab must be contiguous {dt} [tables, "
                         f"R, H] on {dev} with q < tables and ptab_rows <= "
                         f"R, got {ptab.dtype} {tuple(ptab.shape)}, q {q}, "
                         f"ptab_rows {ptab_rows}")
    H = ptab.shape[2]
    if x_out is not None and (
            x_out.dtype != torch.float32 or tuple(x_out.shape) != (M, H)
            or not x_out.is_contiguous() or x_out.device != dev):
        raise ValueError(f"{name}: x_out must be None or contiguous float32 "
                         f"[{M}, {H}] on {dev}, got {x_out.dtype} "
                         f"{tuple(x_out.shape)}")
    if out is not None and (
            out.dtype != torch.float32 or tuple(out.shape) != (M, n)
            or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"{name}: out (the logits) must be None or "
                         f"contiguous float32 [{M}, {n}] on {dev}")


def _check_fusion(name, x, ncols, col0, n, epilogue, out, norm, act, qk, kv,
                  dt, argmax=None):
    """Refuse, on any device, a combination of prologue and epilogue that
    the kernels do not take; returns `out` (the qk epilogue's (q, k, v),
    allocated when None)."""
    if argmax is not None:
        _check_argmax(name, x, ncols, col0, n, epilogue, out, norm, act, qk,
                      argmax, _model_dtype(x, norm, dt, act))
    if act not in (None, "silu"):
        raise ValueError(f"{name}: act {act!r}; only 'silu'")
    if act is not None and (norm is not None or qk is not None):
        raise ValueError(f"{name}: the silu prologue takes no norm and no "
                         "qk epilogue")
    if act is not None and x.shape[-1] % 2:
        raise ValueError(f"{name}: silu takes the gate/up row [M, 2K], got "
                         f"{tuple(x.shape)}")
    if kv is not None and qk is None:
        raise ValueError(f"{name}: the KV store is part of the qk epilogue "
                         "(qk=)")
    if qk is None:
        return out
    return _check_qk(name, x, ncols, col0, n, epilogue, out, norm, qk, kv,
                     _model_dtype(x, norm, dt, act))


def _check(name, x, w, col0, n, epilogue, out, pro, ln_w, dt, *, align,
           packed=False):
    """Validate a launch (w has K rows, K/2 when `packed`; x has 2K columns
    with the silu prologue); returns (M, K, n, out, ln pointer)."""
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if dt not in _DTYPES:
        raise TypeError(f"{name}: model dtype {dt}; float32 or bfloat16")
    want_x = dt if pro == PRO_NONE else torch.float32
    if x.dtype != want_x:
        raise TypeError(f"{name}: x {x.dtype}, expected {want_x} (f32 with "
                        "a prologue, else the model dtype)")
    if x.dim() != 2 or w.dim() != 2 or not x.is_contiguous() \
            or w.stride(1) != 1:
        raise ValueError(f"{name}: x must be contiguous [M, K] and w "
                         "[rows, N] with unit column stride")
    M, K = x.shape
    if pro == PRO_SILU:
        K //= 2
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
    ln = 0
    if ln_w is not None:
        if ln_w.dtype != dt or tuple(ln_w.shape) != (K,) \
                or not ln_w.is_contiguous() or ln_w.device != x.device:
            raise ValueError(f"{name}: norm weight {ln_w.dtype} "
                             f"{tuple(ln_w.shape)}, expected contiguous "
                             f"{dt} ({K},) on {x.device}")
        ln = ln_w.data_ptr()
    if epilogue == EPI_QK or epilogue == EPI_ARGMAX and out is None:
        return M, K, n, out, ln
    out_dtype = dt if epilogue == EPI_STORE_DT else torch.float32
    if out is None:
        if epilogue == EPI_ADD_F32:
            raise ValueError("EPI_ADD_F32 needs the residual buffer `out`")
        out = torch.empty(M, n, dtype=out_dtype, device=x.device)
    elif (out.dtype != out_dtype or tuple(out.shape) != (M, n)
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"{name}: out {out.dtype} {tuple(out.shape)} does "
                         f"not match {out_dtype} {(M, n)}")
    return M, K, n, out, ln


def _check_scale(name, scale, w):
    if scale.dtype != torch.float32 or scale.dim() != 1 \
            or scale.shape[0] != w.shape[1] or not scale.is_contiguous() \
            or scale.device != w.device:
        raise ValueError(f"{name}: scale must be contiguous f32 "
                         f"[{w.shape[1]}] on {w.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


_argmax_ws: dict = {}


def _argmax_workspace(dev) -> torch.Tensor:
    """The argmax epilogue's workspace on `dev` for the current stream:
    MAX_M 64-bit keys (a row each), then MAX_M 32-bit tickets (a row chunk
    each), zeroed once; every launch leaves them zero. It is kept for the
    process's life, keyed by the raw stream handle.

    Launches that share a workspace must not overlap, so, with CUDA graphs:
    capture only after one eager argmax launch on the capture stream (the
    workspace and its zeroing memset are then made outside the graph, not
    in its private pool); the graph bakes in that stream's workspace, so
    replay it on the capture stream, or anywhere no eager argmax launch on
    the capture stream and no other replay of it can run at the same time."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _argmax_ws:
        _argmax_ws[key] = torch.zeros(MAX_M + MAX_M // 2, dtype=torch.int64,
                                      device=dev)
    return _argmax_ws[key]


class _Launch:
    """A launch's fusion codes and C arguments: the prologue code, the norm
    weight and eps, the epilogue code and the qk epilogue's QkArgs or the
    argmax epilogue's ArgmaxArgs."""

    def __init__(self, norm, act, qk, kv, epilogue, out, argmax=None,
                 ws=None):
        self.pro = PRO_SILU if act is not None else \
            PRO_NONE if norm is None else PRO_NORM
        self.ln_w, self.eps = (None, 0.0) if norm is None else norm
        self.epilogue = EPI_QK if qk is not None else \
            EPI_ARGMAX if argmax is not None else epilogue
        self.args = self.am = None
        if argmax is not None:
            codes, q, ptab, ptab_rows, x_out = argmax
            self.am = _ArgmaxArgs(
                codes.data_ptr(), ptab[q].data_ptr(),
                None if x_out is None else x_out.data_ptr(), ws.data_ptr(),
                ws.data_ptr() + MAX_M * 8, codes.shape[1], q, ptab_rows,
                ptab.shape[1], ptab.shape[2])
        if qk is not None:
            q_norm, k_norm, cos, sin, nq, nk, eps = qk
            q, k, v = out
            kc, vc = kv if kv is not None else (None, None)
            self.args = _QkArgs(
                q_norm.data_ptr(), k_norm.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kc.data_ptr() if kc is not None else None,
                vc.data_ptr() if vc is not None else None,
                kc.stride(0) if kc is not None else 0,
                kc.stride(1) if kc is not None else 0,
                vc.stride(0) if vc is not None else 0,
                vc.stride(1) if vc is not None else 0,
                nq, nk, q_norm.shape[0], eps)

    def qk_ptr(self):
        return None if self.args is None else ctypes.addressof(self.args)

    def am_ptr(self):
        return None if self.am is None else ctypes.addressof(self.am)

    def count(self, fn) -> None:
        fn.launches += 1
        fn.norm_launches += self.pro == PRO_NORM
        fn.silu_launches += self.pro == PRO_SILU
        fn.argmax_launches += self.am is not None
        if self.args is not None:
            fn.qk_launches += 1
            fn.kv_launches += bool(self.args.kc)


def gemv(x, w, *, col0: int = 0, n: int | None = None,
         epilogue: int = EPI_STORE_DT, out=None, norm=None, act=None,
         qk=None, kv=None, argmax=None, dt=None):
    """B: y = x @ w[:, col0:col0+n] with a prologue and an epilogue (module
    docstring).

    x [M, K] contiguous (silu: [M, 2K]), M <= 32; w [K, ldw] in the model
    dtype with unit column stride (a layer slice of a stacked [L, K, N]
    weight is such a view).
    """
    out = _check_fusion("gemv", x, w.shape[1], col0, n, epilogue, out, norm,
                        act, qk, kv, dt, argmax)
    if x.device.type == "cpu":
        return gemv_plain(x, w, col0=col0, n=n, epilogue=epilogue, out=out,
                          norm=norm, act=act, qk=qk, kv=kv, argmax=argmax,
                          dt=dt)
    dt = _model_dtype(x, norm, dt, act)
    if w.dtype != dt:
        raise TypeError(f"gemv: w {w.dtype} must be the model dtype {dt}")
    ln = _Launch(norm, act, qk, kv, epilogue, out, argmax,
                 None if argmax is None else _argmax_workspace(x.device))
    M, K, n, out, ln_ptr = _check("gemv", x, w, col0, n, ln.epilogue, out,
                                  ln.pro, ln.ln_w, dt, align=16)
    from ..kernels import build
    err = build.lib().gemv_launch(
        x.data_ptr(), w.data_ptr(), ln_ptr, _out_ptr(out), M, K, n,
        w.stride(0), col0, launch_splits(x, w, M, K, n, DENSE, dt, ln.pro),
        _DTYPES[dt], ln.epilogue, float(ln.eps), ln.pro, ln.qk_ptr(),
        ln.am_ptr(), _stream(x))
    build.check(err, "gemv")
    ln.count(gemv)
    return out


def gemv_int8(x, q, scale, *, col0: int = 0, n: int | None = None,
              epilogue: int = EPI_STORE_DT, out=None, norm=None, act=None,
              qk=None, kv=None, argmax=None, dt=None):
    """B8: y = (x @ q[:, col0:col0+n]) * scale[col0:col0+n], prologue and
    epilogue. q int8 [K, ldq], scale f32 [ldq]."""
    out = _check_fusion("gemv_int8", x, q.shape[1], col0, n, epilogue, out,
                        norm, act, qk, kv, dt, argmax)
    if x.device.type == "cpu":
        return gemv_int8_plain(x, q, scale, col0=col0, n=n,
                               epilogue=epilogue, out=out, norm=norm,
                               act=act, qk=qk, kv=kv, argmax=argmax, dt=dt)
    if q.dtype != torch.int8:
        raise TypeError(f"gemv_int8: q {q.dtype}, not int8")
    dt = _model_dtype(x, norm, dt, act)
    _check_scale("gemv_int8", scale, q)
    ln = _Launch(norm, act, qk, kv, epilogue, out, argmax,
                 None if argmax is None else _argmax_workspace(x.device))
    M, K, n, out, ln_ptr = _check("gemv_int8", x, q, col0, n, ln.epilogue,
                                  out, ln.pro, ln.ln_w, dt, align=8)
    from ..kernels import build
    err = build.lib().gemv_int8_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), ln_ptr, _out_ptr(out),
        M, K, n, q.stride(0), col0,
        launch_splits(x, q, M, K, n, INT8, dt, ln.pro), _DTYPES[dt],
        ln.epilogue, float(ln.eps), ln.pro, ln.qk_ptr(), ln.am_ptr(),
        _stream(x))
    build.check(err, "gemv_int8")
    ln.count(gemv_int8)
    return out


def gemv_int4(x, q4, m8, scale, *, col0: int = 0, n: int | None = None,
              epilogue: int = EPI_STORE_DT, out=None, norm=None, act=None,
              qk=None, kv=None, argmax=None, dt=None):
    """B4: y = panel_matmul4(x, q4, m8)[:, cols] * scale[cols], prologue
    and epilogue. q4 int8 [K//2, ldq] packed, m8 int8 [K//GROUP4, ldm],
    scale f32 [ldq]; K a multiple of 2 * GROUP4. Each rank of the K split
    takes whole packed groups (GROUP4 packed rows = two whole k-groups), so
    groups are never split."""
    out = _check_fusion("gemv_int4", x, q4.shape[1], col0, n, epilogue, out,
                        norm, act, qk, kv, dt, argmax)
    if x.device.type == "cpu":
        return gemv_int4_plain(x, q4, m8, scale, col0=col0, n=n,
                               epilogue=epilogue, out=out, norm=norm,
                               act=act, qk=qk, kv=kv, argmax=argmax, dt=dt)
    if q4.dtype != torch.int8 or m8.dtype != torch.int8:
        raise TypeError(f"gemv_int4: q4 {q4.dtype} / m8 {m8.dtype}, "
                        "not int8")
    dt = _model_dtype(x, norm, dt, act)
    _check_scale("gemv_int4", scale, q4)
    ln = _Launch(norm, act, qk, kv, epilogue, out, argmax,
                 None if argmax is None else _argmax_workspace(x.device))
    M, K, n, out, ln_ptr = _check("gemv_int4", x, q4, col0, n, ln.epilogue,
                                  out, ln.pro, ln.ln_w, dt, align=8,
                                  packed=True)
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
        x.data_ptr(), q4.data_ptr(), m8.data_ptr(), scale.data_ptr(), ln_ptr,
        _out_ptr(out), M, K, n, q4.stride(0), m8.stride(0), col0,
        launch_splits(x, q4, M, K, n, INT4, dt, ln.pro), _DTYPES[dt],
        ln.epilogue, float(ln.eps), ln.pro, ln.qk_ptr(), ln.am_ptr(),
        _stream(x))
    build.check(err, "gemv_int4")
    ln.count(gemv_int4)
    return out


def _out_ptr(out):
    """The output pointer of a launch: none for the qk epilogue, whose
    outputs travel in its QkArgs, or for an argmax epilogue that stores no
    logits."""
    return None if out is None or isinstance(out, tuple) else out.data_ptr()


COUNTERS = ("launches", "norm_launches", "silu_launches", "qk_launches",
            "kv_launches", "argmax_launches")
for _fn in (gemv, gemv_int8, gemv_int4):
    for _c in COUNTERS:
        setattr(_fn, _c, 0)
