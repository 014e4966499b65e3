"""Capability probes of the Hopper primitives the port's kernels are built
on: the port of `tools/mosaic_probe.py`.

    python -m qwen3_tts_tpu_torch.tools.mosaic_probe [--device cuda|cpu]

The JAX tool checks, in eight tiny Pallas kernels, the Mosaic primitives
the fused TPU kernels depend on. Each probe here is a hand-written CUDA
kernel (`csrc/probes.cu`) that computes what its TPU probe computes,
through the Hopper primitive that plays the same role, with a plain
PyTorch version beside it, a launch counter, and the JAX probe's own check
written out in torch:

  #   probe         TPU (tools/mosaic_probe.py)    Hopper
  5   hbm_scratch   :38  HBM scratch, DMA there    cp.async.bulk on an mbarrier,
                         and back                  bulk store to a scratch and
                                                   back, fence.proxy.async;
                                                   16 CTAs of 4 rows
  6   fori_dma      :65  DMA of w[i] in a fori     bulk copies through a ring of
                         loop                      4 stages, an mbarrier each
                                                   re-armed on phase parity
  7   argmax        :93  max + iota-min            the loads issued before
                                                   the first compare, one
                                                   64-bit order key a thread,
                                                   a max by warp shuffles;
                                                   256 threads a row
  8   dyn_sublane   :115 SMEM index, dynamic row   device-held index read while
                                                   a bulk copy stages the table,
                                                   128 KB dynamic shared scratch
  9   rot           :139 rotate-half concat        lane map of 4 / 2 / 1-float
                                                   vectors, 2-D grid, sign bit
                                                   flipped; a row a thread
  10  onehot        :158 one-hot x table matmul    the table's non-finite
                                                   entries counted in column
                                                   blocks of 8 (16 CTAs), the
                                                   chosen entries loaded
                                                   behind the scan's loads
  11  dyn_col_dma   :180 DMA at a dynamic column   2-D TMA tile at coordinates
                                                   computed in the kernel, bulk
                                                   store; 4 rows a CTA
  12  int8_panel    :208 int8 panel DMA, bf16 dot  kernel A (csrc/qmatmul.cu):
                                                   a TMA ring, int8 -> bf16 in
                                                   registers, wgmma

Modes: `kernel` and `plain`, the counterparts of the JAX tool's `compiled`
and `interpret`. `--device cpu` runs `plain` only; `--device cuda` runs both
(in `kernel` mode the kernel is also held against its plain version) and
fails where there is no card: it never quietly runs plain. Each probe and
mode prints one line `[mode] name: OK|FAIL - ...`. Divergence from the JAX
tool: the exit code is 1 if any line says FAIL.

Kernel against plain: probes 5, 6, 8 and 11 move data and probe 7
picks an index, so they must be equal; probe 9 must be equal bit for bit
(its NaN included, which `torch.equal` counts unequal to itself); probe
10 must be equal as values, NaN equal to NaN and -0 equal to +0 (a NaN's
payload and the sign of a zero sum are not the product's). Probe
12: every int8 value is exact in bf16 and every bf16 x int8 product is
exact in f32, so only the order of the sums differs: max |kernel - plain|
<= 1e-5 * max |plain|.

These are not kernels of the synthesis path. hbm_scratch, fori_dma,
dyn_sublane, dyn_col_dma, argmax, rot and onehot were redesigned for the
H100 (copies spread over CTAs, kept in flight by a ring, issued before
the device-held index is read, or all of a thread's loads issued before
its first compare, test or store); int8_panel computes kernel A's
function and launches kernel A, the port's Hopper design of it (each
launch counted in `int8_panel.launches` and in
`quant.qmatmul_kernel.launches`). On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

PANEL_REL_TOL = 1e-5          # probe 12, kernel vs plain (see above)


class ProbeFailed(Exception):
    """A probe's own check did not hold."""


def _require(cond, msg: str) -> None:
    if not bool(cond):
        raise ProbeFailed(msg)


def _check(name: str, t: torch.Tensor, dtype, shape=None,
           device=None) -> None:
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name}: tensor on {t.device}, not the CUDA "
                         "device of the call")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _aligned(name: str, t: torch.Tensor) -> None:
    """Bulk copies read from 16-byte aligned addresses."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data not 16-byte aligned")


def dynamic_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """A start index as lax.dynamic_slice takes it: a negative start counts
    from the end, then the start is clamped so that `size` elements fit."""
    start = start.long()
    start = torch.where(start < 0, start + dim, start)
    return start.clamp(0, dim - size)


def _launch(name: str, symbol: str, dev: torch.device, *args) -> None:
    from ..kernels import build
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(build.lib(), symbol)(
        *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)


# ----------------------------------------------------------- 5: hbm_scratch
SCRATCH_SHAPE = (64, 128)


def hbm_scratch_plain(x: torch.Tensor) -> torch.Tensor:
    """2 * x: the round trip through device memory moves data only."""
    return 2.0 * x


def hbm_scratch(x: torch.Tensor) -> torch.Tensor:
    """x f32 [64, 128] -> 2 * x, after x went shared memory -> a 32 KB
    device-memory scratch -> shared memory by bulk async copies, 4 rows a
    CTA."""
    if x.device.type == "cpu":
        return hbm_scratch_plain(x)
    _check("hbm_scratch", x, torch.float32, SCRATCH_SHAPE)
    _aligned("hbm_scratch", x)
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    _launch("hbm_scratch", "probe_hbm_scratch_launch", x.device, x, scratch,
            out, x.numel())
    hbm_scratch.launches += 1
    return out


# -------------------------------------------------------------- 6: fori_dma
def fori_dma_plain(w: torch.Tensor) -> torch.Tensor:
    """Σ_i w[i], summed in the kernel's order (o = 0; o += w[i])."""
    out = torch.zeros_like(w[0])
    for i in range(w.shape[0]):
        out = out + w[i]
    return out


def fori_dma(w: torch.Tensor) -> torch.Tensor:
    """w f32 [n, 8, 128] -> Σ_i w[i] [8, 128], one 4 KB bulk copy of w[i]
    per loop step through a ring of stage buffers, the next copies in
    flight while w[i] is summed."""
    if w.device.type == "cpu":
        return fori_dma_plain(w)
    _check("fori_dma", w, torch.float32)
    _aligned("fori_dma", w)
    if w.dim() != 3 or tuple(w.shape[1:]) != (8, 128) or w.shape[0] < 1:
        raise ValueError(f"fori_dma: w {tuple(w.shape)}, expected [n, 8, 128]")
    out = torch.empty(8, 128, dtype=torch.float32, device=w.device)
    _launch("fori_dma", "probe_fori_dma_launch", w.device, w, out, w.shape[0])
    fori_dma.launches += 1
    return out


# ---------------------------------------------------------------- 7: argmax
LANES = 128


def argmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU probe's formula: the lowest index among each row's maxima,
    broadcast over 128 lanes (int32). A row that holds a NaN gives cols
    (the maximum is NaN and x >= NaN never holds), not torch.argmax's
    index of the NaN; -0 and +0 are equal maxima, the lower index wins."""
    m = x.max(dim=-1, keepdim=True).values
    iota = torch.arange(x.shape[1], device=x.device).expand_as(x)
    idx = torch.where(x >= m, iota, torch.full_like(iota, x.shape[1]))
    return idx.min(dim=-1, keepdim=True).values.to(torch.int32).expand(
        x.shape[0], LANES).contiguous()


def argmax(x: torch.Tensor) -> torch.Tensor:
    """x f32 [rows, cols] (any contiguous view) -> int32 [rows, 128]: the
    per-row argmax of `argmax_plain` (ties to the lower index, cols on a
    row with a NaN) as a max of one 64-bit order key a thread; float4
    loads where the rows start 16-byte aligned and cols % 4 == 0, scalar
    loads otherwise."""
    if x.device.type == "cpu":
        return argmax_plain(x)
    _check("argmax", x, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"argmax: x {tuple(x.shape)}, expected [rows, cols]")
    out = torch.empty(x.shape[0], LANES, dtype=torch.int32, device=x.device)
    _launch("argmax", "probe_argmax_launch", x.device, x, out, x.shape[0],
            x.shape[1], LANES)
    argmax.launches += 1
    return out


# ----------------------------------------------------------- 8: dyn_sublane
SUBLANE_SHAPE = (32, 128)
SUBLANE_COPIES = 8


def dyn_sublane_plain(c: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row c[pos] (pos taken as lax.dynamic_slice takes it), written into
    buf[:, pos, :] of an [8, 32, 128] buffer and read back: [8, 128]."""
    p = dynamic_start(pos[:1], c.shape[0], 1)
    row = c.index_select(0, p)                             # [1, 128]
    buf = torch.zeros(SUBLANE_COPIES, *c.shape, dtype=c.dtype,
                      device=c.device)
    buf.index_copy_(1, p, row.expand(SUBLANE_COPIES, 1, c.shape[1]))
    return buf.index_select(1, p)[:, 0]


def dyn_sublane(c: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """c f32 [32, 128], pos int32 [1] on the device -> [8, 128]: the
    kernel stages c in shared memory by one bulk copy while it reads pos
    itself (no host sync), and indexes a 128 KB dynamic shared scratch
    with it."""
    if c.device.type == "cpu":
        return dyn_sublane_plain(c, pos)
    _check("dyn_sublane", c, torch.float32, SUBLANE_SHAPE)
    _aligned("dyn_sublane", c)
    _check("dyn_sublane pos", pos, torch.int32, (1,), c.device)
    out = torch.empty(SUBLANE_COPIES, SUBLANE_SHAPE[1], dtype=torch.float32,
                      device=c.device)
    _launch("dyn_sublane", "probe_dyn_sublane_launch", c.device, c, pos, out)
    dyn_sublane.launches += 1
    return out


# ------------------------------------------------------------------- 9: rot
SIGN_BIT = -2 ** 31          # 0x80000000 as an int32


def rot_plain(x: torch.Tensor) -> torch.Tensor:
    """Rotate-half of f32 x: concat(-x[..., h:], x[..., :h]), the negation
    a flip of the sign bit of every value, NaN included, as jnp's and
    torch's `-x` do on the CPU. On the card torch's `-x` gives the
    canonical NaN 0x7fffffff for every NaN (and is the flip on every other
    value), so the plain version flips the bit itself and is the same on
    both devices."""
    h = x.shape[-1] // 2
    neg = (x[..., h:].view(torch.int32) ^ SIGN_BIT).view(torch.float32)
    return torch.cat([neg, x[..., :h]], dim=-1)


def rot(x: torch.Tensor) -> torch.Tensor:
    """x f32 [..., d] (d even; any contiguous view) -> rotate-half, as a
    lane map of the widest vectors (4, 2 or 1 floats) that divide d / 2
    and the pointers' alignment, the sign bit flipped."""
    if x.device.type == "cpu":
        return rot_plain(x)
    _check("rot", x, torch.float32)
    d = x.shape[-1]
    if x.dim() < 1 or d < 2 or d % 2:
        raise ValueError(f"rot: x {tuple(x.shape)}, last dim must be even")
    out = torch.empty_like(x)
    _launch("rot", "probe_rot_launch", x.device, x, out, x.numel(), d)
    rot.launches += 1
    return out


# ---------------------------------------------------------------- 10: onehot
def onehot_plain(codes: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The TPU probe's formula: one_hot(codes[:, 0]) @ tab. A code outside
    [0, vocab) matches no row and gives a zero row. The product sums over
    every row of the table, and 0 * inf and 0 * NaN are NaN: a column that
    holds a non-finite entry in a row other than the chosen one is NaN."""
    iota = torch.arange(tab.shape[0], device=tab.device)
    oh = (iota[None] == codes[:, :1].long()).to(tab.dtype)
    return oh @ tab


def onehot(codes: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """codes int32 [rows, c] (column 0 used), tab f32 [vocab, d] (any
    contiguous views) -> [rows, d], `onehot_plain`'s values: the chosen
    entries (zeros for a code outside the table), NaN in the columns whose
    non-finite entries the product would multiply by 0. One launch of a
    CTA a column block (csrc/probes.cu, -DONEHOT_COLS, 8 by default), each
    scanning the whole table for non-finite entries in its columns."""
    if codes.device.type == "cpu":
        return onehot_plain(codes, tab)
    _check("onehot codes", codes, torch.int32)
    _check("onehot tab", tab, torch.float32, None, codes.device)
    if codes.dim() != 2 or tab.dim() != 2:
        raise ValueError(f"onehot: codes {tuple(codes.shape)}, tab "
                         f"{tuple(tab.shape)}")
    rows, d = codes.shape[0], tab.shape[1]
    out = torch.empty(rows, d, dtype=torch.float32, device=codes.device)
    _launch("onehot", "probe_onehot_launch", codes.device, codes, tab, out,
            rows, codes.shape[1], tab.shape[0], d)
    onehot.launches += 1
    return out


# ----------------------------------------------------------- 11: dyn_col_dma
COL_MUL, COL_ADD, COL_WIDTH = 512, 256, 256


def dyn_col_dma_plain(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w[:, c0:c0 + 256], c0 = q * 512 + 256 taken as lax.dynamic_slice
    takes a start."""
    c0 = dynamic_start(q[:1].long() * COL_MUL + COL_ADD, w.shape[1],
                       COL_WIDTH)
    cols = c0 + torch.arange(COL_WIDTH, device=w.device)
    return w.index_select(1, cols)


def dyn_col_dma(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q int32 [1] on the device, w f32 [rows <= 256, cols] -> [rows, 256]:
    a few rows a CTA (csrc/probes.cu, -DCOL_ROWS), each slice one 2-D TMA
    box at a column computed in the kernel from q and one bulk store."""
    if w.device.type == "cpu":
        return dyn_col_dma_plain(q, w)
    _check("dyn_col_dma w", w, torch.float32)
    _check("dyn_col_dma q", q, torch.int32, (1,), w.device)
    rows, cols = w.shape if w.dim() == 2 else (0, 0)
    if not (1 <= rows <= 256) or cols < COL_WIDTH or cols % 4 \
            or w.data_ptr() % 16:
        raise ValueError(f"dyn_col_dma: w {tuple(w.shape)}: 1..256 rows, at "
                         f"least {COL_WIDTH} columns, a multiple of 4, "
                         "16-byte aligned")
    out = torch.empty(rows, COL_WIDTH, dtype=torch.float32, device=w.device)
    _launch("dyn_col_dma", "probe_dyn_col_dma_launch", w.device, q, w, out,
            rows, cols, COL_WIDTH, COL_MUL, COL_ADD)
    dyn_col_dma.launches += 1
    return out


# ------------------------------------------------------------ 12: int8_panel
PANEL_X_SHAPE = (16, 512)
PANEL_N = 256


def int8_panel_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w[:, :256] in f32 (every bf16 x int8 product is exact in f32)."""
    return x.float() @ w[:, :PANEL_N].float()


_unit_scales: Dict[torch.device, torch.Tensor] = {}


def int8_panel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x bf16 [16, 512], w int8 [512, ldw] -> f32 [16, 256]: kernel A
    (`ops/quant.py qmatmul_kernel`, `csrc/qmatmul.cu`) on the column slice
    w[:, :256] (row stride ldw) with unit column scales (x1.0 is exact):
    its TMA ring streams the int8 panel, int8 -> bf16 in registers, wgmma
    into f32."""
    if x.device.type == "cpu":
        return int8_panel_plain(x, w)
    _check("int8_panel x", x, torch.bfloat16, PANEL_X_SHAPE)
    _aligned("int8_panel x", x)
    _check("int8_panel w", w, torch.int8, None, x.device)
    if w.dim() != 2 or w.shape[0] != PANEL_X_SHAPE[1] \
            or w.shape[1] < PANEL_N or w.shape[1] % 16 or w.data_ptr() % 16:
        raise ValueError(f"int8_panel: w {tuple(w.shape)}, expected [512, "
                         "ldw >= 256], ldw a multiple of 16, 16-byte aligned")
    from ..ops import quant
    ones = _unit_scales.get(x.device)
    if ones is None:
        ones = _unit_scales[x.device] = torch.ones(
            PANEL_N, dtype=torch.float32, device=x.device)
    out = quant.qmatmul_kernel(x, w[:, :PANEL_N], ones)
    int8_panel.launches += 1
    return out


# ------------------------------------------------------------------- probes
@dataclass(frozen=True)
class Probe:
    name: str
    label: str
    line: int                 # the TPU probe's def in tools/mosaic_probe.py
    call: int                 # and its pl.pallas_call
    kernel: Callable
    plain: Callable
    check: Callable           # (out, *inputs): the JAX probe's assertion
    exact: bool = True        # kernel vs plain: equal, else PANEL_REL_TOL
    bitwise: bool = False     # equal bit for bit (NaN and -0 included)
    values: bool = False      # equal as values: NaN = NaN, -0 = +0


def _check_hbm(out, x):
    _require(float(out[0, 0]) == 2.0, f"out[0, 0] = {float(out[0, 0])}")


def _check_fori(out, w):
    _require(torch.allclose(out, w.sum(dim=0)), "mismatch")


def _check_argmax(out, x):
    _require(torch.equal(out[:, 0].long(), torch.argmax(x, dim=-1)),
             "argmax mismatch")


def _check_sublane(out, c, pos):
    _require(torch.allclose(out[0], c[int(pos[0])]), "row mismatch")


def _check_rot(out, x):
    h = x.shape[-1] // 2
    _require(torch.allclose(out, torch.cat([-x[..., h:], x[..., :h]], -1)),
             "rotate-half mismatch")


def _check_onehot(out, codes, tab):
    _require(torch.allclose(out, tab[codes[:, 0].long()]), "gather mismatch")


def _check_col(out, q, w):
    c0 = int(q[0]) * COL_MUL + COL_ADD
    _require(torch.allclose(out, w[:, c0:c0 + COL_WIDTH]),
             "col slice mismatch")


def _check_panel(out, x, w):
    want = x.float() @ w[:, :PANEL_N].float()
    _require(torch.allclose(out, want, atol=2.0), "int8 dot mismatch")


PROBES: Tuple[Probe, ...] = (
    Probe("hbm_scratch", "hbm_scratch (bulk copies: shared -> device-memory "
          "scratch -> shared, mbarrier)", 38, 49, hbm_scratch,
          hbm_scratch_plain, _check_hbm),
    Probe("fori_dma", "fori_dma (bulk copy of w[i] per loop step, mbarrier "
          "phase parity)", 65, 77, fori_dma, fori_dma_plain, _check_fori),
    Probe("argmax", "argmax (one 64-bit order key a thread, a max by warp "
          "shuffles -> [B, 128] int32)", 93, 103, argmax, argmax_plain,
          _check_argmax),
    Probe("dyn_sublane", "dyn_sublane (device-held row index, the table "
          "staged by a bulk copy, 128 KB dynamic shared scratch)", 115, 124,
          dyn_sublane, dyn_sublane_plain, _check_sublane),
    Probe("rot", "rot (rotate-half as a lane map of float4 vectors, sign "
          "bit flipped)", 139, 146, rot, rot_plain, _check_rot,
          bitwise=True),
    Probe("onehot", "onehot (one-hot x table: the chosen entries, NaN "
          "columns from a scan of the table in column blocks)", 158, 169,
          onehot, onehot_plain, _check_onehot, values=True),
    Probe("dyn_col_dma", "dyn_col_dma (2-D TMA boxes at a column computed "
          "from a device-held q, bulk stores, rows over CTAs)", 180, 190,
          dyn_col_dma, dyn_col_dma_plain, _check_col),
    Probe("int8_panel", "int8_panel (kernel A: TMA int8 panel, bf16 "
          "wgmma, f32 accumulation)", 208, 217, int8_panel, int8_panel_plain, _check_panel,
          exact=False),
)


def probe_inputs(device, seed: int = 0) -> Dict[str, tuple]:
    """Each probe's inputs at the TPU probe's shapes and kinds: the same
    constants (ones, arange, codes, pos 7, q 2) and, where the TPU probe
    draws from jax.random, numpy draws from `seed`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    codes = np.broadcast_to(np.array([[3], [7], [0], [255], [9], [1], [2],
                                      [4]], np.int32), (8, 128))
    return {
        "hbm_scratch": (t(np.ones(SCRATCH_SHAPE, np.float32)),),
        "fori_dma": (t(np.arange(4 * 8 * 128, dtype=np.float32).reshape(
            4, 8, 128)),),
        "argmax": (t(rng.standard_normal((8, 2048), np.float32)),),
        "dyn_sublane": (t(np.arange(32 * 128, dtype=np.float32).reshape(
            SUBLANE_SHAPE)), t(np.array([7], np.int32))),
        "rot": (t(rng.standard_normal((8, 16, 128), np.float32)),),
        "onehot": (t(codes), t(rng.standard_normal((256, 128), np.float32))),
        "dyn_col_dma": (t(np.array([2], np.int32)),
                        t(np.arange(128 * 2048, dtype=np.float32).reshape(
                            128, 2048))),
        "int8_panel": (
            t(rng.standard_normal(PANEL_X_SHAPE, np.float32)).bfloat16(),
            t(rng.integers(-127, 127, (512, 512)).astype(np.int8))),
    }


FORI_STEPS = (1, 2, 3, 4, 5, 9)
SUBLANE_POS = (-40, -3, 0, 7, 31, 40)
# dyn_col_dma's rows: one row, a partial, whole or only slice of the 2, 4,
# 8, 16 and 32 rows a CTA that csrc/probes.cu's -DCOL_ROWS may set, the
# most rows; each on a wide and a narrow w, at the device-held q of COL_Q
COL_ROW_CASES = (1, 4, 7, 8, 16, 32, 100, 128, 256)
COL_COLS = (2048, 260)
COL_Q = (-9, 0, 3, 5)
# argmax's edge rows (`argmax_row`), and its varied cases as (rows, cols,
# offset): offset floats into a flat buffer, so a row start that is not
# 16-byte aligned, and cols % 4 != 0, take the kernel's scalar loads
ARGMAX_KINDS = ("normal", "tie", "all equal", "all -inf", "+inf twice",
                "nan", "-nan", "-0 before +0", "+0 before -0", "max at 0",
                "max at end")
ARGMAX_CASES = ((33, 2048, 0), (33, 2048, 1), (33, 2047, 0), (33, 100, 0),
                (33, 100, 2), (12, 3, 0), (11, 1, 0), (16, 4096, 0))
# rot's varied cases as (shape, offset): vectors of 4 floats (d / 2 % 4 ==
# 0, aligned), of 2 (d = 12; or 8-byte aligned) and of 1 (d = 2, 6, 130; or
# 4 bytes off), 1-D to 4-D
ROT_CASES = (((8, 16, 128), 0), ((2,), 0), ((5, 6), 0), ((2, 3, 130), 0),
             ((2, 3, 4, 8), 0), ((7, 12), 0), ((4, 256), 0), ((64,), 0),
             ((33, 128), 1), ((33, 128), 2))
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
ROT_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, NEG_NAN],
                        np.float32)
# onehot's tables (`onehot_table`): normal draws, or one of +-inf and
# NaN of either sign in a chosen row or in a row no code chooses, +inf and
# -inf in one column, -0 entries; and its varied cases as (rows, vocab, d),
# each with a codes row stride of 1 or 128 and a table 0 or 4 bytes off
ONEHOT_VALUES = {"inf": np.float32(np.inf), "-inf": np.float32(-np.inf),
                 "nan": np.float32(np.nan), "-nan": NEG_NAN}
ONEHOT_KINDS = ("finite",) + tuple(
    f"{v} in {where}" for where in ("a chosen row", "another row")
    for v in ONEHOT_VALUES) + ("inf and -inf in a column", "-0")
ONEHOT_CASES = tuple((rows, vocab, d) for rows in (1, 8, 33)
                     for vocab in (1, 256, 1000)
                     for d in (1, 32, 100, 128, 260))


def argmax_row(kind: str, cols: int, rng) -> np.ndarray:
    """One f32 row of an ARGMAX_KINDS kind, from normal draws: the maximum
    copied to three columns far apart (other warps and 256-column chunks
    at 2048 columns), a constant row, all -inf, +inf at two columns, a NaN
    of either sign beside a +inf, -0 and +0 as the maximum of negatives in
    either order, the maximum at the first or the last column."""
    x = rng.standard_normal(cols, np.float32)
    top = x.max() + np.float32(1)
    if kind == "tie":
        x[[cols // 7, min(cols - 1, cols // 2 + 1), max(0, cols - 3)]] = top
    elif kind == "all equal":
        x[:] = 0.25
    elif kind == "all -inf":
        x[:] = -np.inf
    elif kind == "+inf twice":
        x[[cols // 3, (2 * cols) // 3]] = np.inf
    elif kind in ("nan", "-nan"):
        x[0 if kind == "-nan" else cols - 1] = np.inf
        x[(3 * cols) // 4 if kind == "-nan" else cols // 2] = (
            NEG_NAN if kind == "-nan" else np.nan)
    elif kind in ("-0 before +0", "+0 before -0"):
        first = np.float32(-0.0 if kind.startswith("-") else 0.0)
        x = -np.abs(x) - np.float32(1)
        x[cols - 1] = -first
        x[cols // 4] = first
    elif kind == "max at 0":
        x[0] = top
    elif kind == "max at end":
        x[cols - 1] = top
    else:
        assert kind == "normal", kind
    return x


def argmax_rows(rows: int, cols: int, rng) -> np.ndarray:
    """[rows, cols] f32, row i of kind ARGMAX_KINDS[i % 11]."""
    return np.stack([argmax_row(ARGMAX_KINDS[i % len(ARGMAX_KINDS)], cols,
                                rng) for i in range(rows)])


def rot_values(shape, rng) -> np.ndarray:
    """Normal draws with ROT_SPECIALS (+-0, +-inf, NaN of either sign) at
    up to 18 random places."""
    x = rng.standard_normal(shape, np.float32)
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)[:3 * ROT_SPECIALS.size]
    flat[idx] = np.resize(ROT_SPECIALS, idx.size)
    return x


def onehot_codes(rows: int, ld: int, vocab: int, rng) -> np.ndarray:
    """int32 [rows, ld]: column 0 a code in the table in row 0, -1 in row
    1, vocab in row 2, draws from [-2, vocab + 2) below; in the other
    columns, draws that the function must not read."""
    codes = rng.integers(-2, vocab + 2, (rows, ld)).astype(np.int32)
    codes[0, 0] = rng.integers(vocab)
    codes[1:3, 0] = np.array([-1, vocab], np.int32)[:rows - 1]
    return codes


def onehot_table(kind: str, codes: np.ndarray, vocab: int, d: int,
                 rng) -> np.ndarray:
    """f32 [vocab, d] normal draws with the entries of an ONEHOT_KINDS
    kind at column d // 3: in row codes[0, 0] (chosen), in a row no code
    chooses (another; the chosen row where every row is chosen), +inf in
    the chosen row and -inf in another, or -0 in both (the other at the
    next column)."""
    tab = rng.standard_normal((vocab, d), np.float32)
    chosen = int(codes[0, 0])
    free = np.setdiff1d(np.arange(vocab), codes[:, 0])
    other = int(rng.choice(free)) if free.size else chosen
    j = d // 3
    if kind == "inf and -inf in a column":
        tab[chosen, j], tab[other, j] = np.inf, -np.inf
    elif kind == "-0":
        tab[chosen, j] = tab[other, (j + 1) % d] = np.float32(-0.0)
    elif kind != "finite":
        value, where = kind.split(" in ")
        tab[chosen if where == "a chosen row" else other, j] = (
            ONEHOT_VALUES[value])
    return tab


def onehot_edges(device, seed: int) -> Tuple[Tuple[str, tuple], ...]:
    """(label, (codes, tab)) at the probe's shape, codes [8, 128] and a
    normal table [256, 128]: codes outside [0, 256); the same table with
    +inf at (100, 5), NaN at (200, 7) and -inf at (3, 9), rows 0-2 and 4
    choosing 3, 100, -1 and 300 (NaN in columns 5 and 7 of row 0, -inf in
    its column 9, the chosen +inf kept in row 1, NaN in row 2's columns 5,
    7 and 9); then `onehot_codes` and an `onehot_table` of each
    ONEHOT_KINDS kind."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((256, 128), np.float32)
    codes = np.broadcast_to(np.array([[3], [-1], [256], [255], [1000], [0],
                                      [-7], [4]], np.int32), (8, 128)).copy()
    bad, odd = tab.copy(), codes.copy()
    bad[100, 5], bad[200, 7], bad[3, 9] = np.inf, np.nan, -np.inf
    odd[[1, 2, 4], 0] = 100, -1, 300
    cases = [("codes outside the table", codes, tab),
             ("inf / NaN / -inf table", odd, bad)]
    for kind in ONEHOT_KINDS:
        c = onehot_codes(8, 128, 256, rng)
        cases.append((kind, c, onehot_table(kind, c, 256, 128, rng)))
    return tuple((label, (torch.from_numpy(c).to(device),
                          torch.from_numpy(t).to(device)))
                 for label, c, t in cases)


def shifted(a: np.ndarray, floats: int, device) -> torch.Tensor:
    """A contiguous f32 copy of `a` that starts `floats` elements into a
    flat buffer, so 4 * floats bytes past the allocation's alignment (at
    least 16 bytes on the CPU and the card)."""
    flat = torch.zeros(a.size + floats, dtype=torch.float32, device=device)
    view = flat[floats:].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return view


def varied_inputs(device, seed: int = 0) -> Tuple[Tuple[str, str, tuple], ...]:
    """(probe name, label, inputs) of the cases a constant or fixed input
    would not tell apart: hbm_scratch on an arange and on normal draws (a
    CTA that copied another slice would still give 2.0 on ones), fori_dma
    on normal draws at each of FORI_STEPS steps, dyn_sublane on a normal
    table at each of SUBLANE_POS, dyn_col_dma on normal draws at each of
    COL_ROW_CASES x COL_COLS (a slice dealt to the wrong CTA, or a partial
    last slice stored whole, would show), int8_panel on draws from `seed`
    over the whole int8 range with three row strides (ldw 256, 400,
    512), argmax on the edge rows of `argmax_rows` at each of ARGMAX_CASES
    (ties, NaN rows, -0 / +0, cols % 4 != 0, rows that start off 16
    bytes), rot on `rot_values` at each of ROT_CASES, onehot on
    `onehot_codes` and an `onehot_table` of each kind in turn at each of
    ONEHOT_CASES (a code row stride of 1 or 128, a table 0 or 4 bytes
    off)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = [("hbm_scratch", "arange", (t(np.arange(
        SCRATCH_SHAPE[0] * SCRATCH_SHAPE[1], dtype=np.float32).reshape(
            SCRATCH_SHAPE)),)),
             ("hbm_scratch", f"normal, seed {seed}", (t(rng.standard_normal(
                 SCRATCH_SHAPE, np.float32)),))]
    cases += [("fori_dma", f"steps={n}, normal", (t(rng.standard_normal(
        (n, 8, 128), np.float32)),)) for n in FORI_STEPS]
    cases += [("dyn_sublane", f"pos={v}, normal", (t(rng.standard_normal(
        SUBLANE_SHAPE, np.float32)), t(np.array([v], np.int32))))
        for v in SUBLANE_POS]
    for i, rows in enumerate(COL_ROW_CASES):
        for j, cols in enumerate(COL_COLS):
            q = COL_Q[(i + j) % len(COL_Q)]
            w = rng.standard_normal((rows, cols), np.float32)
            cases.append(("dyn_col_dma", f"rows={rows} cols={cols} q={q}, "
                          "normal", (t(np.array([q], np.int32)), t(w))))
    for rows, cols, off in ARGMAX_CASES:
        cases.append(("argmax", f"rows={rows} cols={cols} offset={off}, "
                      "edge rows", (shifted(argmax_rows(rows, cols, rng), off,
                                            device),)))
    for shape, off in ROT_CASES:
        cases.append(("rot", f"shape={shape} offset={off}, +-0 +-inf NaN",
                      (shifted(rot_values(shape, rng), off, device),)))
    for i, (rows, vocab, d) in enumerate(ONEHOT_CASES):
        ld, off = (1, 128)[i % 2], (i // 2) % 2
        kind = ONEHOT_KINDS[i % len(ONEHOT_KINDS)]
        codes = onehot_codes(rows, ld, vocab, rng)
        cases.append(("onehot", f"rows={rows} ld={ld} vocab={vocab} d={d} "
                      f"offset={off}, {kind}", (t(codes), shifted(
                          onehot_table(kind, codes, vocab, d, rng), off,
                          device))))
    for ldw in (PANEL_N, 400, 512):
        cases.append(("int8_panel", f"ldw={ldw}, seed {seed}", (
            t(rng.standard_normal(PANEL_X_SHAPE, np.float32)).bfloat16(),
            t(rng.integers(-128, 128, (PANEL_X_SHAPE[1], ldw)).astype(
                np.int8)))))
    return tuple(cases)


def agree(probe: Probe, got: torch.Tensor, want: torch.Tensor
          ) -> Tuple[bool, float]:
    """Kernel against plain at the module's tolerances (rot by its bits,
    onehot as values); returns (ok, max |got - want|, 0 where the bits or
    the values agree, inf where only one is NaN)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    diff = (got.double() - want.double()).abs()
    if probe.bitwise:
        same = got.view(torch.int32) == want.view(torch.int32)
        return bool(same.all()), float(
            diff.masked_fill(same, 0.0).nan_to_num(nan=float("inf")).max())
    if probe.values:
        nan = got.isnan()
        same = (got == want) | (nan & want.isnan())
        ok = torch.equal(nan, want.isnan()) and torch.equal(got[~nan],
                                                           want[~nan])
        return ok, float(diff.masked_fill(same, 0.0).nan_to_num(
            nan=float("inf")).max())
    err = float(diff.max())
    if probe.exact:
        return bool(torch.equal(got, want)), err
    bound = PANEL_REL_TOL * float(want.abs().max())
    return err <= bound, err


def reset_launch_counts() -> None:
    for p in PROBES:
        p.kernel.launches = 0


def launch_counts() -> Dict[str, int]:
    return {p.name: p.kernel.launches for p in PROBES}


reset_launch_counts()


def run(device: str) -> int:
    """Every probe in each mode of `device`; returns the number of FAIL
    lines."""
    dev = torch.device(device)
    inputs = probe_inputs(dev)
    modes = ("plain",) if dev.type == "cpu" else ("plain", "kernel")
    failed = 0
    for p in PROBES:
        args = inputs[p.name]
        for mode in modes:
            try:
                out = (p.kernel if mode == "kernel" else p.plain)(*args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                p.check(out, *args)
                if mode == "kernel":
                    ok, err = agree(p, out, p.plain(*args))
                    _require(ok, f"kernel differs from plain: max|d| {err:g}")
                print(f"  [{mode}] {p.label}: OK", flush=True)
            # the tool's boundary: report the probe and go on to the next
            except Exception as e:     # noqa: BLE001
                msg = str(e).split("\n")[0][:140]
                print(f"  [{mode}] {p.label}: FAIL - {type(e).__name__}: "
                      f"{msg}", flush=True)
                failed += 1
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: kernel and plain modes on the card (fails "
                         "without one); cpu: plain mode only")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mosaic_probe: --device cuda, but torch.cuda.is_available() is "
              "False (use --device cpu for the plain mode)", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"device: {args.device} ({name})", flush=True)
    return 1 if run(args.device) else 0


if __name__ == "__main__":
    sys.exit(main())
