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
  7   argmax        :93  max + iota-min            (value, index) reduction
  8   dyn_sublane   :115 SMEM index, dynamic row   device-held index, 128 KB
                                                   dynamic shared memory
  9   rot           :139 rotate-half concat        lane map
  10  onehot        :158 one-hot x table matmul    bounds-checked row load
  11  dyn_col_dma   :180 DMA at a dynamic column   2-D TMA tile at coordinates
                                                   computed in the kernel
  12  int8_panel    :208 int8 panel DMA, bf16 dot  kernel A (csrc/qmatmul.cu):
                                                   a TMA ring, int8 -> bf16 in
                                                   registers, wgmma

Modes: `kernel` and `plain`, the counterparts of the JAX tool's `compiled`
and `interpret`. `--device cpu` runs `plain` only; `--device cuda` runs both
(in `kernel` mode the kernel is also held against its plain version) and
fails where there is no card: it never quietly runs plain. Each probe and
mode prints one line `[mode] name: OK|FAIL - ...`. Divergence from the JAX
tool: the exit code is 1 if any line says FAIL.

Kernel against plain: probes 5, 6, 8, 9, 10 and 11 move data and probe 7
picks an index, so they must be equal. Probe 12: every int8 value is exact
in bf16 and every bf16 x int8 product is exact in f32, so only the order
of the sums differs: max |kernel - plain| <= 1e-5 * max |plain|.

These are not kernels of the synthesis path. hbm_scratch and fori_dma
were redesigned for the H100 (their copies spread over CTAs, or kept in
flight by a ring); int8_panel computes kernel A's function and launches
kernel A, the port's Hopper design of it (each launch counted in
`int8_panel.launches` and in `quant.qmatmul_kernel.launches`); the other
five are right and simple, not fast. On a CPU tensor each wrapper runs its
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
    broadcast over 128 lanes (int32). Inputs are finite."""
    m = x.max(dim=-1, keepdim=True).values
    iota = torch.arange(x.shape[1], device=x.device).expand_as(x)
    idx = torch.where(x >= m, iota, torch.full_like(iota, x.shape[1]))
    return idx.min(dim=-1, keepdim=True).values.to(torch.int32).expand(
        x.shape[0], LANES).contiguous()


def argmax(x: torch.Tensor) -> torch.Tensor:
    """x f32 [rows, cols] -> int32 [rows, 128]: per-row argmax, ties to
    the lower index."""
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
    kernel reads pos itself (no host sync) and indexes a 128 KB dynamic
    shared buffer with it."""
    if c.device.type == "cpu":
        return dyn_sublane_plain(c, pos)
    _check("dyn_sublane", c, torch.float32, SUBLANE_SHAPE)
    _check("dyn_sublane pos", pos, torch.int32, (1,), c.device)
    out = torch.empty(SUBLANE_COPIES, SUBLANE_SHAPE[1], dtype=torch.float32,
                      device=c.device)
    _launch("dyn_sublane", "probe_dyn_sublane_launch", c.device, c, pos, out)
    dyn_sublane.launches += 1
    return out


# ------------------------------------------------------------------- 9: rot
def rot_plain(x: torch.Tensor) -> torch.Tensor:
    """Rotate-half: concat(-x[..., h:], x[..., :h])."""
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def rot(x: torch.Tensor) -> torch.Tensor:
    """x f32 [..., d] (d even) -> rotate-half, as an elementwise lane map."""
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
    [0, vocab) matches no row and gives a zero row."""
    iota = torch.arange(tab.shape[0], device=tab.device)
    oh = (iota[None] == codes[:, :1].long()).to(tab.dtype)
    return oh @ tab


def onehot(codes: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """codes int32 [rows, c] (column 0 used), tab f32 [vocab, d] ->
    [rows, d]: a direct row load, zeros for a code outside the table."""
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
    one 2-D TMA box, its column computed in the kernel from q."""
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
    Probe("argmax", "argmax (per-row (value, index) reduction -> [B, 128] "
          "int32)", 93, 103, argmax, argmax_plain, _check_argmax),
    Probe("dyn_sublane", "dyn_sublane (device-held row index, 128 KB "
          "dynamic shared buffer)", 115, 124, dyn_sublane, dyn_sublane_plain,
          _check_sublane),
    Probe("rot", "rot (rotate-half lane map)", 139, 146, rot, rot_plain,
          _check_rot),
    Probe("onehot", "onehot (one-hot x table as a bounds-checked row load)",
          158, 169, onehot, onehot_plain, _check_onehot),
    Probe("dyn_col_dma", "dyn_col_dma (2-D TMA box at a column computed "
          "from a device-held q)", 180, 190, dyn_col_dma, dyn_col_dma_plain,
          _check_col),
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


def varied_inputs(device, seed: int = 0) -> Tuple[Tuple[str, str, tuple], ...]:
    """(probe name, label, inputs) of the cases a constant or fixed input
    would not tell apart: hbm_scratch on an arange and on normal draws (a
    CTA that copied another slice would still give 2.0 on ones), fori_dma
    on normal draws at each of FORI_STEPS steps, int8_panel on draws from
    `seed` over the whole int8 range with three row strides (ldw 256, 400,
    512)."""
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
    for ldw in (PANEL_N, 400, 512):
        cases.append(("int8_panel", f"ldw={ldw}, seed {seed}", (
            t(rng.standard_normal(PANEL_X_SHAPE, np.float32)).bfloat16(),
            t(rng.integers(-128, 128, (PANEL_X_SHAPE[1], ldw)).astype(
                np.int8)))))
    return tuple(cases)


def agree(probe: Probe, got: torch.Tensor, want: torch.Tensor
          ) -> Tuple[bool, float]:
    """Kernel against plain at the module's tolerances; returns (ok,
    max |got - want|)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    err = float((got.double() - want.double()).abs().max())
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
