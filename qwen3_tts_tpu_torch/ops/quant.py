"""Int8 / int4 weight quantization and the quantized products: the port of
`qwen3_tts_tpu/ops/quant.py`.

Layouts (the JAX package's, unchanged):
  int8: {"q": int8 [in, out], "scale": f32 [out]}, symmetric per output
        channel: w ~= q * scale.
  int4: {"q4": int8 [in//2, out] packed BIASED nibbles (stored q+8 in
        [1, 15]; low nibble = row r, high nibble = row in//2 + r),
        "m8": int8 [in//GROUP4, out] per-(k-group, channel) multipliers,
        "scale": f32 [out]}: w[k, n] ~= nib(k, n) * m8[k // GROUP4, n] *
        scale[n], nib in [-7, 7], m8 in [1, 127].
Stacked decoder weights carry a leading layer axis on every entry.

The quantizers are bit-for-bit the JAX package's on the same input: the
same f32 order of operations, round half to even, and the int4 packing
wraps through uint8 as JAX's `astype(uint8).astype(int8)` does.

Products:
  qmatmul      x @ int8 -> f32, with JAX's dispatch on shape: where
               `_pallas_qmatmul` runs (an accelerator, K and N multiples
               of 128) a CUDA tensor launches kernel A (`csrc/qmatmul.cu`)
               on x rounded to bf16; elsewhere the f32 product, as JAX's
               CPU branch computes it.
  qmatmul4     x @ int4 -> f32 through the dequantized weight `dequant4_dt`
               (JAX computes this outside Pallas too).
  panel_matmul4_plain  the int4 panel order of the fused kernels (per
               128-row group: dot against the biased nibbles, minus
               8 * rowsum(x_g), times m8 in f32); kernel B4 of
               `csrc/gemv.cu` computes the same.
  linear       the decoder stacks' single matmul entry point: dense, int8
               or int4, cast to x.dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Union

import torch

Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]

GROUP4 = 128      # int4 k-group size (rows sharing one m8 multiplier)
_LANE = 128
DECODER_MATMULS = ("wqkv", "wo", "w_gu", "w_down")   # stacked per layer


def is_quantized(w: Weight) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def is_quantized4(w: Weight) -> bool:
    return isinstance(w, dict) and "q4" in w and "scale" in w


def layer(w: Weight, l: int) -> Weight:
    """Layer `l` of a stacked dense or quantized weight (views, no copy)."""
    if isinstance(w, dict):
        return {k: v[l] for k, v in w.items()}
    return w[l]


# --------------------------------------------------------------------- int8
def quantize(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w [in, out] -> q * scale ~= w."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    return w["q"].float() * w["scale"]


# --------------------------------------------------------------------- int4
def quantize_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Grouped symmetric int4: w [K, N] with K % (2 * GROUP4) == 0."""
    return _quantize_int4(w, compiled=False)


def _quantize_int4(w: torch.Tensor,
                   compiled: bool) -> Dict[str, torch.Tensor]:
    """`compiled` reproduces JAX's quantizer as XLA compiles it inside
    `quantize_decoder_params` (`jax.lax.map`): there the division by the
    constant 7 * 127 becomes a product with its f32 reciprocal, which
    differs from the division in the last bit of some scales."""
    wf = w.float()
    K, N = wf.shape
    if K % (2 * GROUP4):
        raise ValueError(f"int4 needs rows in multiples of {2 * GROUP4}, "
                         f"got {tuple(wf.shape)}")
    G = K // GROUP4
    wg = wf.reshape(G, GROUP4, N)
    amax_gn = wg.abs().amax(dim=1)                                   # [G, N]
    amax_n = amax_gn.amax(dim=0)                                     # [N]
    if compiled:
        scale = amax_n.clamp_min(1e-8) * (1.0 / (7.0 * 127.0))
    else:
        scale = amax_n.clamp_min(1e-8) / (7.0 * 127.0)
    m8 = torch.clamp(torch.round(amax_gn / (7.0 * scale)), 1, 127)
    step = m8 * scale                                                # [G, N]
    q = torch.clamp(torch.round(wg / step[:, None]), -7, 7).reshape(K, N)
    q = (q + 8.0).to(torch.int32)              # biased storage [1, 15]
    lo = q[: K // 2] & 0xF
    hi = q[K // 2:] & 0xF
    q4 = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return {"q4": q4, "m8": m8.to(torch.int8), "scale": scale}


def unpack4(q4: torch.Tensor) -> torch.Tensor:
    """Packed biased [K//2, N] int8 -> [K, N] int8 nibbles in [-7, 7]."""
    qu = q4.to(torch.int32) & 0xFF
    lo = (qu & 0xF) - 8
    hi = ((qu >> 4) & 0xF) - 8
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def dequant4_dt(q4: torch.Tensor, m8: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """[K, N] weight in dt, per-channel scale NOT applied: the integer
    product nib * m8 (|.| <= 889) rounds once through dt."""
    nib = unpack4(q4).to(torch.int32)
    m = m8.to(torch.int32).repeat_interleave(GROUP4, dim=0)
    return (nib * m).to(dt)


def dequantize4(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    return dequant4_dt(w["q4"], w["m8"], torch.float32) * w["scale"]


def panel_matmul4_plain(x: torch.Tensor, q4: torch.Tensor,
                        m8: torch.Tensor) -> torch.Tensor:
    """The fused kernels' int4 order: x [M, K] @ deq(packed [K//2, N])
    without the per-channel scale, in f32:

        y = sum_g m8[g] * ( x_g @ nib_u_g  -  8 * rowsum(x_g) )

    over 128-row groups g, nib_u the biased nibbles [0, 15]. Products of
    x (in its dtype) and nibbles are exact in f32, as on the TPU's MXU."""
    M, K = x.shape
    N = q4.shape[1]
    ng = m8.shape[0]
    if q4.shape[0] * 2 != K or ng * GROUP4 != K:
        raise ValueError(f"panel_matmul4: x {tuple(x.shape)}, q4 "
                         f"{tuple(q4.shape)}, m8 {tuple(m8.shape)}")
    qu = q4.to(torch.int32) & 0xFF
    nib_u = torch.cat([qu & 0xF, qu >> 4], dim=0).float()        # [K, N]
    xg = x.float().reshape(M, ng, GROUP4).transpose(0, 1)        # [g, M, 128]
    part = torch.bmm(xg, nib_u.reshape(ng, GROUP4, N))           # [g, M, N]
    bias = 8.0 * xg.sum(dim=2, keepdim=True)                     # [g, M, 1]
    return ((part - bias) * m8.float()[:, None, :]).sum(dim=0)


def qmatmul4(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ int4-grouped [in, out] -> [..., out] f32: dequantize
    to x.dtype, one product with f32 accumulation, per-channel scale."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wd = dequant4_dt(w["q4"], w["m8"], x2.dtype)
    out = (x2.float() @ wd.float()) * w["scale"]
    return out.reshape(*lead, w["q4"].shape[1])


# ------------------------------------------------------------- kernel A
def qmatmul_kernel_plain(x: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: f32( bf16(x) @ bf16(q) ) * scale."""
    return (x.to(torch.bfloat16).float() @ q.float()) * scale


# csrc/qmatmul.cu's geometry: a ring stage is one 64-deep K chunk of
# BN / 128 int8 weight boxes (64 x 128) and x's box (MT x 64 bf16)
A_BK, A_BOX_N = 64, 128
A_MT = (16, 32, 64, 128, 192)         # the kernel's row tiles (wgmma's N)
A_WIDE_MT = 64        # the largest row tile of a 256-column tile
A_SPLITS = (1, 2, 4, 8)               # the cluster's K ranks
A_MAX_STAGES = 8
A_SMEM = 232448                       # 227 KB of shared memory a block
A_SMEM_MIN = 118 * 1024               # one block an SM
_A_PAD = 8                            # f32 pad of a partial-tile row
# the plan's cost model, fitted to kernel A's times on the H100 (chip_smoke.py
# qmatmul_plan_times): a block costs _A_FIXED_US plus, per 64-row K chunk,
# _A_CHUNK_US + _A_COL_US a column + _A_ROW_US a row of its tile (about 17
# KB/us of weights a block); a cluster of 8 ranks adds _A_RANKS8_US; up to
# `sms` blocks run at once, but 128 blocks in clusters of 4 or 8 ran as two
# waves, 68 as one (at most _A_CLUSTER_BLOCKS at once)
_A_FIXED_US, _A_CHUNK_US, _A_COL_US, _A_ROW_US = 6.0, 0.10, 0.0018, 0.0022
_A_RANKS8_US = 1.0
_A_CLUSTER_BLOCKS = 96


class QPlan(NamedTuple):
    """Kernel A's launch: BN columns and MT rows a block, the K split
    across a cluster's ranks, the ring's stages (`qmatmul_plan`)."""
    bn: int
    mt: int
    splits: int
    stages: int


def qmatmul_smem(mt: int, bn: int, stages: int) -> int:
    """Shared memory of a block (csrc/qmatmul.cu smem_bytes): the ring, or
    the f32 partial tile it becomes, the mbarriers, 1024 to align; at
    least A_SMEM_MIN, so that the grid spreads one block an SM."""
    stage = bn * A_BK + mt * A_BK * 2
    part = mt * (bn + _A_PAD) * 4
    return max(A_SMEM_MIN,
               max(stages * stage, part) + 2 * A_MAX_STAGES * 8 + 1024)


def _a_cost(M, K, N, bn, mt, splits, sms) -> float:
    """Estimated us of one product by the fitted model above."""
    blocks = (N // bn) * -(-M // mt) * splits
    at_once = sms if splits <= 2 else min(sms, _A_CLUSTER_BLOCKS)
    chunks = K // A_BK // splits
    block = (_A_FIXED_US + (_A_RANKS8_US if splits == 8 else 0.0)
             + chunks * (_A_CHUNK_US + _A_COL_US * bn + _A_ROW_US * mt))
    return -(-blocks // at_once) * block


@functools.lru_cache(maxsize=None)
def qmatmul_plan(M: int, K: int, N: int, sms: int = 132) -> QPlan:
    """Kernel A's tiles for (M, K, N) on `sms` SMs: the column tile (256
    where it divides N), the row tile, and the K split across a cluster's
    ranks (whole 64-deep TMA boxes a rank), by `_a_cost`; then as many ring
    stages as the rank's chunks take and 227 KB hold."""
    if M < 1 or K % _LANE or N % _LANE:
        raise ValueError(f"qmatmul_plan: M={M}, K={K}, N={N}: M >= 1, K "
                         "and N multiples of 128")
    chunks = K // A_BK
    best = None
    for bn in (256, 128):
        if N % bn:
            continue
        for mt in A_MT:
            if bn > A_BOX_N and mt > A_WIDE_MT or mt >= 2 * M and mt > 16:
                continue
            for splits in A_SPLITS:
                if chunks % splits:
                    continue
                cost = _a_cost(M, K, N, bn, mt, splits, sms)
                if best is None or cost < best[0]:
                    best = (cost, bn, mt, splits)
    _, bn, mt, splits = best
    return qmatmul_ring(bn, mt, splits, chunks // splits)


def qmatmul_ring(bn: int, mt: int, splits: int, chunks: int) -> QPlan:
    """The ring of a rank with `chunks` 64-row chunks: as many stages as
    227 KB hold, up to the rank's chunks and A_MAX_STAGES."""
    stages = min(A_MAX_STAGES, chunks)
    while stages > 1 and qmatmul_smem(mt, bn, stages) > A_SMEM:
        stages -= 1
    return QPlan(bn, mt, splits, stages)


_A_MAPS: dict = {}
_A_MAPS_MAX = 4096


def _weight_map(lib, q: torch.Tensor, K: int, N: int, ldq: int):
    """The TMA map of the weight view q (128 bytes of host memory), encoded
    once per view: a map holds only the view's address, shape and row
    stride, so a key of those is never stale."""
    key = (q.device.index, q.data_ptr(), K, N, ldq)
    buf = _A_MAPS.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        from ..kernels import build
        build.check(lib.qmatmul_map(ctypes.addressof(buf), q.data_ptr(), K, N,
                                    ldq), "qmatmul_map")
        if len(_A_MAPS) >= _A_MAPS_MAX:
            _A_MAPS.clear()
        _A_MAPS[key] = buf
    return buf


def qmatmul_kernel(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Kernel A (`csrc/qmatmul.cu`, the port of `_pallas_qmatmul`):
    out [M, N] f32 = f32( bf16(x) [M, K] @ bf16(q) [K, N] ) * scale [N].
    Any M; K and N multiples of 128; q a view with unit column stride, a
    row stride and base 16-byte aligned. One launch a product. On a CPU
    tensor: the plain version; a CUDA tensor it cannot take raises."""
    if x.device.type == "cpu":
        return qmatmul_kernel_plain(x, q, scale)
    if not x.is_cuda or q.device != x.device or scale.device != x.device:
        raise ValueError(f"qmatmul: x on {x.device}, q on {q.device}, "
                         f"scale on {scale.device}")
    if x.dim() != 2 or q.dim() != 2 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32 or q.stride(1) != 1 \
            or not scale.is_contiguous():
        raise TypeError("qmatmul: x [M, K], q int8 [K, N] with unit column "
                        "stride, scale f32 [N]")
    M, K = x.shape
    N = q.shape[1]
    ldq = q.stride(0)
    if q.shape[0] != K or scale.shape != (N,) or M < 1 \
            or K % _LANE or N % _LANE or ldq % 16 or q.data_ptr() % 16:
        raise ValueError(f"qmatmul: x {tuple(x.shape)}, q {tuple(q.shape)}"
                         f" (row stride {ldq}), scale {tuple(scale.shape)}:"
                         " K and N must be multiples of 128, q's rows and "
                         "base 16-byte aligned")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)

    from ..kernels import build
    plan = qmatmul_plan(M, K, N, build.sm_count(x.device))
    lib = build.lib()
    wmap = _weight_map(lib, q, K, N, ldq)
    err = lib.qmatmul_launch(
        xb.data_ptr(), ctypes.addressof(wmap), scale.data_ptr(),
        out.data_ptr(), M, K, N, plan.bn, plan.mt, plan.splits, plan.stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmatmul")
    qmatmul_kernel.launches += 1
    return out


qmatmul_kernel.launches = 0


# ------------------------------------------------------------- products
def qmatmul(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ int8 [in, out] -> [..., out] f32. The JAX package's
    dispatch on shape: kernel A where `_pallas_qmatmul` would run (an
    accelerator tensor, K % 128 == 0 and N % 128 == 0), else the f32
    product of JAX's CPU branch."""
    q, scale = w["q"], w["scale"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    K, N = q.shape
    if x2.is_cuda and K % _LANE == 0 and N % _LANE == 0:
        out = qmatmul_kernel(x2, q, scale)
    else:
        out = (x2.float() @ q.float()) * scale
    return out.reshape(*lead, N)


def linear(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x [..., in] @ w [in, out] in x.dtype: dense, int8 or int4."""
    if is_quantized(w):
        return qmatmul(x, w).to(x.dtype)
    if is_quantized4(w):
        return qmatmul4(x, w).to(x.dtype)
    if isinstance(w, dict):
        raise ValueError(f"linear: a weight dict needs q/scale (int8) or "
                         f"q4/m8/scale (int4), got keys {sorted(w)}")
    return x @ w


# ------------------------------------------------------------- trees
def _quantize_stack(w: torch.Tensor, fn) -> Dict[str, torch.Tensor]:
    """[L, in, out] -> one dict of [L, ...] stacks, quantized one layer at
    a time (an f32 copy of a whole flagship stack would be 2.8 GB)."""
    parts = [fn(w[l]) for l in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def quantize_decoder_params(params, kind: str = "int8"):
    """Quantize a `models/decoder` tree: the four stacked layer matmuls
    (per layer slice) and the output head; norms stay dense.
    kind: "int8" (per channel) or "int4" (grouped, Q4_K-class)."""
    if kind not in ("int8", "int4"):
        raise ValueError(f"quantize kind {kind!r}: 'int8' or 'int4'")
    if kind == "int8":
        fn3 = fn2 = quantize
    else:
        fn2 = quantize_int4
        fn3 = lambda w: _quantize_int4(w, compiled=True)  # noqa: E731
    layers = dict(params["layers"])
    for name in DECODER_MATMULS:
        layers[name] = _quantize_stack(layers[name], fn3)
    return {"layers": layers, "final_norm": params["final_norm"],
            "head": fn2(params["head"])}
