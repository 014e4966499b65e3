"""The predictor's 16-code expansion of a frame: the port of
`qwen3_tts_tpu/ops/fused_predictor.py::frame_codes_fused` and `make_ptab`.

On the TPU this is one Pallas kernel. Here it takes one of two routes,
decided by `frame_route` before any launch, from the weights' kinds and the
batch alone (JAX's own split is `usable` against `predictor.frame_codes`,
`qwen3_tts_tpu/tts/generate.py:97-104`):

  kernel  dense (f32 / bf16) or int8 weights (any mix of the two), or
          all five int4, and B <= ROUTE_MAX_B of their kinds: one
          persistent CUDA kernel a frame, `csrc/predictor_frame.cu`
          (`predictor_frame_kernel`, which takes B <= MAX_B), the TPU
          kernel's own shape;
  chain   a larger B, or int4 mixed with another kind: a chain of the
          port's kernels (`ops/chain.py`) driven from Python (`_frame`),
          which with the plain op set is also the kernel's plain version
          (`frame_codes_fused_plain`).

The chain, pass by pass:

  pass 0   x = h1024 (rounded to the model dtype) at position 0
  q=1..15  pass q (x = ptab[0][sel(code_0)] at position 1 for q = 1),
           then head slice q - 1 (its product with the final norm as
           prologue) with the argmax epilogue: code_q = the greedy code of
           the f32 slice [(q-1)*2048, q*2048) (JAX's `argmax_row`: lowest
           index on ties, 2048 for a row holding a NaN) -> codes[:, q];
           for q < 15 the same launch gathers x = ptab[q][sel(code_q)],
           the input of pass q + 1 at position q + 1 (`ops/gemv.py`,
           `argmax=`).

Each pass runs all layers for one token; the frame-local KV cache
[L, B, nk, max_seq, hd] is f32 (holding values rounded to the model dtype,
as the TPU kernel's is). Each layer's qkv launch stores the pass's k and v
at slot p itself, right after QK-norm and RoPE, where the TPU kernel
stores them (`qwen3_tts_tpu/ops/fused_predictor.py:359-379`): the gemv's
qk epilogue with the KV store (`ops/gemv.py`, `kv=`), given the slot's
strided views, with no copy of its own. The pass's attention reads slots
[0, p) only. Codes stay on the device: no `.item()`, no host sync inside
the frame. Codes out of range select the bias row of ptab; negative codes
clamp to 0 (`qwen3_tts_tpu/ops/fused_predictor.py:651-659`). The kernel
computes the same at the same rounding points, in one launch (its design:
the top of `csrc/predictor_frame.cu`).

Weights are dense, int8 or int4, split per layer as the TPU kernel's
`_split_w` splits them (`qwen3_tts_tpu/ops/fused_predictor.py:596`): values
to gemv B / B8 / B4, the f32 per-channel scales into their epilogues; the
head's logits are f32 rounded through the model dtype for every kind.

Deliberate divergences from the TPU kernel:
  * the residual stream is f32 (the TPU predictor kernel keeps it in the
    model dtype), the same as the talker step; with f32 weights the two
    are the same;
  * SwiGLU rounds once: silu(g) * u in f32 from the f32 gate/up product,
    then one rounding to the model dtype (the silu prologue of the down
    product), as the TPU talker kernel does. The TPU predictor kernel
    rounds gate/up to the model dtype, then silu(g) to the model dtype,
    and multiplies in the model dtype
    (`qwen3_tts_tpu/ops/fused_predictor.py:409-413`). The two are
    identical in f32 and differ by bf16 roundings in bf16;
  * the TPU kernel's VMEM-resident int8 weights (`resident`, `kv_res`;
    `qwen3_tts_tpu/ops/fused_predictor.py:52-65`) are not ported. They are
    a placement of the same math, bit-identical to its streamed int8 path
    (the whole int8 layer stack staged once per frame into the TPU core's
    128 MB of VMEM); an H100 SM has 227 KB of shared memory, so every pass
    here streams its weights from HBM (or the 50 MB L2).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import protocol
from . import chain, quant, rope
from .elementwise import sel_rows
from .gemv import EPI_F32_ROUND_DT


def _frame(ops, params: Dict[str, Any], cfg, ptab: torch.Tensor,
           ptab_rows: int, h1024: torch.Tensor, code_0: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain; `residual`, if given, receives the f32 residual after
    the last pass (what the frame kernel leaves in its workspace's
    `xres`)."""
    chain.check_weights(params, cfg, "predictor")
    lw = params["layers"]
    head = params["head"]
    B = code_0.shape[0]
    dev = h1024.device
    L, nq, nk, hd = cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    T = cfg.max_seq
    NB, CV = protocol.NUM_CODEBOOKS, protocol.CODE_VOCAB
    dt = getattr(torch, cfg.dtype)
    if T < NB:
        raise ValueError(f"predictor max_seq {T} < {NB} positions per frame")

    # per-position RoPE tables and prefix lengths, made once per frame
    pos = torch.arange(T, device=dev)
    cos, sin = rope.rope_angles(rope.mrope_positions(pos[None]),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    cos_t = cos[0][:, None].expand(T, B, hd).contiguous()
    sin_t = sin[0][:, None].expand(T, B, hd).contiguous()
    kv_len_t = pos.to(torch.int32)[:, None].expand(T, B).contiguous()
    valid_from = torch.zeros(B, dtype=torch.int32, device=dev)

    k_cache = torch.zeros(L, B, nk, T, hd, dtype=torch.float32, device=dev)
    v_cache = torch.zeros_like(k_cache)
    q_buf = torch.empty(B, nq, hd, dtype=dt, device=dev)
    k_new = torch.empty(B, nk, hd, dtype=dt, device=dev)
    v_new = torch.empty(B, nk, hd, dtype=dt, device=dev)
    codes = torch.zeros(B, NB, dtype=torch.int32, device=dev)
    codes[:, 0] = code_0.to(torch.int32)
    x_res = h1024.to(dt).to(torch.float32, copy=True)

    def stack_pass(p: int) -> None:
        for l in range(L):
            # the qkv launch stores this token's k/v at slot p of the
            # frame-local cache; the layer's attention reads [0, p) only
            chain.layer_pass(ops, lw, l, cfg, x_res, cos_t[p], sin_t[p],
                             k_cache, v_cache, q_buf, k_new, v_new,
                             kv_len_t[p], valid_from,
                             kv=(k_cache[l, :, :, p], v_cache[l, :, :, p]))

    stack_pass(0)
    x_res.copy_(ptab[0][sel_rows(code_0.long(), ptab_rows, ptab.shape[1])])
    for qi in range(1, NB):
        stack_pass(qi)
        # head slice qi - 1 with the final norm as its prologue, as in the
        # TPU kernel, and the argmax epilogue: code qi, and (but after the
        # last slice) the next pass's input row gathered into x_res
        chain.matmul(ops, x_res, head, col0=(qi - 1) * CV, n=CV,
                     epilogue=EPI_F32_ROUND_DT,
                     norm=(params["final_norm"], cfg.rms_eps), dt=dt,
                     argmax=(codes, qi, ptab, ptab_rows,
                             None if qi == NB - 1 else x_res))
    if residual is not None:
        residual.copy_(x_res)
    return codes


def frame_codes_fused(params: Dict[str, Any], cfg, ptab: torch.Tensor,
                      ptab_rows: int, h1024: torch.Tensor,
                      code_0: torch.Tensor) -> torch.Tensor:
    """h1024 [B, H] f32 projected talker hidden; code_0 [B]; ptab from
    `make_ptab`. Returns codes [B, 16] int32 with code_0 in column 0.
    Routed by `frame_route`: the frame kernel, or the chain."""
    if frame_route(params, code_0.shape[0]) == KERNEL:
        return predictor_frame_kernel(params, cfg, ptab, ptab_rows, h1024,
                                      code_0)
    return _frame(chain.KERNELS, params, cfg, ptab, ptab_rows, h1024, code_0)


def frame_codes_fused_plain(params, cfg, ptab, ptab_rows, h1024, code_0):
    """The same expansion through the plain PyTorch versions of every op:
    the plain version of the chain and of the frame kernel."""
    return _frame(chain.PLAIN, params, cfg, ptab, ptab_rows, h1024, code_0)


# ------------------------------------------------------------ frame kernel
KERNEL, CHAIN = "kernel", "chain"
# the kernel's batch cap (csrc/predictor_frame.cu kFMaxB), the TPU kernel's
# own (`max_b`, qwen3_tts_tpu/ops/fused_predictor.py:905)
MAX_B = 16
# the route's, per weight kind: the largest B at which every end-to-end run
# of a frame on the kernel beat every run on the chain (PERF.md's predictor
# route table, tools/frame_measure.py route predictor); past it the runs
# overlap (both kinds at 16) or were not taken (dense B = 11; dense also
# won every run at 12 and 13 in the measurement that moved its limit from
# 9 to 10, and int8 from 12 to 13); all-int4 weights won every run at B =
# 1, 2, 4, 8, 9, 12 and 16 (their chain of B4 launches took 33-81 ms a
# frame on the host, the kernel 6-36)
ROUTE_MAX_B = {"dense": 10, "int8": 13, "int4": 16}
UNIT = 8            # columns of a work unit (csrc/predictor_frame.cu kUnit)
MAX_MT4 = 4         # x rows a pass with int4 weights (kFMaxMT4, kSMaxMT4)
GROUP4_ROWS = quant.GROUP4 // 2     # packed int4 rows of a group (kG4Rows)
MAX_G = 4           # q heads per kv head
MAX_H = 2048        # hidden: a thread holds 8 of a row's values (kXPer)
RING = 6            # ring buffers (kFRing): a deeper ring takes L1 the
                    # kernel's spills need (PERF.md)
CHUNK = 16 * 1024   # bytes of a ring buffer
_WARPS = 8          # consumer warps of a block (kFWarps)
_STAGES = ("qkv", "wo", "gu", "down", "head")
_WEIGHTS = {"qkv": "wqkv", "wo": "wo", "gu": "w_gu", "down": "w_down"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"dense": 0, "int8": 1, "int4": 2}


def _weights(params):
    return {st: params["layers"][name] for st, name in _WEIGHTS.items()} \
        | {"head": params["head"]}


def weight_kind(w) -> str:
    return "int4" if quant.is_quantized4(w) else \
        "int8" if quant.is_quantized(w) else "dense"


def weight_parts(w, shape, dt) -> Dict[Optional[str], tuple]:
    """{part (None: the weight itself): (shape, dtype)} of what the
    persistent kernels read of a weight of `shape` [..., K, N], by its kind:
    dense values in dt; int8 values and f32 column scales; int4's packed
    values [..., K / 2, N], int8 multipliers [..., K / 128, N] and f32
    column scales."""
    kind = weight_kind(w)
    lead, (K, N) = tuple(shape[:-2]), shape[-2:]
    if kind == "int4":
        return {"q4": (lead + (K // 2, N), torch.int8),
                "m8": (lead + (K // quant.GROUP4, N), torch.int8),
                "scale": (lead + (N,), torch.float32)}
    if kind == "int8":
        return {"q": (tuple(shape), torch.int8),
                "scale": (lead + (N,), torch.float32)}
    return {None: (tuple(shape), dt)}


def route(weights, B: int, limits: Dict[str, int]) -> str:
    """KERNEL at B <= `limits` of each weight kind present (dense and int8
    in any mix, or all five int4); CHAIN for a larger B or int4 mixed with
    another kind (the persistent kernels refuse the mix; the chain refuses
    it too, as the TPU kernels do). Decided from the weights' kinds and the
    batch alone, before any launch, never on a failure: a kernel that does
    not build or launch raises."""
    kinds = {weight_kind(w) for w in weights}
    if "int4" in kinds and len(kinds) > 1:
        return CHAIN
    return KERNEL if B <= min(limits[k] for k in kinds) else CHAIN


def frame_route(params: Dict[str, Any], B: int) -> str:
    """The frame kernel's route (`route`) at ROUTE_MAX_B."""
    return route(_weights(params).values(), B, ROUTE_MAX_B)


def row_pass(B: int, t_bytes: int, int4: bool = False) -> int:
    """x rows a row pass stages (kMT) in both persistent kernels: 1, 2, 4,
    else 8 in bf16 and 4 in f32, so the staged rows take at most 16 bytes a
    K element; at most MAX_MT4 with int4 weights (B > kMT: ceil(B / kMT)
    passes over each stage, the weights streamed once a pass;
    csrc/predictor_frame.cu frame_rows, csrc/talker_step.cu step_rows)."""
    mt = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    mt = min(mt, 16 // t_bytes)
    return min(mt, MAX_MT4) if int4 else mt


def units_a_batch(mt: int) -> int:
    """Units a batch: a thread holds 32 sums (64 at 8 rows)."""
    return max(32, 8 * mt) // (8 * mt)


def stage_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each weight stage: N the columns dealt over the blocks
    (the head: one 2048-code slice)."""
    H, F = cfg.hidden, cfg.ffn_dim
    nqkv = (cfg.n_q_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    return {"qkv": (H, nqkv), "wo": (cfg.n_q_heads * cfg.head_dim, H),
            "gu": (H, 2 * F), "down": (F, H),
            "head": (H, protocol.CODE_VOCAB)}


def split_units(units: int, nb: int):
    """[lo, hi) of each of nb blocks: block i takes [i * units // nb,
    (i + 1) * units // nb), contiguous and in order (csrc/predictor_frame.cu
    unit_lo)."""
    return [(i * units // nb, (i + 1) * units // nb) for i in range(nb)]


def unit_owner(x: int, units: int, nb: int) -> int:
    """The block that owns unit x under `split_units` (csrc/
    predictor_frame.cu unit_owner)."""
    return ((x + 1) * nb - 1) // units


def frame_barriers(cfg) -> int:
    """Grid barriers a frame: four a layer pass (after qkv, wo with its
    attention prologue, gate/up, down) and one after each of the 15 head
    slices (csrc/predictor_frame.cu frame_barriers)."""
    NB = protocol.NUM_CODEBOOKS
    return NB * 4 * cfg.n_layers + NB - 1


def frame_plan(cfg, B: int, nb: int) -> Dict[str, list]:
    """The kernel's work plan over nb blocks: per weight stage, each block's
    range of 8-column units; "attention", the (row, kv head) units b * nk +
    j each block computes in wo's prologue (all of them where it holds wo
    units, none elsewhere); "kv_store", the block that stores each unit's k
    and v at slot p (the owner of wo unit u mod H / 8); "residual", each
    block's columns of the residual it writes from a pass's source row."""
    plan = {st: split_units(N // UNIT, nb)
            for st, (_, N) in stage_shapes(cfg).items()}
    units = B * cfg.n_kv_heads
    plan["attention"] = [(0, units) if hi > lo else (0, 0)
                         for lo, hi in plan["wo"]]
    n_wo = cfg.hidden // UNIT
    plan["kv_store"] = [unit_owner(u % n_wo, n_wo, nb) for u in range(units)]
    plan["residual"] = split_units(cfg.hidden, nb)
    return plan


def frame_smem_fixed(cfg, B: int, t_bytes: int, int4: bool = False) -> int:
    """Bytes of a block's shared memory besides the ring
    (csrc/predictor_frame.cu fixed_smem): the ring's mbarriers, the trace's
    sums, the staged x rows, the sums' scratch, the head's argmax and
    codes, the warps' head vectors and attention scores."""
    mt = row_pass(B, t_bytes, int4)
    hd, NB = cfg.head_dim, protocol.NUM_CODEBOOKS
    kmax = max(cfg.hidden, cfg.n_q_heads * hd, cfg.ffn_dim)
    xs = -(-(mt * kmax * t_bytes) // 16) * 16
    return 2 * RING * 8 + TRACE_SUMS * 8 + xs + 4 * (
        2 * _WARPS * 32 + 64 + 8 + 3 * MAX_B + _WARPS * hd
        + _WARPS * MAX_G * (NB + 1))


def ring_bytes(int4: bool = False, chunk: int = CHUNK) -> int:
    """The ring's shared memory: RING buffers of `chunk` bytes of values,
    with int4 weights each a 64th longer for the chunk's multipliers
    (csrc/predictor_frame.cu f_buf)."""
    return RING * (chunk + (chunk // 64 if int4 else 0))


def frame_smem(fixed: int, smem_max: int, int4: bool = False) -> int:
    """Bytes of a block's shared memory: the fixed part and the ring
    (`ring_bytes`); raises where that exceeds smem_max."""
    smem = fixed + ring_bytes(int4)
    if smem > smem_max:
        raise ValueError(f"predictor_frame: {fixed} bytes of fixed shared "
                         f"memory leave no room for {RING} {CHUNK}-byte ring "
                         f"buffers{' and their multipliers' if int4 else ''} "
                         f"in {smem_max}")
    return smem


def row_bytes(kind: str, t_bytes: int) -> int:
    """Bytes of one packed row of a unit (8 columns): T, int8, or 8 bytes
    of two nibbles a column (int4, half the rows)."""
    return UNIT * (t_bytes if kind == "dense" else 1)


def chunk_rows(chunk: int, nub: int, wb: int, Kp: int,
               int4: bool = False) -> int:
    """Rows of a batch of nub units a ring buffer of `chunk` bytes holds,
    at most Kp (csrc/predictor_frame.cu f_chunk_rows, csrc/talker_step.cu
    s_chunk_rows): even (whole 16-byte copies);
    with int4 whole pairs of groups (128 packed rows), whose multipliers (8
    bytes a group and unit) go to the buffer's last 64th."""
    return min(Kp, (chunk // (nub * wb)) & (~127 if int4 else ~1))


def frame_stages(cfg) -> list:
    """The frame's weight stages in the kernel's order: (stage, layer,
    head slice) for the 4 of each layer of pass 0, then per pass p >= 1
    the layers' and head slice p - 1 (csrc/predictor_frame.cu stage_of)."""
    layers = [(st, l, 0) for l in range(cfg.n_layers)
              for st in _STAGES[:4]]
    out = list(layers)
    for p in range(1, protocol.NUM_CODEBOOKS):
        out += layers + [("head", 0, p - 1)]
    return out


def chunk_sequence(cfg, B: int, nb: int, blk: int, kinds, t_bytes: int,
                   chunk: int) -> list:
    """Block blk's ring chunks in the order producer and consumers walk
    them (csrc/predictor_frame.cu FrameWalk): (stage index, stage, layer,
    head slice, row pass, first unit, units, first packed row, rows)."""
    out = []
    mt = row_pass(B, t_bytes, "int4" in kinds)
    ub_n = units_a_batch(mt)
    shapes = stage_shapes(cfg)
    for s, (st, l, q) in enumerate(frame_stages(cfg)):
        K, N = shapes[st]
        kind = kinds[_STAGES.index(st)]
        Kp = K // 2 if kind == "int4" else K
        wb = row_bytes(kind, t_bytes)
        lo, hi = split_units(N // UNIT, nb)[blk]
        for rc in range(-(-B // mt)):
            for ul in range(lo, hi, ub_n):
                nub = min(ub_n, hi - ul)
                R = chunk_rows(chunk, nub, wb, Kp, kind == "int4")
                for r0 in range(0, Kp, R):
                    out.append((s, st, l, q, rc, ul, nub, r0,
                                min(R, Kp - r0)))
    return out


def pack_units(w: torch.Tensor) -> torch.Tensor:
    """The frame kernel's weight layout: w [..., K, N] -> [..., N / 8, K, 8],
    each 8-column unit's K rows contiguous, so a chunk of a block's batch of
    units is one bulk copy a unit (csrc/predictor_frame.cu FrameWalk).
    Values unchanged."""
    N = w.shape[-1]
    return w.reshape(*w.shape[:-1], N // UNIT, UNIT).transpose(-3, -2) \
        .contiguous()


def unpack_units(p: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_units`: [..., N / 8, K, 8] -> [..., K, N]."""
    U, K, _ = p.shape[-3:]
    return p.transpose(-3, -2).reshape(*p.shape[:-3], K, U * UNIT)


def pair_int4(q4: torch.Tensor) -> torch.Tensor:
    """int4 values [..., K / 2, N] as ops/quant.py packs them (row r's
    nibble low, row r + K / 2's high) -> the persistent kernels' pairs:
    packed row r holds weight row 2 r in its low nibble and 2 r + 1 in its
    high one, so a 128-row group is 64 consecutive packed rows (the biased
    nibbles unchanged)."""
    qu = q4.to(torch.int32) & 0xFF
    nib = torch.cat([qu & 0xF, qu >> 4], dim=-2)            # [..., K, N]
    return (nib[..., 0::2, :] | (nib[..., 1::2, :] << 4)).to(
        torch.uint8).view(torch.int8)


# copies of the weights the kernels have read, by (the weight's id, the
# copy's kind); an entry holds a weak reference to the weight and its
# version, so a freed or modified weight is copied anew
_derived: dict = {}


def derived(w: torch.Tensor, kind: str, fn) -> torch.Tensor:
    """fn(w), made once per (weight tensor, kind) and kept while the weight
    lives and is unchanged."""
    key = (id(w), kind)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    ref = weakref.ref(w, lambda _, key=key: _derived.pop(key, None))
    _derived[key] = (ref, w._version, fn(w))
    return _derived[key][2]


def packed_weight(w: torch.Tensor, part: str = "values") -> torch.Tensor:
    """The kernel's copy of a weight part, made once per tensor and kept
    while it lives: `pack_units` of the values or of int4's multipliers
    ("m8"); int4's values ("q4") paired first (`pair_int4`). The kernel's
    extra copy of the predictor weights: 285 MB dense bf16 at full width,
    half for int8, about a quarter for int4."""
    if part == "q4":
        return derived(w, "units q4", lambda t: pack_units(pair_int4(t)))
    return derived(w, "units", pack_units)


def better(v: float, i: int, bv: float, bi: int) -> bool:
    """The argmax order of the kernel: NaN above every number, then the
    larger value, then the lower index: a strict total order, so any
    reduction tree agrees. A NaN logit enters as (NaN, CV), so a row
    holding one gives code CV, as JAX's `argmax_row`."""
    n, bn = v != v, bv != bv
    if n != bn:
        return n
    if not n and v != bv:
        return v > bv
    return i < bi


def reduce_partials(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain reduction of the head stage's per-block partials, vals / idx
    [nb, B] (a block with no columns holds (-inf, 2^31 - 1)): the code of
    each row [B] int64."""
    out = []
    for b in range(vals.shape[1]):
        bv, bi = float("-inf"), 2 ** 31 - 1
        for v, i in zip(vals[:, b].tolist(), idx[:, b].tolist()):
            if better(v, i, bv, bi):
                bv, bi = v, i
        out.append(bi)
    return torch.tensor(out, dtype=torch.int64)


def block_partials(logits: torch.Tensor, nb: int):
    """Plain per-block partials of a head slice's logits [B, CV] under the
    head stage's plan: (vals, idx) [nb, B], each block's argmax over its
    columns (the lowest index on ties; (NaN, CV) where they hold a NaN)."""
    B, CV = logits.shape
    vals = torch.full((nb, B), float("-inf"))
    idx = torch.full((nb, B), 2 ** 31 - 1, dtype=torch.int64)
    for blk, (lo, hi) in enumerate(split_units(CV // UNIT, nb)):
        if hi > lo:
            part = logits[:, lo * UNIT:hi * UNIT]
            k = torch.argmax(part, dim=-1)
            nan = torch.isnan(part).any(dim=-1)
            vals[blk] = part.gather(1, k[:, None])[:, 0]
            idx[blk] = torch.where(nan, CV, k + lo * UNIT)
    return vals, idx


class _FrameArgs(ctypes.Structure):
    """`FrameArgs` of csrc/predictor_frame.cu, field for field."""
    _fields_ = [("w", ctypes.c_void_p * 5), ("m8", ctypes.c_void_p * 5),
                ("sc", ctypes.c_void_p * 5)] \
        + [(f, ctypes.c_void_p) for f in (
            "ln1", "ln2", "q_norm", "k_norm", "final_norm", "ptab", "h1024",
            "code0", "codes", "xres", "qkv", "gu", "kc", "vc", "cos", "sin",
            "part_v", "part_i", "bar")] \
        + [("kind", ctypes.c_int * 5)] \
        + [(f, ctypes.c_int) for f in ("B", "H", "L", "nq", "nk", "hd", "F",
                                       "CV", "R", "rows0", "chunk", "mode")] \
        + [("eps", ctypes.c_float), ("trace", ctypes.c_void_p)]


# a [blocks x TRACE_STRIDE] int64 CUDA tensor, or None: every block's stage
# timeline (tools/frame_measure.py trace); MODE: NO_WORK cuts the products
# out. Both are read only by a library built with kernels/build.py
# trace_build.
TRACE = None
TRACE_STRIDE = 2048     # csrc/predictor_frame.cu kTrStride
TRACE_SUMS = 40         # kTrSums: the trace's sums in shared memory
MODE = 0
NO_WORK = 1         # kNoWork


def _geometry(cfg):
    return (cfg.hidden, cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.dtype)


# made once per (config geometry, device): the RoPE tables of positions
# 0..15; per (geometry, B, blocks, device, stream): the kernel's workspace;
# per (geometry, B, dtype, int4 or not, device): the launch plan
_tables: dict = {}
_workspaces: dict = {}
_plans: dict = {}


def _rope_table(cfg, dev):
    key = (_geometry(cfg), cfg.mrope_sections, cfg.rope_theta, dev)
    if key not in _tables:
        pos = torch.arange(protocol.NUM_CODEBOOKS, device=dev)
        cos, sin = rope.rope_angles(rope.mrope_positions(pos[None]),
                                    cfg.mrope_sections, cfg.head_dim,
                                    cfg.rope_theta)
        _tables[key] = (cos[0].contiguous(), sin[0].contiguous())
    return _tables[key]


def _workspace(cfg, B: int, nb: int, dev):
    """Scratch of the kernel, kept per (geometry, B, device, stream): the
    f32 residual, the qkv and gate-up outputs, the frame cache (never
    zeroed: only the slots a frame wrote are read), the head's per-block
    partials and the grid barrier's arrival count (zeroed once: it only
    grows, by the grid at every barrier, so it serves one grid size)."""
    key = (_geometry(cfg), B, nb, dev,
           torch.cuda.current_stream(dev).cuda_stream)
    if key not in _workspaces:
        H, L, nq, nk, hd = (cfg.hidden, cfg.n_layers, cfg.n_q_heads,
                            cfg.n_kv_heads, cfg.head_dim)
        f32 = dict(dtype=torch.float32, device=dev)
        cache = (L, B, nk, protocol.NUM_CODEBOOKS, hd)
        _workspaces[key] = dict(
            xres=torch.empty(B, H, **f32),
            qkv=torch.empty(B, (nq + 2 * nk) * hd, **f32),
            gu=torch.empty(B, 2 * cfg.ffn_dim, **f32),
            kc=torch.empty(cache, **f32), vc=torch.empty(cache, **f32),
            part_v=torch.empty(nb, B, **f32),
            part_i=torch.empty(nb, B, dtype=torch.int32, device=dev),
            bar=torch.zeros(1, dtype=torch.int64, device=dev))
    return _workspaces[key]


def _query(dtype: int, mt: int, smem: int):
    """(resident blocks per SM at smem bytes, opt-in shared memory per
    block, SM count) of the frame kernel on the current device."""
    from ..kernels import build
    out = (ctypes.c_int * 3)()
    build.check(build.lib().predictor_frame_query(dtype, mt, smem, out),
                "predictor_frame_query")
    return out[0], out[1], out[2]


def _plan(cfg, B: int, t_bytes: int, int4: bool, dev):
    """(x rows a pass, blocks, shared memory a block): the fixed part and
    the ring, the grid SMs x the resident blocks per SM at that shared
    memory."""
    key = (_geometry(cfg), B, t_bytes, int4, CHUNK, dev)
    if key not in _plans:
        mt = row_pass(B, t_bytes, int4)
        dtype = 0 if t_bytes == 4 else 1
        _, smem_max, sms = _query(dtype, mt, 0)
        smem = frame_smem(frame_smem_fixed(cfg, B, t_bytes, int4), smem_max,
                          int4)
        per_sm = _query(dtype, mt, smem)[0]
        if per_sm < 1:
            raise RuntimeError(f"predictor_frame: no block fits an SM at "
                               f"{smem} bytes of shared memory")
        _plans[key] = (mt, sms * per_sm, smem)
    return _plans[key]


def _check_frame(params, cfg, ptab, h1024, code_0):
    """Refuse what the frame kernel does not take (ValueError / TypeError):
    the checks run on every device, so a CPU run refuses what the card
    would."""
    B, H = h1024.shape[0], cfg.hidden
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    NB, CV = protocol.NUM_CODEBOOKS, protocol.CODE_VOCAB
    if dt not in _DTYPES:
        raise TypeError(f"predictor_frame: model dtype {dt}; float32 or "
                        "bfloat16")
    if not 1 <= B <= MAX_B or tuple(h1024.shape) != (B, H) \
            or tuple(code_0.shape) != (B,):
        raise ValueError(f"predictor_frame: h1024 {tuple(h1024.shape)}, "
                         f"code_0 {tuple(code_0.shape)}; B in [1, {MAX_B}]")
    if hd < 8 or hd > 128 or hd & (hd - 1) or nq % nk or nq // nk > MAX_G \
            or H % UNIT or H > MAX_H or cfg.ffn_dim % UNIT \
            or cfg.max_seq < NB:
        raise ValueError("predictor_frame: head_dim a power of two in [8, "
                         f"128], n_q_heads / n_kv_heads <= {MAX_G}, hidden "
                         f"<= {MAX_H}, hidden and ffn_dim multiples of "
                         f"{UNIT}, max_seq >= {NB}")
    if ptab.dtype != dt or ptab.dim() != 3 or ptab.shape[0] != NB \
            or ptab.shape[2] != H or not ptab.is_contiguous():
        raise ValueError(f"predictor_frame: ptab must be contiguous {dt} "
                         f"[{NB}, R, {H}]")
    L, F = cfg.n_layers, cfg.ffn_dim
    want = {"qkv": (L, H, (nq + 2 * nk) * hd), "wo": (L, nq * hd, H),
            "gu": (L, H, 2 * F), "down": (L, F, H), "head": (H, NB * CV)}
    kinds = []
    for st, w in _weights(params).items():
        for k, (shape, dtype) in weight_parts(w, want[st], dt).items():
            t = w if k is None else w[k]
            if tuple(t.shape) != shape or t.dtype != dtype \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                part = st if k is None else f"{st} {k}"
                raise ValueError(f"predictor_frame: {part} must be "
                                 f"contiguous 16-byte aligned {dtype} "
                                 f"{shape}")
        kinds.append(weight_kind(w))
    if "int4" in kinds:
        g2 = 2 * quant.GROUP4
        if kinds.count("int4") != len(kinds) or H % g2 or F % g2 \
                or (nq * hd) % g2:
            raise ValueError("predictor_frame: int4 weights all five or "
                             f"none, hidden, ffn_dim and n_q_heads * "
                             f"head_dim multiples of {g2}")
    lw = params["layers"]
    for name, shape in (("ln1", (L, H)), ("ln2", (L, H)),
                        ("q_norm", (L, hd)), ("k_norm", (L, hd))):
        t = lw[name]
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"predictor_frame: {name} must be contiguous "
                             f"{dt} {shape}")
    fn = params["final_norm"]
    if fn.dtype != dt or tuple(fn.shape) != (H,) or not fn.is_contiguous():
        raise ValueError(f"predictor_frame: final_norm must be contiguous "
                         f"{dt} ({H},)")
    return tuple(kinds)


def predictor_frame_kernel(params: Dict[str, Any], cfg, ptab: torch.Tensor,
                           ptab_rows: int, h1024: torch.Tensor,
                           code_0: torch.Tensor) -> torch.Tensor:
    """The frame in one launch of csrc/predictor_frame.cu (dense or int8
    weights, or all five int4; B <= MAX_B): codes [B, 16] int32, as
    `frame_codes_fused_plain` computes them. On a CPU tensor it takes that
    plain version; on a CUDA tensor it launches the kernel or raises.
    `.launches` counts its launches, `.launches_int4` those of them with
    int4 weights."""
    kinds = _check_frame(params, cfg, ptab, h1024, code_0)
    if h1024.device.type == "cpu":
        return frame_codes_fused_plain(params, cfg, ptab, ptab_rows, h1024,
                                       code_0)
    dev = h1024.device
    tensors = [ptab, code_0] + [t for w in _weights(params).values()
                                for t in (w.values() if isinstance(w, dict)
                                          else (w,))]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"predictor_frame: every tensor must be on {dev}")
    dt = getattr(torch, cfg.dtype)
    t_bytes = 4 if dt == torch.float32 else 2
    B = h1024.shape[0]
    int4 = "int4" in kinds
    from ..kernels import build
    with torch.cuda.device(dev):
        mt, nb, smem = _plan(cfg, B, t_bytes, int4, dev)
        ws = _workspace(cfg, B, nb, dev)
        cos, sin = _rope_table(cfg, dev)
        h = h1024.float().contiguous()
        c0 = code_0.to(torch.int32).contiguous()
        codes = torch.empty(B, protocol.NUM_CODEBOOKS, dtype=torch.int32,
                            device=dev)
        lw = params["layers"]
        a = _FrameArgs()
        for i, w in enumerate(_weights(params).values()):
            kind = kinds[i]
            if kind == "int4":
                a.w[i] = packed_weight(w["q4"], "q4").data_ptr()
                a.m8[i] = packed_weight(w["m8"], "m8").data_ptr()
            else:
                a.w[i] = packed_weight(w["q"] if kind == "int8"
                                       else w).data_ptr()
            a.sc[i] = w["scale"].data_ptr() if kind != "dense" else None
            a.kind[i] = _KINDS[kind]
        for name, t in (("ln1", lw["ln1"]), ("ln2", lw["ln2"]),
                        ("q_norm", lw["q_norm"]), ("k_norm", lw["k_norm"]),
                        ("final_norm", params["final_norm"]), ("ptab", ptab),
                        ("h1024", h), ("code0", c0), ("codes", codes),
                        ("cos", cos), ("sin", sin)):
            setattr(a, name, t.data_ptr())
        for name in ("xres", "qkv", "gu", "kc", "vc", "part_v", "part_i",
                     "bar"):
            setattr(a, name, ws[name].data_ptr())
        (a.B, a.H, a.L, a.nq, a.nk, a.hd, a.F, a.CV, a.R, a.rows0, a.chunk,
         a.mode) = (B, cfg.hidden, cfg.n_layers, cfg.n_q_heads,
                    cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                    protocol.CODE_VOCAB, ptab.shape[1], ptab_rows, CHUNK,
                    MODE)
        a.eps = cfg.rms_eps
        if TRACE is not None and TRACE.numel() < nb * TRACE_STRIDE:
            raise ValueError(f"predictor_frame: TRACE holds {TRACE.numel()} "
                             f"words; {nb} blocks need {nb * TRACE_STRIDE}")
        a.trace = None if TRACE is None else TRACE.data_ptr()
        err = build.lib().predictor_frame_launch(
            ctypes.addressof(a), _DTYPES[dt], mt, nb, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "predictor_frame")
    predictor_frame_kernel.launches += 1
    predictor_frame_kernel.launches_int4 += int4
    return codes


predictor_frame_kernel.launches = 0
predictor_frame_kernel.launches_int4 = 0


def make_ptab(assets, cfg) -> Tuple[torch.Tensor, int]:
    """Pre-projected codebook tables ptab[q, c] = codec_embedding_1024(q, c),
    computed in f32 and stored in cfg.dtype, with rows padded as the JAX
    package pads them and at least one bias row (the value of an
    out-of-range code: zero codec row -> projection -> bias).
    Returns (ptab [16, R, H], real row count)."""
    tabs = assets.codec_tables.float()
    pt = torch.einsum("qrd,pd->qrp", tabs, assets.proj_weight.float())
    pt = pt + assets.proj_bias.float()
    rows = pt.shape[1]
    rw = min(512, rows + 1)
    r_pad = -(-(rows + 1) // rw) * rw
    bias = assets.proj_bias.float().expand(pt.shape[0], r_pad - rows,
                                           pt.shape[2])
    pt = torch.cat([pt, bias], dim=1)
    return pt.to(getattr(torch, cfg.dtype)).contiguous(), rows
