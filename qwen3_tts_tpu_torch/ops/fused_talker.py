"""One talker decode step over all layers: the port of
`qwen3_tts_tpu/ops/fused_talker.py::talker_step_fused`.

On the TPU this is one Pallas kernel. Here it takes one of two routes,
decided by `talker_route` before any launch, from the weights and the batch
alone:

  kernel  B <= ROUTE_MAX_B of the weights' kind (dense f32 / bf16 or
          int8, in any mix, or all five int4): one persistent CUDA kernel
          a step, `csrc/talker_step.cu` (`talker_step_kernel`, which takes
          B <= MAX_B = 32, the TPU kernel's cap), the TPU kernel's own
          shape;
  chain   larger batches: a chain of the port's kernels (`ops/chain.py`)
          driven per layer from Python (`_step`), which with the plain op
          set is also the kernel's plain version (`talker_step_fused_plain`).

The chain is five launches a layer: gemv for every product, with the
elementwise work in the product's launch (ln1 as the norm prologue and
QK-norm + RoPE as the qk epilogue of the qkv product, ln2 as the norm
prologue of gate/up, SwiGLU as the silu prologue of down), and decode
attention over the pre-update cache; then the Triton `rms_norm` for the
final norm and the head's gemv. Semantics are the TPU kernel's:

  * the residual stream stays f32 across layers; matmul inputs are rounded
    to the model dtype (rms outputs, attention output, silu*up);
  * the current token's k/v fold into the attention last, and the cache is
    written in place at the row's slot once no launch of the step reads it
    (the pre-update contract of `qwen3_tts_tpu/ops/fused_talker.py:575-596`):
    the chain copies k/v in after the whole step; the kernel stores them
    at the end of each layer's attention;
  * logits are f32 rounded through the model dtype, for dense and
    quantized heads alike.

Weights are dense, int8 or int4, split per layer as the TPU kernel's
`_split_w` splits them (`qwen3_tts_tpu/ops/fused_talker.py:72-82`): values
to gemv B / B8 / B4 (or the kernel's packed copy), the f32 per-channel
scales into their epilogues. The kernel's design is at the top of
`csrc/talker_step.cu`; its plan (work units, the head counters and the
attention deal, the weight ring, the kernel's weight copies) is mirrored
here for the CPU tests.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Tuple

import torch

from . import chain, quant, rope
from .flash_decode import NEG_INF
from .fused_predictor import (CHAIN, GROUP4_ROWS, KERNEL, MAX_MT4,
                              chunk_rows, derived, pack_units, pair_int4,
                              route, row_bytes, row_pass, split_units,
                              units_a_batch, weight_kind, weight_parts)
from .gemv import EPI_F32_ROUND_DT


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _step(ops, params: Dict[str, Any], cfg, x, positions, slot, kv_len,
          valid_from, k_cache, v_cache):
    chain.check_weights(params, cfg, "talker")
    lw = params["layers"]
    B = x.shape[0]
    dev = x.device
    L, nq, nk, hd = cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)

    positions = torch.as_tensor(positions, device=dev).reshape(B)
    cos, sin = rope.rope_angles(rope.mrope_positions(positions[:, None]),
                                cfg.mrope_sections, hd, cfg.rope_theta)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    kv_len = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(B)
    valid_from = torch.as_tensor(valid_from, device=dev).to(
        torch.int32).reshape(B)

    x_res = x.to(dtype=torch.float32, copy=True)
    k_new = torch.empty(L, B, nk, hd, dtype=dt, device=dev)
    v_new = torch.empty(L, B, nk, hd, dtype=dt, device=dev)
    q_buf = torch.empty(B, nq, hd, dtype=dt, device=dev)
    for l in range(L):
        chain.layer_pass(ops, lw, l, cfg, x_res, cos, sin, k_cache, v_cache,
                         q_buf, k_new[l], v_new[l], kv_len, valid_from)
    # the final norm stays a launch of its own: its output is also the
    # step's returned hidden, which a product's prologue would not keep
    h = ops.rms_norm(x_res, params["final_norm"], cfg.rms_eps, dt)
    logits = chain.matmul(ops, h, params["head"], epilogue=EPI_F32_ROUND_DT)

    # the cache write after the step, in place at each row's slot
    slot_b = torch.as_tensor(slot, device=dev).to(torch.long).expand(B)
    rows = torch.arange(B, device=dev)
    k_cache[:, rows, :, slot_b] = k_new.transpose(0, 1).to(k_cache.dtype)
    v_cache[:, rows, :, slot_b] = v_new.transpose(0, 1).to(v_cache.dtype)
    if ops is chain.KERNELS:
        talker_step_fused.kv_copies += 2
    return h, logits, k_cache, v_cache


def talker_step_fused(
    params: Dict[str, Any],
    cfg,
    x: torch.Tensor,            # [B, H] embedding input (cfg.dtype)
    positions,                  # [B] RoPE positions (slot - pad_offset)
    slot,                       # int or [B]: cache write slot
    kv_len,                     # [B] tokens already cached (pre-update)
    valid_from,                 # [B] first valid cache slot (left pad)
    k_cache: torch.Tensor,      # [L, B, nk, T, hd], updated in place
    v_cache: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hidden [B, H] cfg.dtype post final-norm, logits [B, vocab]
    f32, k_cache, v_cache). Routed by `talker_route`: the step kernel, or
    the chain (on CUDA tensors every op one of the port's kernels)."""
    if talker_route(params, x.shape[0]) == KERNEL:
        return talker_step_kernel(params, cfg, x, positions, slot, kv_len,
                                  valid_from, k_cache, v_cache)
    return _step(chain.KERNELS, params, cfg, x, positions, slot, kv_len,
                 valid_from, k_cache, v_cache)


# the chain's two indexed cache copies a step (none on the kernel route)
talker_step_fused.kv_copies = 0


def talker_step_fused_plain(params, cfg, x, positions, slot, kv_len,
                            valid_from, k_cache, v_cache):
    """The same step through the plain PyTorch versions of every op."""
    return _step(chain.PLAIN, params, cfg, x, positions, slot, kv_len,
                 valid_from, k_cache, v_cache)


# ------------------------------------------------------------- step kernel
MAX_B = 32          # the kernel's batch cap (csrc/talker_step.cu kSMaxB)
WIDE_B = 16         # the cap before it: `.launches_wide` counts B > WIDE_B
# The route's batch limits per weight kind, from `generate_codes` ms a
# frame on each route, five runs a side in turns, with the device ms a
# frame beside them (tools/frame_measure.py route; NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md, "the route's batch limit"): the kernel where every
# kernel run beat every chain run, and where the runs overlapped, the
# route that took less device time (as for ROUTE_MAX_B in
# ops/fused_predictor.py). At B = 1, 2, 4, 8, 16: dense and int8 on the
# kernel at every B (its device ms the lower at each); int4 through B = 8,
# at 16 the chain (16.27 against 17.90 device ms a frame). At B = 16, 17,
# 24, 32: dense on the kernel at each (every run faster at 17 and 32, less
# device time at 16 and 24); int8 on the kernel through 24, at 32 the
# chain (29.55 against 27.74 device ms a frame; B = 25-31 were not run);
# int4 the chain at each (17.30 / 21.28 / 23.75 / 30.31 against 16.35 /
# 21.24 / 22.81 / 27.52).
ROUTE_MAX_B = {"dense": 32, "int8": 24, "int4": 8}
UNIT = 8            # columns of a work unit (csrc/talker_step.cu kSUnit)
MAX_G = 4           # q heads per kv head
MAX_H = 2048        # hidden: a thread holds 8 of a row's values (kSXPer)
MAX_SPLITS = 16     # attention splits per (row, kv head)
MIN_SPLIT_SLOTS = 32    # cache slots a split at least
# The weight ring, one size for every B and dtype (csrc/talker_step.cu
# kSRing, kSChunk; `_plan` checks the library's own): RING buffers of
# CHUNK bytes of values (and int4's multipliers, `ring_bytes`), measured on
# the H100 (PERF.md, the talker's ring sweep)
RING = 4
CHUNK = 16 * 1024
_WARPS = 8          # consumer warps of a block
_STAGES = ("qkv", "wo", "gu", "down", "head")
_WEIGHTS = {"qkv": "wqkv", "wo": "wo", "gu": "w_gu", "down": "w_down"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"dense": 0, "int8": 1, "int4": 2}
# csrc/talker_step.cu's trace words: a block's TRACE_STRIDE words from
# blk * TRACE_STRIDE (kTrStride; tools/frame_measure.py talker reads them)
TRACE_STRIDE = 1024


def _weights(params):
    return {st: params["layers"][name] for st, name in _WEIGHTS.items()} \
        | {"head": params["head"]}


def talker_route(params: Dict[str, Any], B: int) -> str:
    """The step kernel's route (ops/fused_predictor.py `route`) at
    ROUTE_MAX_B."""
    return route(_weights(params).values(), B, ROUTE_MAX_B)


def stage_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each weight stage: K the x width, N the columns dealt over
    the blocks."""
    H, F = cfg.hidden, cfg.ffn_dim
    nqkv = (cfg.n_q_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    return {"qkv": (H, nqkv), "wo": (cfg.n_q_heads * cfg.head_dim, H),
            "gu": (H, 2 * F), "down": (F, H), "head": (H, cfg.vocab)}


def step_barriers(cfg) -> int:
    """Grid barriers a step: four a layer, after qkv with its attention,
    wo, gate/up and down (csrc/talker_step.cu step_barriers; the kernel
    traps if it meets another count)."""
    return 4 * cfg.n_layers


def step_splits(B: int, nk: int, T: int, nb: int) -> int:
    """Splits S of each (row, kv head)'s live range: doubled while the B *
    nk * S attention units fit the grid's nb blocks, up to MAX_SPLITS, and
    while the cache holds at least MIN_SPLIT_SLOTS slots a split. From B,
    nk, the grid and the capacity T only, never from kv_len: the kernel
    divides each row's live range itself."""
    s = 1
    while (s * 2 <= MAX_SPLITS and B * nk * s * 2 <= nb
           and s * 2 * MIN_SPLIT_SLOTS <= T):
        s *= 2
    return s


def split_range(lo: int, hi: int, S: int, s: int) -> Tuple[int, int]:
    """Split s of the live range [lo, hi) as the kernel takes it: ceil of
    an S-th each, the last ones shorter or empty (lo > hi reads as
    empty)."""
    live = max(hi - lo, 0)
    per = -(-live // S)
    s0 = lo + s * per
    return s0, max(s0, min(s0 + per, hi))


def group_units(cfg) -> int:
    """qkv units of a kv head's group: its g q heads, its k and its v
    (csrc/talker_step.cu group_units; the kernel's qkv columns are grouped
    so, `group_qkv`)."""
    g = cfg.n_q_heads // cfg.n_kv_heads
    return (g + 2) * cfg.head_dim // UNIT


def attention_unit(u: int, B: int, S: int) -> Tuple[int, int, int]:
    """Attention unit u as the kernel takes it: (kv head j, row b, split s),
    j-major, so head j's units fall on about the blocks that hold its qkv
    columns."""
    return u // (B * S), u // S % B, u % S


def head_arrivals(cfg, nb: int, blk: int) -> Dict[int, int]:
    """Block blk's arrivals on the head counters a layer: {kv head j: its
    qkv units of j's group} (csrc/talker_step.cu s_arrive). A unit of head
    j's attention waits until j's counter holds group_units a layer."""
    ug = group_units(cfg)
    lo, hi = split_units(stage_shapes(cfg)["qkv"][1] // UNIT, nb)[blk]
    out = {}
    for u in range(lo, hi):
        out[u // ug] = out.get(u // ug, 0) + 1
    return out


def step_plan(cfg, B: int, nb: int, T: int) -> Dict[str, list]:
    """The kernel's work plan over nb blocks: per weight stage, each block's
    range of 8-column units; "attention", each block's range of attention
    units (`attention_unit`); "residual", each block's columns of the
    residual it writes from x (and of the hidden from the final norm)."""
    plan = {st: split_units(N // UNIT, nb)
            for st, (_, N) in stage_shapes(cfg).items()}
    S = step_splits(B, cfg.n_kv_heads, T, nb)
    plan["attention"] = split_units(B * cfg.n_kv_heads * S, nb)
    plan["residual"] = split_units(cfg.hidden, nb)
    return plan


def step_smem_fixed(cfg, B: int, t_bytes: int, int4: bool = False) -> int:
    """Bytes of a block's shared memory besides the ring
    (csrc/talker_step.cu s_fixed): the ring's mbarriers, the trace's sums,
    the staged x rows, the sums' scratch, the attention unit's head vectors
    (q heads, k, v, k's norm weight, cos, sin) and warp states."""
    mt = row_pass(B, t_bytes, int4)
    hd = cfg.head_dim
    kmax = max(cfg.hidden, cfg.n_q_heads * hd, cfg.ffn_dim)
    xs = -(-(mt * kmax * t_bytes) // 16) * 16
    return 2 * RING * 8 + 40 * 8 + xs + 4 * (
        2 * _WARPS * 32 + 64 + 8 + (5 + MAX_G) * hd
        + _WARPS * MAX_G * (hd + 2) + MAX_G + 4)


def ring_bytes() -> int:
    """The ring's shared memory: RING buffers of CHUNK bytes of values and
    a 64th of that for int4's multipliers (csrc/talker_step.cu
    s_ring_bytes)."""
    return RING * (CHUNK + CHUNK // 64)


def step_smem(cfg, B: int, t_bytes: int, smem_max: int,
              int4: bool = False) -> int:
    """A block's shared memory: the fixed part and the ring; raises where
    that exceeds the block's opt-in shared memory."""
    smem = step_smem_fixed(cfg, B, t_bytes, int4) + ring_bytes()
    if smem > smem_max:
        raise ValueError(f"talker_step: {smem} bytes of shared memory (the "
                         f"ring's {RING} x {CHUNK}) exceed the block's "
                         f"{smem_max}")
    return smem


def chunk_sequence(cfg, B: int, nb: int, blk: int, kinds, t_bytes: int,
                   chunk: int = CHUNK) -> list:
    """Block blk's ring chunks in the order producer and consumers walk
    them: (stage, layer, row pass, first unit, units, first row, rows)."""
    out = []
    int4 = "int4" in kinds
    mt = row_pass(B, t_bytes, int4)
    ub_n = units_a_batch(mt)
    shapes = stage_shapes(cfg)
    seq = [(st, l) for l in range(cfg.n_layers)
           for st in _STAGES[:4]] + [("head", 0)]
    for st, l in seq:
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
                    out.append((st, l, rc, ul, nub, r0, min(R, Kp - r0)))
    return out


def interleave_gu(t: torch.Tensor) -> torch.Tensor:
    """Gate/up columns [..., g (F) | u (F)] -> [..., 2F] with each 8-column
    unit [g 4f..4f+3 | u 4f..4f+3]: the kernel's gate/up stage then holds
    a feature's gate and up sums in one unit and writes silu(g) * u itself.
    Applied alike to the values, the int8 / int4 scales and the int4
    multipliers."""
    F = t.shape[-1] // 2
    lead = t.shape[:-1]
    g = t[..., :F].reshape(*lead, F // 4, 4)
    u = t[..., F:].reshape(*lead, F // 4, 4)
    return torch.cat([g, u], dim=-1).reshape(t.shape).contiguous()


def group_qkv(t: torch.Tensor, nq: int, nk: int, hd: int) -> torch.Tensor:
    """qkv columns [..., q (nq hd) | k (nk hd) | v (nk hd)] -> [..., nk
    groups of (g + 2) hd]: kv head j's q heads j g .. j g + g - 1, its k,
    its v, so the kernel's qkv units of one head are contiguous. Applied
    alike to the values, the scales and the int4 multipliers."""
    g = nq // nk
    cols = []
    for j in range(nk):
        cols += list(range(j * g * hd, (j + 1) * g * hd))
        cols += list(range((nq + j) * hd, (nq + j + 1) * hd))
        cols += list(range((nq + nk + j) * hd, (nq + nk + j + 1) * hd))
    return t[..., torch.tensor(cols, device=t.device)].contiguous()


def kernel_copy(t: torch.Tensor, stage: str, part: str = "", cfg=None):
    """The kernel's copy of a weight part, made once per tensor: qkv's
    columns grouped by kv head (`group_qkv`, needs `cfg`), gate/up's
    interleaved (`interleave_gu`); the values ("values" or int4's "q4",
    pairs of rows, `pair_int4`) and int4's multipliers ("m8") packed in
    units (`pack_units`); other parts as they are."""
    steps = []
    if stage == "qkv":
        steps.append(lambda x: group_qkv(x, cfg.n_q_heads, cfg.n_kv_heads,
                                         cfg.head_dim))
    elif stage == "gu":
        steps.append(interleave_gu)
    if part == "q4":
        steps.append(pair_int4)
    if part in ("values", "q4", "m8"):
        steps.append(pack_units)
    if not steps:
        return t

    def fn(x):
        for f in steps:
            x = f(x)
        return x
    return derived(t, f"talker {stage} {part}", fn)


def int4_group_order_plain(x: torch.Tensor, q4: torch.Tensor,
                           m8: torch.Tensor) -> torch.Tensor:
    """The step kernel's int4 product in plain PyTorch, f32, no column
    scale: x [M, K] @ deq(q4 [K / 2, N], m8 [K / 128, N]) as y = sum over
    128-row groups g of (x_g . (nib_g - 8)) * m8[g], the multiplier once a
    group after the group's dot (the kernel splits a group's dot over the
    lanes of a warp and sums the lanes' products later: the same sum in
    another order)."""
    M, K = x.shape
    N = q4.shape[-1]
    ng = K // quant.GROUP4
    nib = quant.unpack4(q4).float()                          # [K, N] - 8
    xg = x.float().reshape(M, ng, quant.GROUP4).transpose(0, 1)
    part = torch.bmm(xg, nib.reshape(ng, quant.GROUP4, N))   # [g, M, N]
    return (part * m8.float()[:, None, :]).sum(dim=0)


def split_attention_plain(q, k_all, v_all, k_new, v_new, layer: int,
                          kv_len, valid_from, S: int) -> torch.Tensor:
    """The kernel's attention, in its merge order, in plain PyTorch: per
    (row, kv head), S online-softmax states over `split_range`'s splits of
    the live range, each state a max and its rescaled sums; the states
    merged in split order (their max, then the sums rescaled to it), the
    current token folded in last, the output divided by max(l, 1e-30)."""
    B, nq, hd = q.shape
    nk, T = k_all.shape[2], k_all.shape[3]
    g = nq // nk
    qf = q.float().reshape(B, nk, g, hd) / math.sqrt(hd)
    out = torch.empty(B, nk, g, hd)
    for b in range(B):
        lo = max(int(valid_from[b]), 0)
        hi = min(int(kv_len[b]), T)
        for j in range(nk):
            ms, ls, accs = [], [], []
            for s in range(S):
                s0, s1 = split_range(lo, hi, S, s)
                k = k_all[layer, b, j, s0:s1].float()
                v = v_all[layer, b, j, s0:s1].float()
                sc = qf[b, j] @ k.T                              # [g, n]
                m = sc.amax(-1) if s1 > s0 else torch.full((g,), NEG_INF)
                p = torch.exp(sc - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(p @ v)
            mm = torch.stack(ms).amax(0)
            ll = torch.zeros(g)
            aa = torch.zeros(g, hd)
            for m, l_, a in zip(ms, ls, accs):
                c = torch.exp(m - mm)
                ll = ll + l_ * c
                aa = aa + a * c[:, None]
            sn = qf[b, j] @ k_new[b, j].float()
            mf = torch.maximum(mm, sn)
            c, pn = torch.exp(mm - mf), torch.exp(sn - mf)
            lf = (ll * c + pn).clamp_min(1e-30)
            out[b, j] = (aa * c[:, None] + pn[:, None]
                         * v_new[b, j].float()) / lf[:, None]
    return out.reshape(B, nq, hd).to(q.dtype)


class _StepArgs(ctypes.Structure):
    """`StepArgs` of csrc/talker_step.cu, field for field."""
    _fields_ = [("w", ctypes.c_void_p * 5), ("m8", ctypes.c_void_p * 5),
                ("sc", ctypes.c_void_p * 5)] \
        + [(f, ctypes.c_void_p) for f in (
            "ln1", "ln2", "q_norm", "k_norm", "final_norm", "x", "cos", "sin",
            "slot", "kv_len", "valid_from", "kc", "vc", "hidden", "logits",
            "xres", "qkv", "att", "act", "part", "cnt", "hcnt", "bar",
            "trace")] \
        + [("kind", ctypes.c_int * 5)] \
        + [(f, ctypes.c_int) for f in ("B", "H", "L", "nq", "nk", "hd", "F",
                                       "V", "Tc", "S", "mode")] \
        + [("eps", ctypes.c_float)]


# a [nb * TRACE_STRIDE] int64 CUDA tensor, or None: every block's stage
# timeline (tools/frame_measure.py talker; written only by a library built
# with kernels/build.py trace_build); MODE: NO_WORK cuts the products out
# (csrc/talker_step.cu kNoWork; the same builds only)
TRACE = None
NO_WORK = 1
MODE = 0


def _geometry(cfg):
    return (cfg.hidden, cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab, cfg.dtype)


# per (geometry, B, S, blocks, device, stream): the kernel's workspace; per
# (geometry, B, dtype, device): the launch plan
_workspaces: dict = {}
_plans: dict = {}


def _workspace(cfg, B: int, S: int, nb: int, dev):
    """Scratch of the kernel, kept per (geometry, B, splits, blocks,
    device, stream): the f32 residual, the qkv product, the attention output
    and silu(g) * u, the split states; the split counters and the head
    arrival counters (zeroed once; the kernel leaves them zero for the next
    launch) and the grid barrier's arrival count (zeroed once: it only
    grows, by the grid at every barrier, so it serves one grid size)."""
    key = (_geometry(cfg), B, S, nb, dev,
           torch.cuda.current_stream(dev).cuda_stream)
    if key not in _workspaces:
        H, nq, nk, hd = (cfg.hidden, cfg.n_q_heads, cfg.n_kv_heads,
                         cfg.head_dim)
        f32 = dict(dtype=torch.float32, device=dev)
        _workspaces[key] = dict(
            xres=torch.empty(B, H, **f32),
            qkv=torch.empty(B, (nq + 2 * nk) * hd, **f32),
            att=torch.empty(B, nq * hd, **f32),
            act=torch.empty(B, cfg.ffn_dim, **f32),
            part=torch.empty(B * nk * S, (nq // nk) * (hd + 2), **f32),
            cnt=torch.zeros(B * nk, dtype=torch.int32, device=dev),
            hcnt=torch.zeros(nk, dtype=torch.int32, device=dev),
            bar=torch.zeros(1, dtype=torch.int64, device=dev))
    return _workspaces[key]


def _query(dtype: int, mt: int, smem: int):
    """(resident blocks per SM at smem bytes, opt-in shared memory per
    block, SM count, the ring's buffers and bytes a buffer as the library
    was built) of the step kernel on the current device."""
    from ..kernels import build
    out = (ctypes.c_int * 5)()
    build.check(build.lib().talker_step_query(dtype, mt, smem, out),
                "talker_step_query")
    return tuple(out)


def _plan(cfg, B: int, t_bytes: int, int4: bool, dev):
    """(x rows a pass, blocks, shared memory a block): the fixed part and
    the ring, the grid SMs x the resident blocks per SM at that shared
    memory. Raises if the library's ring is not RING x CHUNK."""
    key = (_geometry(cfg), B, t_bytes, int4, dev)
    if key not in _plans:
        mt = row_pass(B, t_bytes, int4)
        dtype = 0 if t_bytes == 4 else 1
        _, smem_max, sms, nbuf, chunk = _query(dtype, mt, 0)
        if (nbuf, chunk) != (RING, CHUNK):
            raise RuntimeError(f"talker_step: the library's ring is {nbuf} x "
                               f"{chunk} bytes, the host's {RING} x {CHUNK}")
        smem = step_smem(cfg, B, t_bytes, smem_max, int4)
        per_sm = _query(dtype, mt, smem)[0]
        if per_sm < 1:
            raise RuntimeError(f"talker_step: no block fits an SM at {smem} "
                               "bytes of shared memory")
        _plans[key] = (mt, sms * per_sm, smem)
    return _plans[key]


def _check_step(params, cfg, x, k_cache, v_cache):
    """Refuse what the step kernel does not take (ValueError / TypeError):
    the checks run on every device, so a CPU run refuses what the card
    would. Returns the five weights' kinds."""
    chain.check_weights(params, cfg, "talker")
    B, H = x.shape[0], cfg.hidden
    L, nq, nk, hd = cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    F, V = cfg.ffn_dim, cfg.vocab
    dt = getattr(torch, cfg.dtype)
    if dt not in _DTYPES:
        raise TypeError(f"talker_step: model dtype {dt}; float32 or bfloat16")
    if not 1 <= B <= MAX_B or tuple(x.shape) != (B, H) or x.dtype != dt:
        raise ValueError(f"talker_step: x {tuple(x.shape)} {x.dtype}; "
                         f"[B, {H}] {dt}, B in [1, {MAX_B}]")
    if hd < 8 or hd > 128 or hd & (hd - 1) or nq % nk or nq // nk > MAX_G \
            or H % UNIT or H > MAX_H or F % UNIT or V % UNIT \
            or (nq * hd) % UNIT:
        raise ValueError("talker_step: head_dim a power of two in [8, 128], "
                         f"n_q_heads / n_kv_heads <= {MAX_G}, hidden <= "
                         f"{MAX_H}, hidden, ffn_dim, vocab and n_q_heads * "
                         f"head_dim multiples of {UNIT}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.dim() != 5 or tuple(c.shape[:3]) != (L, B, nk) \
                or c.shape[4] != hd or c.dtype != dt \
                or not c.is_contiguous() or c.device != x.device:
            raise ValueError(f"talker_step: {name} must be contiguous {dt} "
                             f"[{L}, {B}, {nk}, T, {hd}] on {x.device}, got "
                             f"{tuple(c.shape)} {c.dtype}")
    if k_cache.shape != v_cache.shape:
        raise ValueError("talker_step: k_cache and v_cache differ in shape")
    want = {st: (L,) + kn for st, kn in stage_shapes(cfg).items()}
    want["head"] = stage_shapes(cfg)["head"]
    kinds = []
    for st, w in _weights(params).items():
        for k, (shape, dtype) in weight_parts(w, want[st], dt).items():
            t = w if k is None else w[k]
            if tuple(t.shape) != shape or t.dtype != dtype \
                    or not t.is_contiguous() or t.data_ptr() % 16 \
                    or t.device != x.device:
                part = st if k is None else f"{st} {k}"
                raise ValueError(f"talker_step: {part} must be contiguous "
                                 f"16-byte aligned {dtype} {shape} on "
                                 f"{x.device}")
        kinds.append(weight_kind(w))
    lw = params["layers"]
    for name, shape in (("ln1", (L, H)), ("ln2", (L, H)),
                        ("q_norm", (L, hd)), ("k_norm", (L, hd))):
        t = lw[name]
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"talker_step: {name} must be contiguous {dt} "
                             f"{shape}")
    fn = params["final_norm"]
    if fn.dtype != dt or tuple(fn.shape) != (H,) or not fn.is_contiguous():
        raise ValueError(f"talker_step: final_norm must be contiguous {dt} "
                         f"({H},)")
    return tuple(kinds)


def _rows_i32(v, B: int, dev) -> torch.Tensor:
    return torch.as_tensor(v, device=dev).to(torch.int32).reshape(-1) \
        .expand(B).contiguous()


def talker_step_kernel(params: Dict[str, Any], cfg, x, positions, slot,
                       kv_len, valid_from, k_cache, v_cache):
    """The step in one launch of csrc/talker_step.cu (B <= MAX_B): (hidden,
    logits, k_cache, v_cache) as `talker_step_fused_plain` computes them,
    the caches updated in place. On a CPU tensor it takes that plain
    version; on a CUDA tensor it launches the kernel or raises. positions,
    slot, kv_len and valid_from become device int32 [B]; the RoPE tables
    are made on the device from positions. `.launches` counts its
    launches, `.launches_wide` those of them at B > 16 (the rows the kernel
    took past its first cap)."""
    kinds = _check_step(params, cfg, x, k_cache, v_cache)
    if x.device.type == "cpu":
        return talker_step_fused_plain(params, cfg, x, positions, slot,
                                       kv_len, valid_from, k_cache, v_cache)
    dev = x.device
    dt = getattr(torch, cfg.dtype)
    t_bytes = 4 if dt == torch.float32 else 2
    B, hd = x.shape[0], cfg.head_dim
    from ..kernels import build
    with torch.cuda.device(dev):
        mt, nb, smem = _plan(cfg, B, t_bytes, "int4" in kinds, dev)
        S = step_splits(B, cfg.n_kv_heads, k_cache.shape[3], nb)
        ws = _workspace(cfg, B, S, nb, dev)
        pos = _rows_i32(positions, B, dev)
        cos, sin = rope.rope_angles(rope.mrope_positions(pos[:, None]),
                                    cfg.mrope_sections, hd, cfg.rope_theta)
        cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
        ints = [_rows_i32(v, B, dev) for v in (slot, kv_len, valid_from)]
        xc = x.contiguous()
        hidden = torch.empty(B, cfg.hidden, dtype=dt, device=dev)
        logits = torch.empty(B, cfg.vocab, dtype=torch.float32, device=dev)
        lw = params["layers"]
        a = _StepArgs()
        for i, (st, w) in enumerate(_weights(params).items()):
            kind = kinds[i]
            if kind == "int4":
                vals, part = w["q4"], "q4"
            else:
                vals, part = (w["q"] if kind == "int8" else w), "values"
            a.w[i] = kernel_copy(vals, st, part, cfg).data_ptr()
            a.m8[i] = kernel_copy(w["m8"], st, "m8", cfg).data_ptr() \
                if kind == "int4" else None
            a.sc[i] = kernel_copy(w["scale"], st, "scale", cfg).data_ptr() \
                if kind != "dense" else None
            a.kind[i] = _KINDS[kind]
        for name, t in (("ln1", lw["ln1"]), ("ln2", lw["ln2"]),
                        ("q_norm", lw["q_norm"]), ("k_norm", lw["k_norm"]),
                        ("final_norm", params["final_norm"]), ("x", xc),
                        ("cos", cos), ("sin", sin), ("slot", ints[0]),
                        ("kv_len", ints[1]), ("valid_from", ints[2]),
                        ("kc", k_cache), ("vc", v_cache), ("hidden", hidden),
                        ("logits", logits)):
            setattr(a, name, t.data_ptr())
        for name in ("xres", "qkv", "att", "act", "part", "cnt", "hcnt",
                     "bar"):
            setattr(a, name, ws[name].data_ptr())
        a.trace = None if TRACE is None else TRACE.data_ptr()
        a.mode = MODE
        (a.B, a.H, a.L, a.nq, a.nk, a.hd, a.F, a.V, a.Tc, a.S) = (
            B, cfg.hidden, cfg.n_layers, cfg.n_q_heads, cfg.n_kv_heads, hd,
            cfg.ffn_dim, cfg.vocab, k_cache.shape[3], S)
        a.eps = cfg.rms_eps
        err = build.lib().talker_step_launch(
            ctypes.addressof(a), _DTYPES[dt], mt, nb, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "talker_step")
    talker_step_kernel.launches += 1
    talker_step_kernel.launches_wide += B > WIDE_B
    return hidden, logits, k_cache, v_cache


talker_step_kernel.launches = 0
talker_step_kernel.launches_wide = 0
