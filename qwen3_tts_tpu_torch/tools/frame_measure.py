"""On-card measurements of the persistent kernels and the capability
probes, beside `chip_smoke.py` (PERF.md's stage traces and A/B numbers
come from here). Run from the repo's root (each mode imports its
`chip_smoke.py`):

    python3 -m qwen3_tts_tpu_torch.tools.frame_measure trace [B ...]
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure talker
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure ring [NBUF,CHUNK ...]
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure int8mm
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure sass [SOURCE ...]
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py ab TAG
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py talker-ab TAG
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py route [predictor] [KIND ...] [B ...]
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py frame-ab TAG
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py step-ab TAG
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure probes [PARENT_CU] [DEFS ...]
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py head-ab TAG [quick]

Both persistent kernels carry a trace that is compiled in only for
`trace` and `talker` (`kernels/build.py trace_build`, -DKERNEL_TRACE: a
library of its own, built in the measuring process) and on while a
trace buffer is set (`fused_predictor.TRACE`, `fused_talker.TRACE`). The
library the port runs has none of it.

trace   the predictor frame kernel's timeline: full width, dense bf16,
        int8 and int4, at each B given (1 and 16 by default), each in two modes
        (`fused_predictor.MODE`): as built, and with the products cut out
        (nowork: no weight copies, no sums; barriers, prologues and
        epilogues are left). Per run: ms a frame (CUDA events over 10
        frames), the grid barriers the kernel met against the host's
        count, us a layer pass; from every block's stamps of every grid
        barrier (arrival, release), per stage kind (qkv, wo with its
        attention prologue, gate/up, down, head) the median block's work,
        the spread of arrivals, last arrival to first release, the spread
        of releases and the stage's time; per block on average the time
        from a stage's start to its first activation data, the products'
        phases (first chunk in, last chunk read, end), the attention
        prologue, and a frame's ring waits: the consumers' for full
        buffers, the producer's for free ones.
talker  the talker step kernel's timeline, read from every block: full
        width, dense bf16, int8 and int4 at B = 1 and dense at B = 16, each
        with a 256-slot cache of ~100 live slots (offline) and a 4096-slot
        cache of ~1000 (streaming), each in two modes (`fused_talker.MODE`:
        as built, and `nowork`, the products cut out). Per run: ms a step
        (CUDA events over 10 steps), the grid barriers the kernel met
        against the host's count, us a layer; per stage kind (qkv with its
        attention, wo, gate/up, down) the median block's work, the spread
        of arrivals, last arrival to first release, the spread of releases
        and the stage's time, and the head's; per block on average the time
        to a stage's first activation data, the products' phases and the
        ring waits (consumers' for full buffers, the producer's for free
        ones); attention's phases a unit (the wait for its head's qkv
        columns, the q heads, the slots and warp states, the state and
        count, the merge with the k / v store) over the blocks with units.
ring [NBUF,CHUNK ...]
        the weight ring's size: `csrc/talker_step.cu` alone built with each
        (buffers, bytes a buffer) given (-DSTEP_RING, -DSTEP_CHUNK; 2 to 6
        x 16 KiB, 2 x 32 and 4 x 12 KiB by default; all built at once;
        ptxas's registers and spills a thread printed for each), then
        the step at full width by CUDA-graph replay, dense, int8 and int4
        at B = 1 and 16 (256 slots, ~100 live), two rounds over the
        variants.
sass [SOURCE ...]
        each `csrc` source given (talker_step and predictor_frame by
        default) compiled as `kernels/build.py` compiles it, to a cubin:
        ptxas's registers and spill bytes a thread, then per kernel its SASS
        instructions and its local loads and stores (`cuobjdump -sass`).
        From a parent's tree (`python3 <this file> sass`) it reads the
        parent's sources.
int8mm  whether `torch._weight_int8pack_mm` runs on CUDA, and its device
        time (CUDA-graph replay) at B8's predictor layer (M = 1) and A's
        talker layer (M = 64), weights rotating past the 50 MB L2: the
        one-call yardstick of the int8 products.
ab      one tree's side of a parent-vs-change A/B, run from the tree's
        root (it imports that tree's `chip_smoke.py`): `frame_times` for
        the dense, int4+int8 and int8/int8 weights (host and device ms and
        CUDA kernels a frame), then two warm `generate_stream` calls per
        set (first-chunk ms, streaming RTF including vocoding). Run the
        trees in turns in one call: parent, change, change, parent.
talker-ab  the same with the talker step first: `talker_step_fused` at
        full width, dense, int8 and int4, B = 1 and 2, device ms a step
        (profiler) and ms a step of eager calls (CUDA events); then `ab`.
route [predictor] [KIND ...] [B ...]
        the measurement behind the talker route's batch limits
        (`ops/fused_talker.py ROUTE_MAX_B`), or with `predictor` the frame
        route's (`ops/fused_predictor.py ROUTE_MAX_B`), end to end:
        `generate_codes` (ignore_eos) at full width, at each B given (1,
        2, 4, 8, 16 by default; the talker takes B up to its cap, 32, the
        predictor up to 16), for each weight KIND given (dense, int8,
        int4; all three by default): the talker with dense bf16, int8/int8
        and int4+int8 weights, the predictor with dense bf16, int8/int8
        and int4/int4, on its kernel (every kind's limit set to the
        kernel's cap) and on its chain (set to 0), five runs a side in
        turns kernel, chain, chain, kernel, ...: ms a frame (CUDA events
        over 16 frames, the prefill subtracted; the host loop's pace where
        it bounds the frame), the medians, whether every kernel run beat
        every chain run, and device ms a frame (profiler, prefill + 4
        frames less the prefill).
step-ab   one tree's side of a parent-vs-change A/B of the talker step
        kernel alone, run from the tree's root like `ab`: device ms a step
        by CUDA-graph replay at full width (256 slots, ~100 live), dense,
        int8 and int4 at B = 1, 2, 4, 8, 16, then at B = 1 and 16 with a
        4096-slot cache of ~1000 live slots.
frame-ab  one tree's side of a parent-vs-change A/B of both persistent
        kernels, run from the tree's root like `ab`: device ms of the
        talker step kernel (dense and int8 at B = 1 and 16, int4 at B =
        1) and of the frame kernel (dense and int8 at B = 1, 4, 8, 16) by
        CUDA-graph replay, kernel A at a talker layer (M = 64,
        `chip_smoke.qmatmul_times`) and the 64-token prefill's device ms
        (profiler, dense bf16 and int8/int8); then `generate_codes` ms a
        frame as `route` times it, dense bf16 and int8/int8 at B = 1, 4, 8,
        16, twice on the frame kernel's route and, at B = 8 and 16, once on
        the chain.
        Run the trees in turns, parent, change, change, parent, ..., five
        processes a side.
probes [PARENT_CU] [DEFS ...]
        the probe kernels' designs side by side in one process:
        `csrc/probes.cu` alone built as `kernels/build.py` builds it
        (ptxas's registers and spills printed), a parent's copy of it
        (PARENT_CU, a path ending in .cu) and this source with each
        DEFS given (NAME=VALUE[,NAME=VALUE]: -D overrides of its
        geometry), all at once; each library loaded in turn in place of
        the port's. Two rounds, the libraries in turns (parent, this,
        variants, then back): every probe whose kernel is in probes.cu
        held against its plain version on the tool's inputs and
        `mosaic_probe.varied_inputs`, then its device ms by CUDA-graph
        replay; beside them the PyTorch calls of hbm_scratch (`torch.mul`)
        and fori_dma (`torch.sum`), and each kernel's loss to its call (ms
        over the call's ms). int8_panel launches kernel A, not a kernel of
        probes.cu: `head-ab` times it.
head-ab TAG [quick]
        one tree's side of a parent-vs-change A/B of the predictor's head
        slice and its greedy code, run from the tree's root like `ab`. (a)
        The head slice (the final norm as its prologue, 1024 x 2048 of a
        full-width head, f32 logits rounded through bf16) with the argmax
        and the ptab gather, by CUDA-graph replay (the weights L2-warm), at
        B = 1, 10, 16 and 32 with dense, int8 and int4 heads: in one launch
        where the tree fuses them (`argmax=`), else the slice and the
        standalone `argmax_gather` (also timed alone). (b) The predictor's
        chain (`fused_predictor._frame` on the kernels) at full width,
        dense at B = 10 and 16, int8 at 13 and 16, all three kinds at 24
        and 32: device ms a frame by CUDA-graph replay, ms a frame of eager
        calls (CUDA events) and CUDA kernels a frame (profiler). (c) Kernel
        A (`quant.qmatmul_kernel`) at the int8_panel probe's shape (x bf16
        [16, 512], w int8 [512, 512] sliced to 256 columns, unit scales)
        beside the tree's `int8_panel` probe and
        `torch._weight_int8pack_mm`, each held against the plain panel.
        `quick` leaves out (b)'s eager ms. Run the trees in turns.
"""

from __future__ import annotations

import json
import os
import sys

# csrc/predictor_frame.cu: a block's trace words from blk * kTrStride
# (fused_predictor.TRACE_STRIDE): kTrT0, kTrEnd, kTrNBar, kTrFirst,
# kTrCWait, kTrPWait, kTrAttn, kTrProd
F_T0, F_END, F_NBAR, F_FIRST = 1920, 1921, 1922, 1924
F_CWAIT, F_PWAIT, F_ATTN, F_PROD = 1934, 1936, 1938, 1940
F_BARS = 960                # barriers stamped (kTrBars)
FRAME_STAGES = ("qkv", "wo", "gu", "down", "head")
MODES = {"": 0, "nowork": 1}     # fused_predictor.MODE


def frame_kinds(cfg) -> list:
    """The stage kind ending at each grid barrier of a frame: per pass the
    layers' qkv, wo (with attention), gu, down, then the head slice after
    passes 1..15 (csrc/predictor_frame.cu's order)."""
    out = []
    for p in range(16):
        out += list(FRAME_STAGES[:4]) * cfg.n_layers + (["head"] if p else [])
    return out


def read_trace(tr, nb: int, cfg, frames: int) -> dict:
    """Every block's words of a traced run (`tr`: the flat int64 trace as a
    list; the barrier stamps are the last frame's, the sums over `frames`):
    per stage kind the median block's work (its arrival less its previous
    release), the blocks' arrival spread (last less first arrival), the
    barrier's latency (first release less last arrival) and release spread,
    the stage's time (median release less the previous median release);
    us a layer pass; per block on average the time to a stage's first
    activation data, the products, the attention prologue, the consumers'
    waits for full buffers and the producer's for free ones, us a frame."""
    import statistics as st
    S = 2048
    blk = [tr[b * S:(b + 1) * S] for b in range(nb)]
    kinds = frame_kinds(cfg)
    nbar = blk[0][F_NBAR]
    out = {"barriers": nbar, "host_barriers": len(kinds)}
    n = min(nbar, F_BARS, len(kinds))
    prev = [b[F_T0] for b in blk]
    prev_med = st.median(prev)
    per = {k: {"work": [], "spread": [], "latency": [], "rspread": [],
               "stage": []} for k in FRAME_STAGES}
    for i in range(n):
        arr = [b[2 * i] for b in blk]
        rel = [b[2 * i + 1] for b in blk]
        d = per[kinds[i]]
        d["work"].append(st.median(a - p for a, p in zip(arr, prev)))
        d["spread"].append(max(arr) - min(arr))
        d["latency"].append(min(rel) - max(arr))
        d["rspread"].append(max(rel) - min(rel))
        med = st.median(rel)
        d["stage"].append(med - prev_med)
        prev, prev_med = rel, med
    for k, d in per.items():
        out[k] = {m: (sum(v) / len(v) / 1e3 if v else 0.0)
                  for m, v in d.items()}
    layer = sum(sum(per[k]["stage"]) for k in FRAME_STAGES[:4])
    out["us_layer_pass"] = layer / (16 * cfg.n_layers) / 1e3
    out["timeline_ms"] = (max(b[F_END] for b in blk)
                          - min(b[F_T0] for b in blk)) / 1e6

    def mean(f):
        return sum(f(b) for b in blk) / nb

    out["first"] = {k: mean(lambda b, m=m: b[F_FIRST + 2 * m]
                            / max(b[F_FIRST + 2 * m + 1], 1)) / 1e3
                    for m, k in enumerate(FRAME_STAGES)}
    out["prod"] = {k: tuple(mean(lambda b, m=m, i=i: b[F_PROD + 4 * m + i]
                                 / max(b[F_PROD + 4 * m + 3], 1)) / 1e3
                            for i in range(3))
                   for m, k in enumerate(FRAME_STAGES)}
    out["attn"] = mean(lambda b: b[F_ATTN] / max(b[F_ATTN + 1], 1)) / 1e3
    out["cwait"] = mean(lambda b: b[F_CWAIT]) / frames / 1e3
    out["chunks"] = mean(lambda b: b[F_CWAIT + 1]) / frames
    out["pwait"] = mean(lambda b: b[F_PWAIT]) / frames / 1e3
    return out


def run_trace(batches=(1, 16), modes=("", "nowork")) -> None:
    """The predictor frame kernel's timeline (module docstring, `trace`)."""
    import torch
    import chip_smoke as c
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import quant

    card = c.phase_device()
    build.trace_build()
    c.phase_build()
    dev = torch.device("cuda")
    cfg = EngineConfig().predictor
    g = torch.Generator(device=dev).manual_seed(1)
    dense = decoder.init_decoder(g, cfg, device=dev)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                                  proj_dim=cfg.hidden, device=dev)
    ptab, rows = fp.make_ptab(assets, cfg)
    frames = 10
    for kind, pp in (("dense", dense),
                     ("int8", quant.quantize_decoder_params(dense, "int8")),
                     ("int4", quant.quantize_decoder_params(dense, "int4"))):
        for B in batches:
            h = torch.randn(B, cfg.hidden, generator=g, device=dev)
            c0 = torch.randint(0, 2048, (B,), generator=g, device=dev)
            with torch.cuda.device(dev):
                nb = fp._plan(cfg, B, 2, kind == "int4", dev)[1]
            fp.TRACE = torch.zeros(nb * fp.TRACE_STRIDE, dtype=torch.int64,
                                   device=dev)
            for mode in modes:
                fp.MODE = MODES[mode]
                for _ in range(3):
                    fp.predictor_frame_kernel(pp, cfg, ptab, rows, h, c0)
                fp.TRACE.zero_()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(frames):
                    fp.predictor_frame_kernel(pp, cfg, ptab, rows, h, c0)
                e.record()
                torch.cuda.synchronize()
                r = read_trace(fp.TRACE.cpu().tolist(), nb, cfg, frames)
                tag = f"predictor {kind} B={B}{' ' + mode if mode else ''}"
                print(f"{tag}: {s.elapsed_time(e) / frames:.4f} ms a frame "
                      f"(CUDA events, traced build) on {card}; {nb} blocks; "
                      f"timeline {r['timeline_ms']:.4f} ms; grid barriers "
                      f"{r['barriers']} (host {r['host_barriers']}); "
                      f"{r['us_layer_pass']:.2f} us a layer pass", flush=True)
                print("   us a stage (median block's work / arrival spread "
                      "/ last arrival to first release / release spread / "
                      "stage): " + "; ".join(
                          f"{k} " + "/".join(f"{r[k][m]:.2f}" for m in (
                              "work", "spread", "latency", "rspread",
                              "stage"))
                          for k in FRAME_STAGES), flush=True)
                print("   a block's mean us: to first data " + ", ".join(
                    f"{k} {v:.2f}" for k, v in r["first"].items())
                    + "; products (first chunk in / last chunk read / "
                    "end) " + ", ".join(
                        f"{k} " + "/".join(f"{x:.2f}" for x in v)
                        for k, v in r["prod"].items())
                    + f"; attention prologue {r['attn']:.2f}; ring waits a "
                    f"frame: consumers {r['cwait']:.1f} over "
                    f"{r['chunks']:.0f} chunks, producer {r['pwait']:.1f}",
                    flush=True)
                if r["barriers"] != r["host_barriers"]:
                    raise RuntimeError(
                        f"predictor_frame: the kernel met {r['barriers']} "
                        f"grid barriers, the host counts "
                        f"{r['host_barriers']}")
    fp.TRACE, fp.MODE = None, 0


def step_weights(cfg, kind, seed):
    """Seeded talker weights of `cfg` on the card: dense, or int8 / int4 as
    `quant.quantize_decoder_params` makes them."""
    import torch
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(seed)
    tp = decoder.init_decoder(g, cfg, device="cuda")
    return tp if kind == "dense" else quant.quantize_decoder_params(tp, kind)


def step_inputs(cfg, B, T, live, seed):
    """The step's input x [B, H] and a random [L, B, nk, T, hd] cache whose
    rows have ragged live ranges [valid_from, kv_len) of about `live` slots
    (left pad 3 b, kv_len growing 7 a row): (x, positions, slot, kv_len,
    valid_from, k_cache, v_cache), the step writing at slot kv_len."""
    import torch
    dev = torch.device("cuda")
    dt = getattr(torch, cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (0.1 * torch.randn(B, cfg.hidden, generator=g, device=dev)).to(dt)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, T, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=dev).to(dt)
    vc = torch.randn(shape, generator=g, device=dev).to(dt)
    rows = torch.arange(B, device=dev, dtype=torch.int32)
    vf = 3 * rows
    kv_len = torch.clamp(vf + live + 7 * rows, max=T - 1)
    return x, kv_len - vf, kv_len, kv_len, vf, kc, vc


def step_case(cfg, kind, B, T, live, seed):
    """`step_weights` and `step_inputs`: (params, x, positions, slot,
    kv_len, valid_from, k_cache, v_cache)."""
    return (step_weights(cfg, kind, seed),) + step_inputs(cfg, B, T, live,
                                                          seed + 1)


# csrc/talker_step.cu: a block's trace words from blk * kTrStride
# (fused_talker.TRACE_STRIDE): kTrT0, kTrEnd, kTrNBar, kTrFirst, kTrCWait,
# kTrPWait, kTrAttn, kTrProd; barriers stamped (kTrBars)
T_STRIDE, T_BARS = 1024, 448
T_T0, T_END, T_NBAR, T_FIRST = 900, 901, 902, 904
T_CWAIT, T_PWAIT, T_ATTN, T_PROD = 914, 916, 918, 924
TALKER_STAGES = ("qkv", "wo", "gu", "down", "head")
ATTN_PHASES = ("head wait", "q heads", "slots + warp states",
               "state + count", "merge + k/v store")
TALKER_CASES = (("dense", 1, 256, 100), ("dense", 1, 4096, 1000),
                ("int8", 1, 256, 100), ("int8", 1, 4096, 1000),
                ("int4", 1, 256, 100), ("int4", 1, 4096, 1000),
                ("dense", 16, 256, 100), ("dense", 16, 4096, 1000))


def read_step_trace(tr, nb: int, cfg, steps: int) -> dict:
    """Every block's words of a traced run of the step kernel (`tr`: the
    flat int64 trace as a list; the barrier stamps are the last step's, the
    sums over `steps`): per stage kind (qkv with its attention, wo, gate/up,
    down) the median block's work (its arrival less its previous release),
    the blocks' arrival spread, last arrival to first release, the release
    spread and the stage's time (median release less the previous median
    release), the head's (the last release to each block's end); us a
    layer; per block on average the time to a stage's first activation
    data, the products' phases (first chunk in, last chunk read, end), the
    ring waits (consumers', producer's), us a step; attention's phases per
    unit and the units a block, over the blocks that have units."""
    import statistics as st
    S = T_STRIDE
    blk = [tr[b * S:(b + 1) * S] for b in range(nb)]
    nbar = blk[0][T_NBAR]
    out = {"barriers": nbar, "host_barriers": 4 * cfg.n_layers}
    n = min(nbar, T_BARS, 4 * cfg.n_layers)
    prev = [b[T_T0] for b in blk]
    prev_med = st.median(prev)
    per = {k: {"work": [], "spread": [], "latency": [], "rspread": [],
               "stage": []} for k in TALKER_STAGES[:4]}
    for i in range(n):
        arr = [b[2 * i] for b in blk]
        rel = [b[2 * i + 1] for b in blk]
        d = per[TALKER_STAGES[i % 4]]
        d["work"].append(st.median(a - p for a, p in zip(arr, prev)))
        d["spread"].append(max(arr) - min(arr))
        d["latency"].append(min(rel) - max(arr))
        d["rspread"].append(max(rel) - min(rel))
        med = st.median(rel)
        d["stage"].append(med - prev_med)
        prev, prev_med = rel, med
    for k, d in per.items():
        out[k] = {m: (sum(v) / len(v) / 1e3 if v else 0.0)
                  for m, v in d.items()}
    out["head_us"] = (st.median(b[T_END] for b in blk) - prev_med) / 1e3
    out["us_layer"] = sum(sum(per[k]["stage"]) for k in per) \
        / cfg.n_layers / 1e3
    out["timeline_ms"] = (max(b[T_END] for b in blk)
                          - min(b[T_T0] for b in blk)) / 1e6

    def mean(f, blocks=blk):
        return sum(f(b) for b in blocks) / max(len(blocks), 1)

    out["first"] = {k: mean(lambda b, m=m: b[T_FIRST + 2 * m]
                            / max(b[T_FIRST + 2 * m + 1], 1)) / 1e3
                    for m, k in enumerate(TALKER_STAGES)}
    out["prod"] = {k: tuple(mean(lambda b, m=m, i=i: b[T_PROD + 4 * m + i]
                                 / max(b[T_PROD + 4 * m + 3], 1)) / 1e3
                            for i in range(3))
                   for m, k in enumerate(TALKER_STAGES)}
    busy = [b for b in blk if b[T_ATTN + 5] > 0]
    out["attn"] = tuple(mean(lambda b, i=i: b[T_ATTN + i] / b[T_ATTN + 5],
                             busy) / 1e3 for i in range(5))
    out["attn_units"] = mean(lambda b: b[T_ATTN + 5], busy) / steps
    out["attn_blocks"] = len(busy)
    out["cwait"] = mean(lambda b: b[T_CWAIT]) / steps / 1e3
    out["chunks"] = mean(lambda b: b[T_CWAIT + 1]) / steps
    out["pwait"] = mean(lambda b: b[T_PWAIT]) / steps / 1e3
    return out


def talker_trace(cases=TALKER_CASES, modes=("", "nowork")) -> None:
    """The step kernel's timeline (module docstring, `talker`)."""
    import torch
    import chip_smoke as c
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    card = c.phase_device()
    build.trace_build()
    c.phase_build()
    cfg = EngineConfig().talker
    steps = 10
    for kind, B, T, live in cases:
        tp, *rest = step_case(cfg, kind, B, T, live, 400 + B)
        with torch.cuda.device(0):
            nb = ft._plan(cfg, B, 2, kind == "int4", torch.device("cuda"))[1]
        ft.TRACE = torch.zeros(nb * ft.TRACE_STRIDE, dtype=torch.int64,
                               device="cuda")
        for mode in modes:
            ft.MODE = MODES[mode]
            for _ in range(3):
                ft.talker_step_kernel(tp, cfg, *rest)
            ft.TRACE.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(steps):
                ft.talker_step_kernel(tp, cfg, *rest)
            e.record()
            torch.cuda.synchronize()
            r = read_step_trace(ft.TRACE.cpu().tolist(), nb, cfg, steps)
            tag = (f"talker {kind} B={B} T={T} live~{live}"
                   f"{' ' + mode if mode else ''}")
            print(f"{tag}: {s.elapsed_time(e) / steps:.4f} ms a step (CUDA "
                  f"events, traced build) on {card}; {nb} blocks; timeline "
                  f"{r['timeline_ms']:.4f} ms; grid barriers {r['barriers']} "
                  f"(host {r['host_barriers']}); {r['us_layer']:.2f} us a "
                  "layer", flush=True)
            print("   us a stage (median block's work / arrival spread / "
                  "last arrival to first release / release spread / "
                  "stage): " + "; ".join(
                      f"{k} " + "/".join(f"{r[k][m]:.2f}" for m in (
                          "work", "spread", "latency", "rspread", "stage"))
                      for k in TALKER_STAGES[:4])
                  + f"; head {r['head_us']:.2f}", flush=True)
            print("   a block's mean us: to first data " + ", ".join(
                f"{k} {v:.2f}" for k, v in r["first"].items())
                + "; products (first chunk in / last chunk read / end) "
                + ", ".join(f"{k} " + "/".join(f"{x:.2f}" for x in v)
                            for k, v in r["prod"].items())
                + f"; ring waits a step: consumers {r['cwait']:.1f} over "
                f"{r['chunks']:.0f} chunks, producer {r['pwait']:.1f}",
                flush=True)
            print(f"   attention, us a unit ({r['attn_blocks']} blocks, "
                  f"{r['attn_units']:.2f} units a block a step): " + ", ".join(
                      f"{n} {v:.2f}" for n, v in zip(ATTN_PHASES, r["attn"])),
                  flush=True)
            if r["barriers"] != r["host_barriers"]:
                raise RuntimeError(
                    f"talker_step: the kernel met {r['barriers']} grid "
                    f"barriers, the host counts {r['host_barriers']}")
        del tp, rest
    ft.TRACE, ft.MODE = None, 0


def ring_sweep(specs) -> None:
    """The weight ring's sizes (module docstring, `ring`): talker_step.cu
    alone built once per (buffers, bytes a buffer) with -DSTEP_RING /
    -DSTEP_CHUNK, all at once, each loaded in turn in place of the port's
    library."""
    import ctypes
    import subprocess
    import torch
    import chip_smoke as c
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    card = c.phase_device()
    out = os.path.join(build.BUILD_DIR, "ring")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "talker_step.cu")
    nvcc = build.find_nvcc()
    libs, procs = {}, []
    for spec in specs:
        path = os.path.join(out, "talker_{}_{}.so".format(*spec))
        libs[spec] = path
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", f"-DSTEP_RING={spec[0]}",
             f"-DSTEP_CHUNK={spec[1]}", "-shared", "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for spec, proc in zip(specs, procs):
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ring {spec}: nvcc failed\n{text}")
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  ring {spec}: ptxas " + " | ".join(regs), flush=True)
    cfg = EngineConfig().talker
    cases = [(kind, B) for kind in ("dense", "int8", "int4")
             for B in (1, 16)]
    args = {case: (step_weights(cfg, case[0], 600 + case[1]), cfg)
            + step_inputs(cfg, case[1], 256, 100, 601 + case[1])
            for case in cases}
    ring, chunk0 = ft.RING, ft.CHUNK
    try:
        for rnd in range(2):
            for spec, path in libs.items():
                handle = ctypes.CDLL(path)
                for name in ("talker_step_query", "talker_step_launch"):
                    fn = getattr(handle, name)
                    fn.argtypes = build.SIGNATURES[name]
                    fn.restype = ctypes.c_int
                build._lib = handle
                ft.RING, ft.CHUNK = spec
                ft._plans.clear()
                for case in cases:
                    a = args[case]
                    try:
                        ms = c.graph_ms(lambda: ft.talker_step_kernel(*a),
                                        reps=10)
                    except ValueError as exc:          # does not fit
                        print(f"  ring {spec} talker_step {case[0]} "
                              f"B={case[1]}: {exc}", flush=True)
                        continue
                    print(f"  ring {spec} round {rnd} talker_step {case[0]} "
                          f"B={case[1]}: {ms:.4f} ms a step (graph replay) "
                          f"on {card}", flush=True)
    finally:
        ft.RING, ft.CHUNK = ring, chunk0
        ft._plans.clear()
        build._lib = None


def talker_ab(tag: str) -> None:
    """One tree's side of a talker A/B (module docstring, `talker-ab`)."""
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    cfg = EngineConfig().talker
    for kind in ("dense", "int8", "int4"):
        for B in (1, 2):
            tp, *rest = step_case(cfg, kind, B, 256, 100, 500 + B)

            def fn(tp=tp, rest=rest):
                ft.talker_step_fused(tp, cfg, *rest)
            fn()
            dev = c.profiled_device_ms(fn, 3)
            host = c.cuda_ms(fn, reps=10, warmup=2)
            print(f"  {tag} talker_step_fused {kind} B={B}: device "
                  f"{c._fmt4(dev)} ms a step (profiler), {host:.4f} ms a "
                  f"step of eager calls (CUDA events) on {card}", flush=True)
            del tp, rest
    ab(tag)


def codes_runs(models, cfg, prompt, pad, frames):
    """(run, timed) for `generate_codes` (ignore_eos) of `models` at the
    engine config `cfg` on a [B, 64, H] prompt: run(steps) generates
    `steps` frames, timed(steps) returns its ms (CUDA events)."""
    import torch
    from qwen3_tts_tpu_torch.tts import generate
    dev = prompt.device

    def run(steps):
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode():
            generate.generate_codes(
                models, cfg.talker, cfg.predictor, prompt, pad, gen, 0.7, 40,
                0.9, frames, ignore_eos=True, step_cap=steps)

    def timed(steps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run(steps)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    return run, timed


# the weight sets of each route's KIND: (label, talker kind, predictor kind)
ROUTE_SETS = {"talker": {"dense": ("dense bf16", "dense", "dense"),
                         "int8": ("int8/int8", "int8", "int8"),
                         "int4": ("int4+int8", "int4", "int8")},
              "predictor": {"dense": ("dense bf16", "dense", "dense"),
                            "int8": ("int8/int8", "int8", "int8"),
                            "int4": ("int4/int4", "int4", "int4")}}


def route_times(which: str = "talker", batches=(1, 2, 4, 8, 16),
                kinds=("dense", "int8", "int4")) -> None:
    """Both routes of the talker step, or of the predictor frame, end to
    end (module docstring, `route`), for the weight sets of `kinds`: the
    talker's or the predictor's weights of that kind (`ROUTE_SETS`)."""
    import torch
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    spk = os.path.join(c.REPO, "speakers")
    eng = TtsEngine(config=EngineConfig(), random_weights=True, seed=0,
                    speakers_dir=spk, device="cuda")
    cfg, dev = eng.config, eng.device
    g = torch.Generator(device=dev).manual_seed(7)
    frames = 16
    mod = ft if which == "talker" else fp
    kernel = ft.talker_step_kernel if which == "talker" \
        else fp.predictor_frame_kernel
    limits = mod.ROUTE_MAX_B

    def set_route(route):
        mod.ROUTE_MAX_B = {k: mod.MAX_B if route == "kernel" else 0
                           for k in limits}

    def restore():
        mod.ROUTE_MAX_B = limits
    sets = []
    for kind in kinds:
        label, tk, pk = ROUTE_SETS[which][kind]
        sets.append((label, eng.models if kind == "dense"
                     else c.quantized_models(eng.models, tk, pk)))
    for label, models in sets:
        for B in batches:
            prompt = 0.1 * torch.randn(B, 64, cfg.talker.hidden,
                                       generator=g, device=dev)
            pad = torch.zeros(B, dtype=torch.int32, device=dev)

            run, timed = codes_runs(models, cfg, prompt, pad, frames)
            wall, device = {}, {}
            try:
                for route in ("kernel", "chain", "chain", "kernel") * 2 + (
                        "kernel", "chain"):
                    set_route(route)
                    run(2)                               # warm up
                    n0 = kernel.launches
                    total = timed(frames)
                    if (kernel.launches > n0) != (route == "kernel"):
                        raise RuntimeError(f"route: B={B} did not take the "
                                           f"{which}'s {route} route")
                    wall.setdefault(route, []).append(
                        (total - timed(0)) / frames)
                    if route not in device:
                        d4 = c.profiled_device_ms(lambda: run(4), 1)
                        d0 = c.profiled_device_ms(lambda: run(0), 1)
                        device[route] = None if d4 is None or d0 is None \
                            else (d4 - d0) / 4
            finally:
                restore()
            kw, cw = sorted(wall["kernel"]), sorted(wall["chain"])
            print(f"  route {which} {label} B={B}: ms a frame (CUDA events) "
                  f"kernel {[round(v, 3) for v in wall['kernel']]} (median "
                  f"{kw[len(kw) // 2]:.3f}), chain "
                  f"{[round(v, 3) for v in wall['chain']]} (median "
                  f"{cw[len(cw) // 2]:.3f}); every kernel run faster: "
                  f"{kw[-1] < cw[0]}; device ms a frame (profiler) kernel "
                  f"{c._fmt(device['kernel'])}, chain "
                  f"{c._fmt(device['chain'])} on {card}", flush=True)


def step_times(tag: str, card: str, cases, window=(256, 100)) -> None:
    """The talker step kernel's device ms a step by CUDA-graph replay at
    full width, a `window` (slots, ~live) cache, for each (kind, batches)
    of `cases` (module docstring, `step-ab`)."""
    import chip_smoke as c
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    cfg = EngineConfig().talker
    T, live = window
    for kind, batches in cases:
        for B in batches:
            args = (step_weights(cfg, kind, 300 + B), cfg) \
                + step_inputs(cfg, B, T, live, 301 + B)
            ms = c.graph_ms(lambda: ft.talker_step_kernel(*args), reps=10)
            cache = "" if window == (256, 100) else f" T={T} live~{live}"
            print(f"  {tag} talker_step {kind} B={B}{cache}: {ms:.4f} ms a "
                  f"step (graph replay) on {card}", flush=True)
            del args


def frame_ab(tag: str) -> None:
    """One tree's side of an A/B of both persistent kernels (module
    docstring, `frame-ab`)."""
    import torch
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp

    cfg = EngineConfig()
    step_times(tag, card, (("dense", (1, 16)), ("int8", (1, 16)),
                           ("int4", (1,))))
    for kind in ("dense", "int8"):
        for B in (1, 4, 8, 16):
            pp, _, *rest = c.frame_case(cfg.predictor, kind, B, 90 + B)
            args = (pp, cfg.predictor, *rest)
            ms = c.graph_ms(lambda: fp.predictor_frame_kernel(*args),
                            reps=10)
            print(f"  {tag} predictor_frame {kind} B={B}: {ms:.4f} ms a "
                  f"frame (graph replay) on {card}", flush=True)
            del pp, rest, args
    g = torch.Generator(device="cuda").manual_seed(7)
    c.qmatmul_times(c.Record(), card, g, rows=(64,))
    spk = os.path.join(c.REPO, "speakers")
    eng = TtsEngine(config=cfg, random_weights=True, seed=0,
                    speakers_dir=spk, device="cuda")
    dev = eng.device
    frames = 16
    for label, models in (("dense bf16", eng.models),
                          ("int8/int8", c.quantized_models(eng.models, "int8",
                                                           "int8"))):
        prompt = 0.1 * torch.randn(1, 64, cfg.talker.hidden, generator=g,
                                   device=dev)
        pad = torch.zeros(1, dtype=torch.int32, device=dev)
        run, _ = codes_runs(models, cfg, prompt, pad, frames)
        run(0)
        ms = c.profiled_device_ms(lambda: run(0), 3)
        print(f"  {tag} prefill {label} B=1, 64 tokens: device "
              f"{c._fmt4(ms)} ms (profiler) on {card}", flush=True)
    route = fp.frame_route
    kernel = fp.predictor_frame_kernel
    try:
        for label, models in (
                ("dense bf16", eng.models),
                ("int8/int8", c.quantized_models(eng.models, "int8",
                                                 "int8"))):
            for B in (1, 4, 8, 16):
                prompt = 0.1 * torch.randn(B, 64, cfg.talker.hidden,
                                           generator=g, device=dev)
                pad = torch.zeros(B, dtype=torch.int32, device=dev)
                run, timed = codes_runs(models, cfg, prompt, pad, frames)
                wall = {}
                for way in ("kernel", "kernel") + (
                        ("chain",) if B >= 8 else ()):
                    fp.frame_route = (lambda params, b, w=way: fp.KERNEL
                                      if w == "kernel" else fp.CHAIN)
                    run(2)                               # warm up
                    n0 = kernel.launches
                    total = timed(frames)
                    if (kernel.launches > n0) != (way == "kernel"):
                        raise RuntimeError(f"frame-ab: B={B} did not take "
                                           f"the {way} route")
                    wall.setdefault(way, []).append(
                        (total - timed(0)) / frames)
                print(f"  {tag} route predictor {label} B={B}: ms a frame "
                      f"(CUDA events) " + ", ".join(
                          f"{w} {[round(v, 3) for v in vs]}"
                          for w, vs in wall.items()) + f" on {card}",
                      flush=True)
    finally:
        fp.frame_route = route


def sass_counts(names=("talker_step", "predictor_frame")) -> None:
    """Each source's kernels as compiled for the card (module docstring,
    `sass`): ptxas's registers and spills, then per kernel its SASS
    instructions and local loads / stores (`cuobjdump -sass`)."""
    import re
    import subprocess
    from qwen3_tts_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    tools = os.path.dirname(nvcc)
    out = os.path.join(build.BUILD_DIR, "sass")
    os.makedirs(out, exist_ok=True)
    for name in names:
        cubin = os.path.join(out, name + ".cubin")
        text = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", "-cubin", "-o", cubin,
             os.path.join(build.CSRC_DIR, name + ".cu")],
            capture_output=True, text=True, check=True).stderr
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name} ptxas: {ln.strip()}", flush=True)
        sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass",
                               cubin], capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1)
                counts[fn] = [0, 0, 0]
            elif fn is not None and re.match(r"\s+/\*[0-9a-f]+\*/\s", ln):
                c = counts[fn]
                c[0] += 1
                c[1] += " LDL" in ln
                c[2] += " STL" in ln
        for fn, (n, ldl, stl) in sorted(counts.items()):
            print(f"  {name} {fn}: {n} SASS instructions, {ldl} LDL, "
                  f"{stl} STL", flush=True)


def int8mm() -> None:
    import torch
    import chip_smoke as c
    card = c.phase_device()
    fn = getattr(torch, "_weight_int8pack_mm", None)
    print(f"torch {torch.__version__}: _weight_int8pack_mm "
          f"{'present' if fn is not None else 'absent'}", flush=True)
    if fn is None:
        return
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, M, copies, shapes in (
            ("B8 predictor layer", 1, 8,
             [(1024, 3072), (1024, 1024), (1024, 6144), (3072, 1024)]),
            ("A talker layer", 64, 4,
             [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)])):
        mats = [(torch.randn(M, K, generator=g, device="cuda").bfloat16(),
                 torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                               dtype=torch.int8),
                 torch.rand(N, generator=g, device="cuda").bfloat16())
                for K, N in shapes * copies]
        try:
            out = fn(*mats[0])
        except (RuntimeError, NotImplementedError) as exc:
            print(f"  {label}, M={M}: not implemented for CUDA "
                  f"({str(exc).splitlines()[0][:160]})", flush=True)
            continue
        x, w, sc = mats[0]
        ref = (x.float() @ w.float().t()) * sc.float()
        err = float((out.float() - ref).abs().max() / ref.abs().max())

        def call():
            for m in mats:
                fn(*m)
        ms = c.graph_ms(call, reps=5) / copies
        print(f"  {label}, M={M}: {ms:.4f} ms a layer (4 products, {copies} "
              f"copies rotating past the L2), relative error {err:.2e} on "
              f"{card}", flush=True)


def ab(tag: str) -> None:
    import torch
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from qwen3_tts_tpu_torch import EngineConfig, SamplerConfig, TtsEngine
    spk = os.path.join(c.REPO, "speakers")
    eng = TtsEngine(config=EngineConfig(), random_weights=True, seed=0,
                    speakers_dir=spk, device="cuda")
    q48 = c.quantized_models(eng.models, "int4", "int8")
    q88 = c.quantized_models(eng.models, "int8", "int8")
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, models in (("dense bf16", eng.models), ("int4+int8", q48),
                          ("int8/int8", q88)):
        c.frame_times(eng, models, f"{tag} {label}", card, g)
    voice = eng.get_speaker("vivian")
    for label, models in (("dense bf16", None), ("int4+int8", q48)):
        e = eng if models is None else TtsEngine(
            config=eng.config, weights=(models, eng.vocoder_params),
            speakers_dir=spk, device="cuda")
        e.set_max_steps(32)
        e.set_sampler_config(SamplerConfig(seed=0))
        e.warmup()
        for rep in range(2):
            r = c.stream_once(e, c.TEXT, voice)
            secs = len(r["samples"]) / 24000
            print(f"  {tag} {label} stream warm run {rep}: first chunk "
                  f"{r['first_ms']:.1f} ms, streaming RTF incl. vocoding "
                  f"{r['wall'] / secs:.3f} ({secs:.3f} s of audio) on "
                  f"{card}", flush=True)


def probe_times(parent, variants) -> None:
    """The probe kernels' designs side by side (module docstring,
    `probes`)."""
    import ctypes
    import subprocess
    import torch
    import chip_smoke as c
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.tools import mosaic_probe as mp

    card = c.phase_device()
    out = os.path.join(build.BUILD_DIR, "probes")
    os.makedirs(out, exist_ok=True)
    this = os.path.join(build.CSRC_DIR, "probes.cu")
    specs = ([("parent", parent, [])] if parent else []) + [("this", this, [])]
    specs += [(v, this, ["-D" + d for d in v.split(",")]) for v in variants]
    procs = []
    for i, (tag, src, defs) in enumerate(specs):
        path = os.path.join(out, f"probes_{i}.so")
        procs.append((tag, path, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v", *defs,
             "-I" + build.CSRC_DIR, "-shared", "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, path, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"probes {tag}: nvcc failed\n{text}")
        for ln in text.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"  {tag} ptxas: {ln.strip()[:150]}", flush=True)
        handle = ctypes.CDLL(path)
        for name, argtypes in build.SIGNATURES.items():
            if name.startswith("probe_"):
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[tag] = handle

    dev = torch.device("cuda")
    inputs = mp.probe_inputs(dev, seed=1)
    here = [p for p in mp.PROBES if p.name != "int8_panel"]
    probes = {p.name: p for p in here}
    cases = [(p.name, "the tool's", inputs[p.name]) for p in here]
    cases += [case for case in mp.varied_inputs(dev, seed=2)
              if case[0] in probes]
    calls = {"hbm_scratch": lambda x: torch.mul(x, 2.0),
             "fori_dma": lambda w: torch.sum(w, 0)}
    times = {}
    order = list(libs)
    try:
        for rnd in range(2):
            for tag in order + order[::-1]:
                build._lib = libs[tag]
                for name, label, args in cases:
                    p = probes[name]
                    ok, err = mp.agree(p, p.kernel(*args), p.plain(*args))
                    if not ok:
                        raise RuntimeError(f"{tag} {name} ({label}): kernel "
                                           f"differs from plain, {err:g}")
                for p in here:
                    args = inputs[p.name]
                    ms = c.graph_ms(lambda: p.kernel(*args))
                    times.setdefault((tag, p.name), []).append(ms)
                    print(f"  round {rnd} {tag:24s} {p.name:12s} {ms:.5f} ms "
                          f"(graph replay) on {card}", flush=True)
            for name, fn in calls.items():
                args = inputs[name]
                ms = c.graph_ms(lambda: fn(*args))
                times.setdefault(("call", name), []).append(ms)
                print(f"  round {rnd} {'PyTorch call':24s} {name:12s} "
                      f"{ms:.5f} ms (graph replay) on {card}", flush=True)
    finally:
        build._lib = None
    print(f"  {len(cases)} cases held against plain for each library",
          flush=True)
    for tag in order:
        for p in here:
            ms = times[(tag, p.name)]
            line = f"  {tag:24s} {p.name:12s} {min(ms):.5f}-{max(ms):.5f} ms"
            if p.name in calls:
                ref = times[("call", p.name)]
                line += (f", call {min(ref):.5f}-{max(ref):.5f} ms, loss "
                         f"{sum(ms) / sum(ref) * len(ref) / len(ms):.2f}x")
            print(line + f" on {card}", flush=True)


def head_ab(tag: str, quick: bool = False) -> None:
    """One tree's side of an A/B of the head slice and its argmax (module
    docstring, `head-ab`)."""
    import torch
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import chain, quant
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.tools import mosaic_probe as mp

    cfg = EngineConfig().predictor
    dt = getattr(torch, cfg.dtype)
    CV = P.CODE_VOCAB
    fused = not hasattr(el, "argmax_gather")
    where = "in the head slice" if fused else "a launch of its own"
    print(f"  {tag}: argmax {where}", flush=True)
    # (a) the head slice and its greedy code
    for kind in ("dense", "int8", "int4"):
        pp, _, ptab, rows, h, _ = c.frame_case(cfg, kind, 32, 60)
        norm = (pp["final_norm"], cfg.rms_eps)
        for B in (1, 10, 16, 32):
            x = h[:B].contiguous()
            xo = torch.empty_like(x)
            codes = torch.zeros(B, P.NUM_CODEBOOKS, dtype=torch.int32,
                                device=x.device)
            logits = torch.empty(B, CV, device=x.device)
            kw = dict(col0=2 * CV, n=CV, epilogue=G.EPI_F32_ROUND_DT,
                      norm=norm, dt=dt)

            def head():
                chain.matmul(chain.KERNELS, x, pp["head"], out=logits, **kw)

            if fused:
                def both():
                    chain.matmul(chain.KERNELS, x, pp["head"],
                                 argmax=(codes, 3, ptab, rows, xo), **kw)
                times = {"slice+argmax (one launch)": both,
                         "slice alone": head}
            else:
                def am():
                    el.argmax_gather(logits, codes, 3, ptab, rows, xo)

                def both():
                    head()
                    am()
                times = {"slice+argmax (two launches)": both,
                         "slice alone": head, "argmax_gather alone": am}
            line = ", ".join(f"{k} {c.graph_ms(f):.5f}"
                             for k, f in times.items())
            print(f"  {tag} head {kind} B={B}: ms (graph replay) {line} "
                  f"on {card}", flush=True)
        del pp, ptab, h

    # (b) the predictor's chain
    def kernels_a_call(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)

    for kind, batches in (("dense", (10, 16, 24, 32)),
                          ("int8", (13, 16, 24, 32)),
                          ("int4", (24, 32))):
        for B in batches:
            pp, _, ptab, rows, h, code0 = c.frame_case(cfg, kind, B, 90 + B)

            def frame():
                fp._frame(chain.KERNELS, pp, cfg, ptab, rows, h, code0)

            frame()
            chain.reset_launch_counts()
            frame()
            counts = chain.launch_counts()
            n_cuda = kernels_a_call(frame)
            ms = c.graph_ms(frame, reps=4)
            eager = "not taken" if quick else \
                f"{c.cuda_ms(frame, reps=4, warmup=1):.3f}"
            print(f"  {tag} chain {kind} B={B}: {ms:.4f} device ms a frame "
                  f"(graph replay), eager {eager} ms a frame (CUDA events), "
                  f"{n_cuda} CUDA kernels a frame (profiler); wrappers "
                  f"{json.dumps({k: v for k, v in counts.items() if v})} "
                  f"on {card}", flush=True)
            del pp, ptab, h, code0

    # (c) kernel A at the int8_panel probe's shape
    x8, w8 = mp.probe_inputs(torch.device("cuda"), seed=1)["int8_panel"]
    w8s = w8[:, :mp.PANEL_N]
    ones = torch.ones(mp.PANEL_N, device=x8.device)
    w8t = w8s.t().contiguous()
    ones8 = torch.ones(mp.PANEL_N, dtype=torch.bfloat16, device=x8.device)
    want = mp.int8_panel_plain(x8, w8)
    calls = {"kernel A": lambda: quant.qmatmul_kernel(x8, w8s, ones),
             "int8_panel": lambda: mp.int8_panel(x8, w8),
             "torch._weight_int8pack_mm": lambda: torch._weight_int8pack_mm(
                 x8, w8t, ones8)}
    plan = quant.qmatmul_plan(16, 512, mp.PANEL_N,
                              build.sm_count(x8.device))
    for name, fn in calls.items():
        err = c.rel_err(fn().float(), want)
        print(f"  {tag} panel {name}: {c.graph_ms(fn):.5f} ms (graph "
              f"replay), relative error {err:.2e} against the plain panel "
              f"on {card}", flush=True)
    print(f"  {tag} panel: kernel A's plan at M=16 K=512 N=256: {plan}",
          flush=True)


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    if argv[:1] == ["trace"]:
        run_trace(tuple(int(b) for b in argv[1:]) or (1, 16))
        return 0
    if argv[:1] == ["sass"]:
        sass_counts(tuple(argv[1:]) or ("talker_step", "predictor_frame"))
        return 0
    if argv[:1] == ["int8mm"]:
        int8mm()
        return 0
    if len(argv) == 2 and argv[0] == "ab":
        ab(argv[1])
        return 0
    if argv[:1] == ["talker"]:
        talker_trace()
        return 0
    if argv[:1] == ["ring"]:
        ring_sweep([tuple(int(v) for v in spec.split(","))
                    for spec in argv[1:]] or [
            (2, 16384), (3, 16384), (4, 16384), (5, 16384), (6, 16384),
            (4, 12288), (2, 32768)])
        return 0
    if len(argv) == 2 and argv[0] == "talker-ab":
        talker_ab(argv[1])
        return 0
    if len(argv) == 2 and argv[0] == "step-ab":
        import chip_smoke as c
        card = c.phase_device()
        c.phase_build()
        kinds = ("dense", "int8", "int4")
        step_times(argv[1], card, [(k, (1, 2, 4, 8, 16)) for k in kinds])
        step_times(argv[1], card, [(k, (1, 16)) for k in kinds],
                   (4096, 1000))
        return 0
    if len(argv) == 2 and argv[0] == "frame-ab":
        frame_ab(argv[1])
        return 0
    if len(argv) in (2, 3) and argv[0] == "head-ab":
        head_ab(argv[1], argv[2:] == ["quick"])
        return 0
    if argv[:1] == ["probes"]:
        parent = [a for a in argv[1:] if a.endswith(".cu")]
        probe_times(parent[0] if parent else None,
                    [a for a in argv[1:] if not a.endswith(".cu")])
        return 0
    if argv[:1] == ["route"]:
        which = "predictor" if "predictor" in argv[1:] else "talker"
        kinds = tuple(a for a in argv[1:] if a in ROUTE_SETS[which])
        batches = tuple(int(b) for b in argv[1:] if b.isdigit())
        route_times(which, batches or (1, 2, 4, 8, 16),
                    kinds or ("dense", "int8", "int4"))
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
