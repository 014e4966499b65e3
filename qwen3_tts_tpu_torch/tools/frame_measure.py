"""On-card measurements of the persistent kernels, beside `chip_smoke.py`
(PERF.md's stage traces and A/B numbers come from here). Run from the
repo's root (each mode imports its `chip_smoke.py`):

    python3 -m qwen3_tts_tpu_torch.tools.frame_measure trace
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure talker
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure int8mm
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py ab TAG
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py talker-ab TAG
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py route

Both persistent kernels carry a trace that is compiled in only for
`trace` and `talker` (`kernels/build.py trace_build`, -DKERNEL_TRACE: a
library of its own, built in the measuring process) and on while a
trace buffer is set (`fused_predictor.TRACE`, `fused_talker.TRACE`):
block 0's thread 0 writes %globaltimer at each grid barrier's arrival and
release (`csrc/persistent.cuh grid_barrier_first`) and sums some phases of
its stages. The library the port runs has none of it.

trace   the predictor frame kernel's stage timeline: full width, dense
        bf16 and int8, B = 1 and 16: ms a frame (CUDA events over 10
        frames), per stage kind (qkv, attention, wo, gate/up, down, head)
        block 0's work, its barrier wait and the stage's total, in us a
        stage; block 0's products (to their inputs, the rest), its norm
        inputs (loads, row reduction) and its waits for a stage's copies.
talker  the talker step kernel's stage timeline: full width,
        dense bf16, int8 and int4, B = 1 and 2, a 256-slot cache with ~100
        live slots; ms a step (CUDA events over 10 steps) and per stage
        kind (qkv, attention, wo, gate/up, down, the head) block 0's work
        and its barrier wait, us a stage; the consumers' waits for full
        ring buffers and the producer's for free ones, us a step; the
        last layer's attention unit 0 and block 0's products by phase.
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
route   the measurement behind the talker route's batch limits
        (`ops/fused_talker.py MAX_B`, `INT4_MAX_B`), end to end:
        `generate_codes` (ignore_eos) at full width, dense bf16 and
        int4+int8, B = 1, 2, 4, 8, 16, with the talker on its step kernel
        (both limits set to MAX_B) and on its chain (both set to 0), in
        turns kernel, chain,
        chain, kernel: ms a frame (CUDA events over 16 frames, the
        prefill subtracted; the host loop's pace where it bounds the
        frame) and device ms a frame (profiler, prefill + 4 frames less
        the prefill).
"""

from __future__ import annotations

import os
import sys

STAGES = ("qkv", "attn", "wo", "gu", "down")
TRACE_WORDS = 2000          # the timeline buffer, int64 words
# csrc/predictor_frame.cu kTrT0, kTrProd, kTrNorm, kTrWait
T0, PHASES, NORM, WAIT = 1999, 1900, 1960, 1980


def run_trace() -> None:
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
    fp.TRACE = torch.zeros(TRACE_WORDS, dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    dense = decoder.init_decoder(g, cfg, device=dev)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                                  proj_dim=cfg.hidden, device=dev)
    ptab, rows = fp.make_ptab(assets, cfg)
    seq = []
    for p in range(16):
        seq += list(STAGES) * cfg.n_layers + (["head"] if p else [])
    for kind, pp in (("dense", dense),
                     ("int8", quant.quantize_decoder_params(dense, "int8"))):
        for B in (1, 16):
            h = torch.randn(B, cfg.hidden, generator=g, device=dev)
            c0 = torch.randint(0, 2048, (B,), generator=g, device=dev)
            for _ in range(3):
                fp.predictor_frame_kernel(pp, cfg, ptab, rows, h, c0)
            fp.TRACE.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(10):
                fp.predictor_frame_kernel(pp, cfg, ptab, rows, h, c0)
            e.record()
            torch.cuda.synchronize()
            tr = fp.TRACE.cpu().tolist()
            work, wait = {}, {}
            prev = tr[T0]
            for i, k in enumerate(seq):        # the last frame's timeline
                work.setdefault(k, []).append(tr[2 * i] - prev)
                wait.setdefault(k, []).append(tr[2 * i + 1] - tr[2 * i])
                prev = tr[2 * i + 1]
            line = (f"predictor {kind} B={B}: {s.elapsed_time(e) / 10:.3f} "
                    f"ms a frame (CUDA events) on {card}; timeline "
                    f"{(prev - tr[T0]) / 1e6:.3f} ms; us a stage, block 0's "
                    "work / barrier wait / total:")
            for k in (*STAGES, "head"):
                w = sum(work[k]) / len(work[k]) / 1e3
                b = sum(wait[k]) / len(wait[k]) / 1e3
                line += f" {k} {w:.2f}/{b:.2f}/{w + b:.2f}"
            print(line, flush=True)
            ph = tr[PHASES:PHASES + 20]
            line = "   block 0's products, us a call (to inputs / rest):"
            for i, k in enumerate(("qkv", "wo", "gu", "down", "head")):
                n = max(ph[i * 4 + 3], 1)
                line += (f" {k} {ph[i * 4 + 1] / n / 1e3:.2f}/"
                         f"{ph[i * 4 + 2] / n / 1e3:.2f}")
            n = max(tr[NORM + 3], 1)
            line += (f"; norm inputs: loads {tr[NORM] / n / 1e3:.2f}, "
                     f"row reduction {tr[NORM + 1] / n / 1e3:.2f}; copy "
                     f"wait {tr[WAIT] / max(tr[WAIT + 1], 1) / 1e3:.2f}")
            print(line, flush=True)
    fp.TRACE = None


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


TALKER_STAGES = ("qkv", "attn", "wo", "gu", "down")
T_T0, T_END, T_WAIT, T_PWAIT = 500, 501, 502, 504   # csrc/talker_step.cu kTr*
T_ATTN, T_PROD = 510, 520
PROD_PHASES = ("inputs", "first chunk", "chunks", "sums + epilogue")
ATTN_PHASES = ("head vectors", "slots + warp states", "unit merge",
               "count", "split merge + k/v store")


def talker_trace() -> None:
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
    ft.TRACE = torch.zeros(TRACE_WORDS, dtype=torch.int64, device="cuda")
    steps = 10
    for kind in ("dense", "int8", "int4"):
        for B in (1, 2):
            tp, *rest = step_case(cfg, kind, B, 256, 100, 400 + B)
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
            tr = ft.TRACE.cpu().tolist()
            work, wait = {}, {}
            prev = tr[T_T0]
            for i in range(5 * cfg.n_layers):    # the last step's timeline
                k = TALKER_STAGES[i % 5]
                work.setdefault(k, []).append(tr[2 * i] - prev)
                wait.setdefault(k, []).append(tr[2 * i + 1] - tr[2 * i])
                prev = tr[2 * i + 1]
            line = (f"talker {kind} B={B}: {s.elapsed_time(e) / steps:.4f} ms "
                    f"a step (CUDA events); timeline "
                    f"{(tr[T_END] - tr[T_T0]) / 1e6:.4f} ms; us a stage, block "
                    "0's work / barrier wait:")
            for k in TALKER_STAGES:
                line += (f" {k} {sum(work[k]) / len(work[k]) / 1e3:.2f}/"
                         f"{sum(wait[k]) / len(wait[k]) / 1e3:.2f}")
            line += (f" head {(tr[T_END] - prev) / 1e3:.2f}; ring waits, us "
                     f"a step: consumers {tr[T_WAIT] / steps / 1e3:.2f} over "
                     f"{tr[T_WAIT + 1] // steps} chunks, producer "
                     f"{tr[T_PWAIT] / steps / 1e3:.2f} on {card}")
            print(line, flush=True)
            ph = tr[T_ATTN:T_ATTN + 6]
            print("   attention unit 0, last layer, us: " + ", ".join(
                f"{n} {(ph[i + 1] - ph[i]) / 1e3:.2f}"
                for i, n in enumerate(ATTN_PHASES)), flush=True)
            parts = []
            for m, k in enumerate(("qkv", "wo", "gu", "down", "head")):
                ps = tr[T_PROD + 8 * m:T_PROD + 8 * m + 5]
                parts.append(k + " " + "/".join(
                    f"{(ps[i + 1] - ps[i]) / 1e3:.2f}" for i in range(4)))
            print("   block 0's products, last layer, us (" + ", ".join(
                PROD_PHASES) + "): " + "; ".join(parts), flush=True)
            del tp, rest
    ft.TRACE = None


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


def route_times() -> None:
    """Both talker routes end to end (module docstring, `route`)."""
    import torch
    import chip_smoke as c
    card = c.phase_device()
    c.phase_build()
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.tts import generate

    spk = os.path.join(c.REPO, "speakers")
    eng = TtsEngine(config=EngineConfig(), random_weights=True, seed=0,
                    speakers_dir=spk, device="cuda")
    cfg, dev = eng.config, eng.device
    q48 = c.quantized_models(eng.models, "int4", "int8")
    g = torch.Generator(device=dev).manual_seed(7)
    frames, limits = 16, (ft.MAX_B, ft.INT4_MAX_B)
    for label, models in (("dense bf16", eng.models), ("int4+int8", q48)):
        for B in (1, 2, 4, 8, 16):
            prompt = 0.1 * torch.randn(B, 64, cfg.talker.hidden,
                                       generator=g, device=dev)
            pad = torch.zeros(B, dtype=torch.int32, device=dev)

            def run(steps, models=models, prompt=prompt, pad=pad):
                gen = torch.Generator(device=dev).manual_seed(0)
                with torch.inference_mode():
                    generate.generate_codes(
                        models, cfg.talker, cfg.predictor, prompt, pad, gen,
                        0.7, 40, 0.9, frames, ignore_eos=True,
                        step_cap=steps)

            def timed(steps):
                torch.cuda.synchronize()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run(steps)
                e.record()
                torch.cuda.synchronize()
                return s.elapsed_time(e)

            wall, device = {}, {}
            try:
                for route in ("kernel", "chain", "chain", "kernel"):
                    ft.MAX_B = ft.INT4_MAX_B = \
                        limits[0] if route == "kernel" else 0
                    run(2)                               # warm up
                    n0 = ft.talker_step_kernel.launches
                    total = timed(frames)
                    if (ft.talker_step_kernel.launches > n0) != \
                            (route == "kernel"):
                        raise RuntimeError(f"route: B={B} did not take the "
                                           f"talker's {route} route")
                    wall.setdefault(route, []).append(
                        (total - timed(0)) / frames)
                    if route not in device:
                        d4 = c.profiled_device_ms(lambda: run(4), 1)
                        d0 = c.profiled_device_ms(lambda: run(0), 1)
                        device[route] = None if d4 is None or d0 is None \
                            else (d4 - d0) / 4
            finally:
                ft.MAX_B, ft.INT4_MAX_B = limits
            print(f"  route {label} B={B}: ms a frame (CUDA events) kernel "
                  f"{[round(v, 3) for v in wall['kernel']]}, chain "
                  f"{[round(v, 3) for v in wall['chain']]}; device ms a "
                  f"frame (profiler) kernel {c._fmt(device['kernel'])}, "
                  f"chain {c._fmt(device['chain'])} on {card}", flush=True)


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


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    if argv[:1] == ["trace"]:
        run_trace()
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
    if len(argv) == 2 and argv[0] == "talker-ab":
        talker_ab(argv[1])
        return 0
    if argv[:1] == ["route"]:
        route_times()
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
