#!/usr/bin/env python3
"""The port's main path on one CUDA card: build, check, run, time.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device    the card (nvidia-smi name and power limit), torch / CUDA /
               triton versions, nvcc; TF32 off for matmuls and convolutions
  2. build     nvcc compiles qwen3_tts_tpu_torch/csrc/*.cu for sm_90a
  3. kernels   every kernel against its plain PyTorch version at the
               shapes of the slice (f32 allclose, bf16 relative error)
  4. agree     teacher-forced agreement at full width in bf16, kernels vs
               plain from the same state, with peaked heads: talker step
               argmax >= 0.93, predictor codes >= 0.95
  5. main      TtsEngine(random_weights=True, seed=0) at full EngineConfig()
               width, B=1, 32 frames, generate_with_voice(vivian): a finite
               waveform, every kernel's launch count above 0; then
               generate_batch at B=2; the tiny f32 config's greedy codes on
               the card equal the CPU reference
  6. times     ms/frame of generate_codes through kernels and through the
               plain versions (CUDA events), the device busy share of the
               kernel path (torch.profiler), and each kernel's device time
               against its plain version (CUDA graph replay)

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, REPS = 5, 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, reps=REPS) -> float:
    """Mean device time of fn() over `reps` launches after a warmup."""
    import torch
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=REPS) -> float:
    """Device time of fn(): `reps` calls captured in one CUDA graph, the
    graph replayed and timed with events, so host launch cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def peak_head(params, slices, seed=0, boost=24.0, n_heavy=4):
    """Decisive-logit head: `n_heavy` random columns per sampled slice
    scaled by `boost`, so the argmax race runs between a few well-separated
    candidates instead of 2048 near-ties (the regime of real checkpoints).
    Same rule as tools/tpu_smoke.py::peak_head."""
    import numpy as np
    head = params["head"].float().clone()
    rng = np.random.default_rng(seed)
    for start, width in slices:
        cols = start + rng.choice(width, n_heavy, replace=False)
        head[:, cols.tolist()] *= boost
    return dict(params, head=head.to(params["head"].dtype))


class Record:
    """Per-kernel results for the JSON line."""

    SOURCES = {
        "decode_attention": ("cuda", "qwen3_tts_tpu_torch/csrc/decode_attention.cu",
                             "qwen3_tts_tpu/ops/flash_decode.py:129"),
        "gemv": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cu",
                 "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "rms_norm": ("triton", "qwen3_tts_tpu_torch/ops/elementwise_triton.py",
                     "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "qk_norm_rope": ("triton",
                         "qwen3_tts_tpu_torch/ops/elementwise_triton.py",
                         "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "silu_mul": ("triton", "qwen3_tts_tpu_torch/ops/elementwise_triton.py",
                     "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "argmax_gather": ("triton",
                          "qwen3_tts_tpu_torch/ops/elementwise_triton.py",
                          "qwen3_tts_tpu/ops/fused_predictor.py:610"),
    }

    def __init__(self):
        self.err = {k: 0.0 for k in self.SOURCES}
        self.ms = {}
        self.plain_ms = {}
        self.launches = {}

    def check(self, name, got, want, label, *, rtol=None, atol=None,
              rel=None):
        """f32: allclose(rtol, atol); bf16: relative error <= rel."""
        import torch
        e = abs_err(got, want)
        self.err[name] = max(self.err[name], e)
        if rel is not None:
            r = rel_err(got, want)
            ok = r <= rel
            log(f"  {name:16s} {label:44s} max|d|={e:.3e} rel={r:.2e} "
                f"(<= {rel:g}) {'ok' if ok else 'FAIL'}")
        else:
            ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                atol=atol)
            log(f"  {name:16s} {label:44s} max|d|={e:.3e} "
                f"(rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {label} disagrees with its plain version")

    def line(self):
        out = []
        for name, (route, src, repl) in self.SOURCES.items():
            out.append({"name": name, "route": route, "source": src,
                        "replaces": repl,
                        "launches": self.launches.get(name, 0),
                        "max_abs_err": self.err[name],
                        "ms": self.ms.get(name),
                        "plain_ms": self.plain_ms.get(name)})
        return json.dumps({"kernels": out})


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on a "
             "CUDA card only")
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0] if card else "unknown"
    try:
        import triton
        tv = triton.__version__
    except ImportError:
        fail("triton is not installed")
    from qwen3_tts_tpu_torch.kernels import build
    nvcc = build.find_nvcc()
    log("[1/6] device")
    log(card)
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"triton {tv}  nvcc {nvcc}  python {sys.version.split()[0]}")
    log(f"  device_count {torch.cuda.device_count()}  "
        f"{torch.cuda.get_device_name(0)}")
    # f32 references in full f32: the vocoder's conv1d would otherwise run
    # in TF32 through cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from qwen3_tts_tpu_torch.kernels import build
    log("[2/6] build")
    t0 = time.time()
    path = build.build(verbose=True)
    build.lib()
    log(f"  built {os.path.relpath(path, REPO)} in {time.time() - t0:.1f} s")


def phase_kernels(rec: Record):
    """Kernel vs plain at the slice's shapes."""
    import torch
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import flash_decode
    from qwen3_tts_tpu_torch.ops import gemv as G

    log("[3/6] kernels against their plain versions")
    log("  f32 tolerances: rtol 1e-4, atol 1e-4 (the kernels sum in another "
        "order than cuBLAS / PyTorch); bf16: relative error")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    talker = [(2048, 4096, "qkv"), (2048, 2048, "wo"),
              (2048, 12288, "gate/up"), (6144, 2048, "down"),
              (2048, 2176, "head")]
    pred = [(1024, 3072, "qkv"), (1024, 1024, "wo"), (1024, 6144, "gate/up"),
            (3072, 1024, "down")]
    for K, N, what in [(k, n, "talker " + w) for k, n, w in talker] + \
            [(k, n, "predictor " + w) for k, n, w in pred]:
        for M in (1, 2):
            x32, w32 = randn(M, K), randn(K, N, scale=0.02)
            rec.check("gemv", G.gemv(x32, w32, epilogue=G.EPI_F32),
                      G.gemv_plain(x32, w32, epilogue=G.EPI_F32),
                      f"{what} {K}x{N} M={M} f32", rtol=1e-4, atol=1e-4)
            xb, wb = x32.bfloat16(), w32.bfloat16()
            rec.check("gemv", G.gemv(xb, wb, epilogue=G.EPI_F32),
                      G.gemv_plain(xb, wb, epilogue=G.EPI_F32),
                      f"{what} {K}x{N} M={M} bf16", rel=1e-3)
    xb, wb = randn(1, 1024, dtype=torch.bfloat16), randn(
        1024, 16 * 2048, dtype=torch.bfloat16, scale=0.02)
    for epi, name in ((G.EPI_F32_ROUND_DT, "round"), (G.EPI_STORE_DT, "dt")):
        rec.check("gemv", G.gemv(xb, wb, col0=14 * 2048, n=2048, epilogue=epi),
                  G.gemv_plain(xb, wb, col0=14 * 2048, n=2048, epilogue=epi),
                  f"predictor head slice @14*2048 bf16 {name}", rel=8e-3)
    res = randn(1, 2048)
    x, w = randn(1, 6144, dtype=torch.bfloat16), randn(
        6144, 2048, dtype=torch.bfloat16, scale=0.02)
    rec.check("gemv", G.gemv(x, w, epilogue=G.EPI_ADD_F32, out=res.clone()),
              G.gemv_plain(x, w, epilogue=G.EPI_ADD_F32, out=res.clone()),
              "talker down bf16 add into f32 residual", rel=1e-3)

    # decode attention: talker (16/8, hd 128) and predictor (8/8, T 32)
    L = 2
    for dt, tol in ((torch.float32, None), (torch.bfloat16, 8e-3)):
        for T, nq, nk, cases, cdt in (
                (1024, 16, 8, [(0, 0), (1, 0), (300, 7), (1000, 130)], dt),
                (32, 8, 8, [(0, 0), (1, 0), (9, 0), (15, 0)],
                 torch.float32)):
            kc, vc = randn(L, 1, nk, T, 128, dtype=cdt), randn(
                L, 1, nk, T, 128, dtype=cdt)
            q = randn(1, nq, 128, dtype=dt)
            kn, vn = randn(1, nk, 128, dtype=dt), randn(1, nk, 128, dtype=dt)
            for kv_len, vfrom in cases:
                lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
                vf = torch.tensor([vfrom], dtype=torch.int32, device=dev)
                got = flash_decode.decode_attention_stacked(
                    q, kc, vc, kn, vn, 1, lens, vf)
                want = flash_decode.decode_attention_plain(
                    q, kc, vc, kn, vn, 1, lens, vf)
                label = (f"{nq}/{nk} T={T} kv_len={kv_len} vfrom={vfrom} "
                         f"{str(dt)[6:]}/{str(cdt)[6:]}")
                if tol is None:
                    rec.check("decode_attention", got, want, label,
                              rtol=1e-4, atol=1e-4)
                else:
                    rec.check("decode_attention", got, want, label, rel=tol)
    # batch of 2 with different prefixes (left padding)
    kc, vc = randn(L, 2, 8, 512, 128), randn(L, 2, 8, 512, 128)
    q, kn, vn = randn(2, 16, 128), randn(2, 8, 128), randn(2, 8, 128)
    lens = torch.tensor([400, 37], dtype=torch.int32, device=dev)
    vf = torch.tensor([3, 20], dtype=torch.int32, device=dev)
    rec.check("decode_attention",
              flash_decode.decode_attention_stacked(q, kc, vc, kn, vn, 0,
                                                    lens, vf),
              flash_decode.decode_attention_plain(q, kc, vc, kn, vn, 0, lens,
                                                  vf),
              "16/8 B=2 ragged f32", rtol=1e-4, atol=1e-4)

    # Triton passes (bf16 outputs: one bf16 ulp is 2^-8 relative)
    for H in (2048, 1024):
        x, w = randn(1, H), randn(H, dtype=torch.bfloat16)
        rec.check("rms_norm", el.rms_norm(x, w, 1e-6, torch.bfloat16),
                  el.rms_norm_plain(x, w, 1e-6, torch.bfloat16),
                  f"H={H} f32 -> bf16", rel=8e-3)
        rec.check("rms_norm", el.rms_norm(x, w.float(), 1e-6, torch.float32),
                  el.rms_norm_plain(x, w.float(), 1e-6, torch.float32),
                  f"H={H} f32", rtol=1e-4, atol=1e-4)
    for nq, nk, B in ((16, 8, 1), (8, 8, 1), (16, 8, 3)):
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(B, (nq + 2 * nk) * 128, dtype=dt)
            qn, kn_ = randn(128, dtype=dt), randn(128, dtype=dt)
            cos, sin = randn(B, 128), randn(B, 128)
            got = el.qk_norm_rope(qkv, qn, kn_, cos, sin, nq, nk, 1e-6)
            want = el.qk_norm_rope_plain(qkv, qn, kn_, cos, sin, nq, nk, 1e-6)
            for part, a, b in zip("qkv", got, want):
                label = f"{nq}/{nk} B={B} {part} {str(dt)[6:]}"
                if dt == torch.float32:
                    rec.check("qk_norm_rope", a, b, label, rtol=1e-4,
                              atol=1e-4)
                else:
                    rec.check("qk_norm_rope", a, b, label, rel=8e-3)
    for F in (6144, 3072):
        gu = randn(1, 2 * F)
        rec.check("silu_mul", el.silu_mul(gu, torch.bfloat16),
                  el.silu_mul_plain(gu, torch.bfloat16),
                  f"F={F} f32 -> bf16", rel=8e-3)
        rec.check("silu_mul", el.silu_mul(gu, torch.float32),
                  el.silu_mul_plain(gu, torch.float32), f"F={F} f32",
                  rtol=1e-4, atol=1e-4)
    ptab = randn(16, 3584, 1024, dtype=torch.bfloat16)
    logits = randn(3, 2048)
    logits[0, 100] = logits[0, 900] = 50.0          # tie: lowest index wins
    logits[1, 2047] = 60.0                         # only a bias row exists
    for q in (1, 15):
        outs = []
        for fn in (el.argmax_gather, el.argmax_gather_plain):
            codes = torch.zeros(3, 16, dtype=torch.int32, device=dev)
            x = torch.zeros(3, 1024, device=dev)
            fn(logits, codes, q, ptab, 2000, None if q == 15 else x)
            outs.append((codes, x))
        (ck, xk), (cp, xp) = outs
        if not torch.equal(ck, cp) or not torch.equal(xk, xp):
            fail(f"argmax_gather q={q} disagrees with its plain version")
        if int(cp[0, q]) != 100 or int(cp[1, q]) != 2047:
            fail("argmax_gather tie or bias-row case wrong")
        log(f"  {'argmax_gather':16s} {'B=3 q=' + str(q) + ' ties + bias row':44s}"
            f" exact ok")
    torch.cuda.synchronize()


def phase_agree(eng, rec: Record):
    """Teacher-forced kernel-vs-plain agreement at full width, bf16."""
    import torch
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import fused_predictor, fused_talker
    from qwen3_tts_tpu_torch.tts import generate

    log("[4/6] teacher-forced agreement, full width, bf16, peaked heads")
    cfg = eng.config
    tc, pc = cfg.talker, cfg.predictor
    dev = eng.device
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    pt = peak_head(eng.models["talker"], [(0, P.TALKER_SAMPLE_LIMIT)])
    pp = peak_head(eng.models["predictor"],
                   [(q * P.CODE_VOCAB, P.CODE_VOCAB)
                    for q in range(P.NUM_CODEBOOKS)])

    S, STEPS = 64, 16
    cache = decoder.init_kv_cache(tc, 1, length=256, device=dev)
    x = (0.05 * torch.randn(1, S, tc.hidden, generator=g, device=dev)).to(dt)
    pos = torch.arange(S, device=dev)[None]
    with torch.inference_mode():
        decoder.forward(pt, tc, x, pos, cache, 0)
        fb = (0.05 * torch.randn(1, tc.hidden, generator=g, device=dev)).to(dt)
        pad = torch.zeros(1, dtype=torch.int32, device=dev)
        agree = 0
        dmax = 0.0
        for s in range(STEPS):
            slot = S + s
            sb = torch.full((1,), slot, dtype=torch.int32, device=dev)
            kk, kv = cache["k"].clone(), cache["v"].clone()
            _, kl, _, _ = fused_talker.talker_step_fused(
                pt, tc, fb, sb, slot, sb, pad, kk, kv)
            ph, pl, pk, pv = fused_talker.talker_step_fused_plain(
                pt, tc, fb, sb, slot, sb, pad, cache["k"], cache["v"])
            lim = P.TALKER_SAMPLE_LIMIT
            agree += int(torch.argmax(kl[:, :lim], -1)
                         == torch.argmax(pl[:, :lim], -1))
            dmax = max(dmax, abs_err(kl, pl))
            cache = {"k": pk, "v": pv}               # teacher: the plain state
            fb = (0.9 * fb.float() + 0.1 * ph.float()).to(dt)
        frac_t = agree / STEPS
        log(f"  talker step argmax agreement {agree}/{STEPS} = {frac_t:.3f} "
            f"(gate 0.93), max|dlogits| {dmax:.3e}")

        ptab, rows = generate.predictor_tables(eng.models, pc)
        agree = total = 0
        for s in range(8):
            h1024 = torch.randn(1, pc.hidden, generator=g, device=dev)
            code0 = torch.randint(0, 2048, (1,), generator=g, device=dev)
            ck = fused_predictor.frame_codes_fused(pp, pc, ptab, rows, h1024,
                                                   code0)
            cp = fused_predictor.frame_codes_fused_plain(pp, pc, ptab, rows,
                                                         h1024, code0)
            agree += int((ck == cp).sum())
            total += ck.numel()
        frac_p = agree / total
        log(f"  predictor codes agreement {agree}/{total} = {frac_p:.3f} "
            f"(gate 0.95)")
    if frac_t < 0.93:
        fail(f"talker agreement {frac_t:.3f} < 0.93")
    if frac_p < 0.95:
        fail(f"predictor agreement {frac_p:.3f} < 0.95")


def phase_main(eng, rec: Record):
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.ops import chain
    from qwen3_tts_tpu_torch.tts import generate

    log("[5/6] main path: TtsEngine.generate_with_voice, full width, B=1")
    eng.set_max_steps(32)
    eng.set_sampler_config(SamplerConfig(seed=0))
    voice = eng.get_speaker("vivian")
    text = "Hello from the port: one sentence of speech."
    torch.cuda.synchronize()
    chain.reset_launch_counts()
    t0 = time.time()
    audio = eng.generate_with_voice(text, voice)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = chain.launch_counts()
    rec.launches = counts
    wav = audio.samples
    n_frames = len(wav) // 2000
    log(f"  wav {wav.shape} samples, {n_frames} frames, {wall:.2f} s wall, "
        f"finite={bool(np.isfinite(wav).all())}")
    log(f"  launches {json.dumps(counts)}")
    if not np.isfinite(wav).all():
        fail("waveform not finite")
    if n_frames < 1 or len(wav) != n_frames * 2000 or n_frames > 32:
        fail(f"waveform of {len(wav)} samples is not 1..32 whole frames")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # the batched entry point: two ragged prompts, left-padded, B=2
    t0 = time.time()
    pair = eng.generate_batch([text, "A second, shorter one."], [voice, voice])
    torch.cuda.synchronize()
    for i, a in enumerate(pair):
        w = a.samples
        if not np.isfinite(w).all() or len(w) % 2000 or not 0 < len(w) <= 64000:
            fail(f"generate_batch row {i}: {len(w)} samples, finite="
                 f"{bool(np.isfinite(w).all())}")
    log(f"  generate_batch B=2: {[len(a.samples) // 2000 for a in pair]} "
        f"frames, {time.time() - t0:.2f} s wall, finite")

    # reference on a small input: the tiny f32 config's greedy generation,
    # kernels on the card against the plain versions on the CPU
    cfg = tiny_engine_config(max_steps=8)
    teng = TtsEngine(config=cfg, random_weights=True, seed=0,
                     speakers_dir=os.path.join(REPO, "speakers"), device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (0.1 * rng.standard_normal((2, 9, cfg.talker.hidden))).astype(
            np.float32))
    x[1, :3] = 0
    pad = torch.tensor([0, 3], dtype=torch.int32)
    cpu_models = _to(teng.models, "cpu")
    with torch.inference_mode():
        ck, nk = generate.generate_codes(
            teng.models, cfg.talker, cfg.predictor, x.cuda(), pad.cuda(),
            None, 0.0, 0, 1.0, cfg.max_steps)
        cc, nc = generate.generate_codes(
            cpu_models, cfg.talker, cfg.predictor, x, pad, None, 0.0, 0, 1.0,
            cfg.max_steps)
    same = bool(torch.equal(ck.cpu(), cc)) and bool(torch.equal(nk.cpu(), nc))
    log(f"  tiny f32 greedy codes, card kernels vs CPU plain: "
        f"{'equal' if same else 'DIFFER'} (n_frames {nc.tolist()})")
    if not same:
        fail("tiny-config codes on the card differ from the CPU reference")


def _to(obj, dev):
    import torch
    from qwen3_tts_tpu_torch.assets.tables import Assets
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to(v, dev) for v in obj]
    if isinstance(obj, Assets):
        return Assets(*(_to(t, dev) for t in (
            obj.text_table, obj.codec_tables, obj.proj_weight,
            obj.proj_bias)))
    return obj


def phase_times(eng, rec: Record, card: str):
    import torch
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import flash_decode
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.tts import generate

    log(f"[6/6] times on {card} (CUDA events)")
    cfg = eng.config
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(5)
    frames = 32
    prompt = 0.1 * torch.randn(1, 64, cfg.talker.hidden, generator=g,
                               device=dev)
    pad = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(plain, steps):
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode():
            generate.generate_codes(
                eng.models, cfg.talker, cfg.predictor, prompt, pad, gen,
                0.7, 40, 0.9, frames, ignore_eos=True, step_cap=steps,
                plain=plain)

    def timed(plain, steps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run(plain, steps)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    per_frame = {}
    for plain in (False, True, True, False):        # kernel, plain, plain, kernel
        run(plain, 2)                                # warm up
        total = timed(plain, frames)
        prefill = timed(plain, 0)
        per_frame.setdefault(plain, []).append((total - prefill) / frames)
    kms, pms = min(per_frame[False]), min(per_frame[True])
    log(f"  ms/frame generate_codes(ignore_eos) over {frames} frames, B=1, "
        f"bf16 (prefill subtracted): kernels {kms:.3f} (runs "
        f"{[round(v, 3) for v in per_frame[False]]}), plain {pms:.3f} (runs "
        f"{[round(v, 3) for v in per_frame[True]]}) on {card}")

    # device busy share of the kernel path: device time of the kernels in a
    # profiler trace of prefill + 4 frames, over the wall time of the same
    # run without the profiler (which slows the host down)
    busy = None
    try:
        from torch.profiler import ProfilerActivity, profile
        wall = timed(False, 4)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(False, 4)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kern)
        if dev_us > 0:
            busy = dev_us / 1e3 / wall
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
            log(f"  profiler, prefill + 4 frames: device busy "
                f"{dev_us / 1e3:.2f} ms of {wall:.2f} ms unprofiled wall = "
                f"{busy:.3f} on {card}")
            for e in top:
                log(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                    f"{e.count:6d}x  {e.key[:70]}")
    except (RuntimeError, AssertionError) as exc:
        log(f"  profiler unavailable ({exc}); device busy share not measured")
    if busy is None:
        log("  device busy share: not measured (no device time in trace)")

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    # per-kernel device time: REPS calls captured in one CUDA graph and
    # replayed, so host launch cost drops out; weights and caches rotate
    # over copies larger than the 50 MB L2, as on the main path
    layer = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]
    copies = 4
    mats = [[(randn(1, k), randn(k, n, scale=0.02)) for k, n in layer]
            for _ in range(copies)]

    def gemv_layers(fn):
        def call():
            for layer_mats in mats:
                for x, w in layer_mats:
                    fn(x, w)
        return call

    kc, vc = randn(8, 1, 8, 1024, 128), randn(8, 1, 8, 1024, 128)
    q, kn, vn = randn(1, 16, 128), randn(1, 8, 128), randn(1, 8, 128)
    lens = torch.tensor([1000], dtype=torch.int32, device=dev)
    vf = torch.zeros(1, dtype=torch.int32, device=dev)

    def attn(fn):
        def call():
            for l in range(8):
                fn(q, kc, vc, kn, vn, l, lens, vf)
        return call

    x32, w = randn(1, 2048, dtype=torch.float32), randn(2048)
    qkv, qn, kn_ = randn(1, 32 * 128), randn(128), randn(128)
    cos, sin = (randn(1, 128, dtype=torch.float32),
                randn(1, 128, dtype=torch.float32))
    gu = randn(1, 2 * 6144, dtype=torch.float32)
    ptab = randn(16, 3584, 1024)
    logits = randn(1, 2048, dtype=torch.float32)
    codes = torch.zeros(1, 16, dtype=torch.int32, device=dev)
    xo = torch.zeros(1, 1024, device=dev)
    cases = {
        "gemv": ("one talker layer: qkv+wo+gate/up+down, M=1 bf16", copies,
                 gemv_layers(G.gemv), gemv_layers(G.gemv_plain)),
        "decode_attention": ("16/8 hd128 kv_len=1000 bf16, per layer", 8,
                             attn(flash_decode.decode_attention_stacked),
                             attn(flash_decode.decode_attention_plain)),
        "rms_norm": ("H=2048 f32 -> bf16", 1,
                     lambda: el.rms_norm(x32, w, 1e-6, torch.bfloat16),
                     lambda: el.rms_norm_plain(x32, w, 1e-6, torch.bfloat16)),
        "qk_norm_rope": (
            "16/8 hd128 bf16", 1,
            lambda: el.qk_norm_rope(qkv, qn, kn_, cos, sin, 16, 8, 1e-6),
            lambda: el.qk_norm_rope_plain(qkv, qn, kn_, cos, sin, 16, 8,
                                          1e-6)),
        "silu_mul": ("F=6144 f32 -> bf16", 1,
                     lambda: el.silu_mul(gu, torch.bfloat16),
                     lambda: el.silu_mul_plain(gu, torch.bfloat16)),
        "argmax_gather": (
            "B=1 2048 logits, ptab row 1024 bf16", 1,
            lambda: el.argmax_gather(logits, codes, 3, ptab, 3072, xo),
            lambda: el.argmax_gather_plain(logits, codes, 3, ptab, 3072, xo)),
    }
    for name, (label, per, kfn, pfn) in cases.items():
        rec.ms[name] = graph_ms(kfn) / per
        rec.plain_ms[name] = graph_ms(pfn) / per
        host = cuda_ms(kfn) / per
        log(f"  {name:16s} {label:48s} device: kernel {rec.ms[name]:.4f} ms, "
            f"plain {rec.plain_ms[name]:.4f} ms; host-bound eager kernel "
            f"{host:.4f} ms on {card}")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "qwen3_tts_tpu_torch")):
        fail("qwen3_tts_tpu_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, REPO)
    card = phase_device()
    import torch
    phase_build()
    rec = Record()
    phase_kernels(rec)

    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    t0 = time.time()
    eng = TtsEngine(config=EngineConfig(), random_weights=True, seed=0,
                    speakers_dir=os.path.join(REPO, "speakers"),
                    device="cuda")
    torch.cuda.synchronize()
    log(f"  engine: full EngineConfig() random weights in "
        f"{time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    phase_agree(eng, rec)
    phase_main(eng, rec)
    phase_times(eng, rec, card)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB on {card}")
    print(card, flush=True)
    print(rec.line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
