"""On-card measurements of the predictor frame kernel, beside
`chip_smoke.py` (PERF.md's PR 7 numbers come from here):

    python3 -m qwen3_tts_tpu_torch.tools.frame_measure trace DIR [--nowork]
    python3 -m qwen3_tts_tpu_torch.tools.frame_measure int8mm
    python3 qwen3_tts_tpu_torch/tools/frame_measure.py ab TAG

trace   copies the package into DIR (a directory `.gitignore` lists),
        gives the copy's `csrc/predictor_frame.cu` a stage timeline (block
        0's thread 0 writes %globaltimer at each grid barrier's arrival and
        release, and sums the time to its norm inputs and of its products)
        and builds that kernel alone there; then, full width, dense bf16
        and int8, B = 1 and 16: ms a frame (CUDA events over 10 frames),
        and per stage kind (qkv, attention, wo, gate/up, down, head) block
        0's work, its barrier wait and the stage's total, in us a stage.
        `--nowork` also cuts the stages' work out, leaving the barriers
        and the weight copies: the floor of the design.
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

The timeline variant is a measuring copy, not a second kernel: its
arithmetic is the kernel's.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("qkv", "attn", "wo", "gu", "down")
TRACE_WORDS = 2000          # the timeline buffer, int64 words
T0, PHASES, NORM, WAIT = 1999, 1900, 1960, 1980   # its fixed slots


def _insert(src: str, anchor: str, text: str, before: bool = True) -> str:
    if anchor not in src:
        raise RuntimeError(f"frame_measure: anchor not found: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text, 1)


def _timeline(cu: str, nowork: bool) -> str:
    """The kernel source with the stage timeline (and without the stages'
    work when `nowork`)."""
    rec = "if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) "
    cu = cu.replace("  float eps;\n};",
                    "  float eps;\n  unsigned long long* trace;\n};", 1)
    cu = cu.replace(
        "void grid_barrier(unsigned* bar) {\n  __syncthreads();",
        "void grid_barrier(unsigned* bar, unsigned long long* tr, int& ti) {"
        "\n  __syncthreads();\n  if (tr != nullptr && blockIdx.x == 0 && "
        "threadIdx.x == 0) tr[2 * ti] = global_ns();", 1)
    k = cu.index("void grid_barrier(")
    e = cu.index("\n  __syncthreads();\n}", k)
    cu = cu[:e] + ("\n  if (tr != nullptr && blockIdx.x == 0 && threadIdx.x "
                   "== 0) tr[2 * ti + 1] = global_ns();\n  ++ti;") + cu[e:]
    cu = cu.replace("grid_barrier(a.bar);", "grid_barrier(a.bar, a.trace, ti);")
    cu = cu.replace("  int s = 0;\n",
                    f"  int s = 0, ti = 0;\n  {rec}a.trace[{T0}] = "
                    "global_ns();\n", 1)
    # block 0's products: time to its inputs, then to its stores
    cu = _insert(cu, "  if (mat == kHead && threadIdx.x < B) {\n    sm.bestv",
                 "  const unsigned long long tp0 = global_ns();\n"
                 "  unsigned long long tp1 = tp0;\n")
    cu = _insert(cu, "      // wo / down add into the residual",
                 "      if (c0 == 0) tp1 = global_ns();\n")
    cu = _insert(cu, "  if (mat == kHead && threadIdx.x < B) {\n    a.part_v",
                 f"  {rec}{{\n    a.trace[{PHASES} + mat * 4 + 1] += tp1 - tp0;"
                 f"\n    a.trace[{PHASES} + mat * 4 + 2] += global_ns() - tp1;"
                 f"\n    a.trace[{PHASES} + mat * 4 + 3] += 1;\n  }}\n")
    # block 0's norm inputs: its loads, then the row reduction
    k = cu.index("__device__ void stage_norm(")
    b = cu.index("  const int K = a.H;\n", k)
    cu = cu[:b] + f"  {rec}a.trace[{NORM + 4}] = global_ns();\n" + cu[b:]
    red = "  __syncthreads();\n  if (threadIdx.x < mt) {\n    float t = 0.f;"
    cu = _insert(cu, red, f"  unsigned long long tn0 = 0;\n  {rec}tn0 = "
                 "global_ns();\n")
    done = ("    sm.rinv[threadIdx.x] = rsqrtf(t / static_cast<float>(K) + "
            "a.eps);\n  }\n  __syncthreads();\n")
    cu = _insert(cu, done, f"  {rec}{{\n    a.trace[{NORM}] += tn0 - "
                 f"a.trace[{NORM + 4}];\n    a.trace[{NORM + 1}] += "
                 f"global_ns() - tn0;\n    a.trace[{NORM + 3}] += 1;\n  }}\n",
                 before=False)
    wait = "    mbar_wait(sm.bar + (s & 1), (s >> 1) & 1);\n"
    cu = _insert(cu, wait, "    const unsigned long long tw0 = global_ns();\n")
    cu = _insert(cu, wait, f"    {rec}{{\n      a.trace[{WAIT}] += global_ns()"
                 f" - tw0;\n      a.trace[{WAIT + 1}] += 1;\n    }}\n",
                 before=False)
    if nowork:
        cu = _insert(cu, "  if (a.sc[mat] != nullptr)\n    product<",
                     "  after_inputs();\n  return;\n")
        cu = _insert(cu, "  const float rs = sqrtf(static_cast<float>(hd));\n",
                     "  return;\n", before=False)
    return cu


def make_trace_copy(out: str, nowork: bool) -> None:
    """The package copied into `out`, with the timeline in its frame kernel
    and a build of that kernel alone."""
    dst = os.path.join(out, "qwen3_tts_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    csrc = os.path.join(dst, "csrc")
    for f in os.listdir(csrc):
        if f not in ("predictor_frame.cu", "gemv.cuh"):
            os.remove(os.path.join(csrc, f))
    path = os.path.join(csrc, "predictor_frame.cu")
    with open(path) as f:
        cu = _timeline(f.read(), nowork)
    with open(path, "w") as f:
        f.write(cu)
    path = os.path.join(dst, "kernels", "build.py")
    with open(path) as f:
        text = f.read()
    i = text.index("SIGNATURES = {")
    j = text.index("}\n", i)
    text = text[:i] + ('SIGNATURES = {\n'
                       '    "predictor_frame_query": [I, I, I, P],\n'
                       '    "predictor_frame_launch": [P, I, I, I, I, P],\n'
                       ) + text[j:]
    with open(path, "w") as f:
        f.write(text)
    path = os.path.join(dst, "ops", "fused_predictor.py")
    with open(path) as f:
        text = f.read()
    text = text.replace('        + [("eps", ctypes.c_float)]',
                        '        + [("eps", ctypes.c_float), '
                        '("trace", ctypes.c_void_p)]', 1)
    text = text.replace("        a.eps = cfg.rms_eps\n",
                        "        a.eps = cfg.rms_eps\n        a.trace = "
                        "None if TRACE is None else TRACE.data_ptr()\n", 1)
    text = text.replace("_tables: dict = {}\n",
                        "_tables: dict = {}\nTRACE = None\n", 1)
    with open(path, "w") as f:
        f.write(text)


def run_trace(tag: str) -> None:
    """The timeline of the copy this runs from (its package first on the
    path)."""
    import torch
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import quant

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
            line = (f"{tag} {kind} B={B}: {s.elapsed_time(e) / 10:.3f} ms a "
                    f"frame (CUDA events); timeline {(prev - tr[T0]) / 1e6:.3f}"
                    " ms; us a stage, block 0's work / barrier wait / total:")
            for k in (*STAGES, "head"):
                w = sum(work[k]) / len(work[k]) / 1e3
                b = sum(wait[k]) / len(wait[k]) / 1e3
                line += f" {k} {w:.2f}/{b:.2f}/{w + b:.2f}"
            print(line, flush=True)
            ph = tr[PHASES:PHASES + 20]
            if any(ph):
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
    if len(argv) >= 2 and argv[0] == "trace":
        out = os.path.abspath(argv[1])
        nowork = "--nowork" in argv[2:]
        make_trace_copy(out, nowork)
        env = dict(os.environ, PYTHONPATH=out)
        code = ("import sys; sys.path.insert(0, '.'); "
                "from qwen3_tts_tpu_torch.kernels import build; build.lib(); "
                "from qwen3_tts_tpu_torch.tools import frame_measure as m; "
                f"m.run_trace({'nowork' if nowork else 'timeline'!r})")
        return subprocess.run([sys.executable, "-c", code], cwd=out,
                              env=env).returncode
    sys.path.insert(0, os.getcwd())
    if argv[:1] == ["int8mm"]:
        int8mm()
        return 0
    if len(argv) == 2 and argv[0] == "ab":
        ab(argv[1])
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
