#!/usr/bin/env python3
"""The port's main path on one CUDA card: build, check, run, time.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device    the card (nvidia-smi name and power limit), torch / CUDA /
               triton versions, nvcc; the TF32 switches left at torch's
               defaults, as a user has them (the f32 vocoder and encoders
               turn TF32 off around their own work, core/precision.py)
  2. build     nvcc compiles qwen3_tts_tpu_torch/csrc/*.cu for sm_90a
  3. kernels   every kernel against its plain PyTorch version at the
               shapes of the slice (f32 allclose, bf16 relative error),
               the quantized ones included: A (qmatmul) at the talker's
               five prefill shapes and M = 1, 37, 64, 128, 192, 1088, x
               bf16 and f32 (rtol = atol = 1e-4), a column view of a wider
               weight, repeats and two CUDA-graph replays bit-identical;
               B8 / B4 (gemv_int8 / gemv_int4) at M = 1, 2,
               8, 32, every epilogue and the predictor head's slices;
               B, B8 and B4 with the rms norm as their prologue against
               rms_norm_plain + the plain product at the talker's and the
               predictor's shapes; B, B8 and B4 with the qk epilogue
               (QK-norm, RoPE, q/k/v split; the KV store into a strided f32
               cache view: slot p equal to the launch's own k / v, its
               neighbours untouched) at the talker's and the predictor's
               qkv, and with the silu prologue at their down products,
               against the plain fused products; decode attention with
               bf16 q over the predictor's f32 cache and in the stream
               path's 4096-slot cache; the predictor head slice's argmax
               epilogue (B, B8, B4 at B = 1, 10, 17, 32; q = 1 with the
               ptab gather, 15 without; tied columns, a NaN row, the bias
               row) exactly equal to its plain version, and two launches
               replayed twice in one CUDA graph (its tickets reset); the
               same calls of B, B8, B4 (with
               and without the norm, with the silu prologue and the qk
               epilogue) and decode attention twice and in two CUDA-graph
               replays give bit-identical outputs; the predictor frame
               kernel (csrc/predictor_frame.cu) against
               frame_codes_fused_plain: the tiny f32 config's and a small
               f32 all-int4 predictor's codes equal on the card and to the
               CPU's at B = 1, 2, 3, 16, the residual after the last pass
               within rtol/atol 1e-4, and at full width with peaked heads
               code agreement >= 0.95 for dense bf16, int8 and int4
               weights at B = 1, 2, 16, repeats and two CUDA-graph replays
               of the cooperative launch bit-identical; the talker step
               kernel (csrc/talker_step.cu) against
               talker_step_fused_plain: hidden, logits and the cache slot
               written, every other slot unchanged, at B = 1, 2 and 16,
               ~100 live slots of a 256 window and ~2100 of a 4096 cache,
               and at B = 17, 24 and 32, ~700 of a 1024 window and ~2100
               of a 4096 cache (full-depth f32 the 1024 window alone): f32
               (rtol/atol 1e-4) at the tiny config, a small int4 talker
               and the full width and depth; bf16 (relative error <= 8e-3)
               at the full width cut to 2 layers; bf16 at full depth,
               relative error <= 3e-2, the chain's own error logged beside
               it, and the plain step without its last layer further than
               that; repeats and two CUDA-graph replays bit-identical
  4. probes    the capability-probe tool (`python -m
               qwen3_tts_tpu_torch.tools.mosaic_probe --device cuda`) as a
               user runs it, every probe kernel launched; then each of the
               eight kernels (csrc/probes.cu; int8_panel's is kernel A,
               csrc/qmatmul.cu) against its plain version at
               the TPU probe's shapes (equal, except the int8 panel's f32
               sums: max |d| <= 1e-5 x max |plain|), the TPU probe's own
               check, the edge indices, non-constant inputs
               (`mosaic_probe.varied_inputs`: hbm_scratch on an arange and
               normal draws, fori_dma at 1-5 and 9 steps, the int8 panel
               at three row strides), and device times (CUDA graph replay)
  5. agree     teacher-forced agreement at full width in bf16, kernels vs
               plain from the same state, with peaked heads: talker step
               argmax >= 0.93, predictor codes >= 0.95, for dense weights,
               for the int4 talker with the int8 predictor, and for the
               int8 talker
 5b. predictor `models/predictor.py` (frame_codes, Jacobi decoding) and
               the loop's Jacobi branch: kernel A against its plain version
               at the int8 predictor's products and a head slice view, M =
               1, 2, 16, 32, 64 (rtol = atol = 1e-4); at f32 (the tiny
               config dense, a 256-wide int8 one on kernel A), B = 1 and 4:
               frame_codes, Jacobi with zero, oracle and adversarial drafts
               and the frame kernel's codes equal to each other and to the
               CPU's; at full width bf16, dense and int8, B = 1 and 4:
               Jacobi self-consistent (a verifying pass over its codes
               reproduces codes 1-15, the oracle draft takes one pass),
               with peaked heads Jacobi's and frame_codes's codes each
               agreeing with the frame kernel's >= 0.95; frame_codes on int8
               weights counted as a main-path run (kernel A, decode
               attention); generate_codes with QWEN3_TTS_PRED_JACOBI=1: the
               tiny f32 config's codes equal to the default path's and the
               CPU's, full width 32 frames dense and 8 int8/int8 (kernel A
               launched) against the default path in turns. Prints the
               device ms of one Jacobi pass, passes a frame, ms a frame of
               Jacobi, frame_codes and the frame kernel's route in one call,
               and kernel A a predictor layer at M = 16 and 64 against its
               bound, its plain version and torch._weight_int8pack_mm
  6. main      TtsEngine(random_weights=True, seed=0) at full EngineConfig()
               width, B=1, 32 frames, generate_with_voice(vivian): a finite
               waveform, the talker step kernel and the predictor frame
               kernel launched; generate_batch at B=2, then (4 frames) at
               B = 17, where the talker takes its step kernel
               (`talker_step_b17_32`) beside the predictor's chain (past
               the dense route's limit, were it below the batch cap of 32,
               the talker's chain of gemv, decode attention and the Triton
               rms_norm).
               The same weights quantized as the JAX bench's headline rung
               (talker int4, predictor int8) through
               TtsEngine(weights=...): B=1, 32 frames, then B=2, then past
               the int4 route's limit (9) and at the cap, 32, on the
               talker's chain (B4, and past 16 rows B8 for the predictor's
               chain, launched); the int8/int8 rung, B=1, 16 frames, with
               qmatmul (int8 prefill) launched, then past its route's
               limit (25) on the chain (B8 launched); all five predictor
               weights int4 (int4/int4, B=1, 8 frames): the frame kernel
               (`predictor_frame_int4`) and the talker step kernel once a
               frame and none of the chains' launches, where the measured
               route takes int4 at B = 1. The tiny f32 config's greedy
               codes on the card equal the CPU reference, dense, int8, and
               int4 on a small int4-capable talker. Counts are set to 0
               just before each of these runs and read just after; every
               count a frame is the one of the routes `talker_route` and
               `frame_route` take at the batch (`route_per_frame`): on the
               kernels the talker step kernel and the predictor frame
               kernel once a frame and none of the chain's launches (no
               gemv, decode attention, Triton rms_norm, fused piece, KV
               store or copy, argmax epilogue); on the talker's chain the
               chains' (113 talker gemv, 28 decode attention, one
               rms_norm, two cache copies, and the predictor's chain past
               16 rows).
  7. stream    TtsEngine.generate_stream at full width, B=1, 32 frames,
               dense bf16 and int4 talker + int8 predictor: a cold call,
               warmup, a warm call, each with the counts set to 0 just
               before and read just after. A finite waveform of whole
               frames; every chunk whole frames and at most (4 +
               lookahead) frames, the chunks concatenating to the samples;
               the waveform equal to a one-shot vocoder decode of the
               stream's own codes (f32 vocoder, atol 1e-4). The tiny f32
               config: greedy stream codes equal the offline path's and
               the CPU's, samples within atol 1e-4. Prints first-chunk ms
               (cold, warm), streaming RTF including vocoding, the
               vocoder's device ms per 4-frame chunk, and ms/frame of the
               stream step with its 4096-slot cache against the offline
               window's 256
  8. times     ms/frame of generate_codes through kernels and through the
               plain versions (CUDA events), dense and int4+int8, the
               device busy share of the kernel paths and
               the device ms and CUDA kernels per frame by kernel name
               (torch.profiler: prefill + 4 frames less the prefill), the
               prefill's CUDA kernels, device ms and the share of it in
               dequant4_dt (the int4 dequantisation), and
               each kernel's device time (CUDA graph replay) against its
               plain version, a PyTorch call of the same function and its
               bound, at the earlier timing shapes and the main path's;
               rms_norm + B / B8 / B4 against the same products with the
               fused norm (and without any norm); the qkv products with
               and without the qk epilogue, the down products with and
               without the silu prologue; B, B8, B4 and decode attention
               at each split count beside their plans' choice; the
               predictor frame kernel a frame, dense / int8 / int4 at B =
               1, 16, against its bound and the chain of launches it
               replaces (its plain version at B = 1); the talker step
               kernel a step, dense / int8 / int4 at B = 1, 16, 17, 32,
               against its bound, the chain it replaces and its plain
               version (other batches: their `batches` argument); kernel
               A a talker layer at M = 64, 128, 192 and 1088 against its
               bound, its plain version, torch._weight_int8pack_mm and
               cuBLAS on bf16 weights (a reference), and each product with
               the plan's tiles against the other tiles, K splits and row
               tiles; B4 against torch._weight_int4pack_mm on the same
               weights
  9. checkpoint  the engine's save_checkpoint at full EngineConfig() width
               (dense bf16) into a temporary directory, then
               TtsEngine(model_dir=..., device="cuda") on it: greedy
               generate_codes(ignore_eos=True), B=1, 32 frames, identical
               to the in-memory engine's, once from the .npz checkpoints
               and once from the reference's llama GGUF layout
               (export_llama_gguf, no decoder .npz); then the CLI
               (`cli.main`) on the directory, offline, with --stream and
               with --long (a text of five sentences, one batch of five
               rows): WAVs of whole frames, finite. Prints the bytes
               written and the seconds to save, export and load each
               layout. Then the reference's raw release through the port's
               tool (`tools/convert_weights.main`, in process): the llama
               GGUFs, qwen3_tts_decoder.onnx written from the engine's
               vocoder with torch names and anonymized, both encoder
               graphs (seeded random_encoders, anonymized) and the general
               snake vocoder anonymized, converted with no config: every
               converted vocoder and encoder leaf torch.equal to the one
               written, the derived configs equal to the written ones;
               TtsEngine(model_dir=...) on the output: greedy codes
               identical to the in-memory engine's, generate_with_voice
               within GENERAL_REL of it (the step kernels launched),
               create_voice_file on 4 s of audio with equal codes and the
               speaker embedding within GENERAL_REL; the bytes and seconds
               of each write, read and conversion. Then `python -m
               qwen3_tts_tpu_torch.tools.validate_release --device cuda`
               (in process) on that release in the downloader's layout
               (the llama GGUFs, the decoder and encoder graphs, a
               tokenizer.json): exit 0. The directory is removed in any
               case
 10. clone     voice cloning at full width: random encoders (audio
               1024 x 8, speaker 512 x 6, f32) with the RVQ codebooks tied
               to the vocoder's tables; create_voice_file on a 4 s and a
               10 s 24 kHz WAV, cold and warm, split into mel, audio
               encoder and speaker encoder (codes floor(N/2000) x 16 in
               [0, 2048), a finite 2048-d embedding, the voice JSON saved
               and reloaded); process_reference writes the TTSC .cache and
               a second call with the encoders set to None returns the same
               codes; generate_with_voice with the 10 s clone voice, dense
               bf16 and int4+int8 (the talker step kernel and the
               predictor frame kernel once a frame), int8/int8 (kernel A
               on the clone prompt's bucket); the clone prompt's length
               and bucket, its prefill's device and host ms, ms a frame
               against a preset prompt's; generate_batch with a preset and
               a clone voice; generate_stream with the clone voice (chunks,
               first-chunk ms, streaming RTF); generate(text, wav,
               ref_text); the tiny f32 config: encoder codes and greedy
               clone codes on the card equal to the CPU's; the general
               vocoder at full width (hidden 1024, strides 5,5,5,4,4,
               kernels 10,10,10,8,8, residual dilations 1,3,9, snake,
               halving channels): 4-frame chunked decode against one-shot
               and one-shot against the CPU (atol 1e-4 x the peak), the
               same with torch's default TF32 switches against both off
               (atol 1e-6 x peak), device ms a 4-frame chunk against the
               kernel == stride vocoder's, ctx_r and the first chunk's
               delay, and generate_stream through it; then the CLI with
               --ref-audio --ref-text --save-voice on a full-width
               directory save_checkpoint wrote (with the encoders): exit
               0, a WAV, a voice JSON that loads. Removed in any case
 11. serve     continuous batching at full width (serving.ServingEngine,
               streams of up to 120 frames (10 s of speech), each engine
               warmed up, then driven SERVE_RUNS times, each run with the
               counts set to 0 just before and read just after, the
               launches a frame those of the routes `talker_route` and
               `frame_route` take at the batch): dense bf16 at B = 4 over 6
               staggered streams (one admitted a tick; rows recycled), B =
               16 with 4096-slot rows (the talker step kernel, the
               predictor's chain), B = 32 with kv_window 1024 (the talker
               step kernel once a step where the dense route takes 32 rows,
               `talker_step_b17_32`, else its chain; the predictor's
               chain), int4+int8 at B = 8 (both step kernels);
               every stream finite, whole frames within the frame cap, its
               chunks concatenating to its result. Prints audio-s/s of the
               batch over each run's wall (admissions included) and the
               wall's parts (the step, the batched vocoder call,
               admissions, the rest), ms a tick, admission ms (prefill +
               copy) and
               first-chunk ms after submit, and the batch cache's GiB. The
               tiny f32 config's staggered streams: greedy codes on the card
               equal to the CPU's and to each solo stream's. A talker step
               captured from a real tick (ragged rows, an empty row set to
               the cache's cap) against talker_step_fused_plain at
               FULL_DEPTH_REL with the control, and its device ms with the
               empty row at cap - 1 against slot 1. Then server.TtsServer on
               127.0.0.1: /health, two concurrent POST /tts (one streamed,
               chunked), /stats counting both, the finished streams
               evicted
 12. parallel  `parallel/` on the one card: decode attention at a
               tensor-parallel rank's head counts (the talker's 8/4 and
               4/2 over the 256- and 4096-slot caches, the predictor's 4/4
               and 2/2 over 32 bf16 slots) and kernel A at a rank's int8
               products (the talker's layer at a model axis of 2 and 4,
               the predictor's at 2, a rank's head slice; M = 1, 64)
               against their plain versions; then TP_RANKS = 2 gloo ranks
               over CUDA tensors (`chip_smoke.py --parallel-rank`, each
               killed past TP_TIMEOUT_S), each building EngineConfig()'s
               full weights from seed 0 (a checksum broadcast: both equal
               to this engine's) and keeping its shards. On mesh (1, 2),
               dense bf16 and int8/int8 with peaked heads: the 64-token
               prefill and 16 frames teacher-forced on the codes of this
               process's greedy single-process run (talker steps through
               decoder.forward, frames through models/predictor.
               frame_codes), counted (decode attention, and kernel A for
               int8, launched; counts set to 0 just before, read just
               after) and timed: predictor codes against that run's >=
               0.95, the ranks' codes equal; the prefill and each step
               against the single process from the same state (the ranks'
               caches gathered): talker argmax agreement >= 0.93, the
               hidden's distance to the single process in f32 within
               TP_BF16_MARGIN x the single process's own in bf16; one step
               from phase 3's states in its three tiers: f32 at full width
               and depth (dense) within rtol/atol 1e-4, bf16 cut to 2
               layers within 8e-3, bf16 at full depth with the control
               (the last layer dropped) beyond FULL_DEPTH_REL (the bf16
               errors logged: the single process's own rounding is of
               FULL_DEPTH_REL's size there). On mesh (2, 1) the
               sequence-split prefill of 1024 tokens against the
               single-process prefill (hidden and cache within
               FULL_DEPTH_REL, the control further). Prints ms a frame of
               the 2-rank path, collectives a frame and their share of the
               wall, each rank's peak memory, and the kernels' device times
               at a rank's shapes (and decode attention at frame_codes's
               8/8 over 32 bf16 slots) against their plain versions, SDPA
               / torch._weight_int8pack_mm and their bounds. Prints the
               whole smoke's seconds

The line before the last is a JSON object with one entry per kernel (its
launches on the main path, max |kernel - plain|, device ms of the kernel,
its plain version and one PyTorch call computing the same function where
there is one, `library_ms`, else null; `bound_ms`, the least time the card
could take from the case's bytes at 3.35 TB/s or its operations at the
type's peak, and `bound_by`); the last line is {"ok": true, "device":
{...}}.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, REPS = 5, 20
PROBE = "probe_"      # prefix of the probe kernels' names in the JSON line


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def rel_err(a, b) -> float:
    """max |a - b| over max |b|, the two maxima exact in f32 and their
    ratio taken in f64 (an f32 quotient can round a ratio that equals a
    limit past it: 2^-5 / 3.90625 is 0.008, in f32 0.0080000004)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Mean device time of fn() over `reps` launches after `warmup`."""
    import torch
    for _ in range(warmup):
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
    graph replayed and timed with events, so host launch cost drops out.
    The capture runs on the warm-up's stream, so what a wrapper keeps per
    stream (the argmax epilogue's workspace) is made before the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): HBM
# bytes/s and operations/s by the inputs' type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops=0.0, kind="f32"):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the type's peak rate."""
    b = n_bytes / HBM_BYTES_S * 1e3
    o = ops / PEAK_OPS_S[kind] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


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
        # the argmax epilogue of the predictor's head slice (`argmax_row`
        # and the ptab gather inside the TPU kernel), in B / B8 / B4
        "argmax_gather_gemv": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cuh",
                               "qwen3_tts_tpu/ops/fused_predictor.py:465"),
        "gemv_int8": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cu",
                      "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "gemv_int4": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cu",
                      "qwen3_tts_tpu/ops/fused_talker.py:428"),
        "qmatmul": ("cuda", "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
                    "qwen3_tts_tpu/ops/quant.py:208"),
        # the norm prologue of B / B8 / B4 (`rms2` inside the TPU kernels)
        "rms_norm_gemv": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cu",
                          "qwen3_tts_tpu/ops/fused_talker.py:121"),
        # the qk epilogue of the qkv product (`rms3` + `rope`, and the
        # predictor's KV store) and the silu prologue of the down product
        "qk_rope_gemv": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cuh",
                         "qwen3_tts_tpu/ops/fused_talker.py:126"),
        "silu_gemv": ("cuda", "qwen3_tts_tpu_torch/csrc/gemv.cuh",
                      "qwen3_tts_tpu/ops/fused_talker.py:373"),
        # the predictor's whole frame in one persistent launch
        "predictor_frame": ("cuda",
                            "qwen3_tts_tpu_torch/csrc/predictor_frame.cu",
                            "qwen3_tts_tpu/ops/fused_predictor.py:610"),
        # the talker's whole decode step in one persistent launch
        "talker_step": ("cuda", "qwen3_tts_tpu_torch/csrc/talker_step.cu",
                        "qwen3_tts_tpu/ops/fused_talker.py:428"),
        # the same two kernels' launches on two inputs counted apart by
        # their wrappers (`.launches_int4`, `.launches_wide`): all five
        # predictor weights int4, and 17-32 talker rows
        "predictor_frame_int4": (
            "cuda", "qwen3_tts_tpu_torch/csrc/predictor_frame.cu",
            "qwen3_tts_tpu/ops/fused_predictor.py:610"),
        "talker_step_b17_32": ("cuda",
                               "qwen3_tts_tpu_torch/csrc/talker_step.cu",
                               "qwen3_tts_tpu/ops/fused_talker.py:428"),
        # decode attention and kernel A at a tensor-parallel rank's shapes
        # (phase 12: heads and widths over a model axis of 2), their
        # launches those of the 2-rank path
        "decode_attention_tp": (
            "cuda", "qwen3_tts_tpu_torch/csrc/decode_attention.cu",
            "qwen3_tts_tpu/ops/flash_decode.py:129"),
        "qmatmul_tp": ("cuda", "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
                       "qwen3_tts_tpu/ops/quant.py:208"),
    }

    def __init__(self):
        from qwen3_tts_tpu_torch.tools import mosaic_probe
        self.sources = dict(self.SOURCES)
        for p in mosaic_probe.PROBES:
            # int8_panel launches kernel A (tools/mosaic_probe.py)
            src = "qmatmul.cu" if p.name == "int8_panel" else "probes.cu"
            self.sources[PROBE + p.name] = (
                "cuda", f"qwen3_tts_tpu_torch/csrc/{src}",
                f"tools/mosaic_probe.py:{p.call}")
        self.err = {k: 0.0 for k in self.sources}
        self.ms = {}
        self.plain_ms = {}
        self.library_ms = {}
        self.bound = {}                 # name -> (bound_ms, bound_by)
        self.launches = {}

    def add_launches(self, counts):
        """Counts of one main-path run (each run starts from 0)."""
        for k, v in counts.items():
            self.launches[k] = self.launches.get(k, 0) + v

    def check(self, name, got, want, label, *, rtol=None, atol=None,
              rel=None, quiet=False):
        """f32: allclose(rtol, atol); bf16: relative error <= rel. `quiet`
        logs only a failure; returns (max abs error, relative error)."""
        import torch
        e = abs_err(got, want)
        self.err[name] = max(self.err[name], e)
        r = rel_err(got, want)
        if rel is not None:
            ok = r <= rel
            msg = (f"  {name:16s} {label:44s} max|d|={e:.3e} rel={r:.2e} "
                   f"(<= {rel:g}) {'ok' if ok else 'FAIL'}")
        else:
            ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                atol=atol)
            msg = (f"  {name:16s} {label:44s} max|d|={e:.3e} "
                   f"(rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not quiet or not ok:
            log(msg)
        if not ok:
            fail(f"{name} {label} disagrees with its plain version")
        return e, r

    def line(self):
        out = []
        for name, (route, src, repl) in self.sources.items():
            bound_ms, bound_by = self.bound.get(name, (None, None))
            out.append({"name": name, "route": route, "source": src,
                        "replaces": repl,
                        "launches": self.launches.get(name, 0),
                        "max_abs_err": self.err[name],
                        "ms": self.ms.get(name),
                        "plain_ms": self.plain_ms.get(name),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": self.library_ms.get(name)})
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
    log("[1/12] device")
    log(card)
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"triton {tv}  nvcc {nvcc}  python {sys.version.split()[0]}")
    log(f"  device_count {torch.cuda.device_count()}  "
        f"{torch.cuda.get_device_name(0)}")
    # left at torch's defaults, as the CLI runs: the f32 modules scope TF32
    # off themselves (core/precision.f32_exact)
    log(f"  TF32: float32_matmul_precision "
        f"{torch.get_float32_matmul_precision()!r}, cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from qwen3_tts_tpu_torch.kernels import build
    log("[2/12] build")
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

    log("[3/12] kernels against their plain versions")
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
    wb = randn(1024, 16 * 2048, dtype=torch.bfloat16, scale=0.02)
    for M in (1, 2):
        xb = randn(M, 1024, dtype=torch.bfloat16)
        for qi in (0, 7, 14, 15):
            for epi, name in ((G.EPI_F32_ROUND_DT, "round"),
                              (G.EPI_STORE_DT, "dt")):
                kw = dict(col0=qi * 2048, n=2048, epilogue=epi)
                rec.check("gemv", G.gemv(xb, wb, **kw),
                          G.gemv_plain(xb, wb, **kw),
                          f"predictor head slice @{qi}*2048 M={M} bf16 {name}",
                          rel=8e-3, quiet=qi != 14)
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
    # the stream path's 4096-slot cache with a short live range
    kc, vc = randn(L, 1, 8, 4096, 128, dtype=torch.bfloat16), randn(
        L, 1, 8, 4096, 128, dtype=torch.bfloat16)
    q = randn(1, 16, 128, dtype=torch.bfloat16)
    kn, vn = (randn(1, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    for kv_len, vfrom in ((96, 0), (100, 37), (5, 3), (0, 0)):
        lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        vf = torch.tensor([vfrom], dtype=torch.int32, device=dev)
        rec.check("decode_attention",
                  flash_decode.decode_attention_stacked(q, kc, vc, kn, vn, 1,
                                                        lens, vf),
                  flash_decode.decode_attention_plain(q, kc, vc, kn, vn, 1,
                                                      lens, vf),
                  f"16/8 T=4096 kv_len={kv_len} vfrom={vfrom} bf16/bf16",
                  rel=8e-3)
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

    determinism(randn)

    # Triton passes (bf16 outputs: one bf16 ulp is 2^-8 relative)
    for H in (2048, 1024):
        x, w = randn(1, H), randn(H, dtype=torch.bfloat16)
        rec.check("rms_norm", el.rms_norm(x, w, 1e-6, torch.bfloat16),
                  el.rms_norm_plain(x, w, 1e-6, torch.bfloat16),
                  f"H={H} f32 -> bf16", rel=8e-3)
        rec.check("rms_norm", el.rms_norm(x, w.float(), 1e-6, torch.float32),
                  el.rms_norm_plain(x, w.float(), 1e-6, torch.float32),
                  f"H={H} f32", rtol=1e-4, atol=1e-4)
    argmax_checks(rec, randn)
    phase_kernels_quant(rec, randn)
    phase_kernels_norm(rec, randn)
    phase_kernels_fused(rec, randn)
    phase_kernels_frame(rec)
    phase_kernels_step(rec)
    torch.cuda.synchronize()


def head_case(randn, kind, B):
    """The predictor's head slice at full width for the argmax epilogue:
    slice 1 (1024 x 2048) of a two-slice bf16 head, the final norm as
    prologue; slice 1 holds two tied pairs of columns (u at 300 and 700,
    -u at 1500 and 1800); x row b leans on u (b % 3 == 0), on -u (b % 3 ==
    1) or on neither (random logits, bf16 ties), and row 1 holds an inf
    (NaN logits: code CV). ptab [16, 3584, 1024] bf16, 1024 real rows.
    Returns (kernel, plain, x, weight arguments, norm, ptab, real rows)."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant
    H, CV = 1024, 2048
    w = 0.02 * randn(H, 2 * CV)
    u = 0.3 * randn(H)
    for c, sign in ((300, 1), (700, 1), (1500, -1), (1800, -1)):
        w[:, CV + c] = sign * u
    lean = torch.tensor([(1.0, -1.0, 0.0)[b % 3] for b in range(B)],
                        device=w.device)
    x = randn(B, H) + 2.0 * lean[:, None] * u / u.norm() * H ** 0.5
    if B > 1:
        x[1, 0] = float("inf")
    norm = ((1.0 + 0.1 * randn(H)).bfloat16(), 1e-6)
    ptab = randn(16, 3584, H, dtype=torch.bfloat16)
    if kind == "dense":
        return G.gemv, G.gemv_plain, x, (w.bfloat16(),), norm, ptab, 1024
    if kind == "int8":
        q = quant.quantize(w)
        return (G.gemv_int8, G.gemv_int8_plain, x, (q["q"], q["scale"]),
                norm, ptab, 1024)
    q = quant.quantize_int4(w)
    return (G.gemv_int4, G.gemv_int4_plain, x, (q["q4"], q["m8"],
                                                q["scale"]), norm, ptab, 1024)


def argmax_checks(rec: Record, randn):
    """The head slice's argmax epilogue (`argmax=`, one launch) against its
    plain version at B = 1, 10, 17, 32, dense / int8 / int4 heads, q = 1
    (the gather) and 15 (none): codes and gathered rows exactly
    `argmax_gather_plain` on the launch's own logits; the logits within
    one bf16 ulp (2^-7 of max |plain|) of the plain head slice's, NaN in
    the same rows; codes and rows exactly the plain head slice's where its
    logits decide (the rows leaning on a tied pair: the lower index, a
    real or the bias row; the NaN row: CV, the bias row), and on the
    random rows the plain code or one whose plain logit ties the plain
    maximum within one bf16 ulp; then two launches replayed twice in one
    CUDA graph, the second replay equal to the first (the tickets
    reset). max_abs_err: the logits'."""
    import torch
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import gemv as G
    CV, dev = 2048, torch.device("cuda")
    n = ties = 0
    for kind in ("dense", "int8", "int4"):
        for B in (1, 10, 17, 32):
            fn, plain, x, wargs, norm, ptab, rows = head_case(randn, kind, B)
            kw = dict(col0=CV, n=CV, epilogue=G.EPI_F32_ROUND_DT, norm=norm,
                      dt=torch.bfloat16)
            for q in (1, 15):
                res = {}
                for way in ("kernel", "plain"):
                    codes = torch.zeros(B, 16, dtype=torch.int32, device=dev)
                    xo = None if q == 15 else torch.zeros(B, 1024,
                                                          device=dev)
                    lg = torch.empty(B, CV, device=dev)
                    (fn if way == "kernel" else plain)(
                        x, *wargs, out=lg,
                        argmax=(codes, q, ptab, rows, xo), **kw)
                    res[way] = (codes, xo, lg)
                codes, xo, lg = res["kernel"]
                cp = torch.zeros_like(codes)
                xp = None if xo is None else torch.zeros_like(xo)
                el.argmax_gather_plain(lg, cp, q, ptab, rows, xp)
                same = torch.equal(codes, cp) and (
                    xo is None or torch.equal(xo, xp))
                # the logits (NaN rows aside) within one bf16 ulp of the
                # plain product's: a dropped scale or K partial fails here
                plain_lg = res["plain"][2]
                fin = torch.isfinite(plain_lg).all(-1)
                if not (torch.isnan(lg[~fin]).all()
                        and torch.isnan(plain_lg[~fin]).all()):
                    fail(f"argmax epilogue {kind} B={B} q={q}: the NaN row's "
                         "logits are not NaN in both versions")
                rec.check("argmax_gather_gemv", lg[fin], plain_lg[fin],
                          f"{kind} B={B} q={q} logits", rel=2 ** -7,
                          quiet=True)
                for b in range(B):
                    got_b, want_b = int(codes[b, q]), int(res["plain"][0][b, q])
                    want = CV if b == 1 and B > 1 else {0: 300, 1: 1500}.get(
                        b % 3)
                    if want is not None:
                        same &= got_b == want_b == want
                    elif got_b != want_b:
                        # a random row: the plain code, or one whose plain
                        # logit ties the plain maximum within one bf16 ulp
                        ties += 1
                        same &= bool(plain_lg[b, got_b] >= plain_lg[b, want_b]
                                     - 2 ** -7 * plain_lg[b, want_b].abs())
                        continue
                    if xo is not None:
                        same &= torch.equal(xo[b], res["plain"][1][b])
                if not same:
                    fail(f"argmax epilogue {kind} B={B} q={q} disagrees "
                         "with its plain version")
                n += 1
    # two launches in one CUDA graph, replayed twice
    fn, _, x, wargs, norm, ptab, rows = head_case(randn, "int4", 10)
    kw = dict(col0=CV, n=CV, epilogue=G.EPI_F32_ROUND_DT, norm=norm,
              dt=torch.bfloat16)
    x0 = x.clone()
    codes = torch.zeros(10, 16, dtype=torch.int32, device=dev)

    def launches():
        fn(x, *wargs, argmax=(codes, 3, ptab, rows, x), **kw)
        fn(x, *wargs, argmax=(codes, 4, ptab, rows, None), **kw)

    launches()
    want = (codes.clone(), x.clone())
    # the capture stream's workspace is made (and zeroed) by a launch on
    # it before the capture, so no replay starts with a captured memset
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        launches()
    for _ in range(2):
        x.copy_(x0)
        codes.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not (torch.equal(codes, want[0]) and torch.equal(x, want[1])):
            fail("argmax epilogue: a graph replay differs from the eager "
                 "launches (tickets not reset)")
    label = f"{n} cases B=1/10/17/32 dense/int8/int4 q=1/15"
    log(f"  {'argmax_gather_gemv':16s} {label:44s} codes and rows exact "
        f"(random rows: {ties} bf16 ties taken apart), logits max|d|="
        f"{rec.err['argmax_gather_gemv']:.3e} (rel <= 2^-7) ok; two graph "
        "replays ok")


def bit_identical(fn) -> bool:
    """fn() twice, and a CUDA graph of fn() replayed twice: equal bits."""
    import torch
    a, b = fn().clone(), fn().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    return all(torch.equal(a, t) for t in (b, *replays))


def determinism(randn):
    """The cluster kernels sum in a fixed order: B, B8, B4 (with and
    without the norm prologue, with the silu prologue and the qk epilogue
    with its KV store) and decode attention at main-path shapes give the
    same bits on a repeat and in graph replays."""
    import torch
    from qwen3_tts_tpu_torch.ops import flash_decode
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    x = randn(2, 2048, dtype=torch.bfloat16)
    w = randn(2048, 12288, dtype=torch.bfloat16, scale=0.02)
    res = randn(1, 1024)
    xp = randn(1, 3072, dtype=torch.bfloat16)
    q8 = quant.quantize(randn(3072, 1024, scale=0.02))
    q = randn(1, 8, 128, dtype=torch.bfloat16)
    kc, vc = randn(2, 1, 8, 32, 128), randn(2, 1, 8, 32, 128)
    kn, vn = (randn(1, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    kt, vt = (randn(2, 1, 8, 4096, 128, dtype=torch.bfloat16)
              for _ in range(2))
    qt = randn(1, 16, 128, dtype=torch.bfloat16)
    lens = torch.tensor([15], dtype=torch.int32, device=dev)
    lens_t = torch.tensor([96], dtype=torch.int32, device=dev)
    vf = torch.zeros(1, dtype=torch.int32, device=dev)
    q4 = quant.quantize_int4(randn(6144, 2048, scale=0.02))
    x4 = randn(2, 6144, dtype=torch.bfloat16)
    res4 = randn(2, 2048)
    xr, ln = randn(1, 2048), randn(2048, dtype=torch.bfloat16)
    q4h = quant.quantize_int4(randn(2048, 4096, scale=0.02))
    nb = dict(norm=(ln, 1e-6), dt=torch.bfloat16)
    calls = {
        "gemv talker gate/up M=2 f32 out": lambda: G.gemv(
            x, w, epilogue=G.EPI_F32),
        "gemv talker gate/up M=1 with the norm": lambda: G.gemv(
            xr, w, epilogue=G.EPI_F32, **nb),
        "gemv_int8 predictor down add into residual": lambda: G.gemv_int8(
            xp, q8["q"], q8["scale"], epilogue=G.EPI_ADD_F32,
            out=res.clone()),
        "gemv_int4 talker down M=2 add into residual": lambda: G.gemv_int4(
            x4, q4["q4"], q4["m8"], q4["scale"], epilogue=G.EPI_ADD_F32,
            out=res4.clone()),
        "gemv_int4 talker qkv M=1 with the norm": lambda: G.gemv_int4(
            xr, q4h["q4"], q4h["m8"], q4h["scale"], **nb),
        "decode_attention predictor bf16 q / f32 cache": lambda:
            flash_decode.decode_attention_stacked(q, kc, vc, kn, vn, 1, lens,
                                                  vf),
        "decode_attention talker T=4096 kv_len=96": lambda:
            flash_decode.decode_attention_stacked(
                qt, kt, vt, kn, vn, 0, lens_t, vf)}
    gu = randn(1, 2 * 3072)
    calls["gemv_int8 predictor down with the silu prologue"] = lambda: \
        G.gemv_int8(gu, q8["q"], q8["scale"], epilogue=G.EPI_ADD_F32,
                    out=res.clone(), act="silu", dt=torch.bfloat16)
    c = qk_case(randn, 1024, 8, 8, torch.bfloat16, 1)
    for kind, fn, _, wargs in c["kinds"]:
        def qk_call(fn=fn, wargs=wargs):
            q_, k_, v_ = fn(c["x"], *wargs, norm=(c["ln"], 1e-6), qk=c["qk"],
                            kv=c["views"], dt=torch.bfloat16)
            return torch.cat([t.flatten().float() for t in (q_, k_, v_)]
                             + [c["cache"].flatten()])
        calls[f"{kind} predictor qkv + qk epilogue + KV store"] = qk_call
    for label, fn in calls.items():
        ok = bit_identical(fn)
        log(f"  {'determinism':16s} {label:44s} repeat + 2 graph replays "
            f"{'bit-identical' if ok else 'DIFFER'}")
        if not ok:
            fail(f"{label}: repeated calls or graph replays differ")


def phase_kernels_quant(rec: Record, randn):
    """A, B8 and B4 against their plain versions at the slice's shapes."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    talker = [(2048, 4096, "qkv"), (2048, 2048, "wo"),
              (2048, 12288, "gate/up"), (6144, 2048, "down"),
              (2048, 2176, "head")]
    phase_kernels_a(rec, randn, talker)

    # B8 / B4: the decode shapes, M = 1, 2, 8, 32, every epilogue; the
    # predictor head's codebook slices
    pred = [(1024, 3072, "qkv"), (1024, 1024, "wo"), (1024, 6144, "gate/up"),
            (3072, 1024, "down")]
    shapes = [("talker " + w, k, n) for k, n, w in talker] + \
        [("predictor " + w, k, n) for k, n, w in pred]
    for what, K, N in shapes:
        w = randn(K, N, scale=0.02)
        q8, q4 = quant.quantize(w), quant.quantize_int4(w)
        kinds = (("gemv_int8", G.gemv_int8, G.gemv_int8_plain,
                  (q8["q"], q8["scale"])),
                 ("gemv_int4", G.gemv_int4, G.gemv_int4_plain,
                  (q4["q4"], q4["m8"], q4["scale"])))
        for name, fn, plain, wargs in kinds:
            e32 = r16 = 0.0
            for M in (1, 2, 8, 32):
                x32, res = randn(M, K), randn(M, N)
                for epi in (G.EPI_STORE_DT, G.EPI_F32, G.EPI_F32_ROUND_DT,
                            G.EPI_ADD_F32):
                    out = (lambda: res.clone()) if epi == G.EPI_ADD_F32 \
                        else (lambda: None)
                    for x, dt in ((x32, "f32"), (x32.bfloat16(), "bf16")):
                        got = fn(x, *wargs, epilogue=epi, out=out())
                        want = plain(x, *wargs, epilogue=epi, out=out())
                        label = f"{what} {K}x{N} M={M} epi{epi} {dt}"
                        if dt == "f32":
                            e, _ = rec.check(name, got, want, label,
                                             rtol=1e-4, atol=1e-4, quiet=True)
                            e32 = max(e32, e)
                        else:
                            _, r = rec.check(name, got, want, label,
                                             rel=8e-3, quiet=True)
                            r16 = max(r16, r)
            log(f"  {name:16s} {what + f' {K}x{N}':30s} M=1,2,8,32 x 4 "
                f"epilogues: f32 max|d|={e32:.3e} (rtol/atol 1e-4), bf16 "
                f"rel={r16:.2e} (<= 0.008) ok")
    w = randn(1024, 16 * 2048, scale=0.02)
    q8, q4 = quant.quantize(w), quant.quantize_int4(w)
    r8 = r4 = 0.0
    for M in (1, 2, 8, 32):
        x = randn(M, 1024, dtype=torch.bfloat16)
        for qi in (0, 7, 15):
            for epi in (G.EPI_F32_ROUND_DT, G.EPI_STORE_DT):
                kw = dict(col0=qi * 2048, n=2048, epilogue=epi)
                label = f"pred head @{qi}*2048 M={M} epi{epi} bf16"
                r8 = max(r8, rec.check(
                    "gemv_int8", G.gemv_int8(x, q8["q"], q8["scale"], **kw),
                    G.gemv_int8_plain(x, q8["q"], q8["scale"], **kw),
                    label, rel=8e-3, quiet=True)[1])
                r4 = max(r4, rec.check(
                    "gemv_int4",
                    G.gemv_int4(x, q4["q4"], q4["m8"], q4["scale"], **kw),
                    G.gemv_int4_plain(x, q4["q4"], q4["m8"], q4["scale"],
                                      **kw),
                    label, rel=8e-3, quiet=True)[1])
    log(f"  gemv_int8/int4   predictor head 1024x32768 slices @0,7,15 x "
        f"2048, M=1,2,8,32, bf16: rel {r8:.2e} / {r4:.2e} (<= 0.008) ok")


A_ROWS = (1, 37, 64, 128, 192, 1088)   # kernel A's M: B x the 64-token
#                                        bucket (B = 1-3, 17), one, ragged


def phase_kernels_a(rec: Record, randn, talker):
    """Kernel A against its plain version: the talker's int8 prefill
    products (qkv, wo, gate/up, down, head) at every M of A_ROWS, x in bf16
    and f32 (f32 out from bf16 inputs, exact products: rtol = atol =
    1e-4); a column view of a wider weight (row stride > N, as a head
    slice); a repeat and two CUDA-graph replays bit-identical at M = 64 and
    1088 (the cluster sums its K ranks in rank order)."""
    import torch
    from qwen3_tts_tpu_torch.ops import quant

    for K, N, what in talker:
        qw = quant.quantize(randn(K, N, scale=0.02))
        err = 0.0
        for M in A_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = randn(M, K, dtype=dt)
                e, _ = rec.check(
                    "qmatmul", quant.qmatmul_kernel(x, qw["q"], qw["scale"]),
                    quant.qmatmul_kernel_plain(x, qw["q"], qw["scale"]),
                    f"talker {what} {K}x{N} M={M} x {str(dt)[6:]}",
                    rtol=1e-4, atol=1e-4, quiet=True)
                err = max(err, e)
        same = all(bit_identical(
            lambda x=randn(M, K, dtype=torch.bfloat16): quant.qmatmul_kernel(
                x, qw["q"], qw["scale"])) for M in (64, 1088))
        plans = ", ".join(f"M={M}: {quant.qmatmul_plan(M, K, N)}"
                          for M in (64, 1088))
        log(f"  qmatmul          talker {what} {K}x{N}, M={A_ROWS}, x bf16 "
            f"/ f32: max|d|={err:.3e} (rtol/atol 1e-4) ok; repeat + 2 graph "
            f"replays {'bit-identical' if same else 'DIFFER'} ({plans})")
        if not same:
            fail(f"qmatmul talker {what}: repeats or graph replays differ")
    wide = quant.quantize(randn(2048, 4096, scale=0.02))
    q, sc = wide["q"][:, 1024:1024 + 2176], wide["scale"][1024:1024 + 2176]
    for M in (1, 64, 300):
        x = randn(M, 2048, dtype=torch.bfloat16)
        rec.check("qmatmul", quant.qmatmul_kernel(x, q, sc),
                  quant.qmatmul_kernel_plain(x, q, sc),
                  f"column view 2048x2176 of 4096 M={M}", rtol=1e-4,
                  atol=1e-4)


def phase_kernels_norm(rec: Record, randn):
    """B, B8 and B4 with the rms norm as their prologue (x the f32
    residual) against rms_norm_plain + the plain product, at the talker's
    and the predictor's normed products (qkv, gate/up, the predictor head's
    slices) and M = 1, 2, 8; bf16 relative error, f32 allclose."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    shapes = [("talker qkv", 2048, 4096, G.EPI_STORE_DT, None),
              ("talker gate/up", 2048, 12288, G.EPI_F32, None),
              ("predictor qkv", 1024, 3072, G.EPI_STORE_DT, None),
              ("predictor gate/up", 1024, 6144, G.EPI_F32, None),
              ("predictor head slice", 1024, 16 * 2048, G.EPI_F32_ROUND_DT,
               (0, 7, 15))]
    for what, K, N, epi, slices in shapes:
        w32 = randn(K, N, scale=0.02)
        q8, q4 = quant.quantize(w32), quant.quantize_int4(w32)
        e32 = r16 = 0.0
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            kinds = (("gemv", G.gemv, G.gemv_plain, (w32.to(dt),)),
                     ("gemv_int8", G.gemv_int8, G.gemv_int8_plain,
                      (q8["q"], q8["scale"])),
                     ("gemv_int4", G.gemv_int4, G.gemv_int4_plain,
                      (q4["q4"], q4["m8"], q4["scale"])))
            ln = (1.0 + 0.1 * randn(K)).to(dt)
            for M in (1, 2, 8):
                x = randn(M, K)
                for qi in slices or (None,):
                    kw = dict(epilogue=epi, norm=(ln, 1e-6), dt=dt)
                    if qi is not None:
                        kw.update(col0=qi * 2048, n=2048)
                    for kind, fn, plain, wargs in kinds:
                        got = fn(x, *wargs, **kw)
                        want = plain(x, *wargs, **kw)
                        label = f"{kind} {what} {K}x{N} M={M} {dname}"
                        if dt == torch.float32:
                            e32 = max(e32, rec.check(
                                "rms_norm_gemv", got, want, label,
                                rtol=1e-4, atol=1e-4, quiet=True)[0])
                        else:
                            r16 = max(r16, rec.check(
                                "rms_norm_gemv", got, want, label, rel=8e-3,
                                quiet=True)[1])
        log(f"  {'rms_norm_gemv':16s} {what + f' {K}x{N}':30s} B/B8/B4, "
            f"M=1,2,8: f32 max|d|={e32:.3e} (rtol/atol 1e-4), bf16 "
            f"rel={r16:.2e} (<= 0.008) ok")


def qk_case(randn, K, nq, nk, dt, M, L=2, T=16, slot=5):
    """A qkv product with the qk epilogue at hd 128: the f32 residual x,
    ln1, the weights of B, B8 and B4 (`(name, fn, plain, wargs)`), the qk
    tuple, and an [2, L, M, nk, T, 128] f32 cache whose (last layer, slot)
    views are the KV store's target."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    hd = 128
    w32 = randn(K, (nq + 2 * nk) * hd, scale=0.02)
    q8, q4 = quant.quantize(w32), quant.quantize_int4(w32)
    kinds = (("gemv", G.gemv, G.gemv_plain, (w32.to(dt),)),
             ("gemv_int8", G.gemv_int8, G.gemv_int8_plain,
              (q8["q"], q8["scale"])),
             ("gemv_int4", G.gemv_int4, G.gemv_int4_plain,
              (q4["q4"], q4["m8"], q4["scale"])))
    qk = ((1.0 + 0.1 * randn(hd)).to(dt), (1.0 + 0.1 * randn(hd)).to(dt),
          randn(M, hd), randn(M, hd), nq, nk, 1e-6)
    cache = randn(2, L, M, nk, T, hd)
    views = (cache[0, -1, :, :, slot], cache[1, -1, :, :, slot])
    return dict(x=randn(M, K), ln=(1.0 + 0.1 * randn(K)).to(dt), kinds=kinds,
                qk=qk, cache=cache, views=views, slot=slot)


def phase_kernels_fused(rec: Record, randn):
    """The qk epilogue (B, B8, B4 at the talker's qkv 2048x4096, 16/8 heads,
    and the predictor's 1024x3072, 8/8, with the KV store into a strided f32
    cache view) and the silu prologue (the talker's down 6144x2048 and the
    predictor's 3072x1024, added into the residual) against their plain
    fused products, M = 1, 2, 8, f32 and bf16: f32 allclose (rtol/atol
    1e-4), bf16 relative error <= 8e-3 (phase_kernels_norm's tolerances);
    the cache's slot p equal to the launch's own k / v as f32, every other
    slot bit-unchanged."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    def check(name, got, want, label, dt):
        if dt == torch.float32:
            return rec.check(name, got, want, label, rtol=1e-4, atol=1e-4,
                             quiet=True)
        return rec.check(name, got, want, label, rel=8e-3, quiet=True)

    for what, K, nq, nk, kv in (("talker qkv", 2048, 16, 8, False),
                                ("predictor qkv", 1024, 8, 8, True)):
        e32 = r16 = 0.0
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for M in (1, 2, 8):
                c = qk_case(randn, K, nq, nk, dt, M)
                for kind, fn, plain, wargs in c["kinds"]:
                    outs = []
                    for f in (fn, plain):
                        cache = c["cache"].clone()
                        views = (cache[0, -1, :, :, c["slot"]],
                                 cache[1, -1, :, :, c["slot"]]) if kv else None
                        outs.append((f(c["x"], *wargs, norm=(c["ln"], 1e-6),
                                       qk=c["qk"], kv=views, dt=dt), cache))
                    (got, cache), (want, _) = outs
                    for part, a, b in zip("qkv", got, want):
                        e, r = check("qk_rope_gemv", a, b,
                                     f"{kind} {what} M={M} {part} {dname}",
                                     dt)
                        e32, r16 = (max(e32, e), r16) \
                            if dt == torch.float32 else (e32, max(r16, r))
                    if kv:
                        slot = cache[:, -1, :, :, c["slot"]].clone()
                        if not torch.equal(slot, torch.stack(
                                [got[1], got[2]]).float()):
                            fail(f"{kind} {what} M={M} {dname}: the KV "
                                 "store's slot differs from the launch's k/v")
                        cache[:, -1, :, :, c["slot"]] = \
                            c["cache"][:, -1, :, :, c["slot"]]
                        if not torch.equal(cache, c["cache"]):
                            fail(f"{kind} {what} M={M} {dname}: the KV "
                                 "store wrote outside its slot")
        shape = f"{what} {K}x{(nq + 2 * nk) * 128}"
        store = ", KV store" if kv else ""
        log(f"  {'qk_rope_gemv':16s} {shape:30s} B/B8/B4, M=1,2,8{store}: "
            f"f32 max|d|={e32:.3e} (rtol/atol 1e-4), bf16 rel={r16:.2e} "
            f"(<= 0.008)"
            f"{'; slot p = k/v, other slots unchanged' if kv else ''} ok")

    for what, K, N in (("talker down", 6144, 2048),
                       ("predictor down", 3072, 1024)):
        w32 = randn(K, N, scale=0.02)
        q8, q4 = quant.quantize(w32), quant.quantize_int4(w32)
        e32 = r16 = 0.0
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            kinds = (("gemv", G.gemv, G.gemv_plain, (w32.to(dt),)),
                     ("gemv_int8", G.gemv_int8, G.gemv_int8_plain,
                      (q8["q"], q8["scale"])),
                     ("gemv_int4", G.gemv_int4, G.gemv_int4_plain,
                      (q4["q4"], q4["m8"], q4["scale"])))
            for M in (1, 2, 8):
                gu, res = randn(M, 2 * K, scale=2.0), randn(M, N)
                kw = dict(epilogue=G.EPI_ADD_F32, act="silu", dt=dt)
                for kind, fn, plain, wargs in kinds:
                    e, r = check("silu_gemv",
                                 fn(gu, *wargs, out=res.clone(), **kw),
                                 plain(gu, *wargs, out=res.clone(), **kw),
                                 f"{kind} {what} {K}x{N} M={M} {dname}", dt)
                    e32, r16 = (max(e32, e), r16) \
                        if dt == torch.float32 else (e32, max(r16, r))
        log(f"  {'silu_gemv':16s} {what + f' {K}x{N}':30s} B/B8/B4, "
            f"M=1,2,8: f32 max|d|={e32:.3e} (rtol/atol 1e-4), bf16 "
            f"rel={r16:.2e} (<= 0.008) ok")


def frame_case(cfg, kind, B, seed, peak=False):
    """Seeded predictor weights of `cfg` on the card (dense, or int8 / int4
    as `quant.quantize_decoder_params` makes them), random assets, their
    ptab, h1024 [B, H] and code_0 [B] (some out of range, some negative);
    `peak` makes the head decisive (`peak_head`). Returns (params, assets,
    ptab, ptab rows, h1024, code_0)."""
    import torch
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import fused_predictor, quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    pp = decoder.init_decoder(g, cfg, device=dev)
    if peak:
        pp = peak_head(pp, [(q * P.CODE_VOCAB, P.CODE_VOCAB)
                            for q in range(P.NUM_CODEBOOKS)], seed=seed)
    if kind != "dense":
        pp = quant.quantize_decoder_params(pp, kind=kind)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                                  proj_dim=cfg.hidden, device=dev)
    ptab, rows = fused_predictor.make_ptab(assets, cfg)
    h = torch.randn(B, cfg.hidden, generator=g, device=dev)
    code0 = torch.randint(-3, 2300, (B,), generator=g, device=dev)
    return pp, assets, ptab, rows, h, code0


# the small int4-capable width of the f32 checks (widths in whole pairs of
# 128-row groups), as tests/test_torch_kernels.py and the JAX package's
# own int4 test take it
SMALL4 = dict(hidden=256, n_q_heads=2, n_kv_heads=2, head_dim=128,
              ffn_dim=256)


class LogitsRecorder:
    """An op set (`ops/chain.py`) that keeps the logits of each head slice
    the frame's argmax reads, in order (code q's at q - 1): a product with
    the argmax epilogue stores its logits too."""

    def __init__(self, ops):
        self.ops, self.logits = ops, []

    def __getattr__(self, name):
        fn = getattr(self.ops, name)
        if not name.startswith("gemv"):
            return fn

        def call(x, *args, **kw):
            if kw.get("argmax") is None:
                return fn(x, *args, **kw)
            import torch
            lg = torch.empty(x.shape[0], kw["n"], device=x.device)
            fn(x, *args, **dict(kw, out=lg))
            self.logits.append(lg.clone())
        return call


def plain_tie(got, plains):
    """Where the plain version on the card and on the CPU disagree with
    each other (f32 sums in another order), the kernel's codes `got` must
    equal one of them, and the other's first differing code must be a tie
    in its own logits (relative 1e-6: a last-bit difference decides which
    of two equal maxima wins). `plains`: (codes, LogitsRecorder) on the
    card and on the CPU. Returns a description of the tie, or None."""
    import torch
    if torch.equal(plains[0][0].cpu(), plains[1][0].cpu()):
        return None
    for (mine, _), (other, logits) in ((plains[0], plains[1]),
                                       (plains[1], plains[0])):
        if not torch.equal(got.cpu(), mine.cpu()):
            continue
        b, q = (got.cpu() != other.cpu()).nonzero()[0].tolist()
        lg = logits.logits[q - 1][b].cpu()
        a, w = int(got[b, q]), int(other[b, q])
        if abs(float(lg[a] - lg[w])) <= 1e-6 * abs(float(lg[w])):
            return (f"row {b} code {q}: the other plain version's logits "
                    f"tie, {float(lg[w])!r} at {w} and {float(lg[a])!r} at "
                    f"{a}")
    return None


def frame_residual(fp, cfg, h, int4):
    """The f32 residual after the last pass of the frame kernel's launch
    on h1024 `h` (its workspace's `xres`, kept per device as the wrapper
    keys it, h's; the next launch overwrites it)."""
    import torch
    B, dev = h.shape[0], h.device
    t_bytes = 4 if cfg.dtype == "float32" else 2
    with torch.cuda.device(dev):
        nb = fp._plan(cfg, B, t_bytes, int4, dev)[1]
        return fp._workspace(cfg, B, nb, dev)["xres"].clone()


def phase_kernels_frame(rec: Record):
    """The predictor frame kernel (`csrc/predictor_frame.cu`) against its
    plain version `frame_codes_fused_plain`: the tiny f32 config's codes
    equal on the card and to the CPU's, B = 1, 2, 3, 16; all five weights
    int4 at the small int4 f32 width (hidden 256, 2/2 heads of 128, ffn
    256), B = 1, 2, 3, 16: codes equal on the card and to the CPU's, the
    residual after the last pass rtol/atol 1e-4 against the plain chain's;
    the tiny f32 config at B = 3 with a NaN head column: codes equal to
    the plain version's (code 14 CV, pass 15 from the bias row); at full
    width with peaked heads, code agreement >= 0.95 for dense bf16,
    int8 and int4 weights at B = 1, 2, 16 (bf16 sums in another order may
    flip a near tie); repeats bit-identical, at B = 2 also two CUDA-graph
    replays of the cooperative launch. max_abs_err: the largest |kernel -
    plain| over every case, codes and residuals (the int4 cases under
    `predictor_frame_int4`)."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.ops import chain
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp

    tiny = tiny_engine_config().predictor
    small4 = dataclasses.replace(tiny, mrope_sections=(64, 0, 0, 0),
                                 **SMALL4)
    full = EngineConfig().predictor

    def codes_err(got, want, kind="dense"):
        e = abs_err(got, want)
        name = "predictor_frame_int4" if kind == "int4" else \
            "predictor_frame"
        rec.err[name] = max(rec.err[name], e)
        return e

    for cfg, kind, what in ((tiny, "dense", "tiny f32"),
                            (small4, "int4", "small f32 int4")):
        name = "predictor_frame_int4" if kind == "int4" else \
            "predictor_frame"
        for B in (1, 2, 3, 16):
            pp, _, ptab, rows, h, c0 = frame_case(cfg, kind, B, 60 + B)
            got = fp.predictor_frame_kernel(pp, cfg, ptab, rows, h, c0)
            res = frame_residual(fp, cfg, h, kind == "int4")
            plains = []
            for dev in ("cuda", "cpu"):
                ops = LogitsRecorder(chain.PLAIN)
                r = torch.empty(res.shape, device=dev)
                codes = fp._frame(ops, _to(pp, dev), cfg, ptab.to(dev), rows,
                                  h.to(dev), c0.to(dev), residual=r)
                plains.append((codes, ops, r))
            (want, _, want_res), (cpu, _, cpu_res) = plains
            codes_err(got, want, kind)
            same = torch.equal(got, want) and torch.equal(got.cpu(), cpu)
            # the int4 cases also take a tie that the two plain versions
            # break differently (`plain_tie`); the tiny f32 check is exact
            tie = None if same or kind != "int4" else \
                plain_tie(got, [p[:2] for p in plains])
            log(f"  {'predictor_frame':16s} {f'{what} B={B}':44s} codes "
                f"{'equal' if same else 'DIFFER'} to the plain version on "
                "the card and on the CPU" + (f"; {tie}, the kernel's equal "
                                             "to the other's" if tie else ""))
            if not same and tie is None:
                fail(f"predictor_frame {what} B={B}: codes differ from the "
                     "plain version")
            ref = want_res if torch.equal(got, want) else cpu_res.cuda()
            rec.check(name, res, ref,
                      f"{what} B={B} residual after the last pass",
                      rtol=1e-4, atol=1e-4)
    # a NaN head column (slice 13, column 100) at the tiny f32 config: every
    # row's code 14 is CV (JAX's argmax_row) and pass 15 takes the bias row;
    # codes exact against the plain version on the card and on the CPU
    CV = 2048
    pp, _, ptab, rows, h, c0 = frame_case(tiny, "dense", 3, 63)
    head = pp["head"].clone()
    head[:, 13 * CV + 100] = float("nan")
    pp = dict(pp, head=head)
    got = fp.predictor_frame_kernel(pp, tiny, ptab, rows, h, c0)
    want = fp.frame_codes_fused_plain(pp, tiny, ptab, rows, h, c0)
    cpu = fp.frame_codes_fused_plain(_to(pp, "cpu"), tiny, ptab.cpu(), rows,
                                     h.cpu(), c0.cpu())
    codes_err(got, want)
    same = torch.equal(got, want) and torch.equal(got.cpu(), cpu) and bool(
        (got[:, 14] == CV).all() and (got[:, 15] != CV).all())
    log(f"  {'predictor_frame':16s} {'tiny f32 B=3, a NaN head column':44s} "
        f"codes {'equal' if same else 'DIFFER'} to the plain version on the "
        "card and on the CPU, code 14 CV in every row")
    if not same:
        fail("predictor_frame: with a NaN head column the codes differ from "
             "the plain version (CV, then the bias row)")
    for kind in ("dense", "int8", "int4"):
        for B in (1, 2, 16):
            pp, _, ptab, rows, h, c0 = frame_case(full, kind, B, 70 + B,
                                                  peak=True)

            def call(pp=pp, ptab=ptab, rows=rows, h=h, c0=c0):
                return fp.predictor_frame_kernel(pp, full, ptab, rows, h, c0)
            got = call()
            want = fp.frame_codes_fused_plain(pp, full, ptab, rows, h, c0)
            agree = float((got == want).float().mean())
            e = codes_err(got, want, kind)
            # the cooperative launch captures: at B = 2 also two replays
            same = bit_identical(call) if B == 2 else \
                torch.equal(got, call())
            graph = ", 2 graph replays" if B == 2 else ""
            log(f"  {'predictor_frame':16s} {f'full {kind} B={B} peaked':44s}"
                f" code agreement {agree:.4f} (gate 0.95), max|d| {e:g}; "
                f"repeat{graph} {'bit-identical' if same else 'DIFFER'}")
            if agree < 0.95:
                fail(f"predictor_frame full {kind} B={B}: agreement "
                     f"{agree:.4f} < 0.95")
            if not same:
                fail(f"predictor_frame full {kind} B={B}: repeats differ")
            del pp


# bf16 relative error limit of the talker step at full width and depth
# (28 layers), against its plain version. On an NVIDIA H100 80GB HBM3
# (PERF.md) the kernel is 7.1e-3-2.05e-2 from the plain version there and
# the chain 8.6e-3-2.3e-2 (B = 1, 2, 16; T = 256, 4096; each weight kind):
# bf16 roundings of the products' inputs flip with the order of the f32
# sums and 28 layers carry them on; cut to 2 layers they stay within 8e-3.
# The plain step without its last layer, the control, is 0.146-0.241.
FULL_DEPTH_REL = 3e-2


def last_layer_dropped(params, cfg):
    """A decoder's params and config without its last layer."""
    return first_layers(params, cfg, cfg.n_layers - 1)


def drop_last_layer(tp, cfg, inputs):
    """The control of the full-depth limit: the same step's params, config
    and inputs with the talker's last layer cut off (its five stages)."""
    L = cfg.n_layers - 1
    x, pos, slot, kv_len, vf, kc, vc = inputs
    return (*last_layer_dropped(tp, cfg),
            (x, pos, slot, kv_len, vf, kc[:L].clone(), vc[:L].clone()))


def step_check(rec, label, cfg, tp, inputs, tol, control=False):
    """One talker step through the kernel against its plain version on the
    same inputs: hidden, logits and the cache slot written within `tol`
    (f32 rtol/atol, or bf16 relative error `rel`), every other slot
    bit-unchanged. With `control` (bf16 at full depth) it also logs the
    chain's relative error to the plain version on the same inputs, and
    fails unless the plain step without its last layer is further from the
    plain version than `rel`: the limit tells a dropped stage from
    rounding."""
    import torch
    from qwen3_tts_tpu_torch.ops import chain
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    x, pos, slot, kv_len, vf, kc, vc = inputs
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    sl = slot.long()
    kk, kv = kc.clone(), vc.clone()
    h, lg, _, _ = ft.talker_step_kernel(tp, cfg, x, pos, slot, kv_len, vf,
                                        kk, kv)
    got_slots = []
    for name, got, orig in (("k", kk, kc), ("v", kv, vc)):
        got_slots.append(got[:, rows, :, sl].clone())
        got[:, rows, :, sl] = orig[:, rows, :, sl]
        if not torch.equal(got, orig):
            fail(f"talker_step {label}: the step wrote {name} outside its "
                 "slot")
    del kk, kv
    ch = ctl = None
    if control:
        ch = ft._step(chain.KERNELS, tp, cfg, x, pos, slot, kv_len, vf,
                      kc.clone(), vc.clone())[:2]
        tp_c, cfg_c, in_c = drop_last_layer(tp, cfg, inputs)
        ctl = ft.talker_step_fused_plain(tp_c, cfg_c, *in_c)[:2]
        del tp_c, in_c
    ph, pl, _, _ = ft.talker_step_fused_plain(tp, cfg, x, pos, slot, kv_len,
                                              vf, kc, vc)
    want_slots = [kc[:, rows, :, sl], vc[:, rows, :, sl]]
    name = "talker_step_b17_32" if B > ft.WIDE_B else "talker_step"
    for what, a, b in (("hidden", h, ph), ("logits", lg, pl),
                       ("k slot", got_slots[0], want_slots[0]),
                       ("v slot", got_slots[1], want_slots[1])):
        rec.check(name, a, b, f"{label} {what}",
                  quiet=what.endswith("slot"), **tol)
    if not control:
        return
    for what, c, d, b in (("hidden", ch[0], ctl[0], ph),
                          ("logits", ch[1], ctl[1], pl)):
        rc, rd = rel_err(c, b), rel_err(d, b)
        ok = rd > tol["rel"]
        log(f"  {'talker_step':16s} {label + ' ' + what:44s} the chain's "
            f"rel={rc:.2e}; control (plain, last layer dropped) "
            f"rel={rd:.2e} (> {tol['rel']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"talker_step {label} {what}: the full-depth limit does not "
                 "tell a dropped layer from rounding")


def phase_kernels_step(rec: Record):
    """The talker step kernel (`csrc/talker_step.cu`) against its plain
    version `talker_step_fused_plain` (`step_check`), at B = 1, 2 and 16,
    ~100 live slots of a 256-slot window and >= 2048 of a 4096-slot cache
    (a small f32 talker: 300 of 512), and at B = 17, 24 and MAX_B (32) with
    the 1024-slot window (~700 live) and the 4096-slot cache (the full f32
    group the window alone: its 4096-slot cache would not fit beside its
    copies; the tiny and small talkers their 512 slots):

      * f32, rtol/atol 1e-4: the tiny config (dense, int8), the small
        int4-capable talker (int4), and the full width AND depth (28 x
        2048, 16/8 heads of 128, ffn 6144, head 2176) for dense, int8 and
        int4;
      * bf16 at the full width, depth cut to 2 layers, relative error <=
        8e-3 (dense, int8, int4);
      * bf16 at the full width and depth (dense, int8, int4), relative
        error <= FULL_DEPTH_REL (3e-2), with the chain's own error logged
        beside it and a control that must exceed the limit (the plain step
        without its last layer; `step_check`).

    Repeats and two CUDA-graph replays bit-identical to the eager call.
    Rows past 16 count as `talker_step_b17_32` in max_abs_err."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.tools import frame_measure as fm

    tiny = tiny_engine_config().talker
    small4 = dataclasses.replace(tiny, mrope_sections=(32, 16, 16, 0),
                                 **SMALL4)
    full = EngineConfig().talker
    full32 = dataclasses.replace(full, dtype="float32")
    f32 = dict(rtol=1e-4, atol=1e-4)
    batches = (1, 2, ft.WIDE_B, 17, 24, ft.MAX_B)
    windows = ((256, 100), (4096, 2100))
    wide = ((1024, 700), (4096, 2100))
    kinds = ("dense", "int8", "int4")
    # (label, config, kinds, windows at B <= 16, at B > 16, tolerance,
    # control)
    groups = [("tiny f32", tiny, ("dense", "int8"), ((512, 100),),
               ((512, 100),), f32, False),
              ("small f32", small4, ("int4",), ((512, 300),), ((512, 300),),
               f32, False),
              ("full f32", full32, kinds, windows, wide[:1], f32, False),
              ("full bf16 2 layers", dataclasses.replace(full, n_layers=2),
               kinds, windows, wide, dict(rel=8e-3), False),
              ("full bf16", full, kinds, windows, wide,
               dict(rel=FULL_DEPTH_REL), True)]
    gb = 2 * full.n_layers * ft.MAX_B * full.n_kv_heads * 4096 \
        * full.head_dim * 4 / 1e9
    log(f"  {'talker_step':16s} full f32 at B > {ft.WIDE_B}: the 1024-slot "
        f"window only (a 4096-slot f32 cache is {gb:.1f} GB at B = "
        f"{ft.MAX_B}, and the check holds two, beside the f32 weights and "
        "the kernel's copies of them)")
    # seeds: B <= 16 the sequence they always had, B > 16 a stream of
    # their own
    seed, wide_seed = 100, 1000
    for what, cfg, kinds, wins, wins_wide, tol, control in groups:
        for kind in kinds:
            seed += 10
            tp = fm.step_weights(cfg, kind, seed)
            for B in batches:
                for T, live in wins if B <= ft.WIDE_B else wins_wide:
                    if B <= ft.WIDE_B:
                        seed += 1
                    else:
                        wide_seed += 1
                    inputs = fm.step_inputs(cfg, B, T, live,
                                            seed if B <= ft.WIDE_B
                                            else wide_seed)
                    label = f"{what} {kind} B={B} T={T} live~{live}"
                    step_check(rec, label, cfg, tp, inputs, tol, control)
                    x, pos, slot, kv_len, vf, kc, vc = inputs

                    def out(tp=tp, cfg=cfg, inputs=inputs):
                        hh, ll, _, _ = ft.talker_step_kernel(tp, cfg, *inputs)
                        return torch.cat([hh.float().flatten(),
                                          ll.flatten()])
                    same = bit_identical(out)
                    log(f"  {'talker_step':16s} {label:44s} slot k/v ok, "
                        f"other slots unchanged; repeat, 2 graph replays "
                        f"{'bit-identical' if same else 'DIFFER'}")
                    if not same:
                        fail(f"talker_step {label}: repeats differ")
                    del inputs, kc, vc
            del tp
            torch.cuda.empty_cache()


def phase_probes(rec: Record, card: str):
    """The probe tool's path and its eight kernels against their plain
    versions."""
    import torch
    from qwen3_tts_tpu_torch.tools import mosaic_probe as mp

    log("[4/12] probes: python -m qwen3_tts_tpu_torch.tools.mosaic_probe "
        "--device cuda, then each kernel against its plain version")
    torch.cuda.synchronize()
    mp.reset_launch_counts()
    rc = mp.main(["--device", "cuda"])
    torch.cuda.synchronize()
    counts = {PROBE + k: v for k, v in mp.launch_counts().items()}
    rec.add_launches(counts)
    log(f"  the tool: exit {rc}, launches {json.dumps(counts)}")
    if rc != 0:
        fail("mosaic_probe --device cuda printed FAIL")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"the probe tool never launched: {missing}")

    dev = torch.device("cuda")
    inputs = mp.probe_inputs(dev, seed=1)        # other draws than the tool's
    for p in mp.PROBES:
        args = inputs[p.name]
        got, want = p.kernel(*args), p.plain(*args)
        torch.cuda.synchronize()
        ok, err = mp.agree(p, got, want)
        name = PROBE + p.name
        rec.err[name] = err
        tol = "equal" if p.exact \
            else f"<= {mp.PANEL_REL_TOL:g} x max|plain|, exact products"
        log(f"  {name:22s} {str(tuple(got.shape)):12s} max|d|={err:.3e} "
            f"({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} disagrees with its plain version")
        try:
            p.check(got, *args)
        except mp.ProbeFailed as e:
            fail(f"{name}: the TPU probe's own check failed: {e}")

    # indices outside the range: zero rows for one-hot codes, device-held
    # starts taken as lax.dynamic_slice takes them
    codes = torch.tensor([[3], [-1], [256], [255], [1000], [0], [-7], [4]],
                         dtype=torch.int32, device=dev).expand(8, 128)
    edge = [("onehot", mp.onehot, mp.onehot_plain,
             (codes.contiguous(), inputs["onehot"][1]))]
    c, w = inputs["dyn_sublane"][0], inputs["dyn_col_dma"][1]
    for v in (-40, -3, 0, 31, 40):
        edge.append((f"dyn_sublane pos={v}", mp.dyn_sublane,
                     mp.dyn_sublane_plain,
                     (c, torch.tensor([v], dtype=torch.int32, device=dev))))
    for v in (-9, -1, 0, 3, 5):
        edge.append((f"dyn_col_dma q={v}", mp.dyn_col_dma,
                     mp.dyn_col_dma_plain,
                     (torch.tensor([v], dtype=torch.int32, device=dev), w)))
    for label, fn, plain, args in edge:
        if not torch.equal(fn(*args), plain(*args)):
            fail(f"probe {label}: kernel differs from its plain version")
    log(f"  edge indices: {len(edge)} cases (one-hot codes outside [0, 256), "
        "clamped device-held starts) equal")
    # non-constant inputs: a CTA that copied another slice of a constant
    # tile would still agree; fori_dma at ring-sized and longer loops
    probes = {p.name: p for p in mp.PROBES}
    varied = mp.varied_inputs(dev, seed=3)
    for name, label, args in varied:
        p = probes[name]
        ok, err = mp.agree(p, p.kernel(*args), p.plain(*args))
        rec.err[PROBE + name] = max(rec.err[PROBE + name], err)
        if not ok:
            fail(f"probe {name} ({label}): kernel differs from its plain "
                 f"version, max|d| {err:g}")
    log(f"  varied inputs: {len(varied)} cases ("
        + "; ".join(f"{n} {l}" for n, l, _ in varied) + ") agree")

    # the one PyTorch call of a probe's function, where there is one; none
    # for dyn_sublane and dyn_col_dma (a start read on the device, clamped
    # as lax.dynamic_slice clamps it) and rot (rotate-half negates one
    # half). int8_panel's is torch._weight_int8pack_mm on the panel
    # transposed to [256, 512] once, outside the timed call, with unit
    # scales (as kernel A's yardstick); it returns bf16, not f32
    x8, w8 = inputs["int8_panel"]
    w8t = w8[:, :mp.PANEL_N].t().contiguous()
    ones8 = torch.ones(mp.PANEL_N, dtype=torch.bfloat16, device=dev)
    library = {"hbm_scratch": lambda x: torch.mul(x, 2.0),
               "fori_dma": lambda w: torch.sum(w, 0),
               "argmax": lambda x: torch.argmax(x, -1),
               "onehot": lambda codes, tab: torch.index_select(
                   tab, 0, codes[:, 0]),
               "int8_panel": lambda x, w: torch._weight_int8pack_mm(
                   x, w8t, ones8)}
    log(f"  torch._weight_int8pack_mm (bf16 out) against the plain panel: "
        f"relative error "
        f"{rel_err(library['int8_panel'](x8, w8), mp.int8_panel_plain(x8, w8)):.2e}")
    for p in mp.PROBES:
        args = inputs[p.name]
        name = PROBE + p.name
        rec.ms[name] = graph_ms(lambda: p.kernel(*args))
        rec.plain_ms[name] = graph_ms(lambda: p.plain(*args))
        lib = library.get(p.name)
        rec.library_ms[name] = None if lib is None else graph_ms(
            lambda: lib(*args))
        # each input read once, the output written once; the panel's
        # function reads only the columns it multiplies, w[:, :PANEL_N]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if p.name == "int8_panel":
            ins = [x8, w8[:, :mp.PANEL_N]]
        rec.bound[name] = bound(nbytes(*ins, p.kernel(*args)))
        log(f"  {name:22s} device: kernel {rec.ms[name]:.4f} ms, plain "
            f"{rec.plain_ms[name]:.4f} ms, library "
            f"{_fmt4(rec.library_ms[name])} ms, bound "
            f"{rec.bound[name][0]:.5f} ms ({rec.bound[name][1]}) on {card}")


def quantized_models(models, talker_kind, predictor_kind):
    """The engine's weights quantized as the JAX bench quantizes them
    (`quant.quantize_decoder_params`, on the card); norms, assets shared."""
    from qwen3_tts_tpu_torch.ops import quant
    return {"talker": quant.quantize_decoder_params(models["talker"],
                                                    kind=talker_kind),
            "predictor": quant.quantize_decoder_params(models["predictor"],
                                                       kind=predictor_kind),
            "assets": models["assets"]}


def phase_agree(eng):
    """Teacher-forced kernel-vs-plain agreement at full width, bf16: dense,
    the int4 talker with the int8 predictor, and the int8 talker."""
    from qwen3_tts_tpu_torch.core import protocol as P

    log("[5/12] teacher-forced agreement, full width, bf16, peaked heads")
    pt = peak_head(eng.models["talker"], [(0, P.TALKER_SAMPLE_LIMIT)])
    pp = peak_head(eng.models["predictor"],
                   [(q * P.CODE_VOCAB, P.CODE_VOCAB)
                    for q in range(P.NUM_CODEBOOKS)])
    peaked = {"talker": pt, "predictor": pp,
              "assets": eng.models["assets"]}
    agree_run(eng, peaked, "dense bf16")
    q48 = quantized_models(peaked, "int4", "int8")
    agree_run(eng, q48, "int4 talker + int8 predictor")
    agree_run(eng, {"talker": quantized_models(peaked, "int8", "int8")[
        "talker"]}, "int8 talker", predictor=False)


def agree_run(eng, models, label, predictor=True):
    import torch
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import fused_predictor, fused_talker
    from qwen3_tts_tpu_torch.tts import generate

    cfg = eng.config
    tc, pc = cfg.talker, cfg.predictor
    dev = eng.device
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    pt = models["talker"]

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
        log(f"  {label}: talker step argmax agreement {agree}/{STEPS} = "
            f"{frac_t:.3f} (gate 0.93), max|dlogits| {dmax:.3e}")
        if frac_t < 0.93:
            fail(f"{label}: talker agreement {frac_t:.3f} < 0.93")
        if not predictor:
            return

        ptab, rows = generate.predictor_tables(eng.models, pc)
        pp = models["predictor"]
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
        log(f"  {label}: predictor codes agreement {agree}/{total} = "
            f"{frac_p:.3f} (gate 0.95)")
    if frac_p < 0.95:
        fail(f"{label}: predictor agreement {frac_p:.3f} < 0.95")


# ------------------------------------------------- models/predictor.py
# kernel A's shapes on an int8 predictor (`models/predictor.py`): qkv, wo,
# gate/up and down of EngineConfig().predictor (hidden 1024, 8 + 2 x 8
# heads of 128, ffn 3072)
PREDICTOR_INT8 = [(1024, 3072), (1024, 1024), (1024, 6144), (3072, 1024)]
PREDICTOR_A_ROWS = (1, 2, 16, 32, 64)   # B, 2B (a prefill), 16B (a pass)
# the f32 width at which int8 predictor weights take kernel A (widths in
# multiples of 128), four layers
MID_F32 = dict(hidden=256, n_layers=4, n_q_heads=4, n_kv_heads=2,
               head_dim=64, ffn_dim=512, mrope_sections=(32, 0, 0, 0))
JACOBI_ENV = "QWEN3_TTS_PRED_JACOBI"


@contextlib.contextmanager
def jacobi_on():
    """QWEN3_TTS_PRED_JACOBI=1 inside the block, as it was after."""
    old = os.environ.get(JACOBI_ENV)
    os.environ[JACOBI_ENV] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[JACOBI_ENV]
        else:
            os.environ[JACOBI_ENV] = old


def loop_codes(e, models, frames):
    """generate_codes(ignore_eos=True) on `models`, the vivian prompt, B =
    1, greedy, `frames` frames: (codes, n_frames)."""
    import torch
    from qwen3_tts_tpu_torch.tts import generate
    cfg = e.config
    d = e._prompt_for_voice(TEXT, e.get_speaker("vivian"), None)
    b, o = e._pad_prompts([d.embeds])
    with torch.inference_mode():
        return generate.generate_codes(
            models, cfg.talker, cfg.predictor, b, o, None, 0.0, 0, 1.0,
            frames, ignore_eos=True)


def predictor_kernel_a(rec: Record, randn):
    """Kernel A against its plain version at the int8 predictor's products
    and a 2048-column head slice (a view of the 32768-column head), M =
    1, 2, 16, 32, 64, x bf16 and f32 (phase 3's rtol = atol = 1e-4), and a
    repeat bit-identical."""
    import torch
    from qwen3_tts_tpu_torch.ops import quant

    for K, N in PREDICTOR_INT8 + [(1024, 4096), (1024, 2048)]:
        if N == 2048:
            wide = quant.quantize(randn(K, 16 * N, scale=0.02))
            q, sc = wide["q"][:, 5 * N:6 * N], wide["scale"][5 * N:6 * N]
        else:
            qw = quant.quantize(randn(K, N, scale=0.02))
            q, sc = qw["q"], qw["scale"]
        err, same = 0.0, True
        for M in PREDICTOR_A_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = randn(M, K, dtype=dt)
                got = quant.qmatmul_kernel(x, q, sc)
                e, _ = rec.check(
                    "qmatmul", got, quant.qmatmul_kernel_plain(x, q, sc),
                    f"predictor {K}x{N} M={M} x {str(dt)[6:]}",
                    rtol=1e-4, atol=1e-4, quiet=True)
                err = max(err, e)
                same &= torch.equal(got, quant.qmatmul_kernel(x, q, sc))
        log(f"  qmatmul          predictor {K}x{N}"
            f"{' (head slice view)' if N == 2048 else ''}, M="
            f"{PREDICTOR_A_ROWS}, x bf16 / f32: max|d|={err:.3e} (rtol/atol "
            f"1e-4) ok; repeats {'bit-identical' if same else 'DIFFER'}")
        if not same:
            fail(f"qmatmul predictor {K}x{N}: repeats differ")


def predictor_small_card_vs_cpu():
    """frame_codes, frame_codes_jacobi (zero, oracle and adversarial
    drafts) and the frame kernel's codes at f32, B = 1 and 4: the tiny
    config dense, and MID_F32 with int8 weights (kernel A): all equal to
    each other on the card and to frame_codes on the CPU."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.models import predictor as pm
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp

    tiny = tiny_engine_config().predictor
    mid = dataclasses.replace(tiny, **MID_F32)
    for cfg, kind, what in ((tiny, "dense", "tiny f32"),
                            (mid, "int8", "mid f32 int8")):
        for B in (1, 4):
            pp, assets, ptab, rows, h, c0 = frame_case(cfg, kind, B, 90 + B)
            want = pm.frame_codes(_to(pp, "cpu"), cfg, _to(assets, "cpu"),
                                  h.cpu(), c0.cpu())
            got = {"frame_codes": pm.frame_codes(pp, cfg, assets, h, c0),
                   "frame kernel": fp.predictor_frame_kernel(
                       pp, cfg, ptab, rows, h, c0)}
            drafts = {"zero": None, "oracle": want[:, 1:].cuda(),
                      "adversarial": ((want[:, 1:] + 7) % 2048).cuda()}
            passes = {}
            for name, d in drafts.items():
                got[f"jacobi {name}"] = pm.frame_codes_jacobi(
                    pp, cfg, assets, h, c0, d)
                passes[name] = pm.frame_codes_jacobi.passes
            bad = [k for k, v in got.items() if not torch.equal(v.cpu(),
                                                                want)]
            log(f"  {what} B={B}: frame_codes, the frame kernel and Jacobi "
                f"(zero / oracle / adversarial drafts: {passes['zero']} / "
                f"{passes['oracle']} / {passes['adversarial']} passes) "
                f"equal to the CPU's frame_codes: {not bad}")
            if bad or passes["oracle"] != 1:
                fail(f"predictor {what} B={B}: {bad} differ from the CPU's "
                     f"codes, or the oracle draft took {passes['oracle']} "
                     "passes")


def predictor_times(label, pp, cfg, assets, ptab, rows, card, B, g):
    """Device ms of one Jacobi pass (profiler) and ms a frame (CUDA events
    after warmup, host gaps included) of frame_codes_jacobi (zero draft),
    frame_codes and the frame kernel's route, in the same call."""
    import torch
    from qwen3_tts_tpu_torch.models import predictor as pm
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp

    h = torch.randn(B, cfg.hidden, generator=g, device=g.device)
    c0 = torch.randint(0, 2048, (B,), generator=g, device=g.device)
    codes = torch.cat([c0[:, None].int(), torch.zeros(
        B, 15, dtype=torch.int32, device=g.device)], 1)
    with torch.inference_mode():
        pm.jacobi_pass(pp, cfg, assets, h, codes)
        pass_dev = profiled_device_ms(
            lambda: pm.jacobi_pass(pp, cfg, assets, h, codes), 3)
        pass_ms = cuda_ms(lambda: pm.jacobi_pass(pp, cfg, assets, h, codes),
                          reps=10, warmup=2)
        pm.frame_codes_jacobi.passes_total = 0
        jac = cuda_ms(lambda: pm.frame_codes_jacobi(pp, cfg, assets, h, c0),
                      reps=3, warmup=1)
        passes = pm.frame_codes_jacobi.passes_total / 4
        fc = cuda_ms(lambda: pm.frame_codes(pp, cfg, assets, h, c0),
                     reps=3, warmup=1)
        kern = cuda_ms(lambda: fp.frame_codes_fused(pp, cfg, ptab, rows, h,
                                                    c0), reps=10, warmup=2)
    log(f"  {label} B={B}: one Jacobi pass {_fmt(pass_dev)} device ms "
        f"(profiler), {pass_ms:.3f} ms (events); Jacobi {jac:.3f} ms a frame"
        f" ({passes:g} passes, zero draft); frame_codes {fc:.3f} ms a frame;"
        f" the frame kernel's route "
        f"({fp.frame_route(pp, B)}) {kern:.3f} ms a frame, on {card}")


def phase_predictor(eng, rec: Record, card: str, q88):
    """`models/predictor.py` on the card: kernel A at the int8 predictor's
    shapes; the small f32 checks (`predictor_small_card_vs_cpu`); at full
    width bf16, dense and int8 (the int8/int8 and int4+int8 rungs' predictor)
    at B = 1 and 4: Jacobi self-consistency (one verifying pass over its own
    codes reproduces codes 1-15, and they as the draft take one pass), and
    with peaked heads Jacobi's and frame_codes's codes each agreeing with
    the frame kernel's >= 0.95; frame_codes int8 counted as a main-path run
    (kernel A, decode attention); the loop with QWEN3_TTS_PRED_JACOBI=1:
    the tiny f32 config's greedy codes equal to the default path's on the
    card and the CPU's, then at full width B = 1, 32 frames dense and 8
    frames int8/int8 (kernel A launched), passes and ms a frame against
    the default path's in the same call; times (`predictor_times`,
    `qmatmul_times` at the predictor's shapes, M = 16 and 64)."""
    import torch
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.models import predictor as pm
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.tts import generate

    log(f"[5b/12] predictor: models/predictor.py (frame_codes, Jacobi "
        f"decoding) and the loop's Jacobi branch, full width, on {card}")
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    t_phase = time.time()

    def took(what):
        log(f"  ({what}: {time.time() - t_phase:.1f} s into the phase)")

    predictor_kernel_a(rec, randn)
    predictor_small_card_vs_cpu()
    took("kernel A and the f32 checks")

    cfg = eng.config.predictor
    assets = eng.models["assets"]
    ptab, rows = generate.predictor_tables(eng.models, cfg)
    dense = eng.models["predictor"]
    kinds = (("dense bf16", dense), ("int8", q88["predictor"]))
    # made outside inference mode: the frame kernel keys its packed copies
    # of the weights by their version counters
    peaked = peak_head(dense, [(q * P.CODE_VOCAB, P.CODE_VOCAB)
                               for q in range(P.NUM_CODEBOOKS)])
    peaked = (("dense bf16", peaked),
              ("int8", quant.quantize_decoder_params(peaked, kind="int8")))
    with torch.inference_mode():
        for label, pp in kinds:
            for B in (1, 4):
                h = torch.randn(B, cfg.hidden, generator=g, device=dev)
                c0 = torch.randint(0, 2048, (B,), generator=g, device=dev)
                jac = pm.frame_codes_jacobi(pp, cfg, assets, h, c0)
                p0 = pm.frame_codes_jacobi.passes
                again = pm.frame_codes_jacobi(pp, cfg, assets, h, c0,
                                              jac[:, 1:])
                p1 = pm.frame_codes_jacobi.passes
                verify = pm.jacobi_pass(pp, cfg, assets, h, jac)
                ok = (torch.equal(verify, jac[:, 1:])
                      and torch.equal(again, jac) and p1 == 1)
                log(f"  {label} B={B}: Jacobi from the zero draft in {p0} "
                    f"passes; a verifying pass over its codes reproduces "
                    f"codes 1-15 and they as the draft take {p1} pass: "
                    f"{ok}")
                if not ok:
                    fail(f"predictor {label} B={B}: Jacobi is not "
                         "self-consistent")

        # agreement with the frame kernel, peaked heads
        for label, pp in peaked:
            for B in (1, 4):
                agree = {"jacobi": 0, "frame_codes": 0}
                total = 0
                for _ in range({1: 4, 4: 2}[B]):    # frames
                    h = torch.randn(B, cfg.hidden, generator=g, device=dev)
                    c0 = torch.randint(0, 2048, (B,), generator=g,
                                       device=dev)
                    kern = fp.frame_codes_fused(pp, cfg, ptab, rows, h, c0)
                    for name, got in (
                            ("jacobi", pm.frame_codes_jacobi(
                                pp, cfg, assets, h, c0)),
                            ("frame_codes", pm.frame_codes(
                                pp, cfg, assets, h, c0))):
                        agree[name] += int((got == kern).sum())
                    total += kern.numel()
                fr = {k: v / total for k, v in agree.items()}
                log(f"  {label} B={B} peaked heads: codes agreement with the "
                    f"frame kernel's ({fp.frame_route(pp, B)} route): Jacobi "
                    f"{fr['jacobi']:.4f}, frame_codes {fr['frame_codes']:.4f}"
                    f" (gate 0.95)")
                if min(fr.values()) < 0.95:
                    fail(f"predictor {label} B={B}: agreement {fr} < 0.95")
        del peaked

        # frame_codes on int8 weights as a main-path run: kernel A and
        # decode attention counted
        h = torch.randn(4, cfg.hidden, generator=g, device=dev)
        c0 = torch.randint(0, 2048, (4,), generator=g, device=dev)
        run_main_path(rec, "frame_codes int8 B=4",
                      lambda: pm.frame_codes(q88["predictor"], cfg, assets,
                                             h, c0),
                      ("qmatmul", "decode_attention"))

    took("full-width checks")
    # the loop: tiny f32 on the card and the CPU, default vs Jacobi
    tiny_loop_jacobi()
    # full width: dense 32 frames, int8/int8 8 frames
    for label, models, frames in (("dense bf16", eng.models, 32),
                                  ("int8/int8", q88, 8)):
        need = ("talker_step", "qmatmul") if label == "int8/int8" \
            else ("talker_step",)
        times = {}
        for mode in ("default", "jacobi"):
            ctx = jacobi_on() if mode == "jacobi" else contextlib.nullcontext()
            with ctx:
                pm.frame_codes_jacobi.passes_total = 0
                torch.cuda.synchronize()
                t0 = time.time()
                short = loop_codes(eng, models, 4)
                torch.cuda.synchronize()
                t1 = time.time()
                codes, n = run_main_path(
                    rec, f"generate_codes {label} B=1 {frames} frames "
                    f"({mode})", lambda: loop_codes(eng, models, frames),
                    need)
                t2 = time.time()
            if not (torch.equal(n.cpu(), torch.full((1,), frames,
                                                    dtype=torch.int32))
                    and codes.shape == (1, frames, 16)
                    and bool((codes >= 0).all())
                    and bool((codes[..., 1:] < P.CODE_VOCAB).all())):
                fail(f"generate_codes {label} ({mode}): {tuple(codes.shape)}"
                     f" codes, n_frames {n.tolist()}")
            per = ((t2 - t1) - (t1 - t0)) / (frames - 4) * 1e3
            passes = pm.frame_codes_jacobi.passes_total / (frames + 4)
            times.setdefault(mode, []).append((per, passes))
        (d, _), = times["default"]
        (j, jp), = times["jacobi"]
        log(f"  loop {label} B=1: {_fmt(j)} ms a frame with "
            f"QWEN3_TTS_PRED_JACOBI=1 ({jp:g} passes a frame) against "
            f"{_fmt(d)} on the default path (host wall, prefill subtracted), "
            f"on {card}")

    took("the loop")
    for (label, pp), B in ((kinds[0], 1), (kinds[0], 4), (kinds[1], 1)):
        predictor_times(label, pp, cfg, assets, ptab, rows, card, B, g)
    qmatmul_times(rec, card, g, rows=(16, 64), shapes=PREDICTOR_INT8,
                  what="predictor", json_row=None)
    took("times")


def tiny_loop_jacobi():
    """The tiny f32 config, B = 2 ragged: greedy generate_codes with
    QWEN3_TTS_PRED_JACOBI=1 on the card equal to the default path's on the
    card and to the CPU's with the variable set."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.models import predictor as pm
    from qwen3_tts_tpu_torch.tts import generate

    cfg = tiny_engine_config(max_steps=8)
    teng = TtsEngine(config=cfg, random_weights=True, seed=0,
                     speakers_dir=os.path.join(REPO, "speakers"),
                     device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal(
        (2, 9, cfg.talker.hidden))).astype(np.float32))
    x[1, :3] = 0
    pad = torch.tensor([0, 3], dtype=torch.int32)

    def run(models, dev):
        with torch.inference_mode():
            return generate.generate_codes(
                models, cfg.talker, cfg.predictor, x.to(dev), pad.to(dev),
                None, 0.0, 0, 1.0, cfg.max_steps, ignore_eos=True)

    base = run(teng.models, "cuda")
    with jacobi_on():
        pm.frame_codes_jacobi.passes_total = 0
        jac = run(teng.models, "cuda")
        passes = pm.frame_codes_jacobi.passes_total
        cpu = run(_to(teng.models, "cpu"), "cpu")
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in
               zip(base + jac, jac + cpu))
    log(f"  tiny f32 B=2 greedy generate_codes with QWEN3_TTS_PRED_JACOBI=1"
        f" ({passes / cfg.max_steps:g} passes a frame) equal to the default "
        f"path's on the card and to the CPU's: {same}")
    if not same or passes < cfg.max_steps:
        fail("tiny f32: the Jacobi loop's codes differ, or it did not run")


def fused_per_frame(cfg) -> dict:
    """Launches a frame on the kernel routes at B <= 16 with a dense or
    int8 predictor (the talker at B <= its ROUTE_MAX_B, the predictor at
    B <= its): the talker step kernel once and the predictor frame kernel
    once, and none of the chain's launches: no gemv, decode attention,
    standalone rms_norm, fused piece, KV store or copy, or argmax epilogue
    (`route_per_frame` for any other batch or weights)."""
    return {"talker_step": 1, "predictor_frame": 1, "gemv_all": 0,
            "decode_attention": 0, "rms_norm": 0, "rms_norm_gemv": 0,
            "qk_rope_gemv": 0, "silu_gemv": 0, "kv_store_gemv": 0,
            "talker_kv_copy": 0, "argmax_gather_gemv": 0,
            "talker_step_b17_32": 0, "predictor_frame_int4": 0}


def chain_per_frame(cfg, predictor_kernel: bool) -> dict:
    """Launches a frame with the talker on its chain route (B > MAX_B), as
    every frame launched them before the step kernel: the talker's gemv per
    product of each layer and its head, the norm prologue at ln1 and ln2,
    the qk epilogue and the silu prologue once a layer, decode attention
    once a layer, the standalone rms_norm (the final norm) once and the two
    cache copies. The predictor: its frame kernel where `frame_route` takes
    it, else its chain too (16 passes of the layer stack with the KV
    stores, 15 head slices with the norm prologue and the argmax epilogue;
    no argmax launch of its own)."""
    Lt, Lp = cfg.talker.n_layers, cfg.predictor.n_layers
    n = {"talker_step": 0, "predictor_frame": 1, "gemv_all": 4 * Lt + 1,
         "decode_attention": Lt, "rms_norm": 1, "rms_norm_gemv": 2 * Lt,
         "qk_rope_gemv": Lt, "silu_gemv": Lt, "kv_store_gemv": 0,
         "talker_kv_copy": 2, "argmax_gather_gemv": 0,
         "talker_step_b17_32": 0, "predictor_frame_int4": 0}
    if not predictor_kernel:
        passes, heads = 16, 15
        n.update(predictor_frame=0, argmax_gather_gemv=heads,
                 gemv_all=n["gemv_all"] + passes * 4 * Lp + heads,
                 decode_attention=Lt + passes * Lp,
                 rms_norm_gemv=n["rms_norm_gemv"] + passes * 2 * Lp + heads,
                 qk_rope_gemv=Lt + passes * Lp, silu_gemv=Lt + passes * Lp,
                 kv_store_gemv=passes * Lp)
    return n


def reset_counts() -> None:
    """Every launch count to 0: the chain's kernels, the cache copies of
    the talker's chain and the two step kernels."""
    from qwen3_tts_tpu_torch.ops import chain, fused_predictor, fused_talker
    chain.reset_launch_counts()
    fused_predictor.predictor_frame_kernel.launches = 0
    fused_predictor.predictor_frame_kernel.launches_int4 = 0
    fused_talker.talker_step_kernel.launches = 0
    fused_talker.talker_step_kernel.launches_wide = 0
    fused_talker.talker_step_fused.kv_copies = 0


def launch_counts() -> dict:
    """`chain.launch_counts()`, the step kernels' launches
    (`predictor_frame`, `talker_step`; of those, the int4 frames and the
    steps of 17-32 rows, `predictor_frame_int4`, `talker_step_b17_32`),
    the talker chain's cache copies (`talker_kv_copy`) and the gemv
    launches of every weight kind (`gemv_all`)."""
    from qwen3_tts_tpu_torch.ops import chain, fused_predictor, fused_talker
    counts = chain.launch_counts()
    frame, step = (fused_predictor.predictor_frame_kernel,
                   fused_talker.talker_step_kernel)
    counts["predictor_frame"] = frame.launches
    counts["predictor_frame_int4"] = frame.launches_int4
    counts["talker_step"] = step.launches
    counts["talker_step_b17_32"] = step.launches_wide
    counts["talker_kv_copy"] = fused_talker.talker_step_fused.kv_copies
    counts["gemv_all"] = sum(counts[k] for k in ("gemv", "gemv_int8",
                                                 "gemv_int4"))
    return counts


def run_main_path(rec: Record, label: str, fn, need, fused=None):
    """fn() with every launch count set to 0 just before and read just
    after; fails if a kernel in `need` was not launched, or, given `fused`
    (`fused_per_frame` or `chain_per_frame`), unless every count in it is
    its number a frame (frames: the talker steps, each one `talker_step`
    launch or, on the chain, one standalone rms_norm)."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    rec.add_launches(counts)
    log(f"  {label}: {wall:.2f} s wall, launches {json.dumps(counts)}")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on this path: {missing}")
    if fused is not None:
        frames = counts["talker_step"] + counts["rms_norm"]
        ok = frames > 0 and all(counts[k] == n * frames
                                for k, n in fused.items())
        log(f"  {label}: {frames} frames (talker steps); a frame: "
            + ", ".join(f"{k} {counts[k] / max(frames, 1):g} (expect {n})"
                        for k, n in fused.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label}: expected {fused} launches a frame")
    return out


def check_wav(label, wav, max_frames):
    import numpy as np
    n_frames = len(wav) // 2000
    finite = bool(np.isfinite(wav).all())
    log(f"  {label}: wav {wav.shape} samples, {n_frames} frames, "
        f"finite={finite}")
    if not finite:
        fail(f"{label}: waveform not finite")
    if n_frames < 1 or len(wav) != n_frames * 2000 or n_frames > max_frames:
        fail(f"{label}: waveform of {len(wav)} samples is not 1..{max_frames}"
             " whole frames")


TEXT = "Hello from the port: one sentence of speech."
# the fused pieces of the gemv launches, each launched on every chain
FUSED = ("rms_norm_gemv", "qk_rope_gemv", "silu_gemv")
# the step kernels: the talker's step and the predictor's frame
STEPS = ("talker_step", "predictor_frame")


def phase_main(eng, rec: Record, q48, q88):
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import fused_talker as ft

    log("[6/12] main path: TtsEngine.generate_with_voice, full width")
    voice = eng.get_speaker("vivian")
    fused = fused_per_frame(eng.config)

    def engine_runs(e, label, frames, need):
        e.set_max_steps(frames)
        e.set_sampler_config(SamplerConfig(seed=0))
        audio = run_main_path(rec, f"{label} B=1 generate_with_voice",
                              lambda: e.generate_with_voice(TEXT, voice),
                              need, fused)
        check_wav(f"{label} B=1", audio.samples, frames)
        return audio

    engine_runs(eng, "dense bf16", 32, STEPS)
    # the batched entry point: two ragged prompts, left-padded, B=2
    pair = run_main_path(
        rec, "dense bf16 B=2 generate_batch",
        lambda: eng.generate_batch([TEXT, "A second, shorter one."],
                                   [voice, voice]), STEPS, fused)
    for i, a in enumerate(pair):
        check_wav(f"dense bf16 B=2 row {i}", a.samples, 32)
    def batch_run(e, label, gemv, nb):
        """generate_batch of nb rows, 4 frames, with the launches a frame
        of the routes ops/fused_talker.py talker_route and
        ops/fused_predictor.py frame_route take at nb (`route_per_frame`):
        each kernel with a count a frame there must launch; `gemv`, the
        weight kinds' gemv where a chain runs."""
        per = route_per_frame(e.config, e.models, nb)
        need = tuple(k for k, n in per.items() if n > 0 and k not in (
            "gemv_all", "talker_kv_copy")) + (gemv if per["gemv_all"] else ())
        talker = "talker step kernel" if per["talker_step"] else \
            "talker chain"
        e.set_max_steps(4)
        rows = run_main_path(
            rec, f"{label} B={nb} generate_batch ({talker})",
            lambda: e.generate_batch([f"Row {i}: {TEXT}" for i in range(nb)],
                                     [voice] * nb), need, per)
        for i, a in enumerate(rows):
            check_wav(f"{label} B={nb} row {i}", a.samples, 4)

    # past 16 rows: the talker's kernel where its route takes the batch
    # (B = 17-32), the predictor's chain (the frame kernel stops at 16, as
    # the TPU's), then past the talker's route limit, where that is below
    # the batch cap (32, the chain's gemv's too), its chain as well
    batch_run(eng, "dense bf16", ("gemv",), ft.WIDE_B + 1)
    if ft.ROUTE_MAX_B["dense"] < ft.MAX_B:
        batch_run(eng, "dense bf16", ("gemv",), ft.ROUTE_MAX_B["dense"] + 1)

    # the JAX bench's headline rung: talker int4, predictor int8; the int4
    # prefill is plain (qmatmul4, as in JAX) and the predictor has no
    # prefill through `linear`, so this run launches no qmatmul
    spk = os.path.join(REPO, "speakers")
    e48 = TtsEngine(config=eng.config, weights=(q48, eng.vocoder_params),
                    speakers_dir=spk, device="cuda")
    need48 = STEPS
    engine_runs(e48, "int4+int8", 32, need48)
    e48.set_max_steps(32)
    pair = run_main_path(
        rec, "int4+int8 B=2 generate_batch",
        lambda: e48.generate_batch([TEXT, "A second, shorter one."],
                                   [voice, voice]), need48, fused)
    for i, a in enumerate(pair):
        check_wav(f"int4+int8 B=2 row {i}", a.samples, 32)
    # int4 talker weights keep the chain past their route's limit (8 rows),
    # and at the batch cap (the predictor takes the route its frame_route
    # gives: its chain past 16 rows)
    batch_run(e48, "int4+int8", ("gemv_int4",), ft.ROUTE_MAX_B["int4"] + 1)
    batch_run(e48, "int4+int8", ("gemv_int4", "gemv_int8"), ft.MAX_B)

    # the second rung, int8/int8: the talker prefill runs kernel A
    e88 = TtsEngine(config=eng.config, weights=(q88, eng.vocoder_params),
                    speakers_dir=spk, device="cuda")
    engine_runs(e88, "int8/int8", 16, ("qmatmul",) + STEPS)
    if ft.ROUTE_MAX_B["int8"] < ft.MAX_B:
        batch_run(e88, "int8/int8", ("gemv_int8",),
                  ft.ROUTE_MAX_B["int8"] + 1)
    # an int4 predictor (all five weights int4): its frame kernel once a
    # frame where ops/fused_predictor.py frame_route takes B = 1 (its
    # ROUTE_MAX_B["int4"] >= 1), the int4 talker's step kernel beside it
    q44 = quantized_models(eng.models, "int4", "int4")
    e44 = TtsEngine(config=eng.config, weights=(q44, eng.vocoder_params),
                    speakers_dir=spk, device="cuda")
    e44.set_max_steps(8)
    e44.set_sampler_config(SamplerConfig(seed=0))
    per44 = route_per_frame(e44.config, e44.models, 1)
    route44 = "frame kernel" if per44["predictor_frame"] else \
        "predictor chain"
    log(f"  int4/int4 B=1: the predictor's {route44} (ROUTE_MAX_B['int4'] "
        f"= {fp.ROUTE_MAX_B['int4']})")
    audio = run_main_path(
        rec, f"int4/int4 ({route44}) B=1 generate_with_voice",
        lambda: e44.generate_with_voice(TEXT, voice),
        tuple(k for k, n in per44.items() if n > 0 and k not in (
            "gemv_all", "talker_kv_copy"))
        + (("gemv_int4",) if per44["gemv_all"] else ()), per44)
    check_wav("int4/int4 B=1", audio.samples, 8)
    del e48, e88, e44, q44
    reset_counts()

    tiny_card_vs_cpu()


def tiny_card_vs_cpu():
    """Reference on a small input: greedy generation of the tiny f32
    config, kernels on the card against the plain versions on the CPU;
    dense, int8/int8, and int4 talker + int8 predictor on a small
    int4-capable talker."""
    import dataclasses

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.tts import generate

    base = tiny_engine_config(max_steps=8)
    small4 = dataclasses.replace(base, talker=dataclasses.replace(
        base.talker, hidden=256, n_q_heads=2, n_kv_heads=2, head_dim=128,
        ffn_dim=256, mrope_sections=(32, 16, 16, 0)))
    for label, cfg, kinds in (("tiny f32 dense", base, None),
                              ("tiny f32 int8/int8", base, ("int8", "int8")),
                              ("small f32 int4+int8", small4,
                               ("int4", "int8"))):
        teng = TtsEngine(config=cfg, random_weights=True, seed=0,
                         speakers_dir=os.path.join(REPO, "speakers"),
                         device="cuda")
        models = teng.models if kinds is None \
            else quantized_models(teng.models, *kinds)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(
            (0.1 * rng.standard_normal((2, 9, cfg.talker.hidden))).astype(
                np.float32))
        x[1, :3] = 0
        pad = torch.tensor([0, 3], dtype=torch.int32)
        cpu_models = _to(models, "cpu")
        with torch.inference_mode():
            ck, nk = generate.generate_codes(
                models, cfg.talker, cfg.predictor, x.cuda(), pad.cuda(),
                None, 0.0, 0, 1.0, cfg.max_steps)
            cc, nc = generate.generate_codes(
                cpu_models, cfg.talker, cfg.predictor, x, pad, None, 0.0, 0,
                1.0, cfg.max_steps)
        same = bool(torch.equal(ck.cpu(), cc)) and bool(
            torch.equal(nk.cpu(), nc))
        log(f"  {label} greedy codes B=2, card kernels vs CPU plain: "
            f"{'equal' if same else 'DIFFER'} (n_frames {nc.tolist()})")
        if not same:
            fail(f"{label}: codes on the card differ from the CPU reference")


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


# f32 vocoder, TF32 off: a chunked and a one-shot decode differ only in the
# order of the sums (other extents of the attention and convolutions)
STREAM_WAV_ATOL = 1e-4


def stream_once(e, text, voice):
    """One generate_stream call: the samples, the chunks handed to
    on_chunk, the codes the stream submitted to its vocoder worker
    [1, N, 16], the first chunk's latency (ms) and the call's wall time
    (s), on the host clock; the call returns after the last chunk is
    vocoded and on the host."""
    import numpy as np
    from qwen3_tts_tpu_torch.parallel import pipeline

    submitted, chunks, first = [], [], []
    submit = pipeline.VocoderPipeline.submit

    def recording_submit(self, codes, is_final=False):
        submitted.append(np.array(codes))
        return submit(self, codes, is_final)

    def on_chunk(piece):
        if not first:
            first.append(time.perf_counter())
        chunks.append(piece)

    pipeline.VocoderPipeline.submit = recording_submit
    try:
        t0 = time.perf_counter()
        audio = e.generate_stream(text, voice, on_chunk=on_chunk)
        wall = time.perf_counter() - t0
    finally:
        pipeline.VocoderPipeline.submit = submit
    codes = np.concatenate(submitted, axis=1) if submitted \
        else np.zeros((1, 0, 16), np.int32)
    return {"samples": audio.samples, "chunks": chunks, "codes": codes,
            "first_ms": (first[0] - t0) * 1e3 if first else None,
            "wall": wall}


def check_stream(label, run, e, max_frames, atol=STREAM_WAV_ATOL):
    """Whole-frame chunks of at most (4 + lookahead + ctx_r) frames (ctx_r
    the general upsampler's delay, 0 on the kernel == stride path) that
    concatenate to the samples, and the samples equal to a one-shot decode
    of the stream's own codes within `atol`."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.models import vocoder

    vcfg = e.config.vocoder
    fs = vcfg.frame_samples
    wav = run["samples"]
    check_wav(label, wav, max_frames)
    sizes = [len(c) for c in run["chunks"]]
    most = 4 + vcfg.lookahead + vocoder.up_context(vcfg)[1]
    if not sizes or any(n % fs or not 0 < n <= most * fs for n in sizes):
        fail(f"{label}: chunk sizes {sizes} are not 1..{most} whole frames")
    if not np.array_equal(np.concatenate(run["chunks"]), wav):
        fail(f"{label}: the chunks do not concatenate to the samples")
    codes = torch.from_numpy(run["codes"]).to(e.device)
    n = codes.shape[1]
    with torch.inference_mode():
        w, v, _ = vocoder.decode(
            e.vocoder_params, vcfg, codes,
            vocoder.init_state(vcfg, 1, frames=n, device=e.device), True)
    one = w[0, : int(v[0])].cpu().numpy()
    err = float(np.abs(one - wav).max()) if one.shape == wav.shape \
        else float("inf")
    log(f"  {label}: chunks of {[s // fs for s in sizes]} frames; against a "
        f"one-shot decode of its {n} frames max|d|={err:.3e} "
        f"(atol {atol:g})")
    if err > atol:
        fail(f"{label}: the streamed waveform differs from a one-shot decode "
             "of its codes")


def profiled_device_ms(fn, n):
    """Device ms per call of fn(): the kernels' self device time in a
    torch.profiler trace of n calls, or None where the trace holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.3f}"


def phase_stream(eng, rec: Record, card: str, q48):
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine

    frames = 32
    log(f"[7/12] stream: TtsEngine.generate_stream, full width, B=1, "
        f"{frames} frames")
    voice = eng.get_speaker("vivian")
    e48 = TtsEngine(config=eng.config, weights=(q48, eng.vocoder_params),
                    speakers_dir=os.path.join(REPO, "speakers"),
                    device="cuda")
    sets = (("dense bf16", eng, STEPS), ("int4+int8", e48, STEPS))
    fused = fused_per_frame(eng.config)
    for label, e, need in sets:
        e.set_max_steps(frames)
        e.set_sampler_config(SamplerConfig(seed=0))
        runs = []
        for what in ("cold", "warm"):
            if what == "warm":
                t0 = time.perf_counter()
                e.warmup()
                log(f"  {label}: warmup (offline + stream, prompt bucket 64) "
                    f"{time.perf_counter() - t0:.2f} s")
            run = run_main_path(rec, f"{label} generate_stream ({what})",
                                lambda: stream_once(e, TEXT, voice), need,
                                fused)
            check_stream(f"{label} {what}", run, e, frames)
            runs.append(run)
        rtf = [r["wall"] / (len(r["samples"]) / 24000) for r in runs]
        log(f"  {label}: first-chunk ms cold {runs[0]['first_ms']:.1f}, warm "
            f"{runs[1]['first_ms']:.1f}; streaming RTF incl. vocoding cold "
            f"{rtf[0]:.3f}, warm {rtf[1]:.3f} "
            f"({len(runs[1]['samples']) / 24000:.3f} s of audio; cold = the "
            f"engine's first stream, kernels already built) on {card}")
    reset_counts()
    vocoder_chunk_times(eng, card)
    for label, e, _ in sets:
        stream_frame_times(e, label, card)
    tiny_stream_card_vs_cpu()


def vocoder_chunk_times(eng, card):
    """One 4-frame chunk through the streaming vocoder (B=1, a KV of
    max_frames slots, 16 frames already decoded)."""
    import torch
    from qwen3_tts_tpu_torch.models import vocoder

    vcfg = eng.config.vocoder
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(3)
    codes = torch.randint(0, vcfg.code_vocab, (1, 4, 16), generator=g,
                          device=dev, dtype=torch.int32)
    with torch.inference_mode():
        st = vocoder.init_state(vcfg, 1, device=dev)
        for _ in range(4):
            _, _, st = vocoder.decode(eng.vocoder_params, vcfg, codes, st,
                                      False)

        def chunk():          # the same slots each call: the same work
            vocoder.decode(eng.vocoder_params, vcfg, codes, st, False)
        wall = cuda_ms(chunk)
        dev_ms = profiled_device_ms(chunk, 5)
    log(f"  vocoder, one 4-frame chunk (f32, {vcfg.max_frames} KV slots): "
        f"device {_fmt(dev_ms)} ms (profiler), {wall:.3f} ms per call "
        f"(CUDA events around eager calls) on {card}")


def stream_frame_times(e, label, card):
    """ms/frame of the stream step (4 frames a call, B=1, prompt 64) with
    the stream path's talker cache (max_seq slots) and with the offline
    path's 256-slot window: per frame on the stream (CUDA events around
    the host loop) and device time (profiler)."""
    import torch
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import flash_decode
    from qwen3_tts_tpu_torch.tts import generate

    cfg = e.config
    dev = e.device
    g = torch.Generator(device=dev).manual_seed(7)
    prompt = 0.1 * torch.randn(1, 64, cfg.talker.hidden, generator=g,
                               device=dev)
    pad = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = []
    for cache_len in (cfg.talker.max_seq, 256):
        prefill_fn, step_fn = generate.make_stream_fns(
            cfg.talker, cfg.predictor, top_k=40, frames_per_call=4,
            cache_len=cache_len)
        with torch.inference_mode():
            state = [prefill_fn(e.models, prompt, pad,
                                torch.Generator(device=dev).manual_seed(0),
                                0.7, 0.9)]

            def step():
                state[0] = step_fn(e.models, state[0])[0]
            wall = cuda_ms(step, reps=2, warmup=1) / 4
            dev_ms = profiled_device_ms(step, 1)
        splits = flash_decode.attention_splits(1, cfg.talker.n_kv_heads,
                                               cache_len, build.sm_count(dev))
        parts.append(f"{cache_len} slots ({splits} splits/head): "
                     f"{wall:.3f} ms/frame on the stream, device "
                     f"{_fmt(None if dev_ms is None else dev_ms / 4)} "
                     "ms/frame")
    log(f"  {label}: stream step, talker cache " + "; ".join(parts)
        + f" on {card}")


def tiny_stream_card_vs_cpu():
    """Reference on a small input for the stream path: the tiny f32
    config's greedy stream on the card against its offline path and
    against the stream on the CPU (plain versions)."""
    import numpy as np
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config

    cfg = tiny_engine_config(max_steps=12)
    spk = os.path.join(REPO, "speakers")
    on_card = TtsEngine(config=cfg, random_weights=True, seed=0,
                        speakers_dir=spk, device="cuda")
    on_cpu = TtsEngine(config=cfg, weights=(_to(on_card.models, "cpu"),
                                            _to(on_card.vocoder_params,
                                                "cpu")),
                       speakers_dir=spk, device="cpu")
    for e in (on_card, on_cpu):
        e.set_sampler_config(SamplerConfig(temperature=0.0, top_k=0,
                                           top_p=1.0, seed=0))
    voice = on_card.get_speaker("vivian")
    card = stream_once(on_card, TEXT, voice)
    cpu = stream_once(on_cpu, TEXT, voice)
    offline = on_card.generate_with_voice(TEXT, voice).samples
    same = np.array_equal(card["codes"], cpu["codes"])
    errs = [float(np.abs(card["samples"] - ref).max())
            if ref.shape == card["samples"].shape else float("inf")
            for ref in (offline, cpu["samples"])]
    log(f"  tiny f32 greedy stream ({card['codes'].shape[1]} frames): codes "
        f"card vs CPU {'equal' if same else 'DIFFER'}; samples max|d| vs the "
        f"card's offline path {errs[0]:.3e}, vs the CPU stream {errs[1]:.3e} "
        f"(atol {STREAM_WAV_ATOL:g})")
    if not same or max(errs) > STREAM_WAV_ATOL:
        fail("tiny f32 stream: the card differs from its offline path or "
             "from the CPU")


def prefill_trace(run):
    """A profiled run(): {CUDA kernel: (device us, launches)} and the device
    us spent inside `quant.dequant4_dt` (the int4 prefill's dequantisation,
    wrapped in a profiler range for this trace only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from qwen3_tts_tpu_torch.ops import quant

    orig = quant.dequant4_dt

    def ranged(*args, **kw):
        with record_function("dequant4_dt"):
            return orig(*args, **kw)

    quant.dequant4_dt = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        quant.dequant4_dt = orig
    events = prof.key_averages()
    kern = {e.key: (e.self_device_time_total, e.count) for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA}
    dq = sum(getattr(e, "device_time_total", 0) for e in events
             if e.key == "dequant4_dt")
    return kern, dq


def frame_times(eng, models, label: str, card: str, g):
    """ms/frame of generate_codes(ignore_eos) through the kernels and
    through their plain versions, in alternating runs (kernel, plain,
    kernel), and the kernel path's device busy share."""
    import torch
    from qwen3_tts_tpu_torch.tts import generate

    cfg = eng.config
    dev = eng.device
    frames = 32
    prompt = 0.1 * torch.randn(1, 64, cfg.talker.hidden, generator=g,
                               device=dev)
    pad = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(plain, steps):
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode():
            generate.generate_codes(
                models, cfg.talker, cfg.predictor, prompt, pad, gen,
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

    per_frame, prefills = {}, {}
    for plain in (False, True, False):              # kernel, plain, kernel
        run(plain, 2)                                # warm up
        total = timed(plain, frames)
        prefill = timed(plain, 0)
        per_frame.setdefault(plain, []).append((total - prefill) / frames)
        prefills.setdefault(plain, []).append(prefill)
    kms, pms = min(per_frame[False]), min(per_frame[True])
    log(f"  {label}: ms/frame generate_codes(ignore_eos) over {frames} "
        f"frames, B=1, bf16 (prefill subtracted): kernels {kms:.3f} (runs "
        f"{[round(v, 3) for v in per_frame[False]]}), plain {pms:.3f} (runs "
        f"{[round(v, 3) for v in per_frame[True]]}); prefill of 64 tokens "
        f"ms: kernels {[round(v, 3) for v in prefills[False]]}, plain "
        f"{[round(v, 3) for v in prefills[True]]} on {card}")

    # device busy share of the kernel path: device time of the kernels in a
    # profiler trace of prefill + 4 frames, over the wall time of the same
    # run without the profiler (which slows the host down); per frame: the
    # trace of prefill + 4 frames less the trace of the prefill alone, by
    # kernel name
    busy = None
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def trace(steps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(False, steps)
                torch.cuda.synchronize()
            return {e.key: (e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA}

        wall = timed(False, 4)
        kern = trace(4)
        pre, dq_us = prefill_trace(lambda: run(False, 0))
        pre_us = sum(us for us, _ in pre.values())
        pre_a = sum(n for k, (_, n) in pre.items() if "qmatmul" in k)
        log(f"  {label}: prefill of 64 tokens, B=1 (profiler): "
            f"{sum(n for _, n in pre.values())} CUDA kernels ({pre_a} of "
            f"kernel A), {pre_us / 1e3:.3f} device ms, of which "
            f"dequant4_dt {dq_us / 1e3:.3f} ms = {dq_us / max(pre_us, 1):.1%}"
            f"; host ms (CUDA events) {[round(v, 3) for v in prefills[False]]}"
            f" on {card}")
        old_a = [k for k in pre if "qmatmul_tile" in k
                 or "qmatmul_reduce" in k]
        if old_a:
            fail(f"{label}: removed kernels in the prefill: {old_a}")
        dev_us = sum(us for us, _ in kern.values())
        if dev_us > 0:
            busy = dev_us / 1e3 / wall
            log(f"  {label}: profiler, prefill + 4 frames: device busy "
                f"{dev_us / 1e3:.2f} ms of {wall:.2f} ms unprofiled wall = "
                f"{busy:.3f} on {card}")
            per = {k: ((us - pre.get(k, (0, 0))[0]) / 4e3,
                       (n - pre.get(k, (0, 0))[1]) / 4)
                   for k, (us, n) in kern.items()}
            tot = sum(ms for ms, _ in per.values())
            cnt = sum(n for _, n in per.values())
            log(f"  {label}: device ms per frame (profiler, (prefill + 4 "
                f"frames) - prefill) {tot:.3f} ms in {cnt:.0f} CUDA kernels "
                f"on {card}; by kernel:")
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
            for k, (ms, n) in top:
                log(f"    {ms:9.4f} ms/frame  {n:7.1f}x/frame  {k[:70]}")
            step = sum(ms for k, (ms, _) in per.items() if "talker_step" in k)
            log(f"  {label}: a frame: CUDA kernels {cnt:.0f}, talker step "
                f"kernel {step:.3f} device ms, host {kms:.3f} ms; with the "
                f"talker's chain (PERF.md §5, dense): 220 kernels, the chain "
                f"1.83 device ms, host 13.5-19.4 ms on {card}")
            gone = [k for k in per if any(
                name in k for name in ("gemv_epilogue", "gemv4_partial",
                                       "qk_norm_rope", "silu_mul",
                                       "argmax_gather_kernel"))]
            if gone:
                fail(f"{label}: removed kernels in the profile: {gone}")
    except (RuntimeError, AssertionError) as exc:
        log(f"  profiler unavailable ({exc}); device busy share not measured")
    if busy is None:
        log(f"  {label}: device busy share: not measured (no device time in "
            "trace)")


def phase_times(eng, rec: Record, card: str, q48):
    import torch

    log(f"[8/12] times on {card} (CUDA events)")
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(5)
    # ms/frame and busy share per weight set; int8/int8 left out for the
    # smoke's 1200 s limit beside phase 12: `frame_times(eng, q88,
    # "int8/int8", card, g)` times it alone
    t0 = time.time()
    for label, models in (("dense bf16", eng.models), ("int4+int8", q48)):
        frame_times(eng, models, label, card, g)
    log(f"  (frame_times: {time.time() - t0:.1f} s into the phase)")
    kernel_times(rec, card, g)
    log(f"  (kernel_times: {time.time() - t0:.1f} s into the phase)")
    split_times(card, g)
    qmatmul_plan_times(card, g)


def int4pack_mats(mats):
    """The int4 weights of `mats` as torch._weight_int4pack_mm's operands,
    or None where this torch cannot express them. The port's scheme (signed
    nibbles q in [-7, 7], a multiplier m8 per 128-row group and a scale per
    column) is the library's with the nibbles biased by 8, zero points 0
    and each group's step m8 * scale rounded to bf16; the library's product
    is logged against the plain one."""
    import torch
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant
    out = []
    try:
        for x, w, _ in mats:
            q = quant.unpack4(w["q4"]).to(torch.int32).t() + 8    # [N, K]
            packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
            wp = torch._convert_weight_to_int4pack(packed.contiguous(), 8)
            step = (w["m8"].float() * w["scale"][None]).to(torch.bfloat16)
            sz = torch.stack([step, torch.zeros_like(step)], -1).contiguous()
            out.append((x, (wp, sz), {}))
        x, w, _ = mats[0]
        got = torch._weight_int4pack_mm(x, out[0][1][0], quant.GROUP4,
                                        out[0][1][1])
        want = G.gemv_int4_plain(x, w["q4"], w["m8"], w["scale"])
        log(f"  torch._weight_int4pack_mm at the talker's int4 qkv, M=1: "
            f"relative error {rel_err(got, want):.2e} against the plain B4 "
            f"(group steps rounded to bf16)")
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"  torch._weight_int4pack_mm cannot take the port's int4 "
            f"weights here: {type(e).__name__}: {e}")
        return None
    return out


def attention_case(g, label, nq, nk, T, kv, qdt, cdt, record,
                   name="decode_attention"):
    """A timing case of decode attention over 8 layers of a cache (a tuple
    for `time_cases`); its library yardstick is SDPA over k / v built
    beforehand as the live slots followed by the current token (in q's
    dtype, as SDPA takes one dtype)."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops import flash_decode

    dev = g.device

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kc, vc = randn(8, 1, nk, T, 128, dtype=cdt), randn(8, 1, nk, T, 128,
                                                      dtype=cdt)
    q, kn, vn = (randn(1, nq, 128, dtype=qdt), randn(1, nk, 128, dtype=qdt),
                 randn(1, nk, 128, dtype=qdt))
    lens = torch.tensor([kv], dtype=torch.int32, device=dev)
    vf = torch.zeros(1, dtype=torch.int32, device=dev)
    kl = [torch.cat([kc[l, :, :, :kv], kn[:, :, None]], 2).to(qdt)
          for l in range(8)]
    vl = [torch.cat([vc[l, :, :, :kv], vn[:, :, None]], 2).to(qdt)
          for l in range(8)]
    q4 = q[:, :, None]

    def attn(fn):
        def call():
            for l in range(8):
                fn(q, kc, vc, kn, vn, l, lens, vf)
        return call

    def sdpa():
        for l in range(8):
            F.scaled_dot_product_attention(q4, kl[l], vl[l], enable_gqa=True)

    # a call's bytes: q, k_new, v_new, kv_len, valid_from and the live
    # slots of k and v read, the output written; 8 calls
    n_b = 8 * (nbytes(q, kn, vn, q, lens, vf)
               + 2 * nk * kv * 128 * kc.element_size())
    return (name, f"{label}, per layer", 8,
            attn(flash_decode.decode_attention_stacked),
            attn(flash_decode.decode_attention_plain), sdpa,
            n_b, 8 * 4.0 * nq * (kv + 1) * 128, "f32", record)


def time_cases(rec: Record, card: str, cases):
    """Each case's device time (CUDA-graph replay) against its plain
    version, its PyTorch call and its bound; a case marked `record` goes
    into the JSON line under its name."""
    for (name, label, per, kfn, pfn, lfn, n_b, n_ops, kind,
         record) in cases:
        ms = graph_ms(kfn) / per
        plain = graph_ms(pfn) / per
        lib = graph_ms(lfn) / per if lfn is not None else None
        b_ms, b_by = bound(n_b / per, n_ops / per, kind)
        host = cuda_ms(kfn) / per
        log(f"  {name:16s} {label:60s} device: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library {_fmt4(lib)} ms, bound {b_ms:.3g} ms "
            f"({b_by}, {b_ms / ms:.1%} of it); host-bound eager kernel "
            f"{host:.4f} ms on {card}")
        if record:
            rec.ms[name], rec.plain_ms[name] = ms, plain
            rec.library_ms[name] = lib
            rec.bound[name] = (b_ms, b_by)


def kernel_times(rec: Record, card: str, g):
    """Each kernel's device time (REPS calls captured in one CUDA graph and
    replayed, so host launch cost drops out) against its plain version, one
    PyTorch call that computes the same function where there is one, and
    its bound from the case's own shapes. Weights and caches rotate over
    copies larger than the 50 MB L2, as on the main path. The first case of
    each kernel is its earlier timing shape (kept comparable); the others
    are the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    cases = []      # (name, label, per call, kernel, plain, library, bytes,
    #                  ops, ops kind, recorded in the JSON line)

    def over(mats, fn):
        def call():
            for x, w, kw in mats:
                fn(x, w, **kw)
        return call

    # B: one layer (qkv, wo, gate/up, down) of the talker and the
    # predictor, the talker head, the predictor head's slices; M = 1, 2
    talker = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]
    pred = [(1024, 3072), (1024, 1024), (1024, 6144), (3072, 1024)]
    for what, shapes, copies, M, record in (
            ("talker layer qkv+wo+gate/up+down", talker, 4, 1, True),
            ("talker layer qkv+wo+gate/up+down", talker, 4, 2, False),
            ("predictor layer qkv+wo+gate/up+down", pred, 4, 1, False),
            ("predictor layer qkv+wo+gate/up+down", pred, 4, 2, False),
            ("talker head 2048x2176", [(2048, 2176)], 8, 1, False),
            ("talker head 2048x2176", [(2048, 2176)], 8, 2, False)):
        mats = [(randn(M, k), randn(k, n, scale=0.02), {})
                for _ in range(copies) for k, n in shapes]
        ws = [w for _, w, _ in mats]
        xs = [x for x, _, _ in mats]
        outs = [torch.empty(M, w.shape[1], dtype=torch.bfloat16, device=dev)
                for w in ws]
        flops = 2.0 * M * sum(w.numel() for w in ws)
        cases.append(("gemv", f"{what}, M={M} bf16", copies,
                      over(mats, G.gemv), over(mats, G.gemv_plain),
                      over(mats, torch.matmul),
                      nbytes(*ws, *xs, *outs), flops, "bf16", record))
    head = randn(1024, 16 * 2048, scale=0.02)
    for M in (1, 2):
        x = randn(M, 1024)
        mats = [(x, head, dict(col0=q * 2048, n=2048,
                               epilogue=G.EPI_F32_ROUND_DT))
                for q in range(16)]
        lib = [(x, head[:, q * 2048:(q + 1) * 2048], {}) for q in range(16)]
        cases.append(("gemv", f"predictor head slice 1024x2048 @q*2048, "
                      f"q=0..15, M={M} bf16", 16, over(mats, G.gemv),
                      over(mats, G.gemv_plain), over(lib, torch.matmul),
                      nbytes(head, x) + 16 * M * 2048 * 4,
                      2.0 * M * head.numel(), "bf16", False))

    # B8, B4: one layer per call (B8 the predictor's int8 layer at M=1,
    # 13.6 MB a copy; B4 the talker's int4 layer at M=1, 25 MB); B4's
    # PyTorch call is torch._weight_int4pack_mm (int4pack_mats); B8's,
    # torch._weight_int8pack_mm, is timed with kernel A (qmatmul_times)
    def qlayers(shapes, n_copies, kind, M):
        fn = quant.quantize if kind == "int8" else quant.quantize_int4
        return [(randn(M, k), fn(randn(k, n, scale=0.02)), {})
                for _ in range(n_copies) for k, n in shapes]

    def qbytes(mats, out_el):
        return sum(nbytes(x, *w.values()) + x.shape[0] * w["scale"].shape[0]
                   * out_el for x, w, _ in mats)

    def qops(mats):
        return sum(2.0 * x.numel() * w["scale"].shape[0] for x, w, _ in mats)

    b8_mats = qlayers(pred, 8, "int8", 1)
    b4_mats = qlayers(talker, 4, "int4", 1)
    b4_lib = int4pack_mats(b4_mats)
    cases += [
        ("gemv_int8", "one predictor layer int8: qkv+wo+gate/up+down, M=1 "
         "bf16", 8,
         over(b8_mats, lambda x, w: G.gemv_int8(x, w["q"], w["scale"])),
         over(b8_mats, lambda x, w: G.gemv_int8_plain(x, w["q"],
                                                      w["scale"])),
         None, qbytes(b8_mats, 2), qops(b8_mats), "bf16", True),
        ("gemv_int4", "one talker layer int4: qkv+wo+gate/up+down, M=1 bf16",
         4, over(b4_mats, lambda x, w: G.gemv_int4(x, w["q4"], w["m8"],
                                                   w["scale"])),
         over(b4_mats, lambda x, w: G.gemv_int4_plain(
             x, w["q4"], w["m8"], w["scale"])),
         b4_lib and over(b4_lib, lambda x, w: torch._weight_int4pack_mm(
             x, w[0], quant.GROUP4, w[1])), qbytes(b4_mats, 2),
         qops(b4_mats), "bf16", True)]

    bf, f32 = torch.bfloat16, torch.float32
    cases += [
        attention_case(g, "16/8 hd128 kv_len=1000 T=1024 bf16", 16, 8, 1024,
                       1000, bf, bf, False),
        attention_case(g, "talker 16/8 hd128 kv_len=96 T=256 bf16", 16, 8,
                       256, 96, bf, bf, True),
        attention_case(g, "talker stream 16/8 hd128 kv_len=96 T=4096 bf16",
                       16, 8, 4096, 96, bf, bf, False),
        attention_case(g, "predictor 8/8 hd128 kv_len=8 T=32 bf16 q / f32 "
                       "cache", 8, 8, 32, 8, bf, f32, False)]

    # the Triton passes at the main path's shapes; no single PyTorch call
    x32, w = randn(1, 2048, dtype=torch.float32), randn(2048)
    w32 = w.float()
    cases += [
        # F.rms_norm computes the same function in f32, without the final
        # rounding to bf16
        ("rms_norm", "H=2048 f32 -> bf16", 1,
         lambda: el.rms_norm(x32, w, 1e-6, torch.bfloat16),
         lambda: el.rms_norm_plain(x32, w, 1e-6, torch.bfloat16),
         (lambda: F.rms_norm(x32, (2048,), w32, 1e-6))
         if hasattr(F, "rms_norm") else None,
         nbytes(x32, w) + 2048 * 2, 4.0 * 2048, "f32", True)]

    # the predictor head's 15 slices (1024 x 2048 each of the full-width
    # head, 63 MB of bf16: past the L2) with the final norm as prologue and
    # the argmax epilogue (code q + 1, the next pass's row gathered), one
    # launch a slice; beside them the same 15 slices without the epilogue,
    # so that the epilogue's cost reads as the difference
    CV = 2048
    head = randn(1024, 15 * CV, scale=0.02)
    xh = randn(1, 1024, dtype=torch.float32)
    norm = (randn(1024), 1e-6)
    ptab = randn(16, 3584, 1024)
    codes = torch.zeros(1, 16, dtype=torch.int32, device=dev)
    xo = torch.zeros(1, 1024, device=dev)
    lg = torch.empty(1, CV, device=dev)
    kw = dict(n=CV, epilogue=G.EPI_F32_ROUND_DT, norm=norm,
              dt=torch.bfloat16)

    def slices(fn, argmax):
        def call():
            for qi in range(15):
                fn(xh, head, col0=qi * CV, **kw,
                   **(dict(argmax=(codes, qi + 1, ptab, 3072, xo))
                      if argmax else dict(out=lg)))
        return call

    head_bytes = 1024 * CV * 2 + nbytes(xh, norm[0]) + 4 + 1024 * 2 \
        + nbytes(xo)
    cases += [
        ("argmax_gather_gemv", "predictor head slice 1024x2048 + argmax + "
         "ptab row, B=1 bf16, 15 slices", 15, slices(G.gemv, True),
         slices(G.gemv_plain, True), None, 15 * head_bytes,
         15 * 2.0 * 1024 * CV, "bf16", True),
        ("gemv", "predictor head slice 1024x2048 alone (norm prologue, f32 "
         "logits), B=1 bf16, 15 slices", 15, slices(G.gemv, False),
         slices(G.gemv_plain, False), None,
         15 * (1024 * CV * 2 + nbytes(xh, norm[0], lg)),
         15 * 2.0 * 1024 * CV, "bf16", False)]

    time_cases(rec, card, cases)
    qmatmul_times(rec, card, g)
    norm_fusion_times(rec, card, g)
    epilogue_fusion_times(rec, card, g)
    # B = 2 left out of the full smoke for its 1200 s limit beside phase
    # 12; the functions' defaults keep it for runs of their own
    frame_kernel_times(rec, card, batches=(1, 16))
    step_kernel_times(rec, card, batches=(1, 16, 17, 32))


TALKER_INT8 = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]


def qmatmul_times(rec: Record, card: str, g, rows=(64, 128, 192, 1088),
                  shapes=None, what="talker", json_row=64, name="qmatmul"):
    """Kernel A a talker layer (qkv + wo + gate/up + down, int8; `shapes`
    and `what` another model's) at each M of `rows` (B = 1, 2, 3 and 17
    prompts of 64 tokens): device ms by CUDA-graph replay, weights rotating
    over copies past the 50 MB L2, its plain version, the one PyTorch call of the same function
    (`torch._weight_int8pack_mm`: x bf16 @ int8 [N, K]^T * scale, out bf16)
    and, as a reference only, cuBLAS on a bf16 copy of the weights
    (`torch.matmul`, twice the weight bytes); the bound from the layer's
    bytes or operations, the larger. M = `json_row` goes into the JSON
    line (64: the comparable case of earlier PRs; None: no row) under
    `name`."""
    import torch
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device
    shapes = shapes or TALKER_INT8
    int8mm = getattr(torch, "_weight_int8pack_mm", None)
    for M in rows:
        copies = 4
        mats = []
        for _ in range(copies):
            for K, N in shapes:
                w = quant.quantize(
                    0.02 * torch.randn(K, N, generator=g, device=dev))
                mats.append((torch.randn(M, K, generator=g, device=dev)
                             .bfloat16(), w))

        def run(fn, mats=mats):
            def call():
                for x, w in mats:
                    fn(x, w)
            return call

        kern = run(lambda x, w: quant.qmatmul_kernel(x, w["q"], w["scale"]))
        ms = graph_ms(kern) / copies
        plain = graph_ms(run(lambda x, w: quant.qmatmul_kernel_plain(
            x, w["q"], w["scale"]))) / copies
        lib = None
        if int8mm is not None:
            packed = [(x, w["q"].t().contiguous(), w["scale"].bfloat16())
                      for x, w in mats]
            try:
                def lcall(packed=packed):
                    for x, wt, sc in packed:
                        int8mm(x, wt, sc)
                lib = graph_ms(lcall, reps=2) / copies
            except (RuntimeError, NotImplementedError) as exc:
                log(f"  torch._weight_int8pack_mm at M={M}: "
                    f"{str(exc).splitlines()[0][:120]}")
            del packed
        dense = [(x, (w["q"].float() * w["scale"]).bfloat16())
                 for x, w in mats[:len(shapes)]]

        def dcall(dense=dense):
            for x, wd in dense:
                torch.matmul(x, wd)
        ref = graph_ms(dcall)
        del dense
        n_b = sum(nbytes(x, w["q"], w["scale"]) + 4 * M * w["q"].shape[1]
                  for x, w in mats) / copies
        ops = sum(2.0 * M * w["q"].numel() for _, w in mats) / copies
        b_ms, b_by = bound(n_b, ops, "bf16")
        host = cuda_ms(kern) / copies
        log(f"  qmatmul          {what} layer int8 qkv+wo+gate/up+down, M={M}"
            f" bf16: device kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"_weight_int8pack_mm {_fmt4(lib)} ms, bound {b_ms:.4g} ms "
            f"({b_by}, {b_ms / ms:.1%} of it); reference cuBLAS bf16 "
            f"weights (2x the weight bytes) {ref:.4f} ms; eager host-timed "
            f"{host:.4f} ms on {card}")
        if M == json_row:
            rec.ms[name], rec.plain_ms[name] = ms, plain
            rec.library_ms[name] = lib
            rec.bound[name] = (b_ms, b_by)
        del mats


def qmatmul_plan_times(card: str, g, rows=(64, 1088)):
    """The measurement behind kernel A's plan (`quant.qmatmul_plan`): device
    ms of each talker product at M in `rows` with the plan's tiles, then
    with each column tile, row tile near M and K split (each with as many
    stages as fit), through the wrapper with only the planner
    replaced."""
    from unittest import mock
    import torch
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device
    for M in rows:
        for K, N in TALKER_INT8 + [(2048, 2176), (128, 128)]:
            copies = max(2, min(64, -(-64 * 2**20 // (K * N))))
            ws = [quant.quantize(0.02 * torch.randn(K, N, generator=g,
                                                    device=dev))
                  for _ in range(copies)]
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()

            def fn(ws=ws, x=x):
                for w in ws:
                    quant.qmatmul_kernel(x, w["q"], w["scale"])
            p = quant.qmatmul_plan(M, K, N)
            alts = [p] + [quant.QPlan(bn, mt, s, 0)
                          for bn in (128, 256) for mt in quant.A_MT
                          for s in quant.A_SPLITS
                          if N % bn == 0 and (K // quant.A_BK) % s == 0
                          and (bn == 128 or mt <= quant.A_WIDE_MT)
                          and (M // 2 < mt <= 2 * M or M > 192 <= mt + 64)
                          and (bn, mt, s) != (p.bn, p.mt, p.splits)]
            out = []
            for a in alts:
                a = quant.qmatmul_ring(a.bn, a.mt, a.splits,
                                       K // quant.A_BK // a.splits)
                with mock.patch.object(quant, "qmatmul_plan",
                                       lambda *_, a=a: a):
                    out.append((a, graph_ms(fn) / copies))
            log(f"  qmatmul plan {K}x{N} M={M}: " + "; ".join(
                f"bn{a.bn} mt{a.mt} s{a.splits} st{a.stages} {t:.4f}"
                for a, t in out) + f" ms (first: the plan) on {card}")
            del ws


def frame_bytes_ops(params, cfg, B):
    """(bytes, operations) the predictor frame must move and do: the layer
    stack's weights once a pass (16 passes: the stack, 218 MB in bf16, does
    not stay on a chip with 50 MB of L2 and ~30 MB of shared memory), 15
    head slices, the 15 ptab rows gathered, h1024 and code_0 read and the
    codes written; two operations a weight element a row."""
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    nb, cv = P.NUM_CODEBOOKS, P.CODE_VOCAB
    stack = head = 0
    for st, w in fp._weights(params).items():
        n = sum(nbytes(t) for t in (w.values() if isinstance(w, dict)
                                    else (w,)))
        if st == "head":
            head = n * (nb - 1) // nb
        else:
            stack += n
    elt = 2 if cfg.dtype == "bfloat16" else 4          # ptab's rows
    n_b = nb * stack + head + (nb - 1) * B * cfg.hidden * elt \
        + B * cfg.hidden * 4 + B * 4 + B * nb * 4
    K_N = sum(K * N for K, N in fp.stage_shapes(cfg).values()
              if (K, N) != (cfg.hidden, cv)) * cfg.n_layers
    ops = 2.0 * B * (nb * K_N + (nb - 1) * cfg.hidden * cv)
    return n_b, ops


def frame_kernel_times(rec: Record, card: str, batches=(1, 2, 16)):
    """The predictor frame kernel per frame at full width (device ms by
    CUDA-graph replay: the cooperative launch captures; and by the
    profiler) against its bound and the chain it replaces (`_frame` over
    the chain's kernels, ~670 launches; the kernels' device time in a
    profiler trace, so host cost drops out), dense bf16, int8 and int4 at
    each B of `batches`, on the device (`fused_predictor.ROUTE_MAX_B` comes
    from the end-to-end times, `tools/frame_measure.py route predictor`).
    The plain version (profiler) at the first B. Dense and int4 at the
    first B are the JSON line's `predictor_frame` and
    `predictor_frame_int4`; no single PyTorch call computes a frame."""
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.ops import chain
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp

    cfg = EngineConfig().predictor
    for kind in ("dense", "int8", "int4"):
        for B in batches:
            pp, _, ptab, rows, h, c0 = frame_case(cfg, kind, B, 90 + B)
            args = (pp, cfg, ptab, rows, h, c0)
            ms = graph_ms(lambda: fp.predictor_frame_kernel(*args), reps=10)
            prof = profiled_device_ms(
                lambda: fp.predictor_frame_kernel(*args), 3)
            # the chain and the plain version build their RoPE tables from
            # host data each frame, which a CUDA graph cannot capture: their
            # kernels' device time from the profiler, after one warm call
            chain_fn = lambda: fp._frame(chain.KERNELS, *args)  # noqa: E731
            chain_fn()
            ch = profiled_device_ms(chain_fn, 2)
            plain = None
            if B == batches[0]:
                plain_fn = lambda: fp.frame_codes_fused_plain(*args)  # noqa
                plain_fn()
                plain = profiled_device_ms(plain_fn, 1)
            n_b, ops = frame_bytes_ops(pp, cfg, B)
            b_ms, b_by = bound(n_b, ops, "bf16" if kind == "dense"
                               else "int8")
            log(f"  {'predictor_frame':16s} {f'full {kind} B={B}, a frame':44s}"
                f" device: kernel {ms:.4f} ms (graph replay; profiler "
                f"{_fmt4(prof)}), the chain it replaces {_fmt4(ch)} ms, "
                f"plain {_fmt4(plain)} ms (profiler), bound {b_ms:.4f} ms "
                f"({b_by}, {b_ms / ms:.1%} of it; {n_b / 1e9:.3f} GB) on "
                f"{card}")
            name = {"dense": "predictor_frame",
                    "int4": "predictor_frame_int4"}.get(kind)
            if name is not None and B == batches[0]:
                rec.ms[name], rec.plain_ms[name] = ms, plain
                rec.library_ms[name] = None
                rec.bound[name] = (b_ms, b_by)
            del pp, args


def step_bytes_ops(params, cfg, B, live):
    """(bytes, operations) the talker step must move and do: every weight
    once (the 28 layers and the head; 2.83 GB dense bf16 at full width),
    the live cache slots' keys and values once a row and layer, x read,
    the hidden, the logits and the new k / v slots written; two operations
    a weight element a row, four a live slot's element a q head."""
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    w_b = sum(nbytes(*(w.values() if isinstance(w, dict) else (w,)))
              for w in ft._weights(params).values())
    t = 2 if cfg.dtype == "bfloat16" else 4
    L, nk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv = 2 * L * nk * hd * t
    n_b = w_b + B * (live * kv + kv + 2 * cfg.hidden * t + cfg.vocab * 4)
    K_N = sum(K * N for K, N in ft.stage_shapes(cfg).values()
              if (K, N) != (cfg.hidden, cfg.vocab)) * L \
        + cfg.hidden * cfg.vocab
    ops = 2.0 * B * K_N + 4.0 * B * L * cfg.n_q_heads * hd * (live + 1)
    return n_b, ops


def kernel_copy_bytes(params, cfg) -> int:
    """Device bytes of the talker step kernel's own copies of the weights
    (`ops/fused_talker.py kernel_copy`: the values and int4's multipliers
    packed in units, int4's rows paired, the qkv and gate/up columns
    reordered), kept beside the weights the chain and the prefill read."""
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    n = 0
    for st, w in ft._weights(params).items():
        parts = [(w, "values")] if not isinstance(w, dict) else \
            [(t, "values" if k == "q" else k) for k, t in w.items()]
        for t, part in parts:
            c = ft.kernel_copy(t, st, part, cfg)
            n += 0 if c is t else c.nbytes
    return n


def step_kernel_times(rec: Record, card: str,
                      batches=(1, 2, 16, 17, 32)):
    """The talker step kernel at full width, T = 256 with ~100 live slots
    (the offline window): device ms a step by CUDA-graph replay (and the
    profiler) against its bound, the chain it replaces (`_step` over the
    chain's kernels, ~142 launches; profiler) and its plain version
    (profiler), dense bf16, int8 and int4, at each B of `batches` (the
    route's limits come from the end-to-end times, `tools/frame_measure.py
    route`). Dense B = 1 is the JSON line's `talker_step`, dense B = 32
    its `talker_step_b17_32`; no single PyTorch call computes a step."""
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.ops import chain
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.tools import frame_measure as fm

    cfg = EngineConfig().talker
    for kind in ("dense", "int8", "int4"):
        for B in batches:
            tp, x, pos, slot, kv_len, vf, kc, vc = fm.step_case(
                cfg, kind, B, 256, 100, 300 + B)
            args = (tp, cfg, x, pos, slot, kv_len, vf, kc, vc)
            kern = lambda: ft.talker_step_kernel(*args)  # noqa: E731
            chain_fn = lambda: ft._step(chain.KERNELS, *args)  # noqa: E731
            plain_fn = lambda: ft.talker_step_fused_plain(*args)  # noqa: E731
            ms = graph_ms(kern, reps=10)
            prof = profiled_device_ms(kern, 3)
            chain_fn()
            ch = profiled_device_ms(chain_fn, 3)
            plain_fn()
            plain = profiled_device_ms(plain_fn, 1)
            live = float((kv_len - vf).float().mean())
            n_b, ops = step_bytes_ops(tp, cfg, B, live)
            b_ms, b_by = bound(n_b, ops, "int8" if kind != "dense"
                               else "bf16")
            share = f", {b_ms / ms:.1%} of it"
            log(f"  {'talker_step':16s} {f'full {kind} B={B}, a step':44s} "
                f"device: kernel {_fmt4(ms)} ms (graph replay; profiler "
                f"{_fmt4(prof)}), the chain it replaces {_fmt4(ch)} ms, plain"
                f" {_fmt4(plain)} ms (profiler), bound {b_ms:.4f} ms "
                f"({b_by}{share}; {n_b / 1e9:.3f} GB) on {card}")
            if B == batches[0]:
                w_b = sum(nbytes(*(w.values() if isinstance(w, dict)
                                   else (w,)))
                          for w in ft._weights(tp).values())
                log(f"  {'talker_step':16s} {f'full {kind} weights':44s} the "
                    f"kernel's copies {kernel_copy_bytes(tp, cfg) / 1e9:.3f} GB "
                    f"of device memory beside {w_b / 1e9:.3f} GB of weights")
            name = {1: "talker_step", 32: "talker_step_b17_32"}.get(B)
            if kind == "dense" and name is not None:
                rec.ms[name], rec.plain_ms[name] = ms, plain
                rec.library_ms[name] = None
                rec.bound[name] = (b_ms, b_by)
            del tp, args, kc, vc


def norm_fusion_times(rec: Record, card: str, g):
    """The norm prologue against the launch it removes: per normed product
    (qkv with its ln1, gate/up with its ln2; 4 copies of the layer's pair
    over the L2), device ms (CUDA-graph replay) of the product alone (x
    already normed), of the standalone Triton rms_norm then the product,
    and of the product with the fused norm; B at the talker layer, B8 at
    the predictor layer, B4 at the talker layer, M=1 bf16. B's case is the
    fused norm's entry in the JSON line (its bound: the product's weights,
    the f32 residual, the norm weight and the output)."""
    import torch
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    for label, K, Ns, kind, record in (
            ("B talker qkv + gate/up", 2048, (4096, 12288), "dense", True),
            ("B8 predictor qkv + gate/up", 1024, (3072, 6144), "int8",
             False),
            ("B4 talker qkv + gate/up", 2048, (4096, 12288), "int4",
             False)):
        fn, plain = {"dense": (G.gemv, G.gemv_plain),
                     "int8": (G.gemv_int8, G.gemv_int8_plain),
                     "int4": (G.gemv_int4, G.gemv_int4_plain)}[kind]
        x = randn(1, K, dtype=torch.float32)
        ln = randn(K)
        xn = el.rms_norm(x, ln, 1e-6, bf)
        mats = []
        for _ in range(4):
            for n, epi in zip(Ns, (G.EPI_STORE_DT, G.EPI_F32)):
                w = randn(K, n, scale=0.02)
                wargs = (w,) if kind == "dense" else tuple(
                    (quant.quantize(w.float()) if kind == "int8"
                     else quant.quantize_int4(w.float())).values())
                mats.append((wargs, epi))

        def run(f, normed):
            def call():
                for wargs, epi in mats:
                    if normed == "fused":
                        f(x, *wargs, epilogue=epi, norm=(ln, 1e-6), dt=bf)
                    elif normed == "standalone":
                        f(el.rms_norm(x, ln, 1e-6, bf), *wargs, epilogue=epi)
                    else:
                        f(xn, *wargs, epilogue=epi)
            return call

        per = len(mats)
        alone = graph_ms(run(fn, "none")) / per
        unfused = graph_ms(run(fn, "standalone")) / per
        fused = graph_ms(run(fn, "fused")) / per
        log(f"  {'rms_norm_gemv':16s} {label + ', per product, M=1 bf16':44s}"
            f" device: product alone {alone:.4f} ms, rms_norm + product "
            f"{unfused:.4f} ms, fused norm {fused:.4f} ms (the fused norm "
            f"costs {fused - alone:+.4f} ms, the launch it removes "
            f"{unfused - alone:+.4f}) on {card}")
        if record:
            n_b = sum(nbytes(*wargs) + (2 if epi == G.EPI_STORE_DT else 4)
                      * wargs[0].shape[1] for wargs, epi in mats)
            n_b += per * nbytes(x, ln)
            ops = sum(2.0 * K * wargs[0].shape[1] for wargs, _ in mats)
            rec.ms["rms_norm_gemv"] = fused
            rec.plain_ms["rms_norm_gemv"] = graph_ms(run(plain, "fused")) / per
            rec.library_ms["rms_norm_gemv"] = None
            rec.bound["rms_norm_gemv"] = bound(n_b / per, ops / per, "bf16")


def epilogue_fusion_times(rec: Record, card: str, g):
    """The qk epilogue and the silu prologue against the product alone, per
    product, M=1 bf16, 4 copies of the layer's pair over the L2, device ms
    (CUDA-graph replay): the qkv product with its norm prologue storing the
    qkv row, then with the qk epilogue (q, k, v; the predictor's with its
    KV store); the down product from the silu output in bf16, then from the
    f32 gate/up with the silu prologue. B at the talker layer, B8 at the
    predictor layer, B4 at the talker layer. B's cases are the two pieces'
    entries in the JSON line (bound: the product's weights, its inputs and
    outputs each once)."""
    import torch
    from qwen3_tts_tpu_torch.ops import elementwise as el
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    for label, K, nq, nk, F, kind, kv, record in (
            ("B talker", 2048, 16, 8, 6144, "dense", False, True),
            ("B8 predictor", 1024, 8, 8, 3072, "int8", True, False),
            ("B4 talker", 2048, 16, 8, 6144, "int4", False, False)):
        fn, plain = {"dense": (G.gemv, G.gemv_plain),
                     "int8": (G.gemv_int8, G.gemv_int8_plain),
                     "int4": (G.gemv_int4, G.gemv_int4_plain)}[kind]

        def weights(k, n):
            w = randn(k, n, scale=0.02)
            return (w.to(bf),) if kind == "dense" else tuple(
                (quant.quantize(w) if kind == "int8"
                 else quant.quantize_int4(w)).values())
        N = (nq + 2 * nk) * 128
        mats = [(weights(K, N), weights(F, K)) for _ in range(4)]
        c = qk_case(randn, K, nq, nk, bf, 1)
        x, ln, qk = c["x"], c["ln"], c["qk"]
        views = c["views"] if kv else None
        outs = tuple(torch.empty(1, n, 128, dtype=bf, device=dev)
                     for n in (nq, nk, nk))
        gu = randn(1, 2 * F, scale=2.0)
        act = el.silu_mul_plain(gu, bf)
        res = randn(1, K)

        def qkv_call(f, fused):
            def call():
                for wq, _ in mats:
                    if fused:
                        f(x, *wq, norm=(ln, 1e-6), qk=qk, out=outs, kv=views,
                          dt=bf)
                    else:
                        f(x, *wq, norm=(ln, 1e-6), dt=bf)
            return call

        def down_call(f, fused):
            def call():
                for _, wd in mats:
                    if fused:
                        f(gu, *wd, epilogue=G.EPI_ADD_F32, out=res, act="silu",
                          dt=bf)
                    else:
                        f(act, *wd, epilogue=G.EPI_ADD_F32, out=res)
            return call

        per = len(mats)
        qk_alone = graph_ms(qkv_call(fn, False)) / per
        qk_fused = graph_ms(qkv_call(fn, True)) / per
        d_alone = graph_ms(down_call(fn, False)) / per
        d_fused = graph_ms(down_call(fn, True)) / per
        log(f"  {'qk_rope_gemv':16s} {label + f' qkv {K}x{N}, M=1 bf16':44s}"
            f" device: product with the norm, storing the qkv row "
            f"{qk_alone:.4f} ms, with the qk epilogue"
            f"{' and the KV store' if kv else ''} {qk_fused:.4f} ms "
            f"({qk_fused - qk_alone:+.4f}) on {card}")
        log(f"  {'silu_gemv':16s} {label + f' down {F}x{K}, M=1 bf16':44s}"
            f" device: product from the bf16 silu output {d_alone:.4f} ms, "
            f"with the silu prologue {d_fused:.4f} ms "
            f"({d_fused - d_alone:+.4f}) on {card}")
        if record:
            w_b = sum(nbytes(*wq) for wq, _ in mats) / per
            n_b = w_b + nbytes(x, ln, qk[0], qk[1], qk[2], qk[3], *outs)
            rec.ms["qk_rope_gemv"] = qk_fused
            rec.plain_ms["qk_rope_gemv"] = graph_ms(qkv_call(plain, True)) \
                / per
            rec.library_ms["qk_rope_gemv"] = None
            rec.bound["qk_rope_gemv"] = bound(n_b, 2.0 * K * N, "bf16")
            w_b = sum(nbytes(*wd) for _, wd in mats) / per
            n_b = w_b + nbytes(gu) + 2 * nbytes(res)
            rec.ms["silu_gemv"] = d_fused
            rec.plain_ms["silu_gemv"] = graph_ms(down_call(plain, True)) / per
            rec.library_ms["silu_gemv"] = None
            rec.bound["silu_gemv"] = bound(n_b, 2.0 * F * K, "bf16")


def split_times(card: str, g):
    """The measurement behind the split plans of the cluster kernels
    (`gemv.gemv_splits`, `gemv.gemv4_splits`,
    `flash_decode.attention_splits`): device ms per call (CUDA-graph
    replay) of B, B8, B4 and decode attention at main-path shapes with the split count forced to 1, 2, 4 and 8 (one split is a
    plain launch, more a cluster launch), beside the plan's own choice.
    The calls go through the wrappers, with their checks; only the planner
    they consult is replaced. Weights and caches rotate over copies larger
    than the 50 MB L2, as in `kernel_times`."""
    from unittest import mock
    import torch
    from qwen3_tts_tpu_torch.kernels import build
    from qwen3_tts_tpu_torch.ops import flash_decode
    from qwen3_tts_tpu_torch.ops import gemv as G
    from qwen3_tts_tpu_torch.ops import quant

    dev = g.device
    sms = build.sm_count(dev)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    def sweep(label, fn, per, target, name, planned):
        times = []
        for s in (1, 2, 4, 8):
            with mock.patch.object(target, name, lambda *a, s=s: s):
                times.append(graph_ms(fn) / per)
        log(f"  splits {label:44s} "
            + " ".join(f"s{s}={t:.4f}" for s, t in zip((1, 2, 4, 8), times))
            + f" ms; plan s{planned} on {card}")

    bf = torch.bfloat16
    for label, K, N, kind in (
            ("B talker qkv 2048x4096, M=1", 2048, 4096, G.DENSE),
            ("B predictor qkv 1024x3072, M=1", 1024, 3072, G.DENSE),
            ("B one tile 256x128, M=1 (launch floor)", 256, 128, G.DENSE),
            ("B8 predictor qkv 1024x3072, M=1", 1024, 3072, G.INT8),
            ("B4 talker qkv 2048x4096, M=1", 2048, 4096, G.INT4),
            ("B4 talker gate/up 2048x12288, M=1", 2048, 12288, G.INT4)):
        w_bytes = {G.DENSE: 2, G.INT8: 1, G.INT4: 0.5}[kind]
        copies = int(min(64, max(2, -(-64 * 2**20 // (K * N * w_bytes)))))
        x = randn(1, K)
        if kind == G.INT8:
            ws = [quant.quantize(randn(K, N, scale=0.02))
                  for _ in range(copies)]

            def fn(ws=ws, x=x):
                for w in ws:
                    G.gemv_int8(x, w["q"], w["scale"])
            w0 = ws[0]["q"]
        elif kind == G.INT4:
            ws = [quant.quantize_int4(randn(K, N, scale=0.02))
                  for _ in range(copies)]

            def fn(ws=ws, x=x):
                for w in ws:
                    G.gemv_int4(x, w["q4"], w["m8"], w["scale"])
            w0 = ws[0]["q4"]
        else:
            ws = [randn(K, N, scale=0.02) for _ in range(copies)]

            def fn(ws=ws, x=x):
                for w in ws:
                    G.gemv(x, w)
            w0 = ws[0]
        planned = G.launch_splits(x, w0, 1, K, N, kind, bf, G.PRO_NONE)
        sweep(label, fn, copies, G, "launch_splits", planned)
        del ws

    f32 = torch.float32
    for label, nq, nk, T, kv, cdt in (
            ("attention talker kv_len 96 of 256", 16, 8, 256, 96, bf),
            ("attention talker kv_len 96 of 4096", 16, 8, 4096, 96, bf),
            ("attention predictor kv_len 8 of 32, f32 cache", 8, 8, 32, 8,
             f32)):
        kc, vc = (randn(8, 1, nk, T, 128, dtype=cdt) for _ in range(2))
        q, kn, vn = (randn(1, n, 128) for n in (nq, nk, nk))
        lens = torch.tensor([kv], dtype=torch.int32, device=dev)
        vf = torch.zeros(1, dtype=torch.int32, device=dev)

        def fn(kc=kc, vc=vc, q=q, kn=kn, vn=vn, lens=lens, vf=vf):
            for layer in range(8):
                flash_decode.decode_attention_stacked(q, kc, vc, kn, vn,
                                                      layer, lens, vf)
        sweep(label, fn, 8, flash_decode, "attention_splits",
              flash_decode.attention_splits(1, nk, T, sms))


LONG_TEXT = ("The port loads what it saved. Each sentence is a chunk of its "
             "own! The chunks run as one batch; the waveforms are joined in "
             "order. That is how long text is spoken.")


def greedy_codes(e, frames=32):
    """Greedy codes of generate_codes(ignore_eos=True), B = 1, `frames`
    frames, for TEXT and the vivian voice."""
    import torch
    from qwen3_tts_tpu_torch.tts import generate
    cfg = e.config
    d = e._prompt_for_voice(TEXT, e.get_speaker("vivian"), None)
    b, o = e._pad_prompts([d.embeds])
    with torch.inference_mode():
        codes, n = generate.generate_codes(
            e.models, cfg.talker, cfg.predictor, b, o, None, 0.0, 0, 1.0,
            frames, ignore_eos=True)
    return codes, n


def phase_checkpoint(eng, rec: Record, card: str):
    """save_checkpoint at full width (dense bf16), the .npz directory and
    the reference's llama GGUF layout loaded on the card, greedy codes
    identical to the in-memory engine's; then the CLI on the directory,
    with --stream and with --long. The directory is removed in any case."""
    import tempfile

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import TtsEngine, cli
    from qwen3_tts_tpu_torch.assets.llama_gguf import export_llama_gguf
    from qwen3_tts_tpu_torch.utils.audio import AudioSample

    log(f"[9/12] checkpoint: save_checkpoint, TtsEngine(model_dir=...) and "
        f"the CLI, full width, on {card}")
    cfg = eng.config
    spk = os.path.join(REPO, "speakers")
    fused = fused_per_frame(cfg)
    tmp = tempfile.mkdtemp(prefix="qwen3_tts_ckpt_")
    try:
        log(f"  {tmp}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
        want, n_want = run_main_path(
            rec, "in-memory engine greedy generate_codes B=1 32 frames",
            lambda: greedy_codes(eng), STEPS, fused)

        def sizes():
            return {f: os.path.getsize(os.path.join(tmp, f))
                    for f in sorted(os.listdir(tmp))}

        def load_and_compare(layout):
            torch.cuda.synchronize()
            t0 = time.time()
            e = TtsEngine(model_dir=tmp, config=cfg, speakers_dir=spk,
                          device=eng.device)
            torch.cuda.synchronize()
            load_s = time.time() - t0
            got, n_got = run_main_path(
                rec, f"{layout}-loaded engine greedy generate_codes B=1 "
                f"32 frames", lambda: greedy_codes(e), STEPS, fused)
            same = torch.equal(got, want) and torch.equal(n_got, n_want)
            log(f"  {layout}: load {load_s:.2f} s on {card}; codes "
                f"{tuple(got.shape)} identical to the in-memory engine's: "
                f"{same}")
            if not same:
                fail(f"{layout}-loaded engine's greedy codes differ from the "
                     "in-memory engine's")
            del e

        t0 = time.time()
        eng.save_checkpoint(tmp)
        save_s = time.time() - t0
        written = sizes()
        log(f"  save_checkpoint: {sum(written.values())} bytes in "
            f"{save_s:.2f} s on {card}: {json.dumps(written)}")
        load_and_compare("npz")

        # the reference's layout: llama.cpp GGUF decoders, no decoder .npz
        t0 = time.time()
        for kind in ("talker", "predictor"):
            export_llama_gguf(os.path.join(tmp, f"qwen3_tts_{kind}.gguf"),
                              getattr(cfg, kind), eng.models[kind])
            os.remove(os.path.join(tmp, f"{kind}.npz"))
        export_s = time.time() - t0
        gg = {k: v for k, v in sizes().items() if k.endswith("_tts_talker.gguf")
              or k.endswith("_tts_predictor.gguf")}
        log(f"  export_llama_gguf: {sum(gg.values())} bytes in "
            f"{export_s:.2f} s on {card}: {json.dumps(gg)}")
        load_and_compare("gguf")

        # the CLI, as a user runs it on the directory (offline)
        os.environ["QWEN3_TTS_OFFLINE"] = "1"
        for mode, text, flag in (("stream", TEXT, "--stream"),
                                 ("long", LONG_TEXT, "--long")):
            wav = os.path.join(tmp, f"cli_{mode}.wav")
            argv = ["--model-dir", tmp, "--no-download",
                    "--device", str(eng.device),
                    "--text", text, flag, "--max-steps", "32", "--seed", "0",
                    "--speakers-dir", spk, "--output", wav]
            rc = run_main_path(rec, f"cli {flag}", lambda: cli.main(argv),
                               STEPS)
            if rc != 0 or not os.path.exists(wav):
                fail(f"cli {flag} returned {rc} without writing {wav}")
            audio = AudioSample.load_wav(wav)
            log(f"  cli {flag}: {audio.duration():.3f} s of audio")
            if not audio.duration() > 0 or not np.isfinite(
                    audio.samples).all():
                fail(f"cli {flag}: the WAV is empty or not finite")
            check_wav(f"cli {flag}", audio.samples, 32 * 8)

        # the reference's raw release (the GGUFs above, ONNX graphs) through
        # the port's convert_weights, loaded and run on the card
        release_checks(eng, rec, card, tmp, want, n_want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        fail(f"{tmp} was not removed")


def leaves_equal(label, npz_path, tree, skip=()):
    """Every leaf of the .npz at `npz_path` torch.equal to `tree`'s on its
    device, the same paths (less `skip`); fails otherwise."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.assets import checkpoint
    want = {k: v for k, v in checkpoint.flatten(tree) if k not in skip}
    with np.load(npz_path) as f:
        if sorted(k for k in f.files if k not in skip) != sorted(want):
            fail(f"{label}: leaves {sorted(f.files)} != {sorted(want)}")
        bad = [k for k, w in want.items()
               if not torch.equal(torch.from_numpy(f[k]).to(w.device), w)]
    log(f"  {label}: {len(want)} leaves torch.equal to those written: "
        f"{not bad}")
    if bad:
        fail(f"{label}: leaves differ from those written: {bad[:8]}")


def release_checks(eng, rec: Record, card: str, tmp: str, want, n_want):
    """The reference's raw release at full width through the port's tool
    (`tools/convert_weights.main`, in process): the llama GGUFs phase 9
    wrote, `qwen3_tts_decoder.onnx` written from the engine's vocoder with
    torch names and anonymized, both encoder graphs (seeded
    random_encoders, anonymized), the general snake vocoder anonymized and
    converted with no config. Every converted vocoder and encoder leaf
    torch.equal to the one written; TtsEngine(model_dir=...) on the
    output: greedy codes identical to the in-memory engine's, its waveform
    within GENERAL_REL, create_voice_file's codes equal and embedding
    within GENERAL_REL; the derived general config equal to the one
    written. One graph in memory at a time; bytes and seconds of each
    write, read and conversion."""
    import dataclasses
    import filecmp

    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.assets import onnx
    from qwen3_tts_tpu_torch.models import encoders, vocoder
    from qwen3_tts_tpu_torch.tools import convert_weights as cw

    t_phase = time.time()
    cfg = eng.config
    dev = eng.device
    spk = os.path.join(REPO, "speakers")
    rel = os.path.join(tmp, "release")
    os.makedirs(rel)
    for name in ("qwen3_tts_talker.gguf", "qwen3_tts_predictor.gguf",
                 "qwen3_assets.gguf"):
        os.replace(os.path.join(tmp, name), os.path.join(rel, name))

    def timed(label, fn, path=None):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        size = f" {os.path.getsize(path)} bytes," if path else ""
        log(f"  {label}:{size} {dt:.2f} s on {card}")
        return out

    def write(name, fn):
        path = os.path.join(rel, name)
        timed(f"write {name}", lambda: fn(path), path)
        timed(f"read {name}", lambda: onnx.read_model(path), path)
        return path

    def convert(label, argv, out):
        rc = timed(f"convert {label} -> {out}",
                   lambda: cw.main(argv + ["--out", out]))
        if rc != 0:
            fail(f"convert_weights {label} returned {rc}")

    log(f"  release: the reference's raw artifacts at full width through "
        f"python -m qwen3_tts_tpu_torch.tools.convert_weights, on {card}")
    out = os.path.join(tmp, "converted")
    for kind in ("talker", "predictor"):
        gg = os.path.join(rel, f"qwen3_tts_{kind}.gguf")
        convert(f"{os.path.basename(gg)} ({os.path.getsize(gg)} bytes)",
                [f"--{kind}", gg], out)
    shutil.copy(os.path.join(rel, "qwen3_assets.gguf"), out)

    # the downloader's layout for validate_release (`validate_release`
    # below): the GGUFs linked, the graphs moved in once converted
    vdir = os.path.join(tmp, "validate")
    os.makedirs(os.path.join(vdir, "gguf"))
    os.makedirs(os.path.join(vdir, "onnx"))
    for name in ("qwen3_tts_talker.gguf", "qwen3_tts_predictor.gguf",
                 "qwen3_assets.gguf"):
        os.link(os.path.join(rel, name), os.path.join(vdir, "gguf", name))
    dec = write("qwen3_tts_decoder.onnx", lambda p: cw.write_vocoder_onnx(
        p, eng.vocoder_params, cfg.vocoder))
    convert("qwen3_tts_decoder.onnx", ["--vocoder", dec], out)
    os.replace(dec, os.path.join(vdir, "onnx", os.path.basename(dec)))
    # the decoder's unused head slot is not in the graph: converted as 0
    head = "transformer/head"
    leaves_equal("vocoder (named graph)", os.path.join(out, "vocoder.npz"),
                 eng.vocoder_params, skip=(head,))
    ae, se = encoders.random_encoders(
        torch.Generator(device=dev).manual_seed(11), cfg, eng.vocoder_params)
    for kind, enc in (("audio", ae), ("speaker", se)):
        name = ("qwen3_tts_codec_encoder.onnx" if kind == "audio"
                else "qwen3_tts_speaker_encoder.onnx")
        path = write(name, lambda p: cw.write_encoder_onnx(
            p, enc.params, kind, getattr(cfg, f"{kind}_encoder"),
            anonymize=True))
        convert(name, [f"--{kind}-encoder", path], out)
        os.replace(path, os.path.join(vdir, "onnx", name))
        leaves_equal(f"{kind} encoder (anonymized graph)",
                     os.path.join(out, f"{kind}_encoder.npz"), enc.params)

    # the same decoder anonymized: the structural mapper at full width
    anon = os.path.join(tmp, "converted_anonymized")
    dec = write("qwen3_tts_decoder_anonymized.onnx",
                lambda p: cw.write_vocoder_onnx(p, eng.vocoder_params,
                                                cfg.vocoder, anonymize=True))
    convert("qwen3_tts_decoder_anonymized.onnx", ["--vocoder", dec], anon)
    os.remove(dec)
    leaves_equal("vocoder (anonymized graph)",
                 os.path.join(anon, "vocoder.npz"), eng.vocoder_params,
                 skip=(head,))
    same_cfg = filecmp.cmp(os.path.join(anon, "vocoder_config.json"),
                           os.path.join(out, "vocoder_config.json"),
                           shallow=False)
    if not same_cfg:
        fail("the anonymized decoder's vocoder_config.json differs from the "
             "named one's")
    shutil.rmtree(anon)

    # the converted directory on the card against the in-memory engine
    t0 = time.time()
    e = TtsEngine(model_dir=out, config=cfg, speakers_dir=spk, device=dev)
    torch.cuda.synchronize()
    log(f"  converted engine: load {time.time() - t0:.2f} s on {card}; "
        f"encoders loaded: {e.encoder is not None}")
    vcfg = dataclasses.asdict(e.config.vocoder)
    if vcfg != dataclasses.asdict(cfg.vocoder):
        fail(f"the derived vocoder config {vcfg} != the engine's "
             f"{dataclasses.asdict(cfg.vocoder)}")
    fused = fused_per_frame(cfg)
    got, n_got = run_main_path(
        rec, "converted engine greedy generate_codes B=1 32 frames",
        lambda: greedy_codes(e), STEPS, fused)
    if not (torch.equal(got, want) and torch.equal(n_got, n_want)):
        fail("the converted engine's greedy codes differ from the in-memory "
             "engine's")
    log("  converted engine: greedy codes identical to the in-memory "
        "engine's: True")
    saved = (eng.sampler_config, eng.max_steps, eng.encoder,
             eng.speaker_encoder)
    greedy = SamplerConfig(temperature=0.0, top_k=0, top_p=1.0, seed=0)
    wavs = {}
    try:
        for label, x in (("in-memory", eng), ("converted", e)):
            x.set_sampler_config(greedy)
            x.set_max_steps(32)
            wavs[label] = run_main_path(
                rec, f"{label} engine generate_with_voice greedy",
                lambda: x.generate_with_voice(
                    TEXT, x.get_speaker("vivian")).samples, STEPS, fused)
            check_wav(f"{label} engine", wavs[label], 32)
        err = rel_err(torch.from_numpy(wavs["converted"]),
                      torch.from_numpy(wavs["in-memory"])) \
            if len(wavs["converted"]) == len(wavs["in-memory"]) else 1.0
        log(f"  converted engine: waveform rel err {err:.3e} (limit "
            f"{GENERAL_REL:g})")
        if not err <= GENERAL_REL:
            fail(f"the converted engine's waveform is {err:.3e} from the "
                 "in-memory engine's")
        ref = write_ref_wav(os.path.join(tmp, "ref_4s.wav"), 4, seed=4)
        eng.encoder, eng.speaker_encoder = ae, se
        v_want = eng.create_voice_file(ref, "A reference transcript.")
        v_got = e.create_voice_file(ref, "A reference transcript.")
        err = rel_err(torch.tensor(v_got.speaker_embedding),
                      torch.tensor(v_want.speaker_embedding))
        same = v_got.audio_codes == v_want.audio_codes
        log(f"  create_voice_file through the converted encoders: "
            f"{len(v_got.audio_codes) // 16} frames of codes equal: {same}; "
            f"speaker embedding rel err {err:.3e}")
        if not same or not err <= GENERAL_REL:
            fail("create_voice_file through the converted encoders differs")
    finally:
        (eng.sampler_config, eng.max_steps, eng.encoder,
         eng.speaker_encoder) = saved
    del e

    # the general snake vocoder, anonymized, converted with no config
    gcfg = general_vocoder_config()
    gparams = vocoder.init_vocoder(
        torch.Generator(device=dev).manual_seed(23), gcfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(24)

    def vary(node):         # alphas other than 1, so none is swapped
        for k, v in node.items() if isinstance(node, dict) else ():
            if k.startswith("alpha"):
                v.uniform_(0.5, 1.5, generator=g)
            elif isinstance(v, (dict, list)):
                vary(v)
        for v in node if isinstance(node, list) else ():
            vary(v)

    vary(gparams)
    gdir = os.path.join(tmp, "converted_general")
    dec = write("qwen3_tts_decoder_general.onnx",
                lambda p: cw.write_vocoder_onnx(p, gparams, gcfg,
                                                anonymize=True))
    convert("qwen3_tts_decoder_general.onnx (no config)",
            ["--vocoder", dec], gdir)
    os.remove(dec)
    leaves_equal("general vocoder (anonymized graph)",
                 os.path.join(gdir, "vocoder.npz"), gparams, skip=(head,))
    from qwen3_tts_tpu_torch.core.config import load_vocoder_config
    derived = load_vocoder_config(os.path.join(gdir, "vocoder_config.json"))
    pads = tuple(pl for pl, _ in vocoder.stage_pads(gcfg))
    chans = tuple(vocoder.up_channels(gcfg)[1:])
    same = (derived.upsample_pads == pads
            and derived.upsample_channels == chans
            and dataclasses.replace(derived, upsample_pads=None,
                                    upsample_channels=None) == gcfg)
    log(f"  general vocoder: derived config equal to the one written "
        f"(pads {pads}, channels {chans} as implied): {same}")
    if not same:
        fail(f"derive_vocoder_config gave {derived}, written {gcfg}")
    validate_release(rec, card, vdir)
    log(f"  release checks took {time.time() - t_phase:.1f} s on {card}")


# a WordLevel tokenizer.json in the HF `tokenizers` format, written as JSON
# so that writing it needs no `tokenizers` library
TOKENIZER_JSON = {
    "version": "1.0", "truncation": None, "padding": None,
    "added_tokens": [], "normalizer": None,
    "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
    "decoder": None,
    "model": {"type": "WordLevel", "unk_token": "[UNK]", "vocab": {
        w: i for i, w in enumerate(["[UNK]", "hello", "from", "the",
                                    "release", "validator", "world"])}}}


def validate_release(rec: Record, card: str, vdir: str):
    """`python -m qwen3_tts_tpu_torch.tools.validate_release --model-dir
    DIR --device cuda` (in process, counted as a main-path run) on the
    full-width release in the downloader's layout: the llama GGUFs and the
    assets, the named decoder graph, both anonymized encoder graphs and a
    tokenizer.json; quant gate 0 (random weights). Exit 0 and every check
    passed, or skipped for its reason, else the run fails."""
    import io

    from qwen3_tts_tpu_torch.tools import validate_release as vr

    os.makedirs(os.path.join(vdir, "tokenizer"))
    with open(os.path.join(vdir, "tokenizer", "tokenizer.json"), "w") as f:
        json.dump(TOKENIZER_JSON, f)
    argv = ["--model-dir", vdir, "--device", "cuda", "--quant-gate", "0"]
    buf = io.StringIO()

    def call():
        with contextlib.redirect_stdout(buf):
            return vr.main(argv)

    t0 = time.time()
    rc = run_main_path(rec, "validate_release --device cuda", call,
                       ("talker_step", "predictor_frame", "qmatmul",
                        "decode_attention"))
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    for line in buf.getvalue().strip().splitlines()[:-1]:
        log(line)
    for name, c in report["checks"].items():
        log(f"  validate_release {name:20s} {c['status']:5s} "
            f"{c.get('detail', '')}")
    log(f"  python -m qwen3_tts_tpu_torch.tools.validate_release --model-dir "
        f"DIR --device cuda: exit {rc}, pass {report['pass']}, "
        f"{time.time() - t0:.1f} s on {card}")
    if rc != 0 or not report["pass"]:
        fail(f"validate_release returned {rc} on the full-width release")


# ------------------------------------------------------------- cloning
CLONE_TEXT = "The cloned voice speaks this sentence."
# the general vocoder at full width, card against card and against the CPU:
# f32, TF32 off, cuDNN's algorithms sum in their own order
GENERAL_REL = 1e-4
# TF32 switches at torch's defaults against both off: the vocoder scopes
# TF32 off itself, so only launch-to-launch order could differ
TF32_REL = 1e-6


def general_vocoder_config():
    """The BigVGAN/DAC family at full width: hidden 1024, strides
    5,5,5,4,4, kernels 10,10,10,8,8, residual units of dilation 1, 3, 9
    after every stage, snake, channels halving 1024 -> 32."""
    import dataclasses
    from qwen3_tts_tpu_torch.core.config import VocoderConfig
    return dataclasses.replace(VocoderConfig(),
                               upsample_kernels=(10, 10, 10, 8, 8),
                               resblock_dilations=(1, 3, 9),
                               activation="snake")


def write_ref_wav(path, seconds, seed):
    """A 24 kHz WAV of seeded noise (16-bit PCM, as save_wav writes)."""
    import numpy as np
    from qwen3_tts_tpu_torch.utils.audio import AudioSample
    rng = np.random.default_rng(seed)
    AudioSample(samples=(0.1 * rng.standard_normal(seconds * 24000)).astype(
        np.float32), sample_rate=24000).save_wav(path)
    return path


def voice_file_times(e, path):
    """create_voice_file(path) with the host ms of the mel frontend, the
    audio encoder and the speaker encoder (less its mel), each call
    synchronised; returns (voice, {part: ms})."""
    import torch
    from qwen3_tts_tpu_torch.models import encoders

    parts = {"mel": 0.0, "audio_encoder": 0.0, "speaker_encoder": 0.0}
    mel_fn = encoders.mel_mod.compute_mel
    ae_fn, se_fn = e.encoder.encode, e.speaker_encoder.encode

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    encoders.mel_mod.compute_mel = timed("mel", mel_fn)
    e.encoder.encode = timed("audio_encoder", ae_fn)
    e.speaker_encoder.encode = timed("speaker_encoder", se_fn)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voice = e.create_voice_file(path, "A reference transcript.")
        total = (time.perf_counter() - t0) * 1e3
    finally:
        encoders.mel_mod.compute_mel = mel_fn
        del e.encoder.encode, e.speaker_encoder.encode
    parts["speaker_encoder"] -= parts["mel"]
    parts["total"] = total
    return voice, parts


def check_voice(label, voice, n_samples, vocab):
    import numpy as np
    codes = np.asarray(voice.audio_codes)
    emb = np.asarray(voice.speaker_embedding, np.float32)
    want = n_samples // 2000 * 16
    ok = (codes.size == want and codes.size > 0 and codes.min() >= 0
          and codes.max() < vocab and emb.shape == (2048,)
          and bool(np.isfinite(emb).all()))
    log(f"  {label}: {codes.size} codes (expect {want}) in "
        f"[{codes.min()}, {codes.max()}], embedding {emb.shape} finite "
        f"{bool(np.isfinite(emb).all())} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: the voice file's codes or embedding are wrong")


def prompt_times(e, voice, card, frames=32):
    """For the voice's prompt: its length and bucket, the prefill's host
    ms (CUDA events around generate_codes with no frames) and device ms
    (profiler), and ms a frame of generate_codes(ignore_eos) over `frames`
    frames with the prefill subtracted, B=1, temperature 0.7."""
    import torch
    from qwen3_tts_tpu_torch.tts import generate

    cfg = e.config
    dev = e.device
    d = e._prompt_for_voice(CLONE_TEXT, voice, None)
    batch, offsets = e._pad_prompts([d.embeds])

    def run(steps):
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode():
            generate.generate_codes(
                e.models, cfg.talker, cfg.predictor, batch, offsets, gen,
                0.7, 40, 0.9, frames, ignore_eos=True, step_cap=steps)

    def timed(steps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        t = torch.cuda.Event(enable_timing=True)
        s.record()
        run(steps)
        t.record()
        torch.cuda.synchronize()
        return s.elapsed_time(t)

    run(2)
    pre = [timed(0) for _ in range(3)]
    total = [timed(frames) for _ in range(2)]
    per_frame = (min(total) - min(pre)) / frames
    dev_ms = profiled_device_ms(lambda: run(0), 1)
    return {"length": int(d.embeds.shape[0]), "bucket": int(batch.shape[1]),
            "prefill_host_ms": min(pre), "prefill_device_ms": dev_ms,
            "ms_per_frame": per_frame}


def tiny_clone_card_vs_cpu(tmp):
    """Reference on a small input: the tiny f32 config with random
    encoders tied to its vocoder, on the card and (the same weights) on
    the CPU: the voice file's codes equal, its embedding within 1e-5, and
    the greedy codes of a clone request equal."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.models import encoders
    from qwen3_tts_tpu_torch.tts import generate

    cfg = tiny_engine_config(max_steps=10)
    spk = os.path.join(REPO, "speakers")
    on_card = TtsEngine(config=cfg, random_weights=True, seed=0,
                        speakers_dir=spk, device="cuda")
    on_card.encoder, on_card.speaker_encoder = encoders.random_encoders(
        torch.Generator(device="cuda").manual_seed(2), cfg,
        on_card.vocoder_params)
    on_cpu = TtsEngine(config=cfg, weights=(_to(on_card.models, "cpu"),
                                            _to(on_card.vocoder_params,
                                                "cpu")),
                       speakers_dir=spk, device="cpu")
    on_cpu.encoder = encoders.AudioEncoder(
        _to(on_card.encoder.params, "cpu"), cfg.audio_encoder)
    on_cpu.speaker_encoder = encoders.SpeakerEncoder(
        _to(on_card.speaker_encoder.params, "cpu"), cfg.speaker_encoder,
        cfg.mel)
    path = write_ref_wav(os.path.join(tmp, "tiny_ref.wav"), 3, seed=5)
    voices = [e.create_voice_file(path, "tiny reference")
              for e in (on_card, on_cpu)]
    same_codes = voices[0].audio_codes == voices[1].audio_codes
    emb_err = float(np.abs(np.subtract(voices[0].speaker_embedding,
                                       voices[1].speaker_embedding)).max())
    codes = []
    for e in (on_card, on_cpu):
        e.set_sampler_config(SamplerConfig(temperature=0.0, top_k=0,
                                           top_p=1.0, seed=0))
        d = e._prompt_for_voice(CLONE_TEXT, voices[0], None)
        b, o = e._pad_prompts([d.embeds])
        with torch.inference_mode():
            c, n = generate.generate_codes(
                e.models, cfg.talker, cfg.predictor, b, o, None, 0.0, 0,
                1.0, cfg.max_steps)
        codes.append((c.cpu(), n.cpu()))
    same = bool(torch.equal(codes[0][0], codes[1][0])
                and torch.equal(codes[0][1], codes[1][1]))
    log(f"  tiny f32 clone: encoder codes ({len(voices[0].audio_codes)}) "
        f"card vs CPU {'equal' if same_codes else 'DIFFER'}, embedding "
        f"max|d|={emb_err:.3e} (atol 1e-5); greedy clone codes card vs CPU "
        f"{'equal' if same else 'DIFFER'} (n_frames "
        f"{codes[1][1].tolist()})")
    if not same_codes or emb_err > 1e-5 or not same:
        fail("tiny f32 clone: the card differs from the CPU reference")


def general_vocoder_checks(eng, rec: Record, card: str, tmp):
    """The general vocoder family at full width (see
    general_vocoder_config): chunked against one-shot and against the CPU,
    torch's default TF32 switches against both off, device ms a chunk
    against the kernel == stride vocoder, and generate_stream through it."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.assets import checkpoint
    from qwen3_tts_tpu_torch.models import vocoder

    gcfg = general_vocoder_config()
    dev = eng.device
    ctx_l, ctx_r = vocoder.up_context(gcfg)
    la = gcfg.lookahead
    t0 = time.time()
    gparams = vocoder.init_vocoder(
        torch.Generator(device=dev).manual_seed(21), gcfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for _, t in checkpoint.flatten(gparams))
    log(f"  general vocoder: {n_par} f32 parameters in "
        f"{time.time() - t0:.2f} s; channels {vocoder.up_channels(gcfg)}, "
        f"(ctx_l, ctx_r) = ({ctx_l}, {ctx_r}) frames, lookahead {la}")
    frames = 25       # > LA + ctx_r: the middle calls emit frames too
    g = torch.Generator(device=dev).manual_seed(22)
    codes = torch.randint(0, gcfg.code_vocab, (1, frames, 16), generator=g,
                          device=dev, dtype=torch.int32)

    def oneshot(params=gparams, device=dev, c=codes):
        with torch.inference_mode():
            w, v, _ = vocoder.decode(
                params, gcfg, c.to(device),
                vocoder.init_state(gcfg, 1, frames=frames, device=device),
                True)
        return w[0, : int(v[0])].float().cpu().numpy()

    def chunked():
        st = vocoder.init_state(gcfg, 1, device=dev)
        out, firsts = [], []
        with torch.inference_mode():
            for s in range(0, frames, 4):
                w, v, st = vocoder.decode(gparams, gcfg, codes[:, s:s + 4],
                                          st, s + 4 >= frames)
                out.append(w[0, : int(v[0])].cpu().numpy())
                firsts.append(int(v[0]) // gcfg.frame_samples)
        return np.concatenate(out), firsts

    one = oneshot()
    peak = float(np.abs(one).max())
    got, emitted = chunked()
    err = float(np.abs(got - one).max()) if got.shape == one.shape \
        else float("inf")
    cpu = oneshot(_to(gparams, "cpu"), "cpu")
    cerr = float(np.abs(cpu - one).max()) if cpu.shape == one.shape \
        else float("inf")
    log(f"  general vocoder {frames} frames: peak {peak:.4f}; 4-frame "
        f"chunks (frames emitted a call {emitted}) vs one-shot max|d|="
        f"{err:.3e}, one-shot card vs CPU max|d|={cerr:.3e} (atol "
        f"{GENERAL_REL:g} x peak) on {card}")
    if not peak > 0 or max(err, cerr) > GENERAL_REL * peak:
        fail("general vocoder: chunked or CPU decode differs from one-shot")

    # TF32: the global switches at torch's defaults (cuDNN convolutions at
    # TF32) against both off; the vocoder's own scope keeps its f32
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = True
        dflt = oneshot()
        # what TF32 would have done: the same decode without the scope
        vocoder.f32_exact = lambda device: contextlib.nullcontext()
        try:
            unscoped = oneshot()
        finally:
            from qwen3_tts_tpu_torch.core.precision import f32_exact
            vocoder.f32_exact = f32_exact
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        off = oneshot()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    terr = float(np.abs(dflt - off).max())
    uerr = float(np.abs(unscoped - off).max())
    log(f"  general vocoder, TF32 switches at torch's defaults vs both off: "
        f"max|d|={terr:.3e} (atol {TF32_REL:g} x peak); without the "
        f"f32 scope, cuDNN at TF32 would move it by max|d|={uerr:.3e} on "
        f"{card}")
    if terr > TF32_REL * peak:
        fail("general vocoder: TF32 at torch's defaults changed the f32 "
             "vocoder's output")

    # a 4-frame chunk, B=1, 16 frames decoded before (the same slots each
    # call: the same work), both families
    c4 = codes[:, :4]
    for label, params, cfg in (("kernel == stride", eng.vocoder_params,
                                eng.config.vocoder),
                               ("general snake", gparams, gcfg)):
        with torch.inference_mode():
            st = vocoder.init_state(cfg, 1, device=dev)
            for _ in range(4):
                _, _, st = vocoder.decode(params, cfg, c4, st, False)

            def chunk():
                vocoder.decode(params, cfg, c4, st, False)
            wall = cuda_ms(chunk)
            dev_ms = profiled_device_ms(chunk, 5)
        log(f"  vocoder {label}: one 4-frame chunk, device {_fmt(dev_ms)} ms "
            f"(profiler), {wall:.3f} ms per call (CUDA events) on {card}")
    log(f"  general vocoder: emission lags lookahead + ctx_r = {la + ctx_r} "
        f"frames ({(la + ctx_r) * 80} ms of audio; kernel == stride: {la}): "
        f"the first {4 * (-(-(la + ctx_r + 1) // 4))} frames are generated "
        "before the first chunk is out")

    # generate_stream through it, full-width talker and predictor
    e = TtsEngine(config=dataclasses.replace(eng.config, vocoder=gcfg),
                  weights=(eng.models, gparams),
                  speakers_dir=os.path.join(REPO, "speakers"), device=dev)
    e.set_max_steps(32)
    e.set_sampler_config(SamplerConfig(seed=0))
    voice = e.get_speaker("vivian")
    fused = fused_per_frame(e.config)
    runs = []
    for what in ("cold", "warm"):
        run = run_main_path(rec, f"general vocoder generate_stream ({what})",
                            lambda: stream_once(e, TEXT, voice), STEPS,
                            fused)
        peak = float(np.abs(run["samples"]).max()) if run["samples"].size \
            else 0.0
        check_stream(f"general vocoder stream {what}", run, e, 32,
                     atol=GENERAL_REL * max(peak, 1e-6))
        runs.append(run)
    rtf = [r["wall"] / (len(r["samples"]) / 24000) for r in runs]
    log(f"  general vocoder stream: {len(runs[1]['chunks'])} chunks, "
        f"first-chunk ms cold {_fmt(runs[0]['first_ms'])}, warm "
        f"{_fmt(runs[1]['first_ms'])}; streaming RTF incl. vocoding cold "
        f"{rtf[0]:.3f}, warm {rtf[1]:.3f} "
        f"({len(runs[1]['samples']) / 24000:.3f} s of audio) on {card}")
    del e, gparams


def phase_clone(eng, rec: Record, card: str, q48, q88):
    """Voice cloning at full width through the engine's entry points, the
    tiny config against the CPU, the general vocoder family, and the CLI
    with --ref-audio (see the module docstring, phase 10)."""
    import tempfile

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, VoiceFile, cli
    from qwen3_tts_tpu_torch.assets import checkpoint
    from qwen3_tts_tpu_torch.models import encoders
    from qwen3_tts_tpu_torch.utils import cache as feature_cache
    from qwen3_tts_tpu_torch.utils.audio import AudioSample

    log(f"[10/12] clone: create_voice_file, clone requests and the general "
        f"vocoder, full width, on {card}")
    cfg = eng.config
    dev = eng.device
    spk = os.path.join(REPO, "speakers")
    fused = fused_per_frame(cfg)
    t0 = time.time()
    eng.encoder, eng.speaker_encoder = encoders.random_encoders(
        torch.Generator(device=dev).manual_seed(11), cfg, eng.vocoder_params)
    torch.cuda.synchronize()
    n_a = sum(t.numel() for _, t in checkpoint.flatten(eng.encoder.params))
    n_s = sum(t.numel() for _, t in checkpoint.flatten(
        eng.speaker_encoder.params))
    tied = eng.encoder.params["codebooks"].data_ptr() \
        == eng.vocoder_params["embed"].data_ptr()
    log(f"  encoders: audio {n_a} and speaker {n_s} f32 parameters "
        f"(codebooks tied to the vocoder's tables: {tied}) in "
        f"{time.time() - t0:.2f} s")
    if not tied:
        fail("random_encoders: the RVQ codebooks are not the vocoder's")
    tmp = tempfile.mkdtemp(prefix="qwen3_tts_clone_")
    try:
        # voice files from 4 s and 10 s of reference audio
        voices = {}
        for secs in (4, 10):
            path = write_ref_wav(os.path.join(tmp, f"ref_{secs}s.wav"), secs,
                                 seed=secs)
            for what in ("cold", "warm"):
                voice, parts = voice_file_times(eng, path)
                log(f"  create_voice_file {secs} s ({what}): "
                    f"{parts['total']:.1f} ms = mel {parts['mel']:.1f} + "
                    "audio encoder "
                    f"{parts['audio_encoder']:.1f} + speaker encoder "
                    f"{parts['speaker_encoder']:.1f} (+ WAV read) host ms, "
                    f"each synchronised, on {card}")
            check_voice(f"voice file {secs} s", voice, secs * 24000,
                        cfg.audio_encoder.code_vocab)
            vpath = os.path.join(tmp, f"voice_{secs}s.json")
            voice.save(vpath)
            back = VoiceFile.load(vpath)
            if back.audio_codes != voice.audio_codes or not np.allclose(
                    back.speaker_embedding, voice.speaker_embedding,
                    rtol=0, atol=0):
                fail(f"voice file {secs} s: the saved JSON reloads "
                     "differently")
            voices[secs] = back

        # the TTSC sidecar: written by the first call, read by the second
        path = os.path.join(tmp, "ref_4s.wav")
        codes, emb = eng.process_reference(path)
        cache_path = os.path.join(tmp, "ref_4s.cache")
        saved = eng.encoder, eng.speaker_encoder
        eng.encoder = eng.speaker_encoder = None
        try:
            c2, e2 = eng.process_reference(path)
        finally:
            eng.encoder, eng.speaker_encoder = saved
        same = (os.path.exists(cache_path) and np.array_equal(c2, codes)
                and np.array_equal(e2, emb)
                and list(c2) == voices[4].audio_codes)
        log(f"  process_reference: {os.path.getsize(cache_path)} bytes of "
            f".cache; with the encoders set to None the same codes and "
            f"embedding: {same}")
        if not same or not np.array_equal(
                feature_cache.load_cache(cache_path)[0], codes):
            fail("process_reference: the cache short-circuit failed")

        # clone requests: dense, int4+int8, int8/int8 (kernel A)
        clone = voices[10]
        preset = eng.get_speaker("vivian")
        e48 = TtsEngine(config=cfg, weights=(q48, eng.vocoder_params),
                        speakers_dir=spk, device="cuda")
        e88 = TtsEngine(config=cfg, weights=(q88, eng.vocoder_params),
                        speakers_dir=spk, device="cuda")
        for label, e, frames, need in (
                ("dense bf16", eng, 32, STEPS),
                ("int4+int8", e48, 32, STEPS),
                ("int8/int8", e88, 16, ("qmatmul",) + STEPS)):
            e.set_max_steps(frames)
            e.set_sampler_config(SamplerConfig(seed=0))
            audio = run_main_path(
                rec, f"{label} clone (10 s reference) generate_with_voice",
                lambda: e.generate_with_voice(CLONE_TEXT, clone), need,
                fused)
            check_wav(f"{label} clone", audio.samples, frames)
            if e is e88:
                continue
            tc = prompt_times(e, clone, card)
            tp = prompt_times(e, preset, card)
            log(f"  {label}: clone prompt {tc['length']} rows, bucket "
                f"{tc['bucket']}: prefill host {tc['prefill_host_ms']:.3f} "
                f"ms, device {_fmt(tc['prefill_device_ms'])} ms; preset "
                f"prompt {tp['length']} rows, bucket {tp['bucket']}: "
                f"prefill host {tp['prefill_host_ms']:.3f} ms, device "
                f"{_fmt(tp['prefill_device_ms'])} ms; ms/frame (32 frames, "
                f"prefill subtracted) clone {tc['ms_per_frame']:.3f}, "
                f"preset {tp['ms_per_frame']:.3f} on {card}")
        del e48, e88

        # a batch of a preset and a clone voice; a stream with the clone
        eng.set_max_steps(32)
        eng.set_sampler_config(SamplerConfig(seed=0))
        pair = run_main_path(
            rec, "dense bf16 B=2 generate_batch (preset + clone)",
            lambda: eng.generate_batch([TEXT, CLONE_TEXT], [preset, clone]),
            STEPS, fused)
        for i, a in enumerate(pair):
            check_wav(f"preset + clone B=2 row {i}", a.samples, 32)
        runs = []
        for what in ("cold", "warm"):
            run = run_main_path(
                rec, f"dense bf16 clone generate_stream ({what})",
                lambda: stream_once(eng, CLONE_TEXT, clone), STEPS, fused)
            check_stream(f"clone stream {what}", run, eng, 32)
            runs.append(run)
        rtf = [r["wall"] / (len(r["samples"]) / 24000) for r in runs]
        log(f"  clone stream: {len(runs[1]['chunks'])} chunks, first-chunk "
            f"ms cold {_fmt(runs[0]['first_ms'])}, warm "
            f"{_fmt(runs[1]['first_ms'])}; streaming RTF incl. vocoding "
            f"cold {rtf[0]:.3f}, warm {rtf[1]:.3f} "
            f"({len(runs[1]['samples']) / 24000:.3f} s of audio) on {card}")

        # engine.generate from a WAV (encoded, then the sidecar written)
        gen_wav = write_ref_wav(os.path.join(tmp, "gen_ref.wav"), 4, seed=9)
        audio = run_main_path(
            rec, "dense bf16 generate(text, wav, ref_text)",
            lambda: eng.generate(CLONE_TEXT, gen_wav, "A reference."),
            STEPS, fused)
        check_wav("generate(text, wav, ref_text)", audio.samples, 32)
        if not os.path.exists(os.path.join(tmp, "gen_ref.cache")):
            fail("generate: no .cache written beside the reference")
        reset_counts()

        tiny_clone_card_vs_cpu(tmp)
        general_vocoder_checks(eng, rec, card, tmp)
        reset_counts()

        # the CLI on a full-width directory with the encoders beside it
        model_dir = os.path.join(tmp, "model")
        t0 = time.time()
        eng.save_checkpoint(model_dir)
        written = sorted(os.listdir(model_dir))
        log(f"  save_checkpoint with the encoders: {written} in "
            f"{time.time() - t0:.2f} s")
        if "audio_encoder.npz" not in written \
                or "speaker_encoder.npz" not in written:
            fail("save_checkpoint did not write the encoders")
        os.environ["QWEN3_TTS_OFFLINE"] = "1"
        wav = os.path.join(tmp, "cli_clone.wav")
        vjson = os.path.join(tmp, "cli_voice.json")
        argv = ["--model-dir", model_dir, "--no-download", "--device",
                str(dev), "--text", CLONE_TEXT, "--max-steps", "32",
                "--seed", "0", "--speakers-dir", spk, "--output", wav,
                "--ref-audio", os.path.join(tmp, "ref_4s.wav"), "--ref-text",
                "A reference transcript.", "--save-voice", vjson]
        # the sidecar written above would skip the encoders: remove it
        os.remove(cache_path)
        rc = run_main_path(rec, "cli --ref-audio --save-voice",
                           lambda: cli.main(argv), STEPS)
        if rc != 0 or not os.path.exists(wav):
            fail(f"cli --ref-audio returned {rc} without writing {wav}")
        check_wav("cli --ref-audio", AudioSample.load_wav(wav).samples, 32)
        back = VoiceFile.load(vjson)
        check_voice("cli --save-voice", back, 4 * 24000,
                    cfg.audio_encoder.code_vocab)
        if back.audio_codes != voices[4].audio_codes:
            fail("cli --save-voice: codes differ from create_voice_file's "
                 "on the same WAV")
    finally:
        eng.encoder = eng.speaker_encoder = None
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        fail(f"{tmp} was not removed")
    reset_counts()


# --------------------------------------------------------------- serving
SERVE_FRAMES = 120    # set_max_steps of the serving runs: 10 s of speech
SERVE_RUNS = 3        # runs of each serving engine


def route_per_frame(cfg, models, B) -> dict:
    """Launches a frame at batch B on the routes `talker_route` and
    `frame_route` take: `fused_per_frame` where both take their kernel,
    `chain_per_frame` where the talker takes its chain, and where only the
    talker takes its kernel, the predictor's chain beside one talker_step;
    `talker_step_b17_32` once where the talker's kernel takes more than 16
    rows, `predictor_frame_int4` once where the frame kernel takes int4
    weights."""
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    talker = ft.talker_route(models["talker"], B) == ft.KERNEL
    predictor = fp.frame_route(models["predictor"], B) == fp.KERNEL
    n = chain_per_frame(cfg, predictor)
    if talker:
        Lt = cfg.talker.n_layers
        for k, less in (("gemv_all", 4 * Lt + 1), ("decode_attention", Lt),
                        ("rms_norm", 1), ("rms_norm_gemv", 2 * Lt),
                        ("qk_rope_gemv", Lt), ("silu_gemv", Lt),
                        ("talker_kv_copy", 2)):
            n[k] -= less
        n["talker_step"] = 1
        n["talker_step_b17_32"] = int(B > ft.WIDE_B)
    n["predictor_frame_int4"] = int(
        predictor and fp.weight_kind(models["predictor"]["head"]) == "int4")
    return n


def serve_drive(srv, texts, voice, stagger):
    """Submit `texts` to `srv` as rows free (one a tick with `stagger`, else
    as many as fit), ticking until drained. Returns (streams: per stream
    id its submit time, admission ms (prefill and copy, synchronised),
    first-chunk time and chunks; tick seconds; wall seconds)."""
    import torch
    streams, ticks, pending = {}, [], list(texts)
    t0 = time.perf_counter()
    while pending or srv.slots.active():
        while pending:
            d = {"chunks": [], "first": None}

            def on_chunk(piece, d=d):
                if d["first"] is None:
                    d["first"] = time.perf_counter()
                d["chunks"].append(piece)

            t = time.perf_counter()
            sid = srv.submit(pending[0], voice, on_chunk=on_chunk)
            if sid is None:
                break
            torch.cuda.synchronize()
            d.update(submit=t, admit_ms=(time.perf_counter() - t) * 1e3)
            streams[sid] = d
            pending.pop(0)
            if stagger:
                break
        t = time.perf_counter()
        srv.step()
        ticks.append(time.perf_counter() - t)
    return streams, ticks, time.perf_counter() - t0


@contextlib.contextmanager
def tick_parts(srv):
    """Times, tick by tick, `srv`'s 4-frame step and its batched vocoder
    call, each synchronised at its end (the tick reads both results on the
    host right after, so the syncs add no wait). Yields {"step": [s, ...],
    "vocoder": [s, ...]}; restores both on exit."""
    import torch
    from qwen3_tts_tpu_torch.models import vocoder as vmod
    parts = {"step": [], "vocoder": []}

    def timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[key].append(time.perf_counter() - t)
            return out
        return run

    step, decode = srv._step_fn, vmod.decode
    srv._step_fn, vmod.decode = timed(step, "step"), timed(decode, "vocoder")
    try:
        yield parts
    finally:
        srv._step_fn, vmod.decode = step, decode


def _med(xs):
    import numpy as np
    return float(np.median(xs)) if len(xs) else float("nan")


def serve_run(rec, label, e, card, B, n_streams, window=None,
              stagger=False):
    """One ServingEngine(e, B, window), warmed up, then driven SERVE_RUNS
    times over `n_streams` streams, each run with every count set to 0 just
    before and read just after (`run_main_path`, the launches a frame of
    `route_per_frame`). Every kernel with a count a frame there must
    launch. Checks each stream (finite, whole frames, within the frame cap,
    no error, chunks concatenating to the result) and prints, per run, the
    batch's audio-s/s over the run's wall (every tick and admission in it),
    and over all runs ms a tick, admission and first-chunk ms and the
    cache's GiB. Returns (srv, the first run's streams)."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.serving import ServingEngine

    srv = ServingEngine(e, max_streams=B, kv_window=window)
    srv.warmup()
    voice = e.get_speaker("vivian")
    texts = [f"Stream {i}. {TEXT}" for i in range(n_streams)]
    per_frame = route_per_frame(e.config, e.models, B)
    need = [k for k, n in per_frame.items()
            if n > 0 and k not in ("gemv_all", "talker_kv_copy")]
    cap = min(e.max_steps,
              e.config.vocoder.max_frames - srv.chunk_frames)
    runs, first_run = [], None
    for run in range(SERVE_RUNS):
        with tick_parts(srv) as parts:
            streams, ticks, wall = run_main_path(
                rec, f"{label}, run {run + 1}",
                lambda: serve_drive(srv, texts, voice, stagger), need,
                per_frame)
        first_run = first_run or streams
        audio = 0.0
        for sid, d in streams.items():
            s = srv.streams[sid]
            if s.error is not None or not s.done:
                fail(f"{label}: stream {sid} did not finish: {s.error}")
            check_wav(f"{label} stream {sid} (row {s.slot})",
                      s.result.samples, cap)
            if not d["chunks"] or not np.array_equal(
                    np.concatenate(d["chunks"]), s.result.samples):
                fail(f"{label}: stream {sid}'s chunks do not concatenate to "
                     "its result")
            audio += len(s.result.samples) / 24000
        runs.append((streams, ticks, wall, audio))
        admits = sum(d["admit_ms"] for d in streams.values()) / 1e3
        other = wall - sum(parts["step"]) - sum(parts["vocoder"]) - admits
        log(f"  {label}, run {run + 1}: {len(streams)} streams, "
            f"{audio:.3f} s of audio in {wall:.3f} s wall (every tick and "
            f"admission): {audio / wall:.3f} audio-s/s of the batch, "
            f"{len(ticks)} ticks; the wall's parts: the 4-frame step (host "
            f"launches and device, synchronised) {sum(parts['step']):.3f} s "
            f"(median {_med(parts['step']) * 1e3:.2f} ms a tick), the "
            f"batched vocoder call {sum(parts['vocoder']):.3f} s (median "
            f"{_med(parts['vocoder']) * 1e3:.2f} ms), admissions "
            f"{admits:.3f} s, the rest (reads, emits, flushes) {other:.3f} "
            f"s, on {card}")
        if run == 0:
            log(f"  {label}, run 1: ms a tick in order "
                f"{[round(t * 1e3, 1) for t in ticks]}")
    rates = [a / w for _, _, w, a in runs]
    tk = [t * 1e3 for _, ticks, _, _ in runs for t in ticks]
    admit = [d["admit_ms"] for st, _, _, _ in runs for d in st.values()]
    first = [(d["first"] - d["submit"]) * 1e3
             for st, _, _, _ in runs for d in st.values()]
    gib = sum(t.numel() * t.element_size()
              for t in srv._state["cache"].values()) / 2**30
    log(f"  {label}: audio-s/s of the batch over each run's wall "
        f"{', '.join(f'{r:.3f}' for r in rates)} (median {_med(rates):.3f});"
        f" ms a tick (4 frames) median {_med(tk):.2f} (min {min(tk):.2f}, "
        f"max {max(tk):.2f}, {len(tk)} ticks); admission ms (prefill + copy) "
        f"median {_med(admit):.2f} (min {min(admit):.2f}, max "
        f"{max(admit):.2f}, {len(admit)}); first-chunk ms after submit "
        f"median {_med(first):.2f} (min {min(first):.2f}, max "
        f"{max(first):.2f}); batch cache "
        f"{srv._state['cache']['k'].shape[3]} slots x {B} rows, {gib:.3f} "
        f"GiB, on {card}")
    return srv, first_run


def capture_tick_step(rec, e, card):
    """A full-width talker step captured from a real tick: rows admitted at
    different ticks with prompts of different buckets (ragged slots), and
    an empty row set to the cache's cap, as a row released long ago
    reaches it (its write slot clamped to cap - 1, its attention over cap
    - 1 slots). The step through the kernel against
    `talker_step_fused_plain` on the same inputs (`step_check`, full depth
    bf16: FULL_DEPTH_REL with the control), then its device ms as captured
    and with the empty row at slot 1: what a row at the cap costs."""
    import torch
    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.serving import ServingEngine

    srv = ServingEngine(e, max_streams=4)
    voice = e.get_speaker("vivian")
    srv.submit(LONG_TEXT, voice)
    for _ in range(3):
        srv.step()
    srv.submit(TEXT, voice)
    srv.step()
    srv.submit("A third stream.", voice)
    srv.step()
    cap = srv._state["cache"]["k"].shape[3]
    with torch.inference_mode():
        srv._state["slot"][3] = cap      # the empty row, at the cap
    captured = {}
    orig = talker_mod.step

    def capture(params, cfg, fb, slot, pad, cache, plain=False):
        if not captured:
            captured.update(x=fb.clone(), slot=slot.clone(), pad=pad.clone(),
                            k=cache["k"].clone(), v=cache["v"].clone())
        return orig(params, cfg, fb, slot, pad, cache, plain)

    talker_mod.step = capture
    try:
        srv.step()
    finally:
        talker_mod.step = orig
    del srv
    torch.cuda.empty_cache()
    c = captured
    slot = c["slot"]
    cfg, tp = e.config.talker, e.models["talker"]
    inputs = (c["x"], slot - c["pad"], slot, slot, c["pad"], c["k"], c["v"])
    log(f"  captured tick: write slots {slot.tolist()} (cap {cap}), pad "
        f"offsets {c['pad'].tolist()}")
    if int(slot[3]) != cap - 1 or len(set(slot.tolist())) < 4:
        fail("captured tick: the rows are not ragged with one at cap - 1")
    with torch.inference_mode():
        step_check(rec, f"full bf16 serving tick B=4 T={cap}", cfg, tp,
                   inputs, dict(rel=FULL_DEPTH_REL), control=True)
        low = slot.clone()
        low[3] = 1
        times = []
        for s in (slot, low):
            kk, vv = c["k"].clone(), c["v"].clone()
            times.append(cuda_ms(lambda s=s, kk=kk, vv=vv: ft.talker_step_kernel(
                tp, cfg, c["x"], s - c["pad"], s, s, c["pad"], kk, vv)))
            del kk, vv
    log(f"  talker_step, the captured tick B=4, {cap}-slot cache: "
        f"{times[0]:.4f} ms with the empty row at cap - 1, {times[1]:.4f} ms "
        f"with it at slot 1 (+{times[0] - times[1]:.4f} ms for the row at the"
        f" cap) on {card}")


def tiny_serve_card_vs_cpu():
    """Reference on a small input for serving: the tiny f32 config's
    staggered streams on 2 rows, greedy, on the card (kernels) against the
    CPU (plain versions), and each against its solo stream on the card:
    codes and frame counts equal."""
    import numpy as np
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.core.config import tiny_engine_config
    from qwen3_tts_tpu_torch.serving import ServingEngine

    cfg = tiny_engine_config(max_steps=12)
    spk = os.path.join(REPO, "speakers")
    on_card = TtsEngine(config=cfg, random_weights=True, seed=0,
                        speakers_dir=spk, device="cuda")
    on_cpu = TtsEngine(config=cfg, weights=(_to(on_card.models, "cpu"),
                                            _to(on_card.vocoder_params,
                                                "cpu")),
                       speakers_dir=spk, device="cpu")
    texts = ["first utterance", "second one", "the third text"]
    codes = []
    for e in (on_card, on_cpu):
        e.set_sampler_config(SamplerConfig(temperature=0.0, top_k=0,
                                           top_p=1.0, seed=0))
        srv = ServingEngine(e, max_streams=2)
        streams, _, _ = serve_drive(srv, texts, e.get_speaker("vivian"),
                                    stagger=True)
        codes.append([srv.streams[sid].frame_codes() for sid in streams])
    voice = on_card.get_speaker("vivian")
    solo = [stream_once(on_card, t, voice)["codes"][0] for t in texts]
    same_cpu = all(np.array_equal(a, b) for a, b in zip(*codes))
    same_solo = all(np.array_equal(a, b) for a, b in zip(codes[0], solo))
    log(f"  tiny f32 staggered serving, 3 streams on 2 rows, frames "
        f"{[len(c) for c in codes[0]]}: codes card vs CPU "
        f"{'equal' if same_cpu else 'DIFFER'}, card vs each solo stream "
        f"{'equal' if same_solo else 'DIFFER'}")
    if not same_cpu or not same_solo or not all(len(c) for c in codes[0]):
        fail("tiny f32 serving: the card's codes differ from the CPU's or "
             "from the solo streams")


def serve_http(rec, e, card):
    """TtsServer on 127.0.0.1 over the full-width engine: /health, two
    concurrent POST /tts (one plain, one streamed), /stats; the finished
    streams evicted."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    from qwen3_tts_tpu_torch import server

    srv = server.TtsServer(e, max_streams=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(srv))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def req(method, path, body=None):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        t = time.perf_counter()
        c.request(method, path,
                  body=None if body is None else json.dumps(body))
        r = c.getresponse()
        data = r.read()
        out = (r.status, dict(r.getheaders()), data,
               time.perf_counter() - t)
        c.close()
        return out

    try:
        status, _, data, _ = req("GET", "/health")
        if status != 200 or json.loads(data)["status"] != "ok":
            fail(f"server /health: {status} {data!r}")
        results = {}

        def both():
            threads = [threading.Thread(target=lambda k=k, b=b: results.__setitem__(
                k, req("POST", "/tts", b)))
                for k, b in (("plain", {"text": TEXT}),
                             ("stream", {"text": TEXT, "stream": True}))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)

        run_main_path(rec, "server: two concurrent POST /tts (one "
                      "streamed), max_streams=4", both, STEPS,
                      fused_per_frame(e.config))
        for k in ("plain", "stream"):
            if k not in results:
                fail(f"server /tts {k}: no response")
            status, headers, data, wall = results[k]
            if status != 200 or data[:4] != b"RIFF":
                fail(f"server /tts {k}: {status} {data[:200]!r}")
            pcm = np.frombuffer(data[44:], "<i2")
            check_wav(f"server /tts {k}", pcm.astype(np.float32) / 32768,
                      SERVE_FRAMES)
            chunked = headers.get("Transfer-Encoding") == "chunked"
            if chunked != (k == "stream"):
                fail(f"server /tts {k}: Transfer-Encoding {headers}")
            log(f"  server /tts {k}: {len(pcm) // 2000} frames in "
                f"{wall:.3f} s (request wall){', chunked' if chunked else ''}")
        status, _, data, _ = req("GET", "/stats")
        stats = json.loads(data)
        log(f"  server /stats: {stats}")
        if stats["streams_served"] != 2 or srv.serving.streams:
            fail("server: /stats does not count the 2 requests, or finished "
                 "streams were kept")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        thread.join(timeout=10)


def phase_serve(eng, rec: Record, card: str, q48):
    """Continuous-batching serving at full width (see the module docstring,
    phase 11)."""
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine

    log(f"[11/12] serve: ServingEngine and TtsServer, full width, on {card}")
    eng.set_max_steps(SERVE_FRAMES)
    eng.set_sampler_config(SamplerConfig(seed=0))
    srv, streams = serve_run(rec, "dense bf16 serving B=4, 6 staggered "
                             "streams", eng, card, 4, 6, stagger=True)
    rows = [srv.streams[sid].slot for sid in streams]
    if len(set(rows)) > 4 or len(set(rows)) == len(rows):
        fail(f"serving B=4: rows {rows} were not recycled")
    log(f"  rows of the 6 streams: {rows}")
    del srv
    torch.cuda.empty_cache()
    for label, B, window in (
            ("dense bf16 serving B=16, 4096 slots", 16, None),
            ("dense bf16 serving B=32, kv_window 1024", 32, 1024)):
        srv, _ = serve_run(rec, label, eng, card, B, B, window=window)
        del srv
        torch.cuda.empty_cache()
    e48 = TtsEngine(config=eng.config, weights=(q48, eng.vocoder_params),
                    speakers_dir=os.path.join(REPO, "speakers"),
                    device="cuda")
    e48.set_max_steps(SERVE_FRAMES)
    e48.set_sampler_config(SamplerConfig(seed=0))
    srv, _ = serve_run(rec, "int4+int8 serving B=8", e48, card, 8, 8)
    del srv, e48
    torch.cuda.empty_cache()
    reset_counts()
    tiny_serve_card_vs_cpu()
    capture_tick_step(rec, eng, card)
    reset_counts()
    serve_http(rec, eng, card)
    reset_counts()


# ------------------------------------------------- parallel/ (phase 12)
TP_RANKS = 2             # one card: two gloo ranks over its CUDA tensors
TP_TIMEOUT_S = 300       # every child is killed past it
TP_PROMPT, TP_FRAMES, TP_WINDOW = 64, 16, 256
TP_CLOCK_FRAMES = 4      # frames of the run that times the collectives
SP_TOKENS = 1024
# kernel A's products of one layer on a rank of a model axis of 2 (its
# columns of wqkv and w_gu, its rows of wo and w_down), and of 4
TALKER_INT8_TP2 = [(2048, 2048), (1024, 2048), (2048, 6144), (3072, 2048)]
TALKER_INT8_TP4 = [(2048, 1024), (512, 2048), (2048, 3072), (1536, 2048)]
PREDICTOR_INT8_TP2 = [(1024, 1536), (512, 1024), (1024, 3072), (1536, 1024)]


def tree_checksum(*trees) -> float:
    """Sum of |w| over every leaf, in f64: equal on two processes only for
    the same weights."""
    import dataclasses
    import torch
    total = 0.0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif dataclasses.is_dataclass(t):
            stack.extend(getattr(t, f.name) for f in dataclasses.fields(t))
        else:
            total += float(torch.sum(t.abs(), dtype=torch.float64))
    return total


def tp_peaked(models):
    """The engine's models with phase 5's peaked talker and predictor
    heads (the agreement gates' regime)."""
    from qwen3_tts_tpu_torch.core import protocol as P
    return {"talker": peak_head(models["talker"],
                                [(0, P.TALKER_SAMPLE_LIMIT)]),
            "predictor": peak_head(models["predictor"],
                                   [(q * P.CODE_VOCAB, P.CODE_VOCAB)
                                    for q in range(P.NUM_CODEBOOKS)]),
            "assets": models["assets"]}


def tp_frames(pt, tc, x, assets, frames, *, pred=None, codes=None,
              h1024=None, tp=None, refs=None):
    """The talker's prefill of x [1, S, H], then a frame at a time: a
    talker step through decoder.forward (`talker.step_unfused`) and, with
    `pred` = (params, config), the frame's expansion through
    `models/predictor.frame_codes`. Greedy where `codes` is None (the
    frames' codes are the run's own); else teacher-forced: frame f's
    feedback is codes[f], its expansion starts from h1024[f] and
    codes[f, 0]. `tp` runs this rank's shards. With `refs` = ([(key,
    params, config), ...], this rank computes them) the prefill and every
    step are also run single-process from the same state (the ranks'
    caches gathered) by each (params, config). Returns {"hidden" [F + 1,
    H] f32, "logits" [F + 1, vocab] f32, "argmax" [F + 1] of the logits'
    [0, 2160), "codes" [F, 16] (the expansion's) or None, "h1024" [F,
    1024], and "<key>_hidden" / "<key>_logits" of each ref (on the rank
    that computes them)}."""
    import torch
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.models import decoder, predictor, talker
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.tts import generate

    dev = x.device
    S = x.shape[1]
    lim = P.TALKER_SAMPLE_LIMIT
    pos = torch.arange(S, device=dev)[None]
    pad = torch.zeros(1, dtype=torch.int32, device=dev)
    same = {}

    def reference(state, run):
        """`run`(params, config, cache) by each ref from `state` (this
        rank's cache, gathered; None: an empty cache)."""
        full = None
        if state is not None:
            full = {k: (pmesh.all_gather(v, tp, dim=2) if tp is not None
                        else v) for k, v in state.items()}
        if not refs[1]:
            return
        for key, params, cfg in refs[0]:
            L = cfg.n_layers
            cache = (decoder.init_kv_cache(cfg, 1, length=TP_WINDOW,
                                           device=dev) if full is None
                     else {k: v[:L].clone() for k, v in full.items()})
            h, lg = run(params, cfg, cache)
            same.setdefault(f"{key}_hidden", []).append(h.float())
            same.setdefault(f"{key}_logits", []).append(lg.float())

    if refs is not None:
        reference(None, lambda p, c, cache: [
            t[:, -1] for t in decoder.forward(p, c, x, pos, cache, 0)[:2]])
    cache = decoder.init_kv_cache(tc, 1, length=TP_WINDOW, device=dev, tp=tp)
    h, lg, cache = decoder.forward(pt, tc, x, pos, cache, 0, tp=tp)
    hidden, logits = h[:, -1], lg[:, -1]
    hs, lgs, out, h1s = [hidden.float()], [logits.float()], [], []
    for f in range(frames):
        if codes is None:
            h1 = assets.project(hidden.float())
            c0 = lgs[-1][:, :lim].argmax(-1).to(torch.int32)
        else:
            h1, c0 = h1024[f:f + 1], codes[f:f + 1, 0]
        if pred is not None:
            out.append(predictor.frame_codes(pred[0], pred[1], assets, h1, c0,
                                             tp))
        h1s.append(h1)
        fb = codes[f:f + 1] if codes is not None else out[-1]
        fb = generate._feedback_embedding(assets, fb, tc.hidden).to(x.dtype)
        if refs is not None:
            reference(cache, lambda p, c, cache, fb=fb, f=f: talker.
                      step_unfused(p, c, fb, S + f, pad, cache)[:2])
        hidden, logits, cache = talker.step_unfused(pt, tc, fb, S + f, pad,
                                                    cache, tp)
        hs.append(hidden.float())
        lgs.append(logits.float())
    res = {"hidden": torch.cat(hs), "logits": torch.cat(lgs),
           "codes": torch.cat(out) if out else None, "h1024": torch.cat(h1s)}
    res["argmax"] = res["logits"][:, :lim].argmax(-1)
    res.update({k: torch.cat(v) for k, v in same.items()})
    return res


def same_state_stats(run, key) -> dict:
    """`tp_frames`'s comparison of its hidden and argmax with ref `key`'s
    from the same states: each state's relative error and the largest,
    the argmax agreement."""
    from qwen3_tts_tpu_torch.core import protocol as P
    want = run[f"{key}_hidden"]
    rels = [rel_err(run["hidden"][i], want[i]) for i in range(len(want))]
    am = run[f"{key}_logits"][:, :P.TALKER_SAMPLE_LIMIT].argmax(-1)
    return {"rels": rels, "max": max(rels),
            "agree": float((run["argmax"] == am).float().mean())}


def to_f32(tree):
    """A decoder tree with its float leaves in f32 (int8 / int4 entries
    stay)."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def first_layers(params, cfg, n):
    """A decoder's params and config cut to its first n layers."""
    import dataclasses
    lw = {k: (v[:n] if not isinstance(v, dict)
              else {m: t[:n] for m, t in v.items()})
          for k, v in params["layers"].items()}
    return dict(params, layers=lw), dataclasses.replace(cfg, n_layers=n)


TP_STEP_STATES = ((256, 100), (4096, 2100))     # phase 3's (T, live)
# bf16 at full depth: the tensor-parallel talker's distance to the single
# process in f32 against the single process's own in bf16. The two bf16
# runs differ from each other by as much as each from the f32 one
# (2-4e-2 on the teacher-forced states), so FULL_DEPTH_REL cannot tell
# them apart; the f32 and 2-layer tiers are the strict checks
TP_BF16_MARGIN = 1.25


def tp_step_tiers(mesh, tp, me, cfg, cfg32, peaked, voc, kinds, full,
                  full32, local):
    """One talker step on this rank's shards against the single process's
    step (`talker.step_unfused`) on the same random state (phase 3's: x
    0.1 N(0, 1), a N(0, 1) cache with `live` slots, B = 1), the state's
    cache split over the ranks by kv head; phase 3's three tiers: f32 at
    full width and depth (dense: kernel A rounds x to bf16, so the int8
    talker has no f32 tier), hidden and logits within rtol/atol 1e-4;
    bf16 at full width cut to 2 layers, relative error <= 8e-3; bf16 at
    full width and depth, <= FULL_DEPTH_REL, the single step without its
    last layer further. Returns [(tier, T, live, hidden err, logits err,
    control err or None, ok)] on the rank that compares (`me`)."""
    import torch
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.parallel import run as prun

    tcfg = prun.tp_config(mesh, cfg).talker
    tiers = []
    if kinds is None:
        # the f32 talker's shards (the predictor's are not used)
        local32 = prun.shard_models(mesh, cfg32, dict(peaked, talker=full32),
                                    voc, kinds)[0]
        tiers.append(("full f32", local32["talker"], full32,
                      prun.tp_config(mesh, cfg32).talker, cfg32.talker,
                      dict(rtol=1e-4, atol=1e-4)))
    l2, lc2 = first_layers(local["talker"], tcfg, 2)
    f2, fc2 = first_layers(full, cfg.talker, 2)
    tiers.append(("full bf16 2 layers", l2, f2, lc2, fc2, dict(rel=8e-3)))
    tiers.append(("full bf16", local["talker"], full, tcfg, cfg.talker,
                  dict(rel=FULL_DEPTH_REL)))
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = pmesh.coordinates(mesh)
    spec = pmesh.P(None, None, "model")
    out, seed = [], 300
    for tier, lp, fp, lc, fc, tol in tiers:
        dt = getattr(torch, fc.dtype)
        for T, live in TP_STEP_STATES:
            seed += 1
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = (0.1 * torch.randn(1, fc.hidden, generator=g,
                                   device="cuda")).to(dt)
            cache = {k: torch.randn(fc.n_layers, 1, fc.n_kv_heads, T,
                                    fc.head_dim, generator=g,
                                    device="cuda").to(dt) for k in "kv"}
            pad = torch.zeros(1, dtype=torch.int32, device="cuda")
            mine = {k: pmesh.local_slice(v, spec, shape, coords)
                    for k, v in cache.items()}
            h, lg, _ = talker.step_unfused(lp, lc, x, live, pad, mine, tp)
            if not me:
                continue
            wh, wl, _ = talker.step_unfused(
                fp, fc, x, live, pad, {k: v.clone() for k, v in
                                       cache.items()})
            row = {"tier": tier, "T": T, "live": live}
            if "rel" in tol:
                row.update(h=rel_err(h, wh), lg=rel_err(lg, wl))
                row["ok"] = max(row["h"], row["lg"]) <= tol["rel"]
            else:
                row.update(h=abs_err(h, wh), lg=abs_err(lg, wl))
                row["ok"] = all(torch.allclose(a.float(), b.float(), **tol)
                                for a, b in ((h, wh), (lg, wl)))
            if tier == "full bf16":
                # the control, and both steps against the f32 step
                cp, cc = last_layer_dropped(fp, fc)
                ch = talker.step_unfused(cp, cc, x, live, pad, {
                    k: v[:cc.n_layers].clone() for k, v in cache.items()})[0]
                th = talker.step_unfused(full32, cfg32.talker, x, live, pad, {
                    k: v.clone() for k, v in cache.items()})[0]
                row.update(ctl=rel_err(ch, wh), tp_f32=rel_err(h, th),
                           single_f32=rel_err(wh, th))
                row["ok"] = row["ctl"] > tol["rel"]
            out.append(row)
    return out


def tp_kernel_checks(rec: Record, g):
    """Decode attention at a rank's head counts (the talker's 16/8 at a
    model axis of 2 and 4: 8/4, 4/2, over the 256-slot window and the
    4096-slot cache; the predictor's 8/8: 4/4, 2/2, bf16 cache of 32
    slots) and kernel A at a rank's int8 products (the talker's layer at
    2 and 4, the predictor's at 2, a rank's head-slice view; M = 1, 64)
    against their plain versions."""
    import torch
    from qwen3_tts_tpu_torch.ops import flash_decode, quant

    dev = g.device

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    bf = torch.bfloat16
    for dt, tol in ((torch.float32, None), (bf, 8e-3)):
        for nq, nk, T, cases in (
                (8, 4, 256, [(0, 0), (1, 0), (96, 0), (200, 17)]),
                (4, 2, 256, [(1, 0), (96, 0), (255, 3)]),
                (8, 4, 4096, [(96, 0), (2100, 0)]),
                (4, 2, 4096, [(96, 0), (2100, 5)]),
                (4, 4, 32, [(0, 0), (2, 0), (9, 0), (16, 0)]),
                (2, 2, 32, [(2, 0), (16, 0)])):
            kc, vc = randn(2, 1, nk, T, 128, dtype=dt), randn(
                2, 1, nk, T, 128, dtype=dt)
            q = randn(1, nq, 128, dtype=dt)
            kn, vn = randn(1, nk, 128, dtype=dt), randn(1, nk, 128, dtype=dt)
            for kv_len, vfrom in cases:
                lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
                vf = torch.tensor([vfrom], dtype=torch.int32, device=dev)
                got = flash_decode.decode_attention_stacked(
                    q, kc, vc, kn, vn, 1, lens, vf)
                want = flash_decode.decode_attention_plain(
                    q, kc, vc, kn, vn, 1, lens, vf)
                label = (f"rank {nq}/{nk} T={T} kv_len={kv_len} vfrom="
                         f"{vfrom} {str(dt)[6:]}")
                if tol is None:
                    rec.check("decode_attention_tp", got, want, label,
                              rtol=1e-4, atol=1e-4)
                else:
                    rec.check("decode_attention_tp", got, want, label,
                              rel=tol)
    head = quant.quantize(randn(1024, 16384, scale=0.02))
    for what, shapes in (("talker model=2", TALKER_INT8_TP2),
                         ("talker model=4", TALKER_INT8_TP4),
                         ("predictor model=2", PREDICTOR_INT8_TP2),
                         ("predictor head slice of a rank", [None])):
        err = 0.0
        for shape in shapes:
            if shape is None:
                q, sc = head["q"][:, 6144:8192], head["scale"][6144:8192]
            else:
                w = quant.quantize(randn(*shape, scale=0.02))
                q, sc = w["q"], w["scale"]
            for M in (1, 64):
                for dt in (bf, torch.float32):
                    x = randn(M, q.shape[0], dtype=dt)
                    e, _ = rec.check(
                        "qmatmul_tp", quant.qmatmul_kernel(x, q, sc),
                        quant.qmatmul_kernel_plain(x, q, sc),
                        f"{what} {tuple(q.shape)} M={M}", rtol=1e-4,
                        atol=1e-4, quiet=True)
                    err = max(err, e)
        log(f"  {'qmatmul_tp':16s} {what}: {len(shapes)} products, M = 1, "
            f"64, x bf16 / f32: max|d|={err:.3e} (rtol/atol 1e-4) ok")


def tp_kernel_times(rec: Record, card: str, g):
    """Device times (CUDA-graph replay) of decode attention at a rank's
    head counts and of kernel A a rank's layer, against their plain
    versions, one PyTorch call (SDPA, torch._weight_int8pack_mm) and their
    bounds; and decode attention at `models/predictor.frame_codes`'s shape
    (8/8 heads, bf16 cache of 32 slots)."""
    import torch
    bf = torch.bfloat16
    time_cases(rec, card, [
        attention_case(g, "talker rank 8/4 (model=2) kv_len=96 T=256 bf16",
                       8, 4, 256, 96, bf, bf, True, "decode_attention_tp"),
        attention_case(g, "talker rank 4/2 (model=4) kv_len=96 T=256 bf16",
                       4, 2, 256, 96, bf, bf, False, "decode_attention_tp"),
        attention_case(g, "talker rank 8/4 stream kv_len=96 T=4096 bf16", 8,
                       4, 4096, 96, bf, bf, False, "decode_attention_tp"),
        attention_case(g, "talker rank 4/2 stream kv_len=96 T=4096 bf16", 4,
                       2, 4096, 96, bf, bf, False, "decode_attention_tp"),
        attention_case(g, "predictor rank 4/4 (model=2) kv_len=8 T=32 bf16",
                       4, 4, 32, 8, bf, bf, False, "decode_attention_tp"),
        attention_case(g, "frame_codes predictor 8/8 kv_len=8 T=32 bf16 "
                       "cache", 8, 8, 32, 8, bf, bf, False)])
    qmatmul_times(rec, card, g, rows=(1, 64), shapes=TALKER_INT8_TP2,
                  what="talker rank (model=2)", name="qmatmul_tp")
    qmatmul_times(rec, card, g, rows=(1, 64), shapes=PREDICTOR_INT8_TP2,
                  what="predictor rank (model=2)", json_row=None)


class CollectiveClock:
    """dist.all_reduce and dist.broadcast counted and timed on the host,
    the stream synchronized before and after each call (so a call's time
    is its own, not the work it waits for)."""

    def __init__(self):
        self.n, self.s = 0, 0.0

    def __enter__(self):
        import torch
        import torch.distributed as dist
        self.saved = {k: getattr(dist, k) for k in ("all_reduce",
                                                    "broadcast")}

        def timed(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.s += time.perf_counter() - t0
                self.n += 1
                return out
            return call
        for k, fn in self.saved.items():
            setattr(dist, k, timed(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self.saved.items():
            setattr(dist, k, fn)


def parallel_child(rank: int, port: int, tmp: str) -> int:
    """A rank of phase 12's world (gloo, TP_RANKS ranks on the one card):
    builds the full models (seed 0, as the parent's engine), keeps its
    shards, and runs the teacher-forced tensor-parallel frames (mesh (1,
    2)) dense and int8/int8, then the sequence-split prefill (mesh (2,
    1)); writes its results to `tmp`."""
    import dataclasses

    import torch
    import torch.distributed as dist

    if not os.path.isdir(os.path.join(REPO, "qwen3_tts_tpu_torch")):
        fail("qwen3_tts_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    if not torch.cuda.is_available():
        fail("parallel child: no CUDA card")
    torch.cuda.set_device(0)
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.models import decoder
    from qwen3_tts_tpu_torch.ops import flash_decode, quant
    from qwen3_tts_tpu_torch.parallel import context as pcontext
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.parallel import run as prun
    from qwen3_tts_tpu_torch.tts.engine import random_weights

    def say(msg):
        log(f"[rank {rank}] {msg}")

    t_start = time.time()
    pmesh.initialize_multihost(f"127.0.0.1:{port}", TP_RANKS, rank,
                               backend="gloo", timeout_s=TP_TIMEOUT_S)
    cfg = EngineConfig()
    models, voc = random_weights(cfg, 0, "cuda")
    ck = torch.tensor([tree_checksum(models["talker"], models["predictor"],
                                     models["assets"], voc)],
                      dtype=torch.float64, device="cuda")
    res = {"checksum": float(ck)}
    dist.broadcast(ck, src=0)
    res["checksum_rank0"] = float(ck)
    inp = torch.load(os.path.join(tmp, "tp_inputs.pt"))
    x = inp["x"].cuda()
    mesh = pmesh.make_mesh(1, TP_RANKS, device_type="cuda")
    tp = pmesh.group(mesh, "model")
    tcfg = prun.tp_config(mesh, cfg)
    peaked = tp_peaked(models)
    say(f"full weights, checksum, mesh (1, {TP_RANKS}) in "
        f"{time.time() - t_start:.1f} s")
    cfg32 = dataclasses.replace(cfg, talker=dataclasses.replace(
        cfg.talker, dtype="float32"), predictor=dataclasses.replace(
        cfg.predictor, dtype="float32"))
    talker32 = to_f32(peaked["talker"])
    for label, kinds in (("dense bf16", None),
                         ("int8/int8", {"talker": "int8",
                                        "predictor": "int8"})):
        local, _ = prun.shard_models(mesh, cfg, peaked, voc, kinds)
        full = peaked["talker"] if kinds is None else \
            quant.quantize_decoder_params(peaked["talker"], kind="int8")
        full32 = talker32 if kinds is None else to_f32(full)
        ref = {k: v.cuda() for k, v in inp[label].items()}

        def run(local, tcfg, x, frames=TP_FRAMES, ref=ref, **kw):
            return tp_frames(local["talker"], tcfg.talker, x, local["assets"],
                             frames, codes=ref["codes"], h1024=ref["h1024"],
                             tp=tp, **kw)

        pred = (local["predictor"], tcfg.predictor)
        me = rank == 0
        with torch.inference_mode():
            # the path: counted and timed
            torch.cuda.synchronize()
            flash_decode.decode_attention_stacked.launches = 0
            quant.qmatmul_kernel.launches = 0
            t0 = time.time()
            out = run(local, tcfg, x, pred=pred)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = {"decode_attention_tp":
                      flash_decode.decode_attention_stacked.launches,
                      "qmatmul_tp": quant.qmatmul_kernel.launches}
            got = {"codes": out["codes"].cpu(), "argmax": out["argmax"].cpu(),
                   "hidden": out["hidden"].cpu(), "counts": counts,
                   "ms_frame": 1e3 * wall / TP_FRAMES}
            # the talker from the same states as the single process: in
            # bf16 against the single process in bf16 and in f32 (the
            # same weights)
            same = run(local, tcfg, x, refs=([
                ("bf16", full, cfg.talker), ("f32", full32, cfg32.talker)],
                me))
            if me:
                got["vs_bf16"] = same_state_stats(same, "bf16")
                got["vs_f32"] = same_state_stats(same, "f32")
                got["bf16_vs_f32"] = max(
                    rel_err(same["bf16_hidden"][i], same["f32_hidden"][i])
                    for i in range(TP_FRAMES + 1))
            # one step from phase 3's states, in its three tiers
            got["steps"] = tp_step_tiers(
                mesh, tp, me, cfg, cfg32, peaked, voc, kinds, full, full32,
                local)
            if label == "dense bf16":
                with CollectiveClock() as clock:
                    t0 = time.time()
                    run(local, tcfg, x, TP_CLOCK_FRAMES, pred=pred)
                    torch.cuda.synchronize()
                    got["collectives_frame"] = clock.n / TP_CLOCK_FRAMES
                    got["collective_share"] = clock.s / (time.time() - t0)
        res[label] = got
        say(f"{label}: prefill + {TP_FRAMES} teacher-forced frames in "
            f"{wall:.2f} s, launches {json.dumps(counts)}")
        del local, full, full32
        torch.cuda.empty_cache()
    del talker32

    # the sequence-split prefill of one long prompt: mesh (2, 1)
    m21 = pmesh.make_mesh(TP_RANKS, 1, device_type="cuda")
    tc = cfg.talker
    g = torch.Generator(device="cuda").manual_seed(37)
    xs = (0.05 * torch.randn(1, SP_TOKENS, tc.hidden, generator=g,
                             device="cuda")).to(torch.bfloat16)
    pos = torch.arange(SP_TOKENS, device="cuda")[None]
    pt = models["talker"]
    cp, cc = last_layer_dropped(pt, tc)

    def prefill(fn, params, config):
        cache = decoder.init_kv_cache(config, 1, length=SP_TOKENS,
                                      device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        h, _, cache = fn(params, config, cache)
        torch.cuda.synchronize()
        return h, cache, 1e3 * (time.time() - t0)

    split = (lambda p, c, cache: pcontext.prefill_sequence_sharded(
        m21, p, c, xs, pos, cache, 0))
    whole = (lambda p, c, cache: decoder.forward(p, c, xs, pos, cache, 0,
                                                 with_logits=False))
    with torch.inference_mode():
        prefill(split, pt, tc)                  # warm: the next is timed
        h, cache, ms = prefill(split, pt, tc)
        res["sp"] = {"ms": ms}
        if rank == 0:
            rh, rc, ref_ms = prefill(whole, pt, tc)
            ch = prefill(whole, cp, cc)[0]
            res["sp"].update({
                "h_rel": rel_err(h, rh), "k_rel": rel_err(cache["k"], rc["k"]),
                "v_rel": rel_err(cache["v"], rc["v"]),
                "ctl_rel": rel_err(ch, rh), "ref_ms": ref_ms})
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["wall_s"] = time.time() - t_start
    torch.save(res, os.path.join(tmp, f"tp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    say(f"done in {res['wall_s']:.1f} s, peak {res['peak_gib']:.2f} GiB")
    return 0


def phase_parallel(eng, rec: Record, card: str):
    """`parallel/` on the card: the kernels at a rank's shapes; a world of
    TP_RANKS gloo processes on the one card (`parallel_child`), each
    building EngineConfig()'s full weights from seed 0 and keeping its
    shards: the weights' checksum against this process's engine; the
    64-token prefill and 16 frames teacher-forced on the codes of this
    process's greedy single-process run, dense and int8/int8, and one
    step from phase 3's states in its three tiers (the gates in the
    module docstring, phase 12); the sequence-split prefill of 1024
    tokens against the single-process prefill; then the kernels' times."""
    import tempfile

    import torch
    log(f"[12/12] parallel: parallel/ (tensor-parallel frames, the "
        f"sequence-split prefill) in {TP_RANKS} gloo ranks on {card}")
    t_phase = time.time()
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(41)
    tp_kernel_checks(rec, g)
    cfg = eng.config
    tc, pc = cfg.talker, cfg.predictor
    peaked = tp_peaked(eng.models)
    kinds = {"dense bf16": peaked,
             "int8/int8": quantized_models(peaked, "int8", "int8")}
    x = (0.05 * torch.randn(1, TP_PROMPT, tc.hidden, generator=g,
                            device=dev)).to(torch.bfloat16)
    tmp = tempfile.mkdtemp(prefix="tp_smoke_")
    try:
        refs, inputs = {}, {"x": x.cpu()}
        with torch.inference_mode():
            for label, m in kinds.items():
                ref = tp_frames(m["talker"], tc, x, m["assets"], TP_FRAMES,
                                pred=(m["predictor"], pc))
                refs[label] = ref
                inputs[label] = {"codes": ref["codes"].cpu(),
                                 "h1024": ref["h1024"].cpu()}
        torch.save(inputs, os.path.join(tmp, "tp_inputs.pt"))
        # the ranks build ~20 GiB each on this card: give back this
        # process's cached blocks first
        del kinds, peaked, ref
        torch.cuda.empty_cache()
        log(f"  this process: {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
            f"reserved before the ranks start")
        want_ck = tree_checksum(eng.models["talker"],
                                eng.models["predictor"],
                                eng.models["assets"], eng.vocoder_params)
        log(f"  references (single process, greedy, {TP_FRAMES} frames, "
            f"dense and int8/int8) in {time.time() - t_phase:.1f} s")
        torch.cuda.synchronize()
        from qwen3_tts_tpu_torch.tools import multihost_smoke as launcher
        procs, logs = launcher.start_ranks(
            lambda r, port: [sys.executable, os.path.abspath(__file__),
                             "--parallel-rank", str(r), str(port), tmp],
            TP_RANKS, TP_RANKS)
        rcs, outs = launcher.finish_ranks(procs, logs, TP_TIMEOUT_S)
        for out in outs:
            for line in out.splitlines():
                if "hostname of the client socket" not in line:
                    log(f"  | {line}")
        if rcs != [0] * TP_RANKS:
            fail(f"parallel: the ranks exited {rcs}")
        ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"))
                 for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cks = [r["checksum"] for r in ranks] + [ranks[1]["checksum_rank0"]]
    ok = all(abs(c - want_ck) <= 1e-9 * abs(want_ck) for c in cks)
    log(f"  weights' checksum: this engine {want_ck:.6f}, ranks "
        f"{[round(c, 6) for c in cks[:-1]]}, broadcast from rank 0 "
        f"{cks[-1]:.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("parallel: the ranks did not build the engine's weights")
    lim = FULL_DEPTH_REL
    for label, ref in refs.items():
        got0 = ranks[0][label]
        for row in got0["steps"]:
            tier = row["tier"]
            head = (f"  {label}, one step from phase 3's state (T={row['T']}, "
                    f"live {row['live']}), {tier}: ")
            if tier == "full f32":
                msg = (f"hidden max|d|={row['h']:.2e}, logits max|d|="
                       f"{row['lg']:.2e} (rtol/atol 1e-4)")
            elif tier == "full bf16 2 layers":
                msg = (f"hidden rel={row['h']:.2e}, logits rel="
                       f"{row['lg']:.2e} (<= 8e-3)")
            else:
                msg = (f"control (last layer dropped) rel={row['ctl']:.2e} "
                       f"(> {lim:g}); hidden rel={row['h']:.2e}, logits rel="
                       f"{row['lg']:.2e} against the single process in bf16 "
                       f"(not gated at {lim:g}); against it in f32: hidden "
                       f"rel {row['tp_f32']:.2e}, the single process in "
                       f"bf16 {row['single_f32']:.2e}")
            log(head + msg + f" {'ok' if row['ok'] else 'FAIL'}")
            if not row["ok"]:
                fail(f"parallel {label} {tier}: the step disagrees with the "
                     "single process")
        st, st32 = got0["vs_bf16"], got0["vs_f32"]
        own = got0["bf16_vs_f32"]
        ok = st["agree"] >= 0.93 and st32["max"] <= TP_BF16_MARGIN * own
        log(f"  {label}: the prefill and {TP_FRAMES} teacher-forced steps, "
            f"each from the same state as the single process (the ranks' "
            f"caches gathered): talker argmax agreement {st['agree']:.3f} "
            f"(gate 0.93); hidden rel <= {st32['max']:.2e} against the "
            f"single process in f32, where the single process in bf16 is "
            f"<= {own:.2e} (gate: <= {TP_BF16_MARGIN:g} x it) "
            f"{'ok' if ok else 'FAIL'}; against the single process in "
            f"bf16 <= {st['max']:.2e} (not gated); each state's rel against "
            f"bf16: " + " ".join(f"{r:.1e}" for r in st["rels"]))
        if not ok:
            fail(f"parallel {label}: the talker disagrees with the single "
                 "process")
        for r, res in enumerate(ranks):
            got = res[label]
            agree_p = float((got["codes"][:, 1:] == ref["codes"][:, 1:]
                             .cpu()).float().mean())
            lockstep = (torch.equal(got["codes"], got0["codes"])
                        and torch.equal(got["argmax"], got0["argmax"]))
            ok = agree_p >= 0.95 and lockstep
            drift = rel_err(got["hidden"], ref["hidden"].cpu())
            agree_run = float((got["argmax"] == ref["argmax"].cpu()).float()
                              .mean())
            log(f"  {label} rank {r}: predictor codes agreement "
                f"{agree_p:.3f} (gate 0.95), the ranks' codes and argmax "
                f"{'equal' if lockstep else 'DIFFER'}; over the whole "
                f"teacher-forced run (drift through the caches, not gated): "
                f"hidden rel {drift:.2e}, argmax agreement {agree_run:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"parallel {label} rank {r}: disagrees with the single "
                     "process")
            counts = got["counts"]
            need = ("decode_attention_tp",) + (
                ("qmatmul_tp",) if label.startswith("int8") else ())
            missing = [k for k in need if counts[k] <= 0]
            if missing:
                fail(f"parallel {label} rank {r}: kernels never launched: "
                     f"{missing}")
            rec.add_launches(counts)
            clock = (f", {got['collectives_frame']:.1f} collectives a frame, "
                     f"{got['collective_share']:.1%} of the wall in them (a "
                     f"run of {TP_CLOCK_FRAMES} frames, synchronized around "
                     f"each)" if "collectives_frame" in got else "")
            log(f"  {label} rank {r}: {got['ms_frame']:.1f} ms a frame (host "
                f"clock, the prefill included){clock}, kernel launches "
                f"{json.dumps(counts)} on {card}")
    sp = ranks[0]["sp"]
    ok = max(sp["h_rel"], sp["k_rel"], sp["v_rel"]) <= lim < sp["ctl_rel"]
    log(f"  sequence-split prefill, {SP_TOKENS} tokens over {TP_RANKS} "
        f"ranks: hidden rel={sp['h_rel']:.2e}, cache k rel={sp['k_rel']:.2e}"
        f", v rel={sp['v_rel']:.2e} (<= {lim:g}); control rel="
        f"{sp['ctl_rel']:.2e} (> {lim:g}) {'ok' if ok else 'FAIL'}; "
        f"{sp['ms']:.1f} ms against {sp['ref_ms']:.1f} single-process (host "
        f"clock, rank 0) on {card}")
    if not ok:
        fail("parallel: the sequence-split prefill disagrees")
    peaks = ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
    walls = ", ".join(f"{r['wall_s']:.1f}" for r in ranks)
    log(f"  peak device memory of the ranks: {peaks} GiB; their walls "
        f"{walls} s")
    tp_kernel_times(rec, card, g)
    log(f"  (phase 12: {time.time() - t_phase:.1f} s)")


def _fmt4(ms):
    return "none" if ms is None else f"{ms:.4f}"


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "qwen3_tts_tpu_torch")):
        fail("qwen3_tts_tpu_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    t_start = time.time()
    sys.path.insert(0, REPO)
    card = phase_device()
    import torch
    phase_build()
    rec = Record()
    phase_kernels(rec)
    phase_probes(rec, card)

    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    t0 = time.time()
    eng = TtsEngine(config=EngineConfig(), random_weights=True, seed=0,
                    speakers_dir=os.path.join(REPO, "speakers"),
                    device="cuda")
    torch.cuda.synchronize()
    log(f"  engine: full EngineConfig() random weights in "
        f"{time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    phase_agree(eng)
    q48 = quantized_models(eng.models, "int4", "int8")
    q88 = quantized_models(eng.models, "int8", "int8")
    for name, run in (
            ("predictor", lambda: phase_predictor(eng, rec, card, q88)),
            ("main", lambda: phase_main(eng, rec, q48, q88)),
            ("stream", lambda: phase_stream(eng, rec, card, q48)),
            ("times", lambda: phase_times(eng, rec, card, q48)),
            ("checkpoint", lambda: phase_checkpoint(eng, rec, card)),
            ("clone", lambda: phase_clone(eng, rec, card, q48, q88)),
            ("serve", lambda: phase_serve(eng, rec, card, q48)),
            ("parallel", lambda: phase_parallel(eng, rec, card))):
        t0 = time.time()
        run()
        log(f"  phase {name} took {time.time() - t0:.1f} s")
    log(f"  the whole smoke took {time.time() - t_start:.1f} s")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB on {card}")
    print(card, flush=True)
    print(rec.line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_child(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    sys.exit(main())
