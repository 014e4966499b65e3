"""qwen3-tts command-line interface of the PyTorch/CUDA port.

The flag surface and flow of `qwen3_tts_tpu/cli.py` (itself the reference
binary's): model dir / quant, text, voice file, ref-audio + ref-text +
save-voice, output, max-steps, speakers dir, speaker, instruction,
temperature / top-k / top-p / seed, --stream, --long, --lang-id,
--random-weights, --tiny, --profile, --compile-cache; plus --device.

  * `--device` (default `cuda`) is the engine's device; `cuda` raises
    where there is no card, `cpu` runs the kernels' plain versions;
  * `--profile DIR` writes a `torch.profiler` trace (`DIR/trace.json`);
  * `--compile-cache` is accepted and has no effect: the port compiles no
    programs per process (its kernels build once per checkout,
    `kernels/build.py`);
  * `--long` with `--stream` is refused: long text is one offline batch.

Run: python -m qwen3_tts_tpu_torch.cli --text "..." [--speaker vivian]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-tts-torch",
        description="Qwen3-TTS on PyTorch and CUDA (hand-written Hopper "
                    "kernels)",
    )
    p.add_argument("--model-dir", default="models",
                   help="directory with assets + checkpoints")
    p.add_argument("--quant", default="none",
                   help="weight release to download/load (none/q5_k_m/"
                        "q8_0): selects the per-quant model subdirectory")
    p.add_argument("--no-download", action="store_true",
                   help="skip the download/verify step (offline)")
    p.add_argument("-t", "--text", required=True, help="text to synthesise")
    p.add_argument("-v", "--voice-file", default=None,
                   help="preset voice file (.json)")
    p.add_argument("--ref-audio", default=None,
                   help="reference audio for cloning (.wav, 24 kHz)")
    p.add_argument("--ref-text", default=None,
                   help="transcript of the reference audio")
    p.add_argument("--save-voice", default=None,
                   help="path to save the extracted VoiceFile (.json)")
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--max-steps", type=int, default=512)
    p.add_argument("--speakers-dir", default="speakers")
    p.add_argument("-s", "--speaker", default=None,
                   help="speaker name or id (fallback: vivian)")
    p.add_argument("--instruction", default=None,
                   help='style instruction (e.g. "Happy", "Sad")')
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lang-id", type=int, default=None,
                   help="language id (default 2055 Chinese, like the "
                        "reference's hardcoded value)")
    p.add_argument("--long", action="store_true",
                   help="split arbitrary-length text at sentence "
                        "boundaries and synthesize it as one batch")
    p.add_argument("--stream", action="store_true",
                   help="stream ~333 ms chunks instead of offline decode")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (no checkpoints needed; "
                        "smoke/benchmark runs)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model geometry (CI smoke)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="accepted for the JAX CLI's flag surface; no "
                        "effect: the port's kernels build once per "
                        "checkout (kernels/build.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda, which "
                        "needs a card; cpu runs the kernels' plain "
                        "versions)")
    return p


def _generate(engine, args, voice, t_gen):
    if args.stream:
        n_chunks = 0
        first_chunk_ms = None

        def on_chunk(piece):
            nonlocal n_chunks, first_chunk_ms
            if first_chunk_ms is None:
                first_chunk_ms = 1000.0 * (time.time() - t_gen)
            n_chunks += 1

        audio = engine.generate_stream(args.text, voice,
                                       instruct=args.instruction,
                                       on_chunk=on_chunk)
        first = "none" if first_chunk_ms is None \
            else f"{first_chunk_ms:.0f} ms"
        print(f"Streamed {n_chunks} chunks; first chunk at {first}")
        return audio
    if args.long:
        return engine.generate_long(args.text, voice,
                                    instruct=args.instruction)
    return engine.generate_with_voice(args.text, voice,
                                      instruct=args.instruction)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.long and args.stream:
        parser.error("--long and --stream cannot be combined: long text is "
                     "synthesized as one offline batch")

    from . import SamplerConfig, TtsEngine, VoiceFile
    from .core.config import EngineConfig, tiny_engine_config

    t0 = time.time()
    config = tiny_engine_config() if args.tiny else EngineConfig()
    if args.lang_id is not None:
        import dataclasses
        config = dataclasses.replace(config, lang_id=args.lang_id)

    print(f"=== Qwen3-TTS (PyTorch) ===\nModel Dir: {args.model_dir}\n"
          f"Text:      {args.text}")

    # download/verify the model files before the engine is built
    if not args.random_weights and not args.no_download:
        status = TtsEngine.download_models(args.model_dir, args.quant)
        fetched = sum(1 for v in status.values() if v == "downloaded")
        bad = sorted(r for r, v in status.items()
                     if v in ("missing", "corrupt"))
        if fetched:
            print(f"Downloaded {fetched} model file(s)")
        if bad:
            print("Missing model files (offline or fetch failed):\n  "
                  + "\n  ".join(bad), file=sys.stderr)

    try:
        engine = TtsEngine(
            model_dir=None if args.random_weights else args.model_dir,
            config=config,
            quant=args.quant,
            random_weights=args.random_weights,
            speakers_dir=args.speakers_dir,
            device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        print(f"Failed to load models: {e}", file=sys.stderr)
        return 1
    engine.set_max_steps(args.max_steps)
    engine.set_sampler_config(SamplerConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed,
    ))
    print(f"Sampler: temp={args.temperature}, top_k={args.top_k}, "
          f"top_p={args.top_p}, seed={args.seed}")

    if args.ref_audio:
        print(f"Creating voice from reference: {args.ref_audio}")
        try:
            voice = engine.create_voice_file(args.ref_audio,
                                             args.ref_text or "")
        except (OSError, ValueError, RuntimeError) as e:
            print(f"Feature extraction failed: {e}", file=sys.stderr)
            return 1
        if args.save_voice:
            voice.save(args.save_voice)
            print(f"Saved new voice file to: {args.save_voice}")
    elif args.voice_file:
        try:
            voice = VoiceFile.load(args.voice_file)
        except (OSError, ValueError, KeyError) as e:
            print(f"Failed to load voice file: {e}", file=sys.stderr)
            return 1
    else:
        try:
            voice = engine.get_speaker(args.speaker or "vivian")
        except RuntimeError as e:
            print(f"Speaker selection failed: {e}", file=sys.stderr)
            return 1
    print(f"Voice Name: {voice.name or 'Dynamic'}")

    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)

    t_gen = time.time()
    with profiler:
        audio = _generate(engine, args, voice, t_gen)
    gen_s = time.time() - t_gen

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        profiler.export_chrome_trace(trace)
        print(f"Profile trace: {trace}")

    audio.save_wav(args.output)
    dur = audio.duration()
    rtf = gen_s / dur if dur > 0 else float("inf")
    print(f"Generation took: {gen_s:.2f}s for {dur:.2f}s audio "
          f"(RTF {rtf:.3f})")
    print(f"Saved to: {args.output}")
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
