"""Release validation in one command: downloaded weights -> pass/fail JSON.

    python -m qwen3_tts_tpu_torch.tools.validate_release --model-dir models \
        [--quant none] [--geometry auto|flagship|tiny] [--steps 12] \
        [--skip-synthesis] [--quant-gate 0.9] [--wav-out x.wav] \
        [--device cuda]

The port's copy of the JAX package's `tools/validate_release.py`, without
JAX: it imports neither `jax` nor anything of `qwen3_tts_tpu`, so it runs
on a machine that has only the port and a card. Given a model directory in
the downloader's layout (`src/download.rs:55-101`):

    tokenizer/tokenizer.json
    onnx/qwen3_tts_decoder.onnx            [+ optional encoder graphs]
    <quant>/qwen3_assets.gguf
    <quant>/qwen3_tts_{talker,predictor}.gguf

it runs, in order: the manifest, the tokenizer, the assets GGUF and its
protocol shapes, the talker / predictor GGUF geometry and conversion, the
vocoder ONNX validation and conversion (its upsampler family derived from
the graph; `vocoder.npz` and `vocoder_config.json` written beside the
GGUFs, so the engine serves it), the optional encoders (converted into the
model directory), a short greedy synthesis through `TtsEngine` on
`--device`, and the teacher-forced agreement of int8 and int4 predictor
weights with the release's own on these weights
(`models/predictor.frame_codes`). It prints one JSON line,

    {"pass": true|false, "checks": {...}, "model_dir": ...}

and exits 0 on a pass, 1 on any failed check. Converting goes through the
port's `tools/convert_weights.py` and GGUF readers.

Deliberate divergences from the JAX tool:
  * the quant-agreement inputs are drawn from `torch.Generator` seeds
    100-107 where JAX draws from `jax.random` keys 100-107: the same
    check on other random inputs;
  * synthesis and the quant-agreement check share one engine where their
    configurations are equal (JAX loads the release twice);
  * where the `tokenizers` library is not installed, the tokenizer check
    cannot encode: it reads tokenizer.json as JSON, checks that its model
    has a vocabulary and reports `skip` (the engine then runs the byte
    fallback, as the JAX package's does). The JAX tool reports `fail`
    there.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import traceback


class _Skip(Exception):
    """A check that cannot run here: reported as `skip` with its reason."""


def require(cond, msg) -> None:
    """A check's condition: AssertionError (a failed check) unless it
    holds, also under `python -O`, which drops `assert` statements."""
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.validate_release")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--quant", default="none",
                    choices=("none", "q5_k_m", "q8_0"))
    ap.add_argument("--geometry", default="auto",
                    choices=("auto", "flagship", "tiny"),
                    help="engine geometry; 'auto' reads it from the talker/"
                         "predictor GGUF metadata")
    ap.add_argument("--steps", type=int, default=12,
                    help="frames for the synthesis smoke")
    ap.add_argument("--skip-synthesis", action="store_true")
    ap.add_argument("--quant-gate", type=float, default=0.9,
                    help="minimum teacher-forced code agreement of int8 / "
                         "int4 predictor weights with the release's ON "
                         "THESE weights (0 disables gating but still "
                         "records the fractions: random weights are "
                         "near-tie degenerate)")
    ap.add_argument("--wav-out", default=None,
                    help="write the synthesis smoke's waveform here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .. import download
    from ..assets import checkpoint, tables
    from ..assets.llama_gguf import convert_llama_gguf
    from ..core.config import (EngineConfig, SamplerConfig,
                               save_vocoder_config, tiny_engine_config)
    from ..utils.tokenizer import load_tokenizer
    from . import convert_weights as cw

    checks: dict = {}

    def run(name, fn, fatal=True):
        try:
            detail = fn()
            checks[name] = {"status": "pass",
                            **({"detail": detail} if detail else {})}
            return True
        except _Skip as e:
            skip(name, str(e))
            return True
        except Exception as e:
            checks[name] = {"status": "fail",
                            "detail": f"{type(e).__name__}: {e}"}
            if not isinstance(e, (ValueError, FileNotFoundError,
                                  KeyError, AssertionError,
                                  cw.OnnxConversionError)):
                traceback.print_exc()
            return not fatal

    def skip(name, why):
        checks[name] = {"status": "skip", "detail": why}

    mdir = args.model_dir
    qdir = os.path.join(mdir, download.quant_dir(args.quant))

    # 1. manifest ----------------------------------------------------------
    def check_manifest():
        missing = [rel for rel, _ in download.manifest(args.quant)
                   if not os.path.exists(os.path.join(mdir, rel))]
        require(not missing, f"missing release files: {missing}")
        return f"{len(download.manifest(args.quant))} files present"

    ok = run("manifest", check_manifest)
    if not ok:
        print(json.dumps({"pass": False, "checks": checks,
                          "model_dir": mdir}), flush=True)
        return 1

    # 2. tokenizer ---------------------------------------------------------
    def check_tokenizer():
        if importlib.util.find_spec("tokenizers") is None:
            path = os.path.join(mdir, "tokenizer", "tokenizer.json")
            with open(path, encoding="utf-8") as f:
                model = json.load(f)["model"]
            require(model.get("vocab"), "tokenizer.json has no vocabulary")
            raise _Skip(
                f"the tokenizers library is not installed: tokenizer.json "
                f"parses ({model.get('type')}, {len(model['vocab'])} vocab "
                f"entries) but cannot encode here; the engine runs the "
                f"byte fallback")
        tok = load_tokenizer(mdir)
        require(tok.warning is None, tok.warning)
        ids = tok.encode("你好, hello world")
        require(ids, "tokenizer produced no ids")
        return f"real tokenizer.json, {len(ids)} ids for the probe string"

    ok &= run("tokenizer", check_tokenizer)

    # 3. assets GGUF -------------------------------------------------------
    def check_assets():
        a = tables.load_assets(qdir, device=args.device)
        rows = a.codec_tables.shape
        require(rows[0] == 16, f"{rows[0]} codec tables != 16")
        require(rows[1] >= 2161,
                f"codec table rows {rows[1]} < 2161 (protocol ids BOS=2149/"
                "EOS=2150/codec-BOS=2160 must exist)")
        require(a.proj_weight.shape[1] == a.text_table.shape[1],
                f"proj {tuple(a.proj_weight.shape)} does not consume "
                f"text-table dim {a.text_table.shape[1]}")
        return (f"text {tuple(a.text_table.shape)}, codec {tuple(rows)}, "
                f"proj {tuple(a.proj_weight.shape)}")

    ok &= run("assets_gguf", check_assets)

    # 4. talker / predictor GGUF ------------------------------------------
    geometries = {}

    def check_decoder(kind):
        def fn():
            path = os.path.join(qdir, f"qwen3_tts_{kind}.gguf")
            gcfg, params = convert_llama_gguf(path, kind)
            n = sum(int(np.prod(np.shape(v)))
                    for _, v in checkpoint.flatten(params))
            geometries[kind] = gcfg
            return (f"hidden={gcfg.hidden} L={gcfg.n_layers} "
                    f"heads={gcfg.n_q_heads}/{gcfg.n_kv_heads} "
                    f"ffn={gcfg.ffn_dim} ({n/1e6:.0f}M params)")
        return fn

    ok &= run("talker_gguf", check_decoder("talker"))
    ok &= run("predictor_gguf", check_decoder("predictor"))

    # 5. vocoder ONNX ------------------------------------------------------
    vcfg_box = {}

    def check_vocoder():
        path = os.path.join(mdir, "onnx", "qwen3_tts_decoder.onnx")
        base = None
        if args.geometry == "tiny":
            base = tiny_engine_config().vocoder
        params, vcfg = cw.convert_vocoder_onnx(path, base, return_cfg=True)
        checkpoint.save_tree(os.path.join(qdir, "vocoder.npz"), params)
        save_vocoder_config(os.path.join(qdir, "vocoder_config.json"),
                            vcfg)
        vcfg_box["cfg"] = vcfg
        fam = "general (BigVGAN/DAC)" if vcfg.general_upsampler \
            else "sequential"
        return (f"family={fam}, activation={vcfg.activation}, "
                f"strides={vcfg.upsample_factors}, converted -> "
                f"{qdir}/vocoder.npz")

    ok &= run("vocoder_onnx", check_vocoder)

    # 6. optional encoders -------------------------------------------------
    for kind, fname, out in (
            ("audio", "qwen3_tts_codec_encoder.onnx", "audio_encoder.npz"),
            ("speaker", "qwen3_tts_speaker_encoder.onnx",
             "speaker_encoder.npz")):
        path = os.path.join(mdir, "onnx", fname)
        if not os.path.exists(path):
            skip(f"{kind}_encoder_onnx",
                 f"{fname} not in release (cloning disabled, preset "
                 "speakers unaffected — src/tts/engine.rs:108-120)")
            continue

        def conv(p=path, k=kind, o=out):
            params = cw.convert_encoder_onnx(p, k)
            checkpoint.save_tree(os.path.join(mdir, o), params)
            return f"converted -> {o}"

        ok &= run(f"{kind}_encoder_onnx", conv)

    # the engines of steps 7 and 8, one per configuration
    engines = {}

    def engine(cfg):
        from ..tts.engine import TtsEngine
        if "cfg" in vcfg_box:
            cfg = dataclasses.replace(cfg, vocoder=vcfg_box["cfg"])
        if cfg not in engines:
            engines.clear()         # one release in memory at a time
            engines[cfg] = TtsEngine(model_dir=mdir, config=cfg,
                                     quant=args.quant, device=args.device)
        return engines[cfg]

    def gguf_config():
        t, p = geometries["talker"], geometries["predictor"]
        return dataclasses.replace(EngineConfig(), talker=t, predictor=p)

    # 7. end-to-end synthesis ---------------------------------------------
    if args.skip_synthesis:
        skip("synthesis", "--skip-synthesis")
    elif not ok:
        skip("synthesis", "earlier checks failed")
    else:
        def check_synthesis():
            from ..utils.voice_file import VoiceFile

            if args.geometry == "tiny":
                cfg = tiny_engine_config()
            elif args.geometry == "flagship":
                cfg = EngineConfig()
            else:
                cfg = gguf_config()
            eng = engine(cfg)
            eng.set_max_steps(args.steps)
            eng.set_sampler_config(SamplerConfig(
                temperature=0.0, top_k=0, top_p=1.0, seed=0))
            try:
                spk = eng.get_speaker("vivian")
            except RuntimeError:
                spk = VoiceFile(speaker_embedding=np.zeros(
                    eng.config.talker.hidden, np.float32).tolist())
            audio = eng.generate_with_voice("hello from the release "
                                            "validator", spk)
            w = np.asarray(audio.samples)
            require(w.size > 0, "empty waveform")
            require(np.isfinite(w).all(), "non-finite samples")
            require(float(np.abs(w).max()) > 0, "silent waveform")
            if args.wav_out:
                audio.save_wav(args.wav_out)
            return (f"{w.size} samples, {audio.duration():.2f}s, "
                    f"peak {float(np.abs(w).max()):.3f}")

        ok &= run("synthesis", check_synthesis)

    # 8. quant acceptance on these weights: random-weight agreement is
    # regime-limited; the gate that matters runs on the release's own logit
    # statistics
    if args.skip_synthesis or not ok:
        skip("quant_agreement", "synthesis skipped or earlier failure")
    else:
        @torch.inference_mode()
        def check_quant():
            from ..models import predictor as pred_mod
            from ..ops import quant

            cfg = tiny_engine_config() if args.geometry == "tiny" \
                else gguf_config()
            eng = engine(cfg)
            pc = eng.config.predictor
            dev = eng.device
            fracs = {}
            for kind in ("int8", "int4"):
                try:
                    mq = {
                        "talker": quant.quantize_decoder_params(
                            eng.models["talker"], kind=kind),
                        "predictor": quant.quantize_decoder_params(
                            eng.models["predictor"], kind=kind),
                        "assets": eng.models["assets"],
                    }
                except Exception as e:
                    fracs[kind] = f"unsupported: {e}"
                    continue
                agree = total = 0
                for s in range(8):
                    g = torch.Generator(device=dev).manual_seed(100 + s)
                    h = torch.randn(1, pc.hidden, generator=g, device=dev)
                    c0 = torch.randint(0, 2048, (1,), generator=g,
                                       device=dev, dtype=torch.int32)
                    a = pred_mod.frame_codes(mq["predictor"], pc,
                                             mq["assets"], h, c0)
                    b = pred_mod.frame_codes(eng.models["predictor"], pc,
                                             eng.models["assets"], h, c0)
                    agree += int((a == b).sum())
                    total += a.numel()
                del mq
                frac = agree / total
                fracs[kind] = round(frac, 4)
                if args.quant_gate > 0 and frac < args.quant_gate:
                    raise AssertionError(
                        f"{kind} teacher-forced code agreement {frac:.3f} "
                        f"< gate {args.quant_gate} on these weights")
            return fracs

        ok &= run("quant_agreement", check_quant)

    engines.clear()
    print(json.dumps({"pass": bool(ok), "checks": checks,
                      "model_dir": mdir}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
