"""Import preset speaker voices from an existing Qwen3-TTS-Rust checkout.

    python -m qwen3_tts_tpu_torch.tools.import_speakers \
        --from /path/to/Qwen3-TTS-Rust/speakers --to speakers/

The port's copy of the JAX package's `tools/import_speakers.py`, over the
port's own `utils/voice_file.VoiceFile` (no JAX). The reference ships nine
preset voices as `speakers/*.json` (vivian, serena, uncle_fu, ryan, aiden,
ono_anna, sohee, eric, dylan; speakers/index.json). They are model-derived
data, consumed unchanged by the VoiceFile loader; the repo vendors them
byte-identical under `speakers/`. This tool re-imports and validates them
when the upstream presets change: each voice that loads and carries a
speaker embedding is copied byte for byte, `index.json` as it is; any
other file is reported and skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from ..utils.voice_file import VoiceFile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.import_speakers")
    ap.add_argument("--from", dest="src", required=True,
                    help="reference speakers/ directory")
    ap.add_argument("--to", dest="dst", default="speakers")
    args = ap.parse_args(argv)

    os.makedirs(args.dst, exist_ok=True)
    imported = []
    for name in sorted(os.listdir(args.src)):
        if not name.endswith(".json"):
            continue
        src_path = os.path.join(args.src, name)
        if name == "index.json":
            shutil.copyfile(src_path, os.path.join(args.dst, name))
            continue
        try:
            v = VoiceFile.load(src_path)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"skip {name}: {e}", file=sys.stderr)
            continue
        if len(v.speaker_embedding) == 0:
            print(f"skip {name}: no speaker embedding", file=sys.stderr)
            continue
        shutil.copyfile(src_path, os.path.join(args.dst, name))
        imported.append((name[:-5], v.spk_id, len(v.speaker_embedding)))
    for name, sid, dim in imported:
        print(f"imported {name}: spk_id={sid}, emb[{dim}]")
    print(f"{len(imported)} voices -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
