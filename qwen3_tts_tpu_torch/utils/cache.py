"""Reference-audio feature cache: the binary `.cache` sidecar.

Byte-compatible with the reference format (`src/utils/cache.rs:5-67`):
magic `TTSC`, u32 version 1, u64 code count + i64 codes, u64 emb count +
f32 embedding, all little-endian. Lets clone-mode generations skip
re-encoding a reference WAV (`src/tts/engine.rs:275-302`).

A copy of `qwen3_tts_tpu/utils/cache.py` (no framework imports).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

MAGIC = b"TTSC"
VERSION = 1


def save_cache(path: str, codes: np.ndarray, emb: np.ndarray) -> None:
    codes = np.asarray(codes, "<i8").reshape(-1)
    emb = np.asarray(emb, "<f4").reshape(-1)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<Q", codes.size))
        f.write(codes.tobytes())
        f.write(struct.pack("<Q", emb.size))
        f.write(emb.tobytes())


def load_cache(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: invalid magic bytes")
        (version,) = struct.unpack("<I", f.read(4))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported cache version {version}")
        (n_codes,) = struct.unpack("<Q", f.read(8))
        codes = np.frombuffer(f.read(8 * n_codes), "<i8")
        (n_emb,) = struct.unpack("<Q", f.read(8))
        emb = np.frombuffer(f.read(4 * n_emb), "<f4")
    if codes.size != n_codes or emb.size != n_emb:
        raise ValueError(f"{path}: truncated cache file")
    return codes.copy(), emb.copy()
