"""VoiceFile: persisted speaker state as JSON.

Format-compatible with the reference (`src/utils/voice_file.rs:5-62`) and the
nine shipped `speakers/*.json` presets: `ref_text` (default ""),
`audio_codes` (default []), `speaker_embedding` with accepted alias
`spk_emb`, optional `name`/`gender`/`age`/`description`. Preset files also
carry `spk_id`; we round-trip it (the reference parser ignores it and drives
presets through the spk_emb prompt path, `src/tts/engine.rs:398-412`).

A copy of `qwen3_tts_tpu/utils/voice_file.py` (no framework imports).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class VoiceFile:
    ref_text: str = ""
    audio_codes: List[int] = field(default_factory=list)
    speaker_embedding: List[float] = field(default_factory=list)
    name: Optional[str] = None
    gender: Optional[str] = None
    age: Optional[str] = None
    description: Optional[str] = None
    spk_id: Optional[int] = None

    @property
    def spk_emb(self) -> np.ndarray:
        return np.asarray(self.speaker_embedding, np.float32)

    @property
    def codes_array(self) -> np.ndarray:
        return np.asarray(self.audio_codes, np.int64).reshape(-1, 16)

    @classmethod
    def load(cls, path: str) -> "VoiceFile":
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        emb = d.get("speaker_embedding", d.get("spk_emb", []))
        return cls(
            ref_text=d.get("ref_text", ""),
            audio_codes=list(d.get("audio_codes", [])),
            speaker_embedding=list(emb),
            name=d.get("name"),
            gender=d.get("gender"),
            age=d.get("age"),
            description=d.get("description"),
            spk_id=d.get("spk_id"),
        )

    def save(self, path: str) -> None:
        d = {
            "ref_text": self.ref_text,
            "audio_codes": [int(c) for c in self.audio_codes],
            "speaker_embedding": [float(x) for x in self.speaker_embedding],
            "name": self.name,
            "gender": self.gender,
            "age": self.age,
            "description": self.description,
        }
        if self.spk_id is not None:
            d["spk_id"] = int(self.spk_id)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(d, f, ensure_ascii=False, indent=2)
