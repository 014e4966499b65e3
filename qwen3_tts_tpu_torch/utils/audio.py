"""WAV audio I/O (24 kHz mono pipeline).

Counterpart of the reference `AudioSample` (`src/utils/audio.rs:10-46`) plus
the wider format support its cloning path needs
(`src/tts/engine.rs:337-373`): PCM s16 / s32 and IEEE float32, stereo
collapsed to channel 0. Implemented on the stdlib `wave`-free RIFF layer so
float WAVs work; numpy does the sample conversion.

A copy of `qwen3_tts_tpu/utils/audio.py` (no framework imports).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class AudioSample:
    samples: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 24000
    channels: int = 1

    def duration(self) -> float:
        return len(self.samples) / float(self.sample_rate)

    @classmethod
    def load_wav(cls, path: str) -> "AudioSample":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        pos = 12
        fmt = None
        payload = None
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
            body = data[pos + 8:pos + 8 + size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                payload = body
            pos += 8 + size + (size & 1)
        if fmt is None or payload is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_format, channels, rate, _, _, bits = fmt
        if audio_format == 1 and bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif audio_format == 1 and bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        elif audio_format == 3 and bits == 32:
            x = np.frombuffer(payload, "<f4").astype(np.float32)
        else:
            raise ValueError(
                f"{path}: unsupported WAV format {audio_format}/{bits}-bit"
            )
        if channels > 1:
            # stereo -> take channel 0 (src/tts/engine.rs:369-373)
            x = x.reshape(-1, channels)[:, 0].copy()
        return cls(samples=x, sample_rate=rate, channels=1)

    def save_wav(self, path: str) -> None:
        """f32 -> s16 with the reference's clamp (src/utils/audio.rs:26-41)."""
        amp = np.clip(self.samples * 32767.0, -32768, 32767).astype("<i2")
        payload = amp.tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
        fmt = b"fmt " + struct.pack(
            "<IHHIIHH", 16, 1, self.channels, self.sample_rate,
            self.sample_rate * self.channels * 2, self.channels * 2, 16,
        )
        with open(path, "wb") as f:
            f.write(hdr + fmt + b"data" + struct.pack("<I", len(payload)) + payload)
