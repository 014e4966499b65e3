"""Host runtime of the serving path: the PCM ring buffer, the
reference-parity 64-code chunker and the continuous-batching slot manager.
Port of `qwen3_tts_tpu/runtime.py`, the port's own copy.

The JAX package binds `native/libttsrt.so` through ctypes and keeps a
pure-Python path with the same semantics. The port keeps only the Python
path: its one caller, `serving.ServingEngine`, makes a few `SlotManager`
calls a tick beside a tick of tens of milliseconds on the card. Everything
here is host bookkeeping; nothing touches the device.
"""

from __future__ import annotations

import numpy as np


class PcmRing:
    """SPSC float PCM ring buffer of `capacity` samples."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32)
        take = min(self.capacity - len(self._buf), len(samples))
        self._buf = np.concatenate([self._buf, samples[:take]])
        return take

    def available(self) -> int:
        return len(self._buf)

    def pop(self, max_n: int) -> np.ndarray:
        n = min(max_n, len(self._buf))
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def pop_s16(self, max_n: int) -> np.ndarray:
        f = self.pop(max_n)
        return np.clip(f * 32767.0, -32768, 32767).astype(np.int16)


class CodeChunker:
    """64-code batching with remainder carry and [0,2047] clamp — the
    reference decoder-thread policy (src/tts/engine.rs:510-537)."""

    def __init__(self, chunk_codes: int = 64, frame_codes: int = 16):
        self.chunk_codes = chunk_codes
        self.frame_codes = frame_codes
        self._pending: list[int] = []

    def push(self, codes: np.ndarray, is_final: bool = False) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.int64).reshape(-1)
        self._pending.extend(int(c) for c in codes)
        if len(self._pending) < self.chunk_codes and not is_final:
            return np.zeros(0, np.int64)
        valid = (len(self._pending) // self.frame_codes) * self.frame_codes
        if valid <= 0:
            if is_final:
                self._pending.clear()
            return np.zeros(0, np.int64)
        out = np.clip(np.asarray(self._pending[:valid], np.int64), 0, 2047)
        if is_final:
            self._pending.clear()
        else:
            del self._pending[:valid]
        return out

    def pending(self) -> int:
        return len(self._pending)


class SlotManager:
    """Continuous-batching slots for multi-stream serving: each slot is
    free (0), live (1) or at EOS (2), with a frame count; stream ids count
    up from 1."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._state = [0] * n_slots
        self._frames = [0] * n_slots
        self._next = 1

    def acquire(self):
        for i, s in enumerate(self._state):
            if s == 0:
                self._state[i] = 1
                self._frames[i] = 0
                sid = self._next
                self._next += 1
                return i, sid
        return None, None

    def mark_frames(self, slot: int, n: int) -> None:
        self._frames[slot] += n

    def mark_eos(self, slot: int) -> None:
        if self._state[slot] == 1:
            self._state[slot] = 2

    def release(self, slot: int) -> None:
        self._state[slot] = 0

    def active(self) -> int:
        return sum(1 for s in self._state if s != 0)

    def frames(self, slot: int) -> int:
        return self._frames[slot]
