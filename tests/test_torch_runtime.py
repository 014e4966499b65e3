"""The port's host runtime (`qwen3_tts_tpu_torch.runtime`, pure Python)
against the JAX package's (`qwen3_tts_tpu.runtime`): the PCM ring, the
reference-parity code chunker and the slot manager run the same operations
in both, and every result is equal. Each case runs twice, once against each
path of the JAX package: its native library (`native/libttsrt.so`, built by
`make -C native` at first use; the case skips only where it cannot be
built) and its pure-Python path (its loader patched to find no library).
Mirrors tests/test_runtime.py, plus random operation sequences.
"""

import numpy as np
import pytest

from qwen3_tts_tpu import runtime as jruntime
from qwen3_tts_tpu_torch import runtime as truntime


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Which path of the JAX package the port is held against."""
    if request.param == "native":
        if not jruntime.native_available():
            pytest.skip("native/libttsrt.so cannot be built here")
    else:
        monkeypatch.setattr(jruntime, "_load", lambda: None)
        assert not jruntime.native_available()
    return request.param


def _both(scenario):
    """scenario(module) on the port's runtime and on JAX's: equal results
    (a list of plain values and arrays). Returns the port's."""
    got, want = scenario(truntime), scenario(jruntime)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    return got


def test_ring_roundtrip_and_overflow(path):
    x = np.linspace(-1, 1, 300).astype(np.float32)
    ones = np.ones(150, np.float32)

    def scenario(rt):
        r = rt.PcmRing(1024)
        out = [r.push(x), r.available(), r.pop(300), r.available()]
        small = rt.PcmRing(100)
        out += [small.push(ones), small.push(ones), len(small.pop(60)),
                small.push(ones), small.available()]
        return out

    got = _both(scenario)
    np.testing.assert_allclose(got[2], x)
    assert got[:2] == [300, 300] and got[3] == 0
    assert got[4:] == [100, 0, 60, 60, 100]


def test_ring_s16_clamp(path):
    def scenario(rt):
        r = rt.PcmRing(16)
        r.push(np.asarray([0.0, 1.0, -1.0, 2.0, -2.0, 0.5], np.float32))
        return [r.pop_s16(5), r.pop(4)]

    got = _both(scenario)
    assert got[0].tolist() == [0, 32767, -32767, 32767, -32768]
    assert got[1].tolist() == [0.5]


def test_chunker_reference_policy(path):
    """64-code batching, whole-frame truncation, remainder carry, the
    [0, 2047] clamp and the final flush (src/tts/engine.rs:510-537)."""
    def scenario(rt):
        c = rt.CodeChunker(64, 16)
        out = [c.push(np.arange(48)), c.pending(),
               c.push(np.arange(48, 80)), c.pending(),
               c.push(np.arange(8)),
               c.push(np.asarray([5000, -3] + list(range(6))),
                      is_final=True), c.pending()]
        c2 = rt.CodeChunker(64, 16)
        c2.push(np.arange(20))
        out += [c2.push(np.zeros(0, np.int64), is_final=True), c2.pending()]
        return out

    got = _both(scenario)
    assert len(got[0]) == 0 and got[1] == 48
    assert len(got[2]) == 80 and got[3] == 0
    assert len(got[4]) == 0 and len(got[5]) == 16
    assert got[5][8] == 2047 and got[5][9] == 0
    assert got[6] == 0 and len(got[7]) == 16 and got[8] == 0


def test_slot_manager(path):
    def scenario(rt):
        s = rt.SlotManager(3)
        out = [s.acquire() for _ in range(3)]
        out += [s.acquire(), s.active()]
        s.mark_frames(1, 7)
        s.mark_frames(1, 2)
        out.append(s.frames(1))
        s.mark_eos(1)
        out.append(s.active())
        s.release(1)
        out += [s.active(), s.acquire(), s.frames(1), s.active()]
        return out

    got = _both(scenario)
    assert {slot for slot, _ in got[:3]} == {0, 1, 2}
    assert got[3] == (None, None) and got[4] == 3
    assert got[5] == 9 and got[6] == 3 and got[7] == 2
    assert got[8][0] == 1 and got[8][1] is not None
    assert got[9] == 0 and got[10] == 3


@pytest.mark.parametrize("seed", range(4))
def test_random_operations(path, seed):
    """Seeded random sequences of every call on the three classes give the
    JAX package's results call for call."""
    def scenario(rt):
        rng = np.random.default_rng(seed)
        ring, chunker, slots = rt.PcmRing(500), rt.CodeChunker(64, 16), \
            rt.SlotManager(5)
        out = []
        for _ in range(200):
            op = int(rng.integers(0, 9))
            if op == 0:
                x = rng.uniform(-1.5, 1.5, int(rng.integers(0, 300)))
                out.append(ring.push(x.astype(np.float32)))
            elif op == 1:
                out.append(ring.pop(int(rng.integers(0, 200))))
            elif op == 2:
                out += [ring.pop_s16(int(rng.integers(0, 200))),
                        ring.available()]
            elif op == 3:
                codes = rng.integers(-100, 2300, int(rng.integers(0, 90)))
                out += [chunker.push(codes, is_final=bool(rng.random() < .2)),
                        chunker.pending()]
            elif op == 4:
                out.append(slots.acquire())
            elif op == 5:
                s, n = int(rng.integers(0, 5)), int(rng.integers(0, 9))
                slots.mark_frames(s, n)
                out.append(slots.frames(s))
            elif op == 6:
                slots.mark_eos(int(rng.integers(0, 5)))
                out.append(slots.active())
            elif op == 7:
                slots.release(int(rng.integers(0, 5)))
                out.append(slots.active())
            else:
                out.append(slots.frames(int(rng.integers(0, 5))))
        return out

    _both(scenario)
