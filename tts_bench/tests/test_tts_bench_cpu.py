"""Tiny cells of every driver, driven on the CPU through the whole run but
the look for a card: the plain paths of the program, the check against
the reference, and the result line; then the same with the timed path
broken underneath, which the check has to find."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import tts_bench_tiny as tiny
from tts_bench import harness
from tts_bench import run as run_mod

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(tmp_path, driver, quantised, trace=False):
    bench = tiny.write_cell(str(tmp_path), driver, quantised)
    return run_mod.run(f"tiny.{driver}", 2 ** 31 + 7, 1.5, trace,
                       time.perf_counter(), roots=(str(tmp_path),
                                                   harness.HERE),
                       bench=bench, device=torch.device("cpu"))


@pytest.mark.parametrize("driver,quantised", [("stream", False),
                                              ("serve", True)])
def test_tiny_run_is_correct(tmp_path, driver, quantised):
    out = _run(tmp_path, driver, quantised)
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"audio_s_per_s", "first_chunk_ms_p95",
                                   "chunk_gap_ms_p95", "setup_s"}
    assert out["device"]["memory_peak_bytes"] is None
    assert out["device"]["platform"] == "cpu"


def test_traced_line_without_a_card_has_no_device_metric(tmp_path):
    """A traced run off the card reads no device trace: the readers of
    device metrics find nothing and leave them out; the spans remain."""
    out = _run(tmp_path, "serve", True, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    device = {m["name"] for m in harness.load_json(harness.BENCH_JSON)[
        "per_layer"] if m["source"] == "device_trace"}
    assert out["metrics"] and not set(out["metrics"]) & device


def _fault_stale_step(monkeypatch):
    """A talker step that returns its state unchanged."""
    from qwen3_tts_tpu_torch.tts import generate as g
    real = g._frame_body

    def stale(models, tcfg, pcfg, top_k, state, *a, **k):
        new, codes, active = real(models, tcfg, pcfg, top_k, state, *a, **k)
        return dict(new, hidden=state["hidden"],
                    logits=state["logits"]), codes, active
    monkeypatch.setattr(g, "_frame_body", stale)


def _fault_code(monkeypatch):
    """A predictor code altered where it is produced."""
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    real = fp.frame_codes_fused

    def altered(*a):
        codes = real(*a).clone()
        codes[:, 7] = (codes[:, 7] + 1) % 2048
        return codes
    monkeypatch.setattr(fp, "frame_codes_fused", altered)


def _fault_code0(monkeypatch):
    """A sampled code_0 altered where it is sampled: the least likely
    token of the slice instead of the draw."""
    from qwen3_tts_tpu_torch.core import sampling
    real = sampling.sample

    def altered(logits, generator, temperature, top_k, top_p):
        real(logits, generator, temperature, top_k, top_p)
        return torch.argmin(logits, dim=-1).to(torch.int32)
    monkeypatch.setattr(sampling, "sample", altered)


def _fault_wave(monkeypatch):
    """The waveform altered where the vocoder produces it."""
    from qwen3_tts_tpu_torch.models import vocoder
    real = vocoder.decode

    def altered(*a, **k):
        wav, valid, state = real(*a, **k)
        return wav * 1.01, valid, state
    monkeypatch.setattr(vocoder, "decode", altered)


def _fault_half_batch(monkeypatch):
    """Half of the batch left out: the second half of the rows get the
    first half's codes."""
    from qwen3_tts_tpu_torch.ops import fused_predictor as fp
    real = fp.frame_codes_fused

    def half(params, cfg, ptab, rows, h1024, code_0):
        codes = real(params, cfg, ptab, rows, h1024, code_0).clone()
        n = codes.shape[0] // 2
        if n:
            codes[n: 2 * n] = codes[:n]
        return codes
    monkeypatch.setattr(fp, "frame_codes_fused", half)


FAULTS = [("stream", False, _fault_stale_step), ("stream", False, _fault_code),
          ("stream", False, _fault_code0), ("stream", False, _fault_wave),
          ("serve", True, _fault_stale_step), ("serve", True, _fault_code),
          ("serve", True, _fault_wave), ("serve", True, _fault_half_batch)]


@pytest.mark.parametrize("driver,quantised,fault", FAULTS,
                         ids=[f"{d}-{f.__name__[7:]}" for d, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, driver,
                                          quantised, fault):
    fault(monkeypatch)
    out = _run(tmp_path, driver, quantised)
    assert not out["correct"], out["checks"]


def test_percentile_is_a_sample_value():
    v = list(np.arange(1, 101, dtype=float))
    assert harness.percentile(v, 95) == 95.0
    assert harness.percentile([3.0], 95) == 3.0
