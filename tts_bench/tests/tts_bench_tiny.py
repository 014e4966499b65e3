"""Tiny cells for the benchmark's CPU tests: the full-width configuration
files with toy widths, written with a traffic and a workload file into a
temporary folder that the harness searches before its own."""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tts_bench import harness  # noqa: E402

LIMITS = {"gap_max": 1e-3, "gap_mean": 1e-4, "wav_err": 1e-4}


def tiny_config(quantised: bool) -> dict:
    """f32 toy widths; the quantised one wide enough for int4 groups."""
    c = copy.deepcopy(harness.find(
        "configs", "qwen3-tts-1.7b-int4-int8" if quantised
        else "qwen3-tts-1.7b-bf16"))
    if quantised:
        c["talker"].update(hidden=256, n_layers=2, n_q_heads=2,
                           n_kv_heads=2, head_dim=128, ffn_dim=256,
                           max_seq=512, dtype="float32")
        c["predictor"].update(hidden=256, n_layers=2, n_q_heads=2,
                              n_kv_heads=2, head_dim=128, ffn_dim=256,
                              dtype="float32")
    else:
        c["talker"].update(hidden=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
                           head_dim=16, ffn_dim=128, max_seq=512,
                           mrope_sections=[4, 2, 2, 0], dtype="float32")
        c["predictor"].update(hidden=32, n_layers=2, n_q_heads=2,
                              n_kv_heads=2, head_dim=16, ffn_dim=64,
                              mrope_sections=[8, 0, 0, 0], dtype="float32")
    c["vocoder"].update(embed_dim=16, hidden=32, n_layers=2, n_heads=2,
                        head_dim=16, ffn_dim=64, max_frames=64)
    c["assets"].update(dim=c["talker"]["hidden"],
                       proj_dim=c["predictor"]["hidden"])
    c["name"] = "tiny-int4-int8" if quantised else "tiny-f32"
    return c


def tiny_traffic(driver: str) -> dict:
    if driver == "stream":
        t = copy.deepcopy(harness.find("traffic", "stream.c1"))
        t.update(frames=[5, 9], warm=[[30, 5], [60, 6]])
    else:
        t = copy.deepcopy(harness.find("traffic", "serve.c8"))
        t.update(clients=3, max_streams=3, kv_window=256, frames=[8, 8],
                 ramp_ticks=2, warm=[[30, 8]])
    return t


def write_cell(root: str, driver: str, quantised: bool,
               limits=LIMITS) -> dict:
    """Write a tiny cell's files under `root`; returns a BENCHMARK.json-
    shaped dict holding it (the real file's metrics)."""
    name = f"tiny.{driver}"
    files = {"configs": tiny_config(quantised),
             "traffic": tiny_traffic(driver),
             "workloads": {"name": name, "check_requests": 4,
                           "limits": dict(limits), "why": "a CPU test"}}
    keys = {"configs": files["configs"]["name"], "traffic": name,
            "workloads": name}
    for kind, body in files.items():
        os.makedirs(os.path.join(root, kind), exist_ok=True)
        with open(os.path.join(root, kind, keys[kind] + ".json"), "w") as f:
            json.dump(body, f)
    bench = copy.deepcopy(harness.load_json(harness.BENCH_JSON))
    bench["workloads"] = [{"name": name, "config": keys["configs"],
                           "traffic": name, "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench
