"""BENCHMARK.json against the contract it is written to, and the harness
finding every cell's files by name, a throwaway cell's among them."""

from __future__ import annotations

import json
import os
import re

import pytest

import tts_bench_tiny as tiny
from tts_bench import harness

BENCH = harness.load_json(harness.BENCH_JSON)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "tts_bench/run.py"]
    assert BENCH["paths"] == ["tts_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metrics_of(BENCH, cell, "per_layer")
    assert per
    for m in per:      # each moves an end-to-end metric the cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(harness.cell_entry(BENCH, cell))
    assert c.config["name"] == harness.cell_entry(BENCH, cell)["config"]
    assert c.workload["name"] == cell
    assert set(c.workload["limits"]) <= {"gap_max", "gap_mean", "wav_err"}
    assert "wav_err" in c.workload["limits"]
    for fn in ("prepare", "window", "close"):
        assert callable(getattr(c.driver, fn))


def test_configs_are_their_files():
    for cfg in BENCH["configs"]:
        assert cfg["file"] == f"tts_bench/configs/{cfg['name']}.json"
        body = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
        assert body["name"] == cfg["name"]
        assert body["source"] == cfg["source"]
        assert body["reduced"] == cfg["reduced"] == []
        assert body["talker"]["hidden"] == 2048
        assert body["talker"]["n_layers"] == 28


@pytest.mark.parametrize("group,kind", [("end_to_end", "end_to_end"),
                                        ("per_layer", "metrics")])
def test_metric_readers_found_by_name(group, kind):
    for m in BENCH[group]:
        mod = harness.find(kind, m["name"])
        assert mod.UNIT == m["unit"]
        if kind == "metrics":
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert callable(mod.read)


def test_a_throwaway_cell_is_added_with_new_files_only(tmp_path):
    """A cell whose configuration, traffic and workload live in another
    folder is found beside the benchmark's own driver and metrics."""
    bench = tiny.write_cell(str(tmp_path), "stream", False)
    entry = harness.cell_entry(bench, "tiny.stream")
    cell = harness.Cell(entry, roots=(str(tmp_path), harness.HERE))
    assert cell.config["name"] == "tiny-f32"
    assert cell.traffic["driver"] == "stream"
    assert harness.find("metrics", "model_mfu",
                        (str(tmp_path), harness.HERE)).UNIT == "%"
    with pytest.raises(FileNotFoundError):
        harness.Cell(entry)          # not among the benchmark's own files
