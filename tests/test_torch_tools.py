"""The port's `tools/import_speakers.py` and `utils/profiling.py` against
the JAX package's `tools/import_speakers.py` and `utils/profiling.py`.

import_speakers: the vendored `speakers/` (plus a voice without an
embedding and a file that is not JSON, which both tools skip) imported by
each tool into its own directory: the same files, byte for byte, and the
same report. GenerationMetrics: the same stage timings (the modules'
`time.perf_counter` patched to one scripted clock) give the same report.
profiler_trace: a Chrome trace written on the CPU, nothing for None.
"""

import filecmp
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from qwen3_tts_tpu.utils import profiling as jprofiling
from qwen3_tts_tpu_torch.tools import import_speakers
from qwen3_tts_tpu_torch.utils import profiling

REPO = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(REPO, "tools")


@pytest.fixture()
def jax_import_speakers():
    sys.path.insert(0, TOOLS)
    try:
        import import_speakers as tool
    finally:
        sys.path.remove(TOOLS)
    return tool


def test_import_speakers_byte_identical_to_jax_tool(tmp_path, capsys,
                                                    jax_import_speakers):
    src = tmp_path / "src"
    shutil.copytree(os.path.join(REPO, "speakers"), src)
    (src / "empty.json").write_text(json.dumps(
        {"name": "empty", "speaker_embedding": []}))
    (src / "broken.json").write_text("{not json")
    (src / "notes.txt").write_text("not a voice")

    assert jax_import_speakers.main(["--from", str(src), "--to",
                                     str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr()
    assert import_speakers.main(["--from", str(src), "--to",
                                 str(tmp_path / "port")]) == 0
    tout = capsys.readouterr()

    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(os.path.join(REPO, "speakers")))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert sorted(match) == names and not mismatch and not errors
    _, mismatch, _ = filecmp.cmpfiles(
        tmp_path / "port", os.path.join(REPO, "speakers"), names,
        shallow=False)
    assert not mismatch
    assert tout.out.replace(str(tmp_path / "port"), "DST") \
        == jout.out.replace(str(tmp_path / "jax"), "DST")
    assert "9 voices" in tout.out
    assert tout.err.splitlines()[0].startswith("skip broken.json")
    assert "skip empty.json: no speaker embedding" in tout.err


def _drive(mod, monkeypatch):
    """One scripted generation through `mod.GenerationMetrics`: the clock
    advances by fixed steps, so both modules see the same times."""
    ticks = iter([0.0, 0.5, 0.75, 1.0, 1.125, 1.25, 1.5, 2.0, 2.25, 3.0,
                  3.0625, 4.0])
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    m = mod.GenerationMetrics()
    m.begin()                                   # 0.0
    with m.stage("prefill"):                    # 0.5 .. 0.75
        pass
    for _ in range(2):
        with m.stage("frame"):                  # 1.0 .. 1.125, 1.25 .. 1.5
            pass
    m.chunk_emitted(8000)                       # first chunk at 2.0
    with m.stage("vocode"):                     # 2.25 .. 3.0
        pass
    m.chunk_emitted(4000)                       # later chunks: no clock read
    with m.stage("frame"):                      # 3.0625 .. 4.0
        pass
    lines = []
    m.log(lines.append)
    return m, lines


def test_generation_metrics_report_matches_jax(monkeypatch):
    jm, jlines = _drive(jprofiling, monkeypatch)
    tm, tlines = _drive(profiling, monkeypatch)
    assert tm.report() == jm.report()
    assert tlines == jlines
    rep = tm.report()
    assert rep["first_chunk_ms"] == 2000.0
    assert rep["stages"]["frame"]["count"] == 3
    assert tm.audio_seconds == jm.audio_seconds == 0.5
    assert tm.rtf == jm.rtf
    s = tm.stages["frame"]
    assert (s.min_s, s.max_s) == (0.125, 0.9375)


def test_generation_metrics_empty_matches_jax():
    assert profiling.GenerationMetrics().report() \
        == jprofiling.GenerationMetrics().report()
    assert profiling.GenerationMetrics().rtf == float("inf")
    assert profiling.StageStats().mean_s == 0.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.profiler_trace(str(log_dir)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_profiler_trace_is_a_no_op_without_a_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with profiling.profiler_trace(log_dir):
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool,argv,rc", [
    ("validate_release", ["--model-dir", "{tmp}", "--device", "cpu"], 1),
    ("import_speakers", ["--from", "{speakers}", "--to", "{tmp}"], 0)])
def test_tools_run_without_jax(tool, argv, rc, tmp_path):
    """Each tool run as `python -m` in a process that then lists what it
    imported: neither `jax` nor the JAX package's modules nor the JAX
    package's tools (an empty model directory fails the manifest check)."""
    argv = [a.format(tmp=tmp_path, speakers=os.path.join(REPO, "speakers"))
            for a in argv]
    code = ("import runpy, sys\n"
            f"sys.argv = [{tool!r}] + {argv!r}\n"
            "try:\n"
            f"    runpy.run_module('qwen3_tts_tpu_torch.tools.{tool}', "
            "run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            f"    assert e.code == {rc}, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'qwen3_tts_tpu.')) or m in "
            f"('qwen3_tts_tpu', {tool!r})]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
