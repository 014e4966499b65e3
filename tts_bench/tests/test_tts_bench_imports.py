"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the port;
the run refuses without a card and without the program."""

from __future__ import annotations

import ast
import glob
import os
import shutil
import subprocess
import sys

from tts_bench import harness

PY = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                      recursive=True))


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in PY:
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        assert set(_imports(path)) <= {"__future__", "contextlib", "math",
                                       "typing", "torch"}, path


def test_forbidden_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu.core", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert harness.forbidden_modules() == ["flax", "qwen3_tts_tpu"]


def _run(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "tts_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_tiny_run_loads_no_jax():
    code = (
        "import sys, time, torch, tempfile\n"
        "sys.path.insert(0, 'tts_bench/tests')\n"
        "import tts_bench_tiny as tiny\n"
        "from tts_bench import harness, run\n"
        "d = tempfile.mkdtemp()\n"
        "b = tiny.write_cell(d, 'stream', False)\n"
        "run.run('tiny.stream', 3, 0.5, False, time.perf_counter(),\n"
        "        roots=(d, harness.HERE), bench=b,\n"
        "        device=torch.device('cpu'))\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert "FORBIDDEN []" in p.stdout, p.stderr[-2000:]


def test_without_a_card_the_run_exits_and_prints_no_result():
    p = _run(harness.ROOT, "--workload", "bf16.stream.c1", "--seed",
             str(2 ** 31 + 5), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program_the_run_exits_and_prints_no_result(tmp_path):
    shutil.copy(harness.BENCH_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "tts_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = _run(str(tmp_path), "--workload", "bf16.stream.c1", "--seed", "1",
             "--seconds", "1", "--trace", "1")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
