"""The port's multi-host tools over gloo on the CPU, as subprocesses:
`python -m qwen3_tts_tpu_torch.tools.multihost_smoke` (two hosts of four
ranks, one global mesh, one sharded generation step) and
`python -m qwen3_tts_tpu_torch.tools.multihost_scaling` (1 vs 2 hosts).

The scaling harness's efficiency gate is marked `slow`, as the JAX
package marks its own (`tests/test_multihost.py`): a timing gate is noise
under a parallel test run. Its report's shape is checked in tier-1.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _run(module, *args, timeout=TIMEOUT_S):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"qwen3_tts_tpu_torch.tools.{module}", *args,
         "--backend", "gloo", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def test_two_host_gloo_smoke():
    rc, out = _run("multihost_smoke", "--timeout", "100")
    assert rc == 0, out[-4000:]
    assert out.count("world size: 8") == 8, out[-4000:]
    assert out.count("MULTIHOST SMOKE OK") == 8, out[-4000:]
    assert "multihost smoke: PASS" in out


def test_smoke_fails_when_a_rank_fails():
    """Three ranks a host cannot split 8 q heads: every rank raises, the
    launcher reports FAIL and exits nonzero (no rank hangs)."""
    rc, out = _run("multihost_smoke", "--hosts", "1", "--ranks-per-host",
                   "3", "--timeout", "100")
    assert rc == 1, out[-4000:]
    assert "multihost smoke: FAIL" in out
    assert "MULTIHOST SMOKE OK" not in out


@pytest.mark.parametrize("mode", ["local", "global"])
def test_scaling_harness_report(mode):
    rc, out = _run("multihost_scaling", "--steps", "2", "--reps", "1",
                   "--mode", mode, "--timeout", "100")
    assert rc == 0, out[-4000:]
    report = json.loads(out.strip().splitlines()[-1])
    assert set(report) == {
        "throughput_1p_audio_s_per_s", "throughput_2p_audio_s_per_s",
        "scaling_efficiency", "median_s_1p", "median_s_2p", "mode",
        "per_host_cores", "note"}
    assert report["mode"] == mode
    assert report["throughput_1p_audio_s_per_s"] > 0
    assert report["throughput_2p_audio_s_per_s"] > 0


@pytest.mark.slow
def test_scaling_harness_efficiency():
    """Host-local DP: each host runs its own generation on its own pinned
    cores, no collective across hosts in the decode loop, so 2 hosts'
    aggregate throughput must track twice one host's. Gated at 0.6, as
    the JAX package's harness test."""
    rc, out = _run("multihost_scaling", "--steps", "8", "--reps", "3",
                   "--timeout", "300", timeout=600)
    assert rc == 0, out[-4000:]
    report = json.loads(out.strip().splitlines()[-1])
    assert report["mode"] == "local"
    assert report["scaling_efficiency"] > 0.6, report
