"""On the card (marked `cuda`; skipped elsewhere): each cell at its own
size on three seeds, short windows at the cell's load, in one process.
The program's readings stay within the check's limits, and the control
(the reference one precision below the configuration) fails one of them.

    python -m pytest --noconftest -m cuda tts_bench/tests -q
"""

from __future__ import annotations

import pytest

from tts_bench import calibrate, harness

BENCH = harness.load_json(harness.BENCH_JSON)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at full width there")
    harness.prepare_process()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits_and_control_outside(card, cell):
    c = harness.Cell(harness.cell_entry(BENCH, cell))
    limits = c.workload["limits"]
    for seed, prog, ctrl, n, failed in calibrate.readings(
            c, [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103], 6.0, card,
            log=lambda line: None):
        assert n > 0 and failed == 0
        assert all(prog[k] <= limits[k] for k in limits), (seed, prog)
        assert any(ctrl[k] > limits[k] for k in limits), (seed, ctrl)
