#!/usr/bin/env python3
"""Run one cell of the benchmark of `qwen3_tts_tpu_torch` on one H100.

    python3 tts_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The run makes the cell's weights on the card
from the seed, builds the engine, warms the shapes its traffic uses, drives
the traffic for `--seconds`, and then holds a sample of what the window
served against the plain float32 reference (`check.py`). It prints the
compared numbers and their limits as its last lines on standard error, and
one JSON object as its last line on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics from a `torch.profiler` trace of the
window), `device`, with `--trace 1` `breakdown`, and last `checks`.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; with the JAX stack or the JAX package loaded once the
window has closed, 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class NoCard(RuntimeError):
    pass


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        roots=(HERE,), bench=None, device=None) -> dict:
    """One run of cell `name`: the result line's object. `device` None
    looks for the card the cell asks for (and raises NoCard without it);
    the tests pass the CPU to drive the rest of a run there."""
    import torch

    from tts_bench import check, harness, weights

    bench = bench or harness.load_json(harness.BENCH_JSON)
    cell = harness.Cell(harness.cell_entry(bench, name), roots)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"cell {name} needs {cell.chips} CUDA card(s); "
                         f"torch sees {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    rec, peak = harness.drive(
        cell, seed, seconds, device, trace, t_start,
        lambda: weights.make(cell.config, seed, device))
    failed = sum(1 for r in rec.requests if r.error is not None
                 or not r.pieces)
    print(f"tts_bench: {name} seed {seed}: {len(rec.requests)} requests, "
          f"{failed} failed, {rec.frames} frames in {rec.window_s:.3f} s, "
          f"set-up {rec.setup_s:.3f} s, peak {peak} bytes", file=sys.stderr)
    for r in rec.requests:
        if r.error is not None:
            print(f"tts_bench: request {r.index} failed: {r.error}",
                  file=sys.stderr)
    t_check = time.perf_counter()
    reqs = check.sample(rec.requests, cell.workload["check_requests"], seed)
    master = weights.make(cell.config, seed, device)
    numbers = check.measure(cell.config, cell.traffic, master, reqs, device)
    del master
    print(f"tts_bench: the check of {len(reqs)} requests took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        kind = ("gpu", torch.cuda.get_device_name(device))
    else:
        kind = (device.type, device.type)
    correct, checks = check.verdict(numbers, cell.workload["limits"],
                                    failed, len(rec.requests))
    dev = {"platform": kind[0], "kind": kind[1], "count": cell.chips,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(rec.requests),
           "failed": failed,
           "metrics": harness.read_metrics(bench, cell, rec, trace),
           "device": dev}
    if trace:
        if rec.device_ops is not None:
            dev["busy_s"] = harness.busy_s(rec)
            dev["window_s"] = rec.window_s
        out["breakdown"] = harness.breakdown(rec)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from tts_bench import harness
    harness.prepare_process()
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace), T0)
    except NoCard as e:
        print(f"tts_bench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"tts_bench: the process loaded {bad} (the JAX stack or the "
              "JAX package); no result", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
