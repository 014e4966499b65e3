#!/usr/bin/env python3
"""Readings that the check's limits are set from, on the card at a cell's
own size: for each seed, one short window of the cell's traffic, then the
check's numbers for what the program served and for the control (the
reference one precision below the configuration, `check.measure(...,
control=True)`), all in one process.

    python3 tts_bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 101,102,...

Prints one JSON line a seed and, last, the program's largest and the
control's smallest reading of each number.
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


def readings(cell, seeds, seconds, device, log=print):
    """[(seed, program numbers, control numbers, requests, failed)]."""
    import torch

    from tts_bench import check, harness, weights

    out = []
    for seed in seeds:
        rec, _ = harness.drive(
            cell, seed, seconds, device, False, time.perf_counter(),
            lambda: weights.make(cell.config, seed, device))
        failed = sum(1 for r in rec.requests if r.error or not r.pieces)
        reqs = check.sample(rec.requests, cell.workload["check_requests"],
                            seed)
        master = weights.make(cell.config, seed, device)
        t = time.perf_counter()
        prog = check.measure(cell.config, cell.traffic, master, reqs,
                             device)
        t_prog = time.perf_counter() - t
        ctrl = check.measure(cell.config, cell.traffic, master, reqs,
                             device, control=True)
        del master
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.append((seed, prog, ctrl, len(rec.requests), failed))
        log(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                        "requests": len(rec.requests), "failed": failed,
                        "frames": rec.frames, "check_s": t_prog,
                        "tokens_checked": sum(16 * len(r.served_codes())
                                              for r in reqs)}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    from tts_bench import harness
    harness.prepare_process()
    import torch

    from tts_bench import harness

    bench = harness.load_json(harness.BENCH_JSON)
    cell = harness.Cell(harness.cell_entry(bench, a.workload))
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    res = readings(cell, [int(s) for s in a.seeds.split(",")], a.seconds,
                   torch.device("cuda", 0), lambda s: print(s, flush=True))
    keys = res[0][1].keys()
    print(json.dumps({
        "workload": a.workload,
        "program_max": {k: max(r[1][k] for r in res) for k in keys},
        "control_min": {k: min(r[2][k] for r in res) for k in keys},
        "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
