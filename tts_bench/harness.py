"""The benchmark's core: finding cells, configurations, traffic, drivers and
metrics by name, running one cell, reading the trace, and the result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its files, each found
by the name the entry gives:

  configs/<config>.json     the model configuration (widths, weight kinds)
  traffic/<traffic>.json    the traffic mix: the driver and its parameters
  workloads/<cell>.json     the check's sample and limits
  drivers/<driver>.py       the entry the window drives (`prepare`,
                            `window`, `close`)
  end_to_end/<metric>.py    an end-to-end metric's reader
  metrics/<metric>.py       a per-layer metric's reader

A reader is `read(rec) -> float | None` over the run's `Record`; None means
it found nothing to read, and the metric is left out of the line.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH_JSON = os.path.join(ROOT, "BENCHMARK.json")
CACHE_DIR = os.path.join(HERE, "_cache")
# top-level module names that may not be loaded in the process that
# prints a result: the JAX stack and the JAX package the port mirrors
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")
# the kernel of `torch.cuda._sleep`, launched once on an idle device to mark
# the window's start in the device's clock
WINDOW_MARK = "spin_kernel"


# ---------------------------------------------------------------- finding
def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find_file(kind: str, name: str, roots=(HERE,), ext: str = ".json"):
    """The file `<root>/<kind>/<name><ext>` of the first root that has it."""
    for root in roots:
        path = os.path.join(root, kind, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {list(roots)}")


def find(kind: str, name: str, roots=(HERE,)):
    """A JSON file's contents (configs, traffic, workloads) or a Python
    module (drivers, metrics, end_to_end), by name."""
    if kind in ("configs", "traffic", "workloads"):
        return load_json(find_file(kind, name, roots))
    path = find_file(kind, name, roots, ".py")
    spec = importlib.util.spec_from_file_location(
        f"tts_bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, group: str) -> List[dict]:
    """The metrics of `group` ("end_to_end", "per_layer") that `cell`
    reports: those with no `workloads` key, and those that list it."""
    return [m for m in bench[group]
            if cell in m.get("workloads", [cell])]


def prepare_process() -> None:
    """Before torch is imported: the caches the program builds at fixed
    directories inside the checkout (Triton's kernels, the CUDA driver's
    JIT cache; the nvcc build already lives in the checkout,
    `qwen3_tts_tpu_torch/kernels/_build`), and one host thread for torch's
    CPU ops, so that the process loads the host's shared cores little."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE_DIR, "nv")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ----------------------------------------------------------------- record
class Record:
    """What a run leaves for the readers: the requests, the harness's host
    spans (perf_counter seconds), the window, and in a traced run the
    device's operations (seconds from the window's start)."""

    def __init__(self, config: dict, traffic: dict, clock=time.perf_counter):
        self.config = config
        self.traffic = traffic
        self.clock = clock
        self.requests = []
        self.spans: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = float("nan")
        self.setup_s = float("nan")
        self.device_ops: Optional[List[Tuple[str, float, float]]] = None
        self.window_s = float("nan")

    @contextlib.contextmanager
    def span(self, name: str):
        t = self.clock()
        try:
            yield
        finally:
            self.spans.append((name, t, self.clock()))

    def span_times(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.spans if n == name]

    @property
    def frames(self) -> int:
        """Frames served in the window (whole frames of delivered audio)."""
        return sum(r.samples // 2000 for r in self.requests)

    def kernels(self, pattern=None):
        """Device kernels (memory copies and sets left out), optionally
        those whose name matches `pattern` (a compiled regex)."""
        if self.device_ops is None:
            return []
        out = [op for op in self.device_ops
               if not op[0].startswith(("Memcpy", "Memset"))]
        if pattern is not None:
            out = [op for op in out if pattern.search(op[0])]
        return out


def served_work(rec: Record) -> dict:
    """The work the window's requests asked of the model: their prompts'
    rows, their served frames, the live talker cache slots summed over
    those frames' steps (prompt rows plus earlier frames), and the frames
    the vocoder's attention covered."""
    prompts, frames, live, voc = [], 0, 0, 0
    for r in rec.requests:
        if r.error is None or r.pieces:
            prompts.append(r.prompt_rows)
        n = r.samples // 2000
        frames += n
        live += n * r.prompt_rows + n * (n - 1) // 2
        voc += n * (n + 1) // 2
    return {"prompts": prompts, "frames": frames, "live": live,
            "voc_attended": voc}


def percentile(values, p: float) -> float:
    """Nearest-rank percentile: a value of the sample."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


# ------------------------------------------------------------------ trace
def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def device_ops(prof) -> List[Tuple[str, float, float]]:
    """Every operation the device ran inside the window, as (name, start,
    end) in seconds from the window's start: the start of the marker
    kernel (WINDOW_MARK) launched just before the window's host clock
    starts."""
    from torch.autograd import DeviceType

    mark = None
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        start = _ns(e, "start")
        if mark is None and WINDOW_MARK in name:
            mark = start
            continue
        ops.append((name, start, start + _ns(e, "duration")))
    if mark is None:
        raise RuntimeError("the trace holds no window marker kernel")
    return [(n, (a - mark) * 1e-9, (b - mark) * 1e-9) for n, a, b in ops
            if b > mark]


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """Merged intervals clipped to [lo, hi]."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(rec: Record) -> float:
    if not rec.device_ops:
        return 0.0
    return sum(b - a for a, b in union(
        [(a, b) for _, a, b in rec.device_ops], 0.0, rec.window_s))


def breakdown(rec: Record) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by the harness span the host was in (innermost; "harness"
    outside every span), ten of each, in seconds; empty lists without a
    device trace."""
    if rec.device_ops is None:
        return {"device_ops": [], "idle_gaps": []}
    by_name: Dict[str, float] = {}
    for n, a, b in rec.device_ops:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (b - a)
    busy = union([(a, b) for _, a, b in rec.device_ops], 0.0, rec.window_s)
    gaps, t = [], 0.0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if t < rec.window_s:
        gaps.append((t, rec.window_s))
    spans = sorted(((a - rec.t0, b - rec.t0, n) for n, a, b in rec.spans),
                   key=lambda s: s[0])
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [s for s in spans if s[0] <= mid < s[1]]
        name = max(open_, key=lambda s: s[0])[2] if open_ else "harness"
        idle[name] = idle.get(name, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]

    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


# ------------------------------------------------------------------- cell
class Cell:
    """A cell's files, found by name from its BENCHMARK.json entry."""

    def __init__(self, entry: dict, roots=(HERE,)):
        self.name = entry["name"]
        self.chips = entry.get("chips", 1)
        self.config = find("configs", entry["config"], roots)
        self.traffic = find("traffic", entry["traffic"], roots)
        self.workload = find("workloads", self.name, roots)
        self.driver = find("drivers", self.traffic["driver"], roots)
        self.roots = roots


class Context:
    """What a driver gets: the engine, the traffic, the record, the
    request stream, and whether admissions are synchronised (the traced
    run's admission spans)."""

    def __init__(self, cell: Cell, engine, rec: Record, requests,
                 seconds: float, traced: bool, device):
        self.cell = cell
        self.engine = engine
        self.rec = rec
        self.requests = requests
        self.seconds = seconds
        self.traced = traced
        self.device = device
        self.state = {}

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def drive(cell: Cell, seed: int, seconds: float, device, trace: bool,
          t_start: float, master_fn):
    """Set up and run one window of `cell`: weights from the seed, the
    engine, the driver's warm-up, then `seconds` of traffic (under the
    profiler with `trace`). Returns (record, memory peak in bytes, or
    None off the card). The program's state is freed on return."""
    import torch

    from . import generate, system

    rec = Record(cell.config, cell.traffic)
    engine = system.build(cell.config, master_fn(), device)
    ctx = Context(cell, engine, rec, generate.requests(cell.traffic, seed),
                  seconds, trace, device)
    try:
        cell.driver.prepare(ctx)
        ctx.sync()
        # what set-up made stays: the collector's passes in the window
        # then scan only what the window makes
        gc.collect()
        gc.freeze()

        def window():
            rec.t0 = rec.clock()
            rec.setup_s = rec.t0 - t_start
            cell.driver.window(ctx)
            ctx.sync()
            rec.t1 = rec.clock()
            rec.window_s = rec.t1 - rec.t0

        if trace and device.type == "cuda":
            # the device's operations only: a host op trace of the whole
            # window costs minutes to take and to read
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                window()
            t = time.perf_counter()
            rec.device_ops = device_ops(prof)
            del prof
            print(f"tts_bench: the trace's {len(rec.device_ops)} device "
                  f"operations: profiler stopped in "
                  f"{t - rec.t1:.3f} s, read in "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        else:
            window()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
    finally:
        gc.unfreeze()
        cell.driver.close(ctx)
        del ctx, engine
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rec, peak


def read_metrics(bench: dict, cell: Cell, rec: Record, trace: bool) -> dict:
    group, kind = (("per_layer", "metrics") if trace
                   else ("end_to_end", "end_to_end"))
    out = {}
    for m in metrics_of(bench, cell.name, group):
        value = find(kind, m["name"], cell.roots).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
