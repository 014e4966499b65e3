"""Multi-host weak-scaling harness: audio-s/s at 1 vs 2 hosts. The port's
counterpart of `tools/multihost_scaling.py`.

    python -m qwen3_tts_tpu_torch.tools.multihost_scaling \
        [--steps 8] [--reps 3] [--mode local|global] [--ranks-per-host N] \
        [--backend nccl] [--device cuda]

One process a rank; a host is `--ranks-per-host` consecutive ranks. The
same run at 1 host and at 2 hosts, with the per-host batch and the
per-host resources held constant (weak scaling):

  * --mode local (default): DP across hosts is host-local. Each host
    builds a mesh over its own ranks only (`parallel/mesh.make_local_mesh`,
    TP over the host's ranks) and runs its own generation over its own
    utterances: the per-frame loop makes no collective across hosts;
    hosts meet only at the start barrier and the result files.
  * --mode global: one global mesh, the data axis across hosts, every
    rank on one global batch (`parallel/run.sharded_generate_step`), kept
    for TP across hosts and as the counter-measurement.

On the CPU (`--device cpu`, gloo) each host-analog's ranks are pinned to
the host's own share of the allowed cores (half of them), with one core a
rank where the share allows: unpinned, the 1-host run would own the whole
machine while the 2-host run fights for it, and the harness would measure
core contention. Efficiency compares the 2-host aggregate throughput with
twice the 1-host one, the 2-host time being the slowest host's median.
It prints one JSON line with the JAX harness's keys:

    {"throughput_1p_audio_s_per_s": ..., "throughput_2p_audio_s_per_s":
     ..., "scaling_efficiency": ..., "median_s_1p": ..., "median_s_2p":
     ..., "mode": ..., "per_host_cores": ..., "note": ...}

`--rank R ...` is a rank's entry (the launcher starts these).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .multihost_smoke import launch, rank_device

PER_HOST_BATCH = 4
FRAME_S = 1.0 / 12.0


def _allowed_cpus():
    """This process's cpuset (cgroup / affinity aware)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:                      # non-Linux
        return list(range(os.cpu_count() or 2))


def per_host_cores() -> int:
    """Cores per host-analog: half of the allowed cores, so each of two
    simulated hosts owns its own."""
    return max(1, len(_allowed_cpus()) // 2)


def default_ranks_per_host(device: str = "cpu") -> int:
    """One rank a core of a host's share, as a power of two up to 4 (the
    test geometry's heads divide a model axis of 1, 2 or 4); on cards at
    most half of them, so that the 2-host run has a card a rank (NCCL
    refuses two ranks on one card)."""
    cap = min(4, per_host_cores())
    if device == "cuda":
        import torch
        cap = min(cap, max(1, torch.cuda.device_count() // 2))
    n = 1
    while n * 2 <= cap:
        n *= 2
    return n


def worker(rank: int, world: int, port: int, rph: int, steps: int,
           reps: int, out_path: str, mode: str, backend: str,
           device: str) -> int:
    host = rank // rph
    if device == "cpu":
        cpus = _allowed_cpus()
        n = per_host_cores()
        mine = cpus[host * n: (host + 1) * n] or cpus
        try:
            os.sched_setaffinity(0, set(mine))
        except (AttributeError, OSError):
            pass                                # unpinned analog still runs
    import torch
    import torch.distributed as dist

    from ..parallel import mesh as mesh_lib
    from ..parallel import run as prun

    rank_device(device)
    if device == "cpu":
        torch.set_num_threads(max(1, per_host_cores() // rph))
    hosts = world // rph
    if world > 1:
        mesh_lib.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                      backend=backend)
    cfg = prun.parallel_test_config(max_steps=steps)
    if mode == "local":
        # host-local DP: this host's ranks, this host's utterances
        mesh = mesh_lib.make_local_mesh(model=rph, local_world_size=rph,
                                        device_type=device)
        batch = PER_HOST_BATCH
    else:
        # one global program: the data axis across hosts
        mesh = mesh_lib.make_mesh(hosts, rph, device_type=device)
        batch = PER_HOST_BATCH * hosts
    models, voc = prun.build_sharded_models(mesh, cfg, seed=0)
    # local: each host draws its own utterances; global: one batch
    seed_off = 1000 * host if mode == "local" else 0

    def step(seed):
        wav, n_frames = prun.sharded_generate_step(
            mesh, cfg, models, voc, batch=batch, prompt_len=16,
            max_steps=steps, seed=seed + seed_off)
        if device == "cuda":
            torch.cuda.synchronize()
        return n_frames

    step(0)                                     # warm
    if world > 1:
        dist.barrier()                # the only touch before the results
    times, frames = [], 0
    t_all = time.perf_counter()
    for r in range(reps):
        t0 = time.perf_counter()
        n_frames = step(r + 1)
        times.append(time.perf_counter() - t0)
        frames += int(n_frames.sum())
    elapsed = time.perf_counter() - t_all
    med = sorted(times)[len(times) // 2]
    audio_s = (frames / reps) * FRAME_S
    if rank % rph == 0:                         # the host's leader reports
        with open(f"{out_path}.{host}", "w") as f:
            json.dump({"host": host, "hosts": hosts, "median_s": med,
                       "elapsed_s": elapsed, "audio_s_per_call": audio_s,
                       "throughput": audio_s / med}, f)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    return 0


def run_config(hosts: int, rph: int, steps: int, reps: int, mode: str,
               backend: str, device: str, timeout_s: float) -> dict:
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        rcs, outs = launch(
            "qwen3_tts_tpu_torch.tools.multihost_scaling", hosts * rph, rph,
            ["--ranks-per-host", str(rph), "--steps", str(steps), "--reps",
             str(reps), "--out", out, "--mode", mode, "--backend", backend,
             "--device", device], timeout_s)
        if rcs != [0] * (hosts * rph):
            sys.stderr.write("".join(outs)[-4000:])
            raise RuntimeError(f"{hosts}-host run failed (exit codes {rcs})")
        res = []
        for h in range(hosts):
            with open(f"{out}.{h}") as f:
                res.append(json.load(f))
            os.remove(f"{out}.{h}")
    finally:
        os.remove(out)
    # local: each host ran its own batch -> sum; global: every host
    # reports the same global batch -> take one. Over the SLOWEST host's
    # median call (the true wall past the barrier)
    audio = sum(r["audio_s_per_call"] for r in res) if mode == "local" \
        else res[0]["audio_s_per_call"]
    t = max(r["median_s"] for r in res)
    return {"hosts": hosts, "median_s": t, "audio_s_per_call": audio,
            "throughput": audio / t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=("local", "global"), default="local")
    ap.add_argument("--ranks-per-host", type=int, default=None)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rph = a.ranks_per_host or default_ranks_per_host(a.device)
    if a.rank is not None:
        return worker(a.rank, a.world, a.port, rph, a.steps, a.reps, a.out,
                      a.mode, a.backend, a.device)

    r1 = run_config(1, rph, a.steps, a.reps, a.mode, a.backend, a.device,
                    a.timeout)
    r2 = run_config(2, rph, a.steps, a.reps, a.mode, a.backend, a.device,
                    a.timeout)
    # weak scaling: per-host work is constant, so efficiency
    #   = throughput_2p / (2 * throughput_1p)
    eff = r2["throughput"] / (2.0 * r1["throughput"])
    print(json.dumps({
        "throughput_1p_audio_s_per_s": round(r1["throughput"], 3),
        "throughput_2p_audio_s_per_s": round(r2["throughput"], 3),
        "scaling_efficiency": round(eff, 3),
        "median_s_1p": round(r1["median_s"], 3),
        "median_s_2p": round(r2["median_s"], 3),
        "mode": a.mode,
        "per_host_cores": per_host_cores(),
        "note": (f"{rph} ranks a host, {a.backend} on {a.device}; "
                 + ("host-local DP, no collective across hosts in the "
                    "decode loop" if a.mode == "local" else
                    "global mesh: the data axis across hosts")
                 + ("; each host-analog pinned to its own half of the "
                    "cores" if a.device == "cpu" else "")),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
