"""Multi-host smoke: one global (hosts, ranks a host) mesh, one sharded
generation step. The port's counterpart of `tools/multihost_smoke.py`.

    python -m qwen3_tts_tpu_torch.tools.multihost_smoke \
        [--hosts 2] [--ranks-per-host 4] [--backend nccl] [--device cuda]

One process a rank; a "host" is `--ranks-per-host` consecutive ranks
(LOCAL_RANK / LOCAL_WORLD_SIZE are set as torchrun sets them). The data
axis spans hosts, the model axis the ranks of a host: the CPU analog of a
multi-host deployment (gloo, `--device cpu`), or, with NCCL, one card a
rank on a machine with hosts x ranks-per-host cards. Each rank prints
`world size: N` and `MULTIHOST SMOKE OK`; the launcher prints
`multihost smoke: PASS` (exit 0) or `FAIL` (exit 1). Every rank is killed
at `--timeout` seconds, or as soon as one rank fails.

    python -m qwen3_tts_tpu_torch.tools.multihost_smoke --rank R ...

is a rank's entry (the launcher starts these).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Sequence, Tuple


def free_port() -> int:
    """A free localhost port (bound to 0, released for rank 0 to take)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(argv_for: Callable[[int, int], List[str]], world: int,
                ranks_per_host: int, env_extra=None, wait_s: float = 120.0):
    """Start `world` rank processes, `argv_for(rank, port)` each, with
    RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE set as torchrun sets
    them and the package on PYTHONPATH; output to temporary files. Rank 0
    starts first and the others once it listens on the port (a rank that
    starts connecting earlier can take the port as its own source port).
    Returns the (processes, log files) for `finish_ranks`."""
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = []

    def spawn(r):
        env = dict(os.environ, PYTHONPATH=path, RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r % ranks_per_host),
                   LOCAL_WORLD_SIZE=str(ranks_per_host), **(env_extra or {}))
        procs.append(subprocess.Popen(argv_for(r, port), env=env,
                                      stdout=logs[r],
                                      stderr=subprocess.STDOUT, text=True))

    spawn(0)
    deadline = time.time() + wait_s
    while world > 1 and procs[0].poll() is None and time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            break
        except OSError:
            time.sleep(0.05)
    for r in range(1, world):
        spawn(r)
    return procs, logs


def finish_ranks(procs, logs, timeout_s: float) -> Tuple[List[int],
                                                         List[str]]:
    """Wait for every rank; at the first rank that fails, or at
    `timeout_s`, kill the others (a rank that died leaves them waiting in
    a collective). Returns (return codes, outputs)."""
    deadline = time.time() + timeout_s
    note = ""
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        failed = any(c not in (None, 0) for c in codes)
        if failed or time.time() > deadline:
            note = ("\n[a rank failed: the others were killed]\n" if failed
                    else f"\n[killed after {timeout_s:.0f} s]\n")
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            break
        time.sleep(0.1)
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    outs[-1] += note
    return [p.returncode for p in procs], outs


def launch(module: str, world: int, ranks_per_host: int,
           args: Sequence[str], timeout_s: float,
           env_extra=None) -> Tuple[List[int], List[str]]:
    """`python -m module --rank r --world world --port p args` for every
    rank (`start_ranks`, `finish_ranks`). Returns (return codes,
    outputs)."""
    procs, logs = start_ranks(
        lambda r, port: [sys.executable, "-m", module, "--rank", str(r),
                         "--world", str(world), "--port", str(port)]
        + list(args), world, ranks_per_host, env_extra)
    return finish_ranks(procs, logs, timeout_s)


def rank_device(device: str):
    """This rank's device: the CPU, or card RANK mod the machine's cards
    (on a machine per host of as many ranks as cards, LOCAL_RANK; hosts
    emulated on one machine get cards of their own; ranks that share a
    card need gloo)."""
    import torch
    if device == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--device cuda: no CUDA card")
    torch.cuda.set_device(int(os.environ.get("RANK", "0")) % n)
    return torch.device("cuda", torch.cuda.current_device())


def worker(rank: int, world: int, port: int, hosts: int, backend: str,
           device: str) -> int:
    import torch

    from ..parallel import mesh as mesh_lib
    from ..parallel import run as prun

    rank_device(device)
    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                  backend=backend)
    rph = world // hosts
    print(f"[rank {rank}] world size: {world}, host {rank // rph} of "
          f"{hosts}, local rank {rank % rph} of {rph}, {backend} on "
          f"{device}", flush=True)
    # data axis across hosts, model axis within a host
    mesh = mesh_lib.make_mesh(hosts, rph, device_type=device)
    cfg = prun.parallel_test_config(max_steps=2)
    models, voc = prun.build_sharded_models(mesh, cfg, seed=0)
    wav, n_frames = prun.sharded_generate_step(
        mesh, cfg, models, voc, batch=hosts, prompt_len=4, max_steps=2)
    if wav.shape[0] != hosts or not bool(torch.isfinite(wav).all()):
        print(f"[rank {rank}] FAIL: wav {tuple(wav.shape)} not finite or "
              f"not one row a host", flush=True)
        return 1
    print(f"[rank {rank}] n_frames (gathered): {n_frames.tolist()}",
          flush=True)
    print(f"[rank {rank}] MULTIHOST SMOKE OK", flush=True)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ranks-per-host", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return worker(a.rank, a.world, a.port, a.hosts, a.backend, a.device)
    world = a.hosts * a.ranks_per_host
    rcs, outs = launch(
        "qwen3_tts_tpu_torch.tools.multihost_smoke", world,
        a.ranks_per_host,
        ["--hosts", str(a.hosts), "--backend", a.backend, "--device",
         a.device], a.timeout)
    for out in outs:
        sys.stdout.write(out)
    ok = rcs == [0] * world
    print("multihost smoke:", "PASS" if ok else f"FAIL (exit codes {rcs})",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
