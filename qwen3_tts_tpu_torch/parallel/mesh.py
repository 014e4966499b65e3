"""Device mesh (`data`, `model`) over `torch.distributed`: the port of
`qwen3_tts_tpu/parallel/mesh.py`.

One process a rank, one rank a card (or a CPU process under gloo).
Utterance batches are data-parallel over `data`; the talker's and the
predictor's products are tensor-parallel over `model`
(`parallel/sharding.py`). JAX places its collectives from sharding
annotations (GSPMD); here the ranks hold local tensors (`shard`) and the
code that needs a collective calls it on the mesh's process group of
that axis (`group(mesh, axis)`): the decoder's two all_reduces a layer,
the gathers below.

Deliberate divergences from the JAX package:
  * `make_mesh` returns a `torch.distributed.device_mesh.DeviceMesh`
    over ranks, not devices; a one-rank mesh in a process that started no
    process group starts a one-rank world (gloo, an in-memory store);
  * `shard` gives this rank's local tensor of each leaf (`local_slice`, a
    pure function of the full tensor, the spec, the mesh shape and the
    rank's coordinates), not a global array;
  * gloo on CUDA tensors offers only broadcast and all_reduce, so
    `all_gather` is an all_reduce of a zeroed buffer that holds this
    rank's block (exact: every other element adds zeros), on every
    backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """A leaf's placement, the port's stand-in for JAX's PartitionSpec:
    one entry a tensor dimension, a mesh axis name (the dimension split
    over that axis) or None (whole); missing trailing entries are None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def make_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """Mesh of shape (data, model) over ranks 0 .. data * model - 1, in
    row-major order (JAX's reshape). Every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = data * model
    if not dist.is_initialized() and n == 1:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    ranks = torch.arange(n).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS,
                                                          MODEL_AXIS))


def single_device_mesh(device_type: str = "cuda"):
    return make_mesh(1, 1, device_type)


def make_local_mesh(model: int = 1, local_world_size: Optional[int] = None,
                    device_type: str = "cuda"):
    """Mesh over THIS host's ranks only (host-level DP): (local ranks /
    model, model). A host is `local_world_size` consecutive ranks
    (default: the LOCAL_WORLD_SIZE variable torchrun sets). Programs on a
    local mesh make no collective across hosts: each host runs its own
    generation over its own utterances, and hosts meet only at start and
    end. Every rank of the world calls it (the groups of all hosts are
    made together)."""
    from torch.distributed.device_mesh import DeviceMesh

    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if model <= 0 or local_world_size % model:
        raise ValueError(f"model axis {model} must divide local device "
                         f"count {local_world_size}")
    if not dist.is_initialized() and local_world_size == 1:
        return make_mesh(1, 1, device_type)
    world = dist.get_world_size()
    if world % local_world_size:
        raise ValueError(f"world of {world} ranks is not whole hosts of "
                         f"{local_world_size}")
    hosts = world // local_world_size
    ranks = torch.arange(world).reshape(hosts, local_world_size // model,
                                        model)
    full = DeviceMesh(device_type, ranks,
                      mesh_dim_names=("host", DATA_AXIS, MODEL_AXIS))
    return full[DATA_AXIS, MODEL_AXIS]


def axis_size(mesh, axis: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]


def coordinates(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def group(mesh, axis: str):
    """This rank's process group along `axis`, or None where the axis has
    one rank (no collective to make)."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def device(mesh) -> torch.device:
    """Where this rank's tensors live: the CPU, or the current CUDA
    device (one card a rank; `torch.cuda.set_device` first)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(x, spec, mesh_shape: Dict[str, int],
                coords: Dict[str, int]):
    """The block of the full tensor `x` that the rank at `coords` holds
    under `spec` on a mesh of `mesh_shape` ({axis: size}): dimension i
    split into mesh_shape[spec[i]] equal blocks, block coords[spec[i]].
    A copy where anything is split (the full tensor can be freed)."""
    index = []
    for i, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        if not isinstance(axis, str):
            raise ValueError(f"spec {spec}: one mesh axis a dimension")
        n, size = mesh_shape[axis], x.shape[i]
        if size % n:
            raise ValueError(f"dimension {i} of {tuple(x.shape)} does not "
                             f"split into {n} blocks (spec {spec})")
        c = coords[axis]
        index.append(slice(c * size // n, (c + 1) * size // n))
    if all(s == slice(None) for s in index):
        return x
    return x[tuple(index)].clone()


def _quantized_specs(w: dict, spec) -> dict:
    """Specs of an int8 / int4 weight's entries from the dense weight's
    spec [..., K, N]: q takes it; scale [..., N] drops the K axis; the
    int4 entries split only by column (their rows pack two k-rows a byte
    and a group of 128 per multiplier: shard the dense weight, then
    quantize each shard)."""
    nd = w["scale"].dim() + 1
    full = tuple(spec) + (None,) * (nd - len(spec))
    out = {}
    for k in w:
        if k == "scale":
            out[k] = P(*full[:-2], full[-1])
        elif k in ("q4", "m8") and full[-2] is not None:
            raise ValueError("int4 weights split only by column: shard the "
                             "dense weight, then quantize each shard")
        else:
            out[k] = P(*full)
    return out


def _map(fn, tree, specs):
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            qs = _quantized_specs(tree, specs)
            return {k: fn(v, qs[k]) for k, v in tree.items()}
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, s) for t, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")


def shard(mesh, tree, specs):
    """This rank's local tensor of each leaf of `tree` (full tensors) under
    the matching tree of specs (`parallel/sharding.py`), on this rank's
    device. A spec that meets an int8 / int4 weight dict applies to the
    weight it stands for (`_quantized_specs`)."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = coordinates(mesh)
    dev = device(mesh)
    return _map(lambda x, s: local_slice(x, s, shape, coords).to(dev),
                tree, specs)


def replicated(mesh, tree):
    """The whole tree on every rank, on this rank's device."""
    dev = device(mesh)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v) for v in t)
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: put(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return t.to(dev)

    return put(tree)


def all_gather(x: torch.Tensor, grp, dim: int = 0) -> torch.Tensor:
    """The group's blocks of `x` concatenated along `dim` in rank order,
    on every rank: one all_reduce of a zeroed buffer holding this rank's
    block (floats summed in f32, exact), so it runs where gloo holds CUDA
    tensors too."""
    n, r = dist.get_world_size(grp), dist.get_rank(grp)
    dim = dim % x.dim()
    shape = list(x.shape)
    size = shape[dim]
    shape[dim] = n * size
    wide = x.dtype if not x.is_floating_point() or x.dtype == torch.float64 \
        else torch.float32
    buf = torch.zeros(shape, dtype=wide, device=x.device)
    buf.narrow(dim, r * size, size).copy_(x)
    dist.all_reduce(buf, group=grp)
    return buf.to(x.dtype)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl",
                         timeout_s: float = 600.0) -> None:
    """`dist.init_process_group` over `tcp://<coordinator>` ("host:port",
    process 0 listens there) for `num_processes` ranks, this one
    `process_id`, with the caller's backend: "nccl" for one card a rank,
    "gloo" for CPU ranks and for ranks that share a card. A collective
    that waits past `timeout_s` raises. No-op when already initialised or
    single-process."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
