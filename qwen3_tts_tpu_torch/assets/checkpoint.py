"""Checkpoint I/O: the port's parameter trees <-> .npz archives.

The layout of `qwen3_tts_tpu/assets/checkpoint.py`: one flat .npz whose
keys are the "/"-joined tree paths (`layers/wqkv`, `up/0/w`), the layout
`convert.unflatten` reads. Trees are nested dicts and lists of tensors
(or, for writing, numpy arrays: the converters of `tools/convert_weights.py`
work in numpy).

Deliberate divergence from the JAX package, in both directions:
  * writing: a bfloat16 leaf goes to disk as f32 (exact), the way the JAX
    engine's `save_checkpoint` already treats the vocoder. The JAX
    package's `save_pytree` writes a bf16 leaf through `np.asarray`, which
    `np.savez` stores as a `|V2` void array, and its own `load_pytree`
    then fails on it (`jnp.asarray(arr, bfloat16)`: "No cast function
    available"); f32 on disk loads in both packages at any model dtype;
  * reading: f32 and f16 leaves are accepted, and so is a 2-byte `|V2`
    leaf, read as bf16 bit patterns, so a checkpoint the JAX package wrote
    at the default (bf16) config loads bit for bit.

Both directions stream: `save_tree` writes one leaf at a time into the
archive, `load_tree` reads one leaf at a time straight to the target
device in the skeleton's dtype, so the host never holds a whole tree (the
flagship talker is 5.6 GB of f32 on disk).
"""

from __future__ import annotations

import zipfile
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order: dict keys sorted,
    list items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host: a tensor copied from its
    device (bf16 as f32, exact), an array as it is."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str, tree: Any) -> None:
    """Write a tree of tensors or numpy arrays as an .npz (`np.savez`'s
    format, uncompressed), one leaf at a time; bf16 tensors as f32."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in flatten(tree):
            arr = host_array(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            del arr     # one leaf on the host at a time


def _tensor(arr: np.ndarray, key: str, path: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint {path} tensor {key!r}: "
                             f"unsupported dtype {arr.dtype}")
        # the JAX package's bf16 leaves: raw bf16 bit patterns
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind not in "fiub":
        raise ValueError(f"checkpoint {path} tensor {key!r}: unsupported "
                         f"dtype {arr.dtype}")
    return torch.from_numpy(arr)


def load_tree(path: str, like: Any, device="cpu") -> Any:
    """Load into the structure of `like` (shapes checked, as in the JAX
    package), each leaf in `like`'s dtype on `device`. `like` may hold
    meta tensors: only shapes and dtypes are read from it."""
    device = torch.device(device)
    with np.load(path) as archive:
        files = set(archive.files)

        def load(key, ref):
            if key not in files:
                raise KeyError(f"checkpoint {path} missing tensor {key!r}")
            arr = archive[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {path} tensor {key!r}: shape {arr.shape} "
                    f"!= expected {tuple(ref.shape)}")
            # to the device first, then the cast there
            return _tensor(arr, key, path).to(device).to(ref.dtype)

        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return load(prefix[:-1], node)

        return walk(like, "")
