"""llama.cpp-layout GGUF <-> decoder parameter trees (numpy).

A copy of `qwen3_tts_tpu/assets/llama_gguf.py`, building the port's
configs. The reference release ships its talker and predictor as
llama.cpp GGUF files (`qwen3_tts_{talker,predictor}.gguf`, what the
downloader fetches); `convert_llama_gguf` reads one into the decoder layout
of `models/decoder.py`, so `TtsEngine(model_dir=...)` loads it without a
conversion step, and `export_llama_gguf` is its inverse.

GGML stores weights [out, in] (the numpy view after dim reversal); the
decoder layout is [in, out], hence the transposes. q|k|v fuse into `wqkv`
and gate|up into `w_gu`. Each [L, ...] stack is filled layer by layer in
place, so the host holds the tree once (the JAX copy stacks lists, which
holds it twice for a moment: 11 GB for the flagship talker).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.config import PredictorConfig, TalkerConfig
from . import gguf


def _meta(f: gguf.GGUFFile, *keys, default=None):
    for k in keys:
        for arch in ("qwen3", "llama", "qwen2"):
            v = f.metadata.get(f"{arch}.{k}")
            if v is not None:
                return v
        if k in f.metadata:
            return f.metadata[k]
    return default


def config_from_gguf(f: gguf.GGUFFile, kind: str):
    """Model geometry from GGUF metadata (as llama.cpp reads it)."""
    n_layer = int(_meta(f, "block_count"))
    hidden = int(_meta(f, "embedding_length"))
    n_head = int(_meta(f, "attention.head_count"))
    n_kv = int(_meta(f, "attention.head_count_kv", default=n_head))
    ffn = int(_meta(f, "feed_forward_length"))
    head_dim = int(_meta(f, "attention.key_length", default=hidden // n_head))
    theta = float(_meta(f, "rope.freq_base", default=1_000_000.0))
    vocab = int(f.tensors["output.weight"].shape[0]) \
        if "output.weight" in f.tensors else int(_meta(f, "vocab_size"))
    sections = _meta(f, "rope.dimension_sections")
    if sections is not None:
        sections = tuple(int(s) for s in sections)
        sections = sections + (0,) * (4 - len(sections))
    common = dict(
        hidden=hidden, n_layers=n_layer, n_q_heads=n_head, n_kv_heads=n_kv,
        head_dim=head_dim, ffn_dim=ffn, vocab=vocab, rope_theta=theta,
    )
    if kind == "talker":
        return TalkerConfig(**common,
                            mrope_sections=sections or (24, 20, 20, 0))
    return PredictorConfig(**common,
                           mrope_sections=sections or (head_dim // 2, 0, 0, 0))


def convert_llama_gguf(path: str, kind: str) -> Tuple[Any, Dict[str, Any]]:
    """llama.cpp GGUF -> (config, decoder parameter tree of f32 numpy
    arrays); k-quant and Q8_0 tensors are dequantised."""
    f = gguf.GGUFFile(path)
    cfg = config_from_gguf(f, kind)
    L, H, F = cfg.n_layers, cfg.hidden, cfg.ffn_dim
    nq_hd = cfg.n_q_heads * cfg.head_dim
    nk_hd = cfg.n_kv_heads * cfg.head_dim

    def t(name):
        return f.read_tensor(name).astype(np.float32).T

    def raw(name):
        return f.read_tensor(name).astype(np.float32)

    def stack(*shape):
        return np.empty((L,) + shape, np.float32)

    layers = {
        "ln1": stack(H), "wqkv": stack(H, nq_hd + 2 * nk_hd),
        "q_norm": stack(cfg.head_dim), "k_norm": stack(cfg.head_dim),
        "wo": stack(nq_hd, H), "ln2": stack(H), "w_gu": stack(H, 2 * F),
        "w_down": stack(F, H),
    }
    for i in range(L):
        p = f"blk.{i}."
        layers["ln1"][i] = raw(p + "attn_norm.weight")
        # the decoder runs fused projections: [in, q|k|v], [in, gate|up]
        layers["wqkv"][i, :, :nq_hd] = t(p + "attn_q.weight")
        layers["wqkv"][i, :, nq_hd:nq_hd + nk_hd] = t(p + "attn_k.weight")
        layers["wqkv"][i, :, nq_hd + nk_hd:] = t(p + "attn_v.weight")
        layers["q_norm"][i] = raw(p + "attn_q_norm.weight")
        layers["k_norm"][i] = raw(p + "attn_k_norm.weight")
        layers["wo"][i] = t(p + "attn_output.weight")
        layers["ln2"][i] = raw(p + "ffn_norm.weight")
        layers["w_gu"][i, :, :F] = t(p + "ffn_gate.weight")
        layers["w_gu"][i, :, F:] = t(p + "ffn_up.weight")
        layers["w_down"][i] = t(p + "ffn_down.weight")

    params = {
        "layers": layers,
        "final_norm": raw("output_norm.weight"),
        "head": np.ascontiguousarray(t("output.weight")),
    }
    return cfg, params


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def export_llama_gguf(path: str, cfg, params: Dict[str, Any],
                      arch: str = "qwen3") -> None:
    """The inverse mapping: a decoder tree of numpy arrays or tensors (a
    tensor is taken a layer at a time, as f32 on the host) -> llama.cpp
    names, F32."""
    tensors: Dict[str, np.ndarray] = {}
    layers = params["layers"]

    def lw(name, i):
        return _host(layers[name][i])

    nq_hd = cfg.n_q_heads * cfg.head_dim
    nk_hd = cfg.n_kv_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        tensors[p + "attn_norm.weight"] = lw("ln1", i)
        wqkv = lw("wqkv", i)
        tensors[p + "attn_q.weight"] = wqkv[:, :nq_hd].T
        tensors[p + "attn_k.weight"] = wqkv[:, nq_hd:nq_hd + nk_hd].T
        tensors[p + "attn_v.weight"] = wqkv[:, nq_hd + nk_hd:].T
        tensors[p + "attn_q_norm.weight"] = lw("q_norm", i)
        tensors[p + "attn_k_norm.weight"] = lw("k_norm", i)
        tensors[p + "attn_output.weight"] = lw("wo", i).T
        tensors[p + "ffn_norm.weight"] = lw("ln2", i)
        w_gu = lw("w_gu", i)
        F = w_gu.shape[1] // 2
        tensors[p + "ffn_gate.weight"] = w_gu[:, :F].T
        tensors[p + "ffn_up.weight"] = w_gu[:, F:].T
        tensors[p + "ffn_down.weight"] = lw("w_down", i).T
    tensors["output_norm.weight"] = _host(params["final_norm"])
    tensors["output.weight"] = _host(params["head"]).T
    meta = {
        f"{arch}.block_count": cfg.n_layers,
        f"{arch}.embedding_length": cfg.hidden,
        f"{arch}.attention.head_count": cfg.n_q_heads,
        f"{arch}.attention.head_count_kv": cfg.n_kv_heads,
        f"{arch}.attention.key_length": cfg.head_dim,
        f"{arch}.feed_forward_length": cfg.ffn_dim,
        f"{arch}.rope.freq_base": cfg.rope_theta,
        f"{arch}.rope.dimension_sections": list(cfg.mrope_sections),
    }
    gguf.write_gguf(path, tensors, meta)
