"""Convert the reference's release weights into the port's checkpoints.

    python -m qwen3_tts_tpu_torch.tools.convert_weights \
        --talker qwen3_tts_talker.gguf --predictor qwen3_tts_predictor.gguf \
        --vocoder qwen3_tts_decoder.onnx \
        --audio-encoder qwen3_tts_codec_encoder.onnx \
        --speaker-encoder qwen3_tts_speaker_encoder.onnx --out models/

The port's copy of the JAX package's `tools/convert_weights.py`, without
JAX: it imports neither `jax` nor anything of `qwen3_tts_tpu`, so it runs
on a machine that has only the port. The reference downloads four kinds of
artifact (`src/download.rs:55-101`): `qwen3_tts_talker.gguf` and
`qwen3_tts_predictor.gguf` (llama.cpp layouts), `qwen3_assets.gguf` (the
embedding tables, read as they are by `assets/tables.py`: copy it into
`--out`) and ONNX graphs of the vocoder and the two encoders.

  * `--talker` / `--predictor`: the llama.cpp GGUFs through
    `assets/llama_gguf.convert_llama_gguf` -> `talker.npz` /
    `predictor.npz` (f32; the engine also loads the GGUFs themselves);
  * `--vocoder`: `qwen3_tts_decoder.onnx` (`assets/onnx.py` parses the
    protobuf) -> `vocoder.npz` and `vocoder_config.json`. The graph is
    checked against the architecture derived from its carried-state
    signature (`validate_vocoder_onnx`; a mismatch is fatal unless
    `--force`), its upsampler family (kernel == stride, or the general
    BigVGAN/DAC family with residual units and snake) read from the graph
    (`derive_vocoder_config`), and its initializers mapped by their torch
    names or, when the export anonymized them, structurally (consumer
    ops, graph order and shapes), with torch weight-norm subgraphs folded
    to constants;
  * `--audio-encoder` / `--speaker-encoder`: the encoder graphs ->
    `audio_encoder.npz` / `speaker_encoder.npz`, by name or structurally;
  * a `.npz` torch state dict in place of any ONNX graph (the default
    configs' geometry).

The tool touches no device: it computes in numpy, as the JAX package's
does, so its outputs equal that tool's bit for bit, and writes the trees
with `assets/checkpoint.save_tree` in the JAX package's key order.
`write_vocoder_onnx` / `write_encoder_onnx` write graphs in the
torch-export idiom (the JAX tool's bytes), for tests and for the smoke.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Dict, Tuple

import numpy as np

from ..assets import checkpoint
from ..assets.checkpoint import host_array
from ..assets import onnx as onnx_mod
from ..assets.llama_gguf import convert_llama_gguf
from ..core.config import (AudioEncoderConfig, SpeakerEncoderConfig,
                           VocoderConfig, save_vocoder_config)
from ..models import encoders as enc
from ..models import vocoder as voc


def convert_vocoder_state_dict(sd: Dict[str, np.ndarray],
                               cfg=None) -> Dict[str, Any]:
    """Torch state dict of the codec decoder -> models/vocoder.py pytree.

    Expected naming (transformers-style export of the upstream codec
    decoder; a missing key names every key the state dict holds):

      quantizer.codebooks.{q}.weight            [2048, 512]
      decoder.pre_conv.{weight,bias}            Conv1d OIH [1024, 512, 3]
      decoder.layers.{i}.input_layernorm.weight
      decoder.layers.{i}.self_attn.{q,k,v,o}_proj.weight   Linear [out, in]
      decoder.layers.{i}.self_attn.{q,k}_norm.weight
      decoder.layers.{i}.post_attention_layernorm.weight
      decoder.layers.{i}.mlp.{gate,up,down}_proj.weight
      decoder.norm.weight
      decoder.post_conv1.{weight,bias}          Conv1d [1024, 1024, 2*LA+1]
      decoder.post_conv2.{weight,bias}          Conv1d [1024, 1024, 3]
      decoder.upsample.{i}.{weight,bias}        ConvTranspose1d [in, out, s]

    Torch Linear stores [out, in] -> transposed into our [in, out]; q/k/v and
    gate/up fuse into the decoder's wqkv / w_gu; ConvTranspose1d (kernel ==
    stride) becomes the matmul form [C_in, s*C_out] used by the frame-local
    upsampler (w[c_in, c_out, j] -> w2[c_in, j*C_out + c_out]).
    """
    cfg = cfg or VocoderConfig()

    def T(name):
        return np.ascontiguousarray(np.asarray(sd[name], np.float32).T)

    def raw(name):
        return np.asarray(sd[name], np.float32)

    embed = np.stack([raw(f"quantizer.codebooks.{q}.weight")
                      for q in range(cfg.num_codebooks)])

    layers: Dict[str, list] = {k: [] for k in (
        "ln1", "wqkv", "q_norm", "k_norm", "wo", "ln2", "w_gu", "w_down")}
    for i in range(cfg.n_layers):
        p = f"decoder.layers.{i}."
        layers["ln1"].append(raw(p + "input_layernorm.weight"))
        layers["wqkv"].append(np.concatenate(
            [T(p + "self_attn.q_proj.weight"),
             T(p + "self_attn.k_proj.weight"),
             T(p + "self_attn.v_proj.weight")], axis=1))
        layers["q_norm"].append(raw(p + "self_attn.q_norm.weight"))
        layers["k_norm"].append(raw(p + "self_attn.k_norm.weight"))
        layers["wo"].append(T(p + "self_attn.o_proj.weight"))
        layers["ln2"].append(raw(p + "post_attention_layernorm.weight"))
        layers["w_gu"].append(np.concatenate(
            [T(p + "mlp.gate_proj.weight"), T(p + "mlp.up_proj.weight")],
            axis=1))
        layers["w_down"].append(T(p + "mlp.down_proj.weight"))

    def maybe_alpha(key, name="alpha"):
        # snake activation (cfg.activation == "snake"): per-channel alphas
        return ({name: raw(key)} if key in sd else {})

    extra: Dict[str, Any] = {}
    up = []
    if cfg.general_upsampler:
        # DAC/BigVGAN family: ConvTranspose kept in torch IOH layout
        # [C_in, C_out, k] + residual dilated units + final output conv
        for i in range(len(cfg.upsample_factors)):
            p = f"decoder.upsample.{i}"
            wt = raw(p + ".weight")
            assert wt.shape[-1] == cfg.upsample_kernels[i], (
                f"upsample stage {i}: kernel {wt.shape[-1]} != "
                f"{cfg.upsample_kernels[i]}")
            entry = {"wt": wt, "b": raw(p + ".bias"),
                     **maybe_alpha(p + ".alpha")}
            res = []
            for j in range(len(cfg.resblock_dilations)):
                rp = f"{p}.res.{j}"
                res.append({
                    "w1": raw(rp + ".conv1.weight"),
                    "b1": raw(rp + ".conv1.bias"),
                    "w2": raw(rp + ".conv2.weight"),
                    "b2": raw(rp + ".conv2.bias"),
                    **maybe_alpha(rp + ".alpha1", "alpha1"),
                    **maybe_alpha(rp + ".alpha2", "alpha2"),
                })
            if res:
                entry["res"] = res
            up.append(entry)
        extra["final"] = {"w": raw("decoder.final_conv.weight"),
                          "b": raw("decoder.final_conv.bias"),
                          **maybe_alpha("decoder.final_conv.alpha")}
    else:
        for i, s in enumerate(cfg.upsample_factors):
            w = np.asarray(sd[f"decoder.upsample.{i}.weight"], np.float32)
            c_in, c_out, k = w.shape
            assert k == s, f"upsample stage {i}: kernel {k} != stride {s}"
            up.append({
                "w": np.ascontiguousarray(
                    w.transpose(0, 2, 1).reshape(c_in, s * c_out)),
                "b": np.tile(np.asarray(sd[f"decoder.upsample.{i}.bias"],
                                        np.float32), s),
                **maybe_alpha(f"decoder.upsample.{i}.alpha"),
            })

    return {
        **extra,
        "embed": embed,
        "pre_conv": {"w": raw("decoder.pre_conv.weight"),
                     "b": raw("decoder.pre_conv.bias"),
                     **maybe_alpha("decoder.pre_conv.alpha")},
        "transformer": {
            "layers": {k: np.stack(v) for k, v in layers.items()},
            "final_norm": raw("decoder.norm.weight"),
            # the shared decoder module carries an (unused) head slot
            "head": np.zeros((cfg.hidden, 8), np.float32),
        },
        "post_a": {"w": raw("decoder.post_conv1.weight"),
                   "b": raw("decoder.post_conv1.bias"),
                   **maybe_alpha("decoder.post_conv1.alpha")},
        "post_b": {"w": raw("decoder.post_conv2.weight"),
                   "b": raw("decoder.post_conv2.bias"),
                   **maybe_alpha("decoder.post_conv2.alpha")},
        "up": up,
    }


def export_vocoder_state_dict(params: Dict[str, Any],
                              cfg=None) -> Dict[str, np.ndarray]:
    """Inverse of convert_vocoder_state_dict; `params` may hold tensors
    (on any device; bf16 leaves come out as f32)."""
    cfg = cfg or VocoderConfig()
    sd: Dict[str, np.ndarray] = {}
    for q in range(cfg.num_codebooks):
        sd[f"quantizer.codebooks.{q}.weight"] = host_array(
            params["embed"][q])
    sd["decoder.pre_conv.weight"] = host_array(params["pre_conv"]["w"])
    sd["decoder.pre_conv.bias"] = host_array(params["pre_conv"]["b"])

    def put_alpha(key, entry):
        if "alpha" in entry:            # snake activation
            sd[key] = host_array(entry["alpha"])

    put_alpha("decoder.pre_conv.alpha", params["pre_conv"])
    lw = params["transformer"]["layers"]
    nq_hd = cfg.n_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        p = f"decoder.layers.{i}."
        sd[p + "input_layernorm.weight"] = host_array(lw["ln1"][i])
        wqkv = host_array(lw["wqkv"][i])
        sd[p + "self_attn.q_proj.weight"] = wqkv[:, :nq_hd].T
        sd[p + "self_attn.k_proj.weight"] = wqkv[:, nq_hd:2 * nq_hd].T
        sd[p + "self_attn.v_proj.weight"] = wqkv[:, 2 * nq_hd:].T
        sd[p + "self_attn.q_norm.weight"] = host_array(lw["q_norm"][i])
        sd[p + "self_attn.k_norm.weight"] = host_array(lw["k_norm"][i])
        sd[p + "self_attn.o_proj.weight"] = host_array(lw["wo"][i]).T
        sd[p + "post_attention_layernorm.weight"] = host_array(lw["ln2"][i])
        w_gu = host_array(lw["w_gu"][i])
        F = w_gu.shape[1] // 2
        sd[p + "mlp.gate_proj.weight"] = w_gu[:, :F].T
        sd[p + "mlp.up_proj.weight"] = w_gu[:, F:].T
        sd[p + "mlp.down_proj.weight"] = host_array(lw["w_down"][i]).T
    sd["decoder.norm.weight"] = host_array(params["transformer"]["final_norm"])
    sd["decoder.post_conv1.weight"] = host_array(params["post_a"]["w"])
    sd["decoder.post_conv1.bias"] = host_array(params["post_a"]["b"])
    put_alpha("decoder.post_conv1.alpha", params["post_a"])
    sd["decoder.post_conv2.weight"] = host_array(params["post_b"]["w"])
    sd["decoder.post_conv2.bias"] = host_array(params["post_b"]["b"])
    put_alpha("decoder.post_conv2.alpha", params["post_b"])
    if cfg.general_upsampler:
        for i in range(len(cfg.upsample_factors)):
            st = params["up"][i]
            p = f"decoder.upsample.{i}"
            sd[p + ".weight"] = host_array(st["wt"])
            sd[p + ".bias"] = host_array(st["b"])
            put_alpha(p + ".alpha", st)
            for j, unit in enumerate(st.get("res", ())):
                rp = f"{p}.res.{j}"
                sd[rp + ".conv1.weight"] = host_array(unit["w1"])
                sd[rp + ".conv1.bias"] = host_array(unit["b1"])
                sd[rp + ".conv2.weight"] = host_array(unit["w2"])
                sd[rp + ".conv2.bias"] = host_array(unit["b2"])
                if "alpha1" in unit:
                    sd[rp + ".alpha1"] = host_array(unit["alpha1"])
                    sd[rp + ".alpha2"] = host_array(unit["alpha2"])
        sd["decoder.final_conv.weight"] = host_array(params["final"]["w"])
        sd["decoder.final_conv.bias"] = host_array(params["final"]["b"])
        put_alpha("decoder.final_conv.alpha", params["final"])
    else:
        for i, s in enumerate(cfg.upsample_factors):
            w2 = host_array(params["up"][i]["w"])          # [C_in, s*C_out]
            c_in = w2.shape[0]
            c_out = w2.shape[1] // s
            sd[f"decoder.upsample.{i}.weight"] = np.ascontiguousarray(
                w2.reshape(c_in, s, c_out).transpose(0, 2, 1))
            sd[f"decoder.upsample.{i}.bias"] = host_array(
                params["up"][i]["b"])[:c_out]
            put_alpha(f"decoder.upsample.{i}.alpha", params["up"][i])
    return sd


# --------------------------------------------------------------------- ONNX
# The reference's codec models ship as ONNX graphs (`src/models/onnx.rs:87-95,
# 130-138,329-336`; manifest `src/download.rs:55-101`). assets/onnx.py parses
# the protobuf (no onnxruntime); the functions below (a) VALIDATE the graph's
# op skeleton against the architecture models/vocoder.py derives from the
# carried-state signature, so a mismatch is a loud error instead of silent
# wrongness, and (b) map the initializers onto our pytrees — by name when the
# export preserved torch parameter names, structurally (consumer-op analysis)
# when it anonymized them (`onnx::MatMul_123`-style).

class OnnxConversionError(ValueError):
    pass


def _consumers(model) -> Dict[str, list]:
    """initializer/value name -> [(node, input_index)] consuming it."""
    out: Dict[str, list] = {}
    for node in model.nodes:
        for i, name in enumerate(node.inputs):
            out.setdefault(name, []).append((node, i))
    return out


def _to_torch_layout(arr: np.ndarray, uses: list) -> np.ndarray:
    """Orient a weight initializer into torch state-dict layout.

    torch.onnx.export folds `Linear` into `MatMul` with a TRANSPOSED
    ([in, out]) initializer (or `Gemm` with transB=1 keeping [out, in]);
    Conv / ConvTranspose / Gather / Mul keep the state-dict layout. The
    consuming op, not the name, is the ground truth for orientation.
    """
    for node, idx in uses:
        if node.op_type == "MatMul" and idx == 1 and arr.ndim == 2:
            return np.ascontiguousarray(arr.T)
        if node.op_type == "Gemm" and idx == 1 and arr.ndim == 2:
            return arr if node.attrs.get("transB") else \
                np.ascontiguousarray(arr.T)
    return arr


def sd_from_onnx(model, expected_keys=None) -> Dict[str, np.ndarray]:
    """Initializers -> torch-layout state dict, names normalized.

    Strips the most-common shared prefix (exporters often prepend `model.`
    or the wrapper module name) chosen to maximize matches against
    `expected_keys` when given.
    """
    uses = _consumers(model)
    sd = {n: _to_torch_layout(np.asarray(a), uses.get(n, ()))
          for n, a in model.initializers.items()}
    if not expected_keys:
        return sd
    expected = set(expected_keys)
    best, best_hits = "", len(expected & set(sd))
    prefixes = {n[: len(n) - len(k)]
                for n in sd for k in expected if n.endswith(k)}
    for p in prefixes:
        hits = sum(1 for n in sd if n.startswith(p) and n[len(p):] in expected)
        if hits > best_hits:
            best, best_hits = p, hits
    if best:
        sd = {n[len(best):] if n.startswith(best) else n: a
              for n, a in sd.items()}
    return sd


def _producers(model) -> Dict[str, Any]:
    """value name -> producing node."""
    out: Dict[str, Any] = {}
    for node in model.nodes:
        for name in node.outputs:
            out[name] = node
    return out


# ops a weight-producing subgraph may use; anything else stops the fold.
# torch.onnx exports `weight_norm` convs as  w = g * v / ||v||  subgraphs
# (ReduceL2/Div/Mul over two initializers) instead of a single initializer;
# real codec releases commonly ship this way, so the converter folds them.
_FOLD_EVAL = {
    "Constant": None,           # attr-valued, handled explicitly
    "Identity": lambda a: a[0],
    "Mul": lambda a: a[0] * a[1],
    "Div": lambda a: a[0] / a[1],
    "Add": lambda a: a[0] + a[1],
    "Sub": lambda a: a[0] - a[1],
    "Sqrt": lambda a: np.sqrt(a[0]),
    "Abs": lambda a: np.abs(a[0]),
    "Neg": lambda a: -a[0],
    "Reciprocal": lambda a: 1.0 / a[0],
    "Exp": lambda a: np.exp(a[0]),
    "Pow": lambda a: np.power(a[0], a[1]),
    "Transpose": None,          # attr-dependent, handled below
    "Reshape": lambda a: a[0].reshape([int(v) for v in a[1]]),
    "Unsqueeze": None,
    "Squeeze": None,
    "Cast": lambda a: a[0],     # weights are read as f32 regardless
    "ReduceL2": None,
    "ReduceSum": None,
    "ReduceMean": None,
}


def _const_eval(model, name, prod=None, cache=None):
    """Evaluate `name` if it is an initializer or computable from
    initializers through _FOLD_EVAL ops. Returns np.ndarray or None."""
    prod = _producers(model) if prod is None else prod
    cache = {} if cache is None else cache
    if name in cache:
        return cache[name]
    if name in model.initializers:
        v = np.asarray(model.initializers[name], np.float32)
        cache[name] = v
        return v
    node = prod.get(name)
    if node is None or node.op_type not in _FOLD_EVAL:
        cache[name] = None
        return None
    if node.op_type == "Constant":
        v = node.attrs.get("value")
        cache[name] = np.asarray(v, np.float32) if v is not None else None
        return cache[name]
    args = []
    for inp in node.inputs:
        v = _const_eval(model, inp, prod, cache)
        if v is None:
            cache[name] = None
            return None
        args.append(v)
    op = node.op_type
    try:
        if op == "Transpose":
            perm = node.attrs.get("perm")
            v = np.transpose(args[0], perm and [int(p) for p in perm])
        elif op == "Unsqueeze":
            axes = node.attrs.get("axes") or [int(x) for x in args[1]]
            v = args[0]
            for ax in sorted(int(a) for a in axes):
                v = np.expand_dims(v, ax)
        elif op == "Squeeze":
            axes = node.attrs.get("axes") or (
                [int(x) for x in args[1]] if len(args) > 1 else None)
            v = np.squeeze(args[0], tuple(int(a) for a in axes)
                           if axes else None)
        elif op in ("ReduceL2", "ReduceSum", "ReduceMean"):
            axes = node.attrs.get("axes")
            if axes is None and len(args) > 1:
                axes = [int(x) for x in args[1]]
            axes = tuple(int(a) for a in axes) if axes else None
            keep = bool(node.attrs.get("keepdims", 1))
            x = args[0]
            if op == "ReduceL2":
                v = np.sqrt(np.sum(x * x, axis=axes, keepdims=keep))
            elif op == "ReduceSum":
                v = np.sum(x, axis=axes, keepdims=keep)
            else:
                v = np.mean(x, axis=axes, keepdims=keep)
        else:
            v = _FOLD_EVAL[op](args)
    except Exception:
        v = None
    cache[name] = v
    return v


def _weight_ports(model):
    """[(node, weight_input_name)] for every op that consumes a weight."""
    out = []
    for node in model.nodes:
        if node.op_type in ("Conv", "ConvTranspose", "MatMul", "Gemm") \
                and len(node.inputs) > 1:
            out.append((node, node.inputs[1]))
    return out


def _weight_subgraph_nodes(model, prod=None):
    """ids of nodes that exist only to COMPUTE a weight (weight-norm folds):
    the producer closure of every non-initializer weight input. The
    structural walk skips these so a `Mul` inside a fold is never mistaken
    for an rms-norm scale. Only closures that actually const-evaluate are
    taken: activation-valued second inputs (attention q@k / probs@v
    MatMuls) fail the eval and are left alone."""
    prod = _producers(model) if prod is None else prod
    cache: Dict[str, Any] = {}
    seen: set = set()

    def walk(name):
        node = prod.get(name)
        if node is None or id(node) in seen:
            return
        seen.add(id(node))
        for inp in node.inputs:
            if inp not in model.initializers:
                walk(inp)

    for node, wname in _weight_ports(model):
        if wname not in model.initializers and \
                _const_eval(model, wname, prod, cache) is not None:
            walk(wname)
    return seen


def _producer_chain(model, name, prod=None, depth=6):
    """Human-readable op chain producing `name` (for diagnostics)."""
    prod = _producers(model) if prod is None else prod
    chain = []
    while depth > 0:
        node = prod.get(name)
        if node is None:
            chain.append(name if name in model.initializers
                         else f"{name}(graph input?)")
            break
        chain.append(f"{node.op_type}->{name}")
        name = node.inputs[0] if node.inputs else ""
        depth -= 1
    return " <- ".join(chain)


def explain_unmapped(model, mapped: set) -> list:
    """Per-initializer diagnostic for everything the converter did NOT map:
    [(name, shape, guess)] where guess classifies the consumer subgraph
    (snake alpha, weight-norm component, ...): the converter maps or
    precisely explains every initializer."""
    uses = _consumers(model)
    prod = _producers(model)
    wnodes = _weight_subgraph_nodes(model, prod)
    snake = _snake_region(model, prod, uses)
    out = []
    for name, arr in model.initializers.items():
        if name in mapped:
            continue
        consumers = uses.get(name, ())
        guess = "unclassified"
        if any(id(n) in wnodes for n, _ in consumers):
            guess = "weight_norm component (g/v of a folded conv weight)"
        elif any(id(n) in snake for n, _ in consumers):
            guess = "snake activation alpha"
        elif any(n.op_type in ("LeakyRelu", "PRelu", "Elu")
                 for n, _ in consumers):
            guess = "leaky/parametric activation slope"
        out.append((name, tuple(np.asarray(arr).shape), guess))
    return out


def _snake_region(model, prod=None, uses=None, hops=2):
    """node ids within `hops` undirected graph steps of any Sin node —
    snake(x) = x + sin^2(alpha*x)/alpha puts alpha's consumers (the
    pre-scale Mul and the post-square Div) 1-2 hops from the Sin."""
    prod = _producers(model) if prod is None else prod
    uses = _consumers(model) if uses is None else uses
    frontier = [n for n in model.nodes if n.op_type == "Sin"]
    region = {id(n) for n in frontier}
    for _ in range(hops):
        nxt = []
        for node in frontier:
            adj = [prod.get(i) for i in node.inputs]
            adj += [c for o in node.outputs for c, _ in uses.get(o, ())]
            for m in adj:
                if m is not None and id(m) not in region:
                    region.add(id(m))
                    nxt.append(m)
        frontier = nxt
    return region


def _skip_chain(model, start: str, target: str, prod, max_depth: int = 24):
    """Walk producers from tensor `start` looking for tensor `target`.
    Returns the Conv/ConvTranspose nodes on the found path (None if the
    target is unreachable) — the structural signature of a residual unit:
    Add(x, f(x)) where f contains convs."""
    seen = set()

    def walk(name, depth):
        if depth > max_depth:
            return None
        node = prod.get(name)
        if node is None or id(node) in seen:
            return None
        seen.add(id(node))
        is_conv = node.op_type in ("Conv", "ConvTranspose")
        if target in node.inputs:
            return [node] if is_conv else []
        for inp in node.inputs:
            r = walk(inp, depth + 1)
            if r is not None:
                return r + [node] if is_conv else r
        return None

    return walk(start, 0)


def _residual_units(model, prod=None) -> list:
    """DAC/BigVGAN residual units: Add nodes whose one input is reachable
    from the other through >=1 Conv. Returns [{'add', 'skip', 'convs'}]
    in graph order. Transformer residuals (MatMul-only chains) and the
    snake subgraph's internal Add (no convs) do not match."""
    prod = _producers(model) if prod is None else prod
    init = model.initializers
    units = []
    claimed = set()
    for n in model.nodes:
        if n.op_type != "Add" or len(n.inputs) != 2:
            continue
        if any(i in init for i in n.inputs):
            continue
        for skip, branch in ((n.inputs[0], n.inputs[1]),
                             (n.inputs[1], n.inputs[0])):
            convs = _skip_chain(model, branch, skip, prod)
            if convs and not any(id(c) in claimed for c in convs):
                units.append({"add": n, "skip": skip, "convs": convs})
                claimed.update(id(c) for c in convs)
                break
    return units


def _conv_weight_shape(model, node, prod=None, cache=None):
    if len(node.inputs) < 2:
        return None
    w = model.initializers.get(node.inputs[1])
    if w is None:
        w = _const_eval(model, node.inputs[1], prod, cache)
    return None if w is None else w.shape


def _snake_sites(model, prod=None, uses=None):
    """Anchor each snake activation to its adjacent conv (an order-based
    assignment silently swaps same-sized alphas). For every snake
    subgraph (alpha Mul -> Sin -> ... -> Add), returns
    (alpha_name, alpha_mul_node, producer_conv, consumer_conv) where
    producer_conv directly produces the snake's input x (post-activation
    site) and consumer_conv directly consumes the snake's output Add
    (pre-activation site); either may be None."""
    prod = _producers(model) if prod is None else prod
    uses = _consumers(model) if uses is None else uses
    init = model.initializers
    out = []
    for n in model.nodes:
        if n.op_type != "Mul" or len(n.inputs) != 2:
            continue
        anames = [i for i in n.inputs if i in init
                  and init[i].ndim == 1]
        if len(anames) != 1:
            continue
        alpha = anames[0]
        x = next(i for i in n.inputs if i != alpha)
        # must actually be a snake: Mul -> Sin among consumers
        if not any(c.op_type == "Sin" for c, _ in uses.get(n.outputs[0], ())):
            continue
        # the subgraph's output Add rejoins x: find Add(x, ...) downstream
        snake_add = None
        frontier = [n]
        for _ in range(6):
            nxt = []
            for m in frontier:
                for o in m.outputs:
                    for c, _ in uses.get(o, ()):
                        if c.op_type == "Add" and x in c.inputs:
                            snake_add = c
                        elif c.op_type in ("Sin", "Mul", "Div"):
                            nxt.append(c)
            if snake_add:
                break
            frontier = nxt
        if snake_add is None:
            continue

        def through_identity(node_):
            while node_ is not None and node_.op_type == "Identity":
                node_ = prod.get(node_.inputs[0])
            return node_

        pc = through_identity(prod.get(x))
        producer = pc if pc is not None and pc.op_type in (
            "Conv", "ConvTranspose") else None
        consumer = None
        for c, _ in uses.get(snake_add.outputs[0], ()):
            if c.op_type == "Identity":
                nxt_uses = uses.get(c.outputs[0], ())
                c = nxt_uses[0][0] if nxt_uses else None
            if c is not None and c.op_type in ("Conv", "ConvTranspose"):
                consumer = c
                break
        out.append((alpha, n, producer, consumer))
    return out


def _expected_vocoder_keys(cfg) -> list:
    return list(export_vocoder_state_dict(_vocoder_key_skeleton(cfg), cfg))


def _zeros_like(tree):
    """A tree of read-only zero arrays (no memory behind them) with the
    shapes of `tree`'s leaves: a key skeleton."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return np.broadcast_to(np.float32(0), tuple(tree.shape))


def _vocoder_key_skeleton(cfg):
    """Shape-correct zero tree, used only to enumerate state-dict keys."""
    return _zeros_like(voc.init_vocoder(None, cfg, device="meta"))


def validate_vocoder_onnx(model, cfg=None) -> Dict[str, str]:
    """Check each derived-architecture assumption (models/vocoder.py:8-29)
    against the actual graph; returns {assumption: 'verified' | 'mismatch:
    ...' | 'unverified: ...'}. Callers decide whether mismatches are fatal.
    """
    cfg = cfg or VocoderConfig()
    r: Dict[str, str] = {}
    ins = {n: dims for n, _, dims in model.inputs}
    outs = {n for n, _, _ in model.outputs}

    def check(name, cond, detail):
        r[name] = "verified" if cond else f"mismatch: {detail}"

    # --- I/O contract (src/models/onnx.rs:342-458) ---
    need_in = {"audio_codes", "is_last", "pre_conv_history", "latent_buffer",
               "conv_history"} | {f"past_key_{i}" for i in range(cfg.n_layers)} \
        | {f"past_value_{i}" for i in range(cfg.n_layers)}
    missing = sorted(need_in - set(ins))
    check("io.inputs", not missing, f"missing graph inputs {missing}")
    need_out = {"final_wav", "valid_samples", "next_pre_conv_history",
                "next_latent_buffer", "next_conv_history"} \
        | {f"next_key_{i}" for i in range(cfg.n_layers)} \
        | {f"next_value_{i}" for i in range(cfg.n_layers)}
    missing = sorted(need_out - outs)
    check("io.outputs", not missing, f"missing graph outputs {missing}")
    n_kv = sum(1 for n in ins if n.startswith("past_key_"))
    check("transformer.n_layers", n_kv == cfg.n_layers,
          f"{n_kv} past_key_* inputs, derived {cfg.n_layers}")

    def dim(name, i):
        d = ins.get(name)
        return d[i] if d and i < len(d) else None

    check("pre_conv.embed_dim", dim("pre_conv_history", 1)
          in (None, cfg.embed_dim),
          f"pre_conv_history ch {dim('pre_conv_history', 1)}, "
          f"derived {cfg.embed_dim}")
    check("transformer.n_heads", dim("past_key_0", 1) in (None, cfg.n_heads),
          f"past_key_0 heads {dim('past_key_0', 1)}, derived {cfg.n_heads}")
    check("transformer.head_dim", dim("past_key_0", 3)
          in (None, cfg.head_dim),
          f"past_key_0 hd {dim('past_key_0', 3)}, derived {cfg.head_dim}")
    check("post_conv.hidden", dim("conv_history", 1) in (None, cfg.hidden),
          f"conv_history ch {dim('conv_history', 1)}, derived {cfg.hidden}")

    # --- op skeleton ---
    init = model.initializers
    convs = [n for n in model.nodes if n.op_type == "Conv"]
    tconvs = [n for n in model.nodes if n.op_type == "ConvTranspose"]

    def kernel(node):
        ks = node.attrs.get("kernel_shape")
        if ks:
            return int(ks[0])
        w = init.get(node.inputs[1]) if len(node.inputs) > 1 else None
        if w is None and len(node.inputs) > 1:   # weight-norm computed weight
            w = _const_eval(model, node.inputs[1])
        return int(w.shape[-1]) if w is not None else None

    # classify convs: residual-unit members, the 1-channel output conv,
    # and the 3 trunk convs (pre / centered post1 / causal post2)
    prod_cls = _producers(model)
    runits = _residual_units(model, prod_cls)
    res_ids = {id(c) for u in runits for c in u["convs"]}
    cache_cls: Dict[str, Any] = {}

    def out_ch(c):
        shp = _conv_weight_shape(model, c, prod_cls, cache_cls)
        return None if shp is None else int(shp[0])

    final_convs = [c for c in convs
                   if id(c) not in res_ids and out_ch(c) == 1]
    trunk = [c for c in convs
             if id(c) not in res_ids and c not in final_convs]
    kks = sorted(kernel(c) for c in trunk if kernel(c) is not None)
    want = sorted([cfg.pre_conv_kernel, 2 * cfg.lookahead + 1,
                   cfg.post_conv_kernel])
    check("conv.kernels", len(trunk) == 3 and kks == want,
          f"{len(trunk)} trunk Conv nodes with kernels {kks}, derived "
          f"{want} (pre K={cfg.pre_conv_kernel}, centered "
          f"K=2*{cfg.lookahead}+1, post K={cfg.post_conv_kernel})")

    strides = [tuple(n.attrs.get("strides", ())) for n in tconvs]
    check("upsample.factors",
          [s[0] if s else None for s in strides]
          == list(cfg.upsample_factors),
          f"ConvTranspose strides {strides}, derived "
          f"{cfg.upsample_factors}")
    kst = [(kernel(n), n.attrs.get("strides", [None])[0]) for n in tconvs]
    if cfg.general_upsampler:
        check("upsample.kernels",
              [k for k, _ in kst] == list(cfg.upsample_kernels),
              f"ConvTranspose kernels {[k for k, _ in kst]}, configured "
              f"{cfg.upsample_kernels}")
        check("upsample.final_conv",
              len(final_convs) == 1
              and kernel(final_convs[0]) == cfg.final_conv_kernel,
              f"{len(final_convs)} 1-channel output Conv(s) with kernels "
              f"{[kernel(c) for c in final_convs]}, configured final "
              f"K={cfg.final_conv_kernel}")
    else:
        check("upsample.kernel_eq_stride", all(k == s for k, s in kst),
              f"kernel/stride pairs {kst} (frame-local matmul form needs "
              "k==s; a BigVGAN/DAC-family graph converts via "
              "derive_vocoder_config / cfg.upsample_kernels)")

    gathers = [n for n in model.nodes if n.op_type == "Gather"
               and n.inputs and n.inputs[0] in init]
    n_books = sum(init[n.inputs[0]].shape[0] if init[n.inputs[0]].ndim == 3
                  else 1 for n in gathers)
    check("rvq.num_codebooks", n_books == cfg.num_codebooks,
          f"{n_books} codebook Gather tables, derived {cfg.num_codebooks}")

    ops = model.ops()
    acts = {k: v for k, v in ops.items()
            if k in ("Sigmoid", "Gelu", "Erf", "Tanh", "Relu", "LeakyRelu",
                     "Elu", "Snake")}
    if acts.get("Tanh", 0) == 1:
        acts.pop("Tanh")        # the waveform head's output tanh
    if set(acts) <= {"Sigmoid"} and acts:
        r["mlp.activation"] = "verified"
    else:
        r["mlp.activation"] = (f"mismatch: graph activations {acts}, derived "
                               "SiLU (Sigmoid*x)")

    # snake activations (x + sin^2(alpha*x)/alpha, used by several public
    # neural codecs): no standard ONNX op, shows up as Sin nodes. The
    # derived vocoder (models/vocoder.py) has none — name the subgraph and
    # its alpha initializers precisely so a real-release mismatch is
    # actionable.
    sins = [n for n in model.nodes if n.op_type == "Sin"]
    snake_cfg = getattr(cfg, "activation", "gelu") == "snake"
    if sins and not snake_cfg:
        prod0 = _producers(model)
        uses0 = _consumers(model)
        region = _snake_region(model, prod0, uses0)
        alphas = sorted({name for name in init
                         for n, _ in uses0.get(name, ())
                         if id(n) in region})
        r["act.snake"] = (
            f"mismatch: {len(sins)} Sin node(s) — snake-style activation "
            f"not in the derived architecture (set cfg.activation='snake' "
            f"to convert); alpha initializer(s): {alphas[:8]}")
    elif snake_cfg and not sins:
        r["act.snake"] = ("mismatch: cfg.activation='snake' but the graph "
                          "has no Sin nodes")
    elif snake_cfg:
        r["act.snake"] = f"verified (snake, {len(sins)} Sin nodes)"
    else:
        r["act.snake"] = "verified"

    # residual conv units (Add whose branch holds convs — the DAC/BigVGAN
    # ResidualUnit shape; transformer MatMul residuals do not match)
    if cfg.general_upsampler:
        want_units = len(cfg.upsample_factors) * len(cfg.resblock_dilations)
        unit_ks = sorted(
            kernel(c) for u in runits for c in u["convs"]
            if kernel(c) is not None and kernel(c) > 1)
        check("conv.residual_units",
              len(runits) == want_units
              and all(k == cfg.resblock_kernel for k in unit_ks),
              f"{len(runits)} residual units (dilated kernels {unit_ks}), "
              f"configured {want_units} units of "
              f"K={cfg.resblock_kernel} per stage")
    else:
        res_desc = [f"Add({', '.join(u['add'].inputs)})" for u in runits]
        check("conv.residual_units", not runits,
              f"residual conv unit(s): {res_desc[:4]} — derived stack is "
              "sequential (pre_conv -> transformer -> post_conv1/2 -> "
              "upsample); a BigVGAN/DAC-family graph converts via "
              "derive_vocoder_config / cfg.resblock_dilations")

    # weight-norm folds: conv/matmul weights computed by a subgraph instead
    # of stored as initializers. Foldable ones are fine (the structural
    # mapper const-evaluates them); unfoldable ones name the producer chain.
    prod = _producers(model)
    cache: Dict[str, Any] = {}
    folded, unfoldable = 0, []
    for node, wname in _weight_ports(model):
        if wname in init:
            continue
        if _const_eval(model, wname, prod, cache) is not None:
            folded += 1
        elif node.op_type in ("Conv", "ConvTranspose"):
            # a Conv's second input is always a weight; a MatMul's may be an
            # activation (attention q@k, probs@v) — those are not errors
            unfoldable.append(
                f"{node.op_type} weight {_producer_chain(model, wname, prod)}")
    if unfoldable:
        r["conv.weight_norm"] = (
            f"mismatch: non-constant weight subgraph(s): {unfoldable[:4]}")
    elif folded:
        r["conv.weight_norm"] = f"verified (folded {folded} computed weights)"
    else:
        r["conv.weight_norm"] = "verified"

    def _w2(name):
        if name in init:
            return init[name] if init[name].ndim == 2 else None
        v = _const_eval(model, name, prod, cache)
        return v if v is not None and v.ndim == 2 else None

    mm = [n for n in model.nodes if n.op_type in ("MatMul", "Gemm")
          and len(n.inputs) > 1 and _w2(n.inputs[1]) is not None]
    check("transformer.linears", len(mm) == 7 * cfg.n_layers,
          f"{len(mm)} weighted MatMul/Gemm, derived 7*{cfg.n_layers} "
          "(q,k,v,o,gate,up,down per layer)")
    return r


def derive_vocoder_config(model, base_cfg=None):
    """Infer the vocoder architecture from the graph itself.

    Trunk geometry comes from the carried-state I/O signature (the
    evidence the architecture was derived from): n_layers = number of
    past_key_* inputs, heads/head_dim from past_key_0's dims, embed_dim/
    hidden from pre_conv_history/conv_history channels, conv kernels (and
    hence lookahead) from the trunk Conv weights, ffn from the stack's
    MatMul shapes. The upsampler family (ConvTranspose strides/kernels/
    pads/channels, residual-unit kernel + dilations, final conv, snake)
    comes from the node walk. `base_cfg` supplies only what the graph
    cannot know (max_frames, rms_eps, dtype)."""
    cfg = base_cfg or VocoderConfig()
    prod = _producers(model)
    cache: Dict[str, Any] = {}
    tconvs = [n for n in model.nodes if n.op_type == "ConvTranspose"]
    if not tconvs:
        raise OnnxConversionError("no ConvTranspose upsampler stages found")

    def wshape(node):
        shp = _conv_weight_shape(model, node, prod, cache)
        if shp is None:
            raise OnnxConversionError(
                f"{node.op_type} weight is not a constant: "
                f"{_producer_chain(model, node.inputs[1], prod)}")
        return shp

    # --- trunk geometry from the carried-state signature ---
    ins = {n: dims for n, _, dims in model.inputs}

    def in_dim(name, i):
        d = ins.get(name)
        return d[i] if d and i < len(d) and d[i] else None

    upd: Dict[str, Any] = {}
    n_kv = sum(1 for n in ins if n.startswith("past_key_"))
    if n_kv:
        upd["n_layers"] = n_kv
    for field, src, i in (("n_heads", "past_key_0", 1),
                          ("head_dim", "past_key_0", 3),
                          ("embed_dim", "pre_conv_history", 1),
                          ("hidden", "conv_history", 1)):
        v = in_dim(src, i)
        if v:
            upd[field] = int(v)
    if upd:
        cfg = dataclasses.replace(cfg, **upd)

    # ffn from the stack linears: [hidden, X] constants where X is neither
    # the qkv width nor hidden itself
    nhd = cfg.n_heads * cfg.head_dim
    ffn_cands = set()
    for node in model.nodes:
        if node.op_type in ("MatMul", "Gemm") and len(node.inputs) > 1:
            mv = _const_eval(model, node.inputs[1], prod, cache)
            if mv is None or mv.ndim != 2:
                continue
            m = (mv if node.op_type == "Gemm" and node.attrs.get("transB")
                 else mv.T)                      # torch [out, in]
            if m.shape[1] == cfg.hidden and m.shape[0] not in (nhd,
                                                               cfg.hidden):
                ffn_cands.add(int(m.shape[0]))
    if len(ffn_cands) == 1:
        cfg = dataclasses.replace(cfg, ffn_dim=ffn_cands.pop())

    strides = [int(n.attrs.get("strides", [1])[0]) for n in tconvs]
    kernels = [int(wshape(n)[-1]) for n in tconvs]
    runits = _residual_units(model, prod)
    sins = any(n.op_type == "Sin" for n in model.nodes)
    act = "snake" if sins else "gelu"

    # trunk conv kernels: pre (Cin == embed_dim), then centered post1
    # (-> lookahead) and causal post2, in graph order; residual-unit and
    # 1-channel output convs are not trunk
    res_ids = {id(c) for u in runits for c in u["convs"]}
    trunk_convs = []
    for n in model.nodes:
        if n.op_type != "Conv" or id(n) in res_ids:
            continue
        shp = wshape(n)
        if shp[0] == 1:
            continue
        trunk_convs.append((n, shp))
    pre = [s for _, s in trunk_convs if s[1] == cfg.embed_dim]
    post = [s for _, s in trunk_convs if s[1] != cfg.embed_dim]
    if len(pre) == 1 and len(post) == 2:
        cfg = dataclasses.replace(
            cfg, pre_conv_kernel=int(pre[0][-1]),
            lookahead=(int(post[0][-1]) - 1) // 2,
            post_conv_kernel=int(post[1][-1]))

    general = bool(runits) or any(
        k != s for k, s in zip(kernels, strides))
    if not general:
        return dataclasses.replace(cfg, upsample_factors=tuple(strides),
                                   activation=act)

    chans = tuple(int(wshape(n)[1]) for n in tconvs)      # IOH: C_out
    pads = tuple(
        int(n.attrs["pads"][0]) if n.attrs.get("pads")
        else (k - s + 1) // 2
        for n, k, s in zip(tconvs, kernels, strides))
    order = {id(n): i for i, n in enumerate(model.nodes)}
    tpos = [order[id(n)] for n in tconvs]
    per_stage: list = [[] for _ in tconvs]
    kr = None
    for u in runits:
        dconvs = [c for c in u["convs"] if wshape(c)[-1] > 1]
        if not dconvs:
            raise OnnxConversionError(
                f"residual unit at Add({u['add'].inputs}) has no conv "
                "with kernel > 1")
        c = dconvs[0]
        k_unit = int(wshape(c)[-1])
        if kr is None:
            kr = k_unit
        elif kr != k_unit:
            raise OnnxConversionError(
                f"residual-unit kernels differ ({kr} vs {k_unit}); "
                "VocoderConfig models one resblock_kernel")
        pos = order[id(c)]
        before = [i for i, tp in enumerate(tpos) if tp < pos]
        if not before:
            raise OnnxConversionError(
                "residual unit precedes the first ConvTranspose stage")
        per_stage[max(before)].append(int(c.attrs.get("dilations", [1])[0]))
    dil0 = tuple(per_stage[0])
    if any(tuple(x) != dil0 for x in per_stage):
        raise OnnxConversionError(
            f"residual-unit dilations differ per stage: {per_stage}; "
            "VocoderConfig models one schedule for all stages")

    finals = [n for n in model.nodes if n.op_type == "Conv"
              and int(wshape(n)[0]) == 1]
    if len(finals) != 1:
        raise OnnxConversionError(
            f"general upsampler needs exactly one 1-channel output Conv, "
            f"found {len(finals)}")
    return dataclasses.replace(
        cfg,
        upsample_factors=tuple(strides),
        upsample_kernels=tuple(kernels),
        upsample_pads=pads,
        upsample_channels=chans,
        resblock_kernel=kr if kr is not None else cfg.resblock_kernel,
        resblock_dilations=dil0,
        final_conv_kernel=int(wshape(finals[0])[-1]),
        activation=act,
    )


def _structural_vocoder_sd(model, cfg) -> Dict[str, np.ndarray]:
    """Anonymous-initializer fallback: recover the torch-name state dict by
    walking the graph in topological order and classifying each weighted op
    (Gather -> codebooks, Conv -> pre/post by channel+kernel, MatMul/Gemm
    grouped 7-per-layer, vector Mul -> rms norms, ConvTranspose -> upsample
    stages). Shape checks make any deviation from the derived architecture a
    hard error, not a misassignment."""
    init = model.initializers
    prod = _producers(model)
    cache: Dict[str, Any] = {}
    # weight-norm exports compute conv weights via g*v/||v|| subgraphs; fold
    # them to constants, and skip the fold's nodes in the walk so its Mul is
    # never mistaken for an rms-norm scale vector
    wnodes = _weight_subgraph_nodes(model, prod)
    # snake activations: Muls adjacent to Sin carry per-channel alphas, not
    # rms-norm scales — anchored to their adjacent convs at the end
    snake_nodes = _snake_region(model, prod)

    def wv(node, idx=1):
        name = node.inputs[idx]
        v = _const_eval(model, name, prod, cache)
        if v is None:
            raise OnnxConversionError(
                f"{node.op_type} weight is neither an initializer nor a "
                f"foldable constant subgraph: "
                f"{_producer_chain(model, name, prod)}")
        return v

    def bias(node, n_out):
        if len(node.inputs) > 2:
            v = _const_eval(model, node.inputs[2], prod, cache)
            if v is not None:
                return v
        return np.zeros(n_out, np.float32)

    sd: Dict[str, np.ndarray] = {}
    site_of: Dict[int, Tuple[str, str]] = {}   # id(conv) -> (kind, prefix)
    runits = _residual_units(model, prod)
    res_ids = {id(c) for u in runits for c in u["convs"]}
    order = {id(n): i for i, n in enumerate(model.nodes)}
    tconv_nodes = [n for n in model.nodes if n.op_type == "ConvTranspose"]
    tpos = [order[id(n)] for n in tconv_nodes]

    if runits and not cfg.general_upsampler:
        raise OnnxConversionError(
            f"{len(runits)} residual conv units present but the config is "
            "the sequential kernel==stride family — derive the general "
            "config from the graph first (derive_vocoder_config)")

    # residual units -> per-stage conv1 (dilated) / conv2 (1x1) keys
    if cfg.general_upsampler:
        stage_units: list = [[] for _ in tconv_nodes]
        for u in sorted(runits, key=lambda u: order[id(u["add"])]):
            before = [i for i, tp in enumerate(tpos)
                      if tp < order[id(u["add"])]]
            if not before:
                raise OnnxConversionError(
                    "residual unit precedes the first ConvTranspose stage")
            stage_units[max(before)].append(u)
        n_dil = len(cfg.resblock_dilations)
        for i, units in enumerate(stage_units):
            if len(units) != n_dil:
                raise OnnxConversionError(
                    f"upsample stage {i}: {len(units)} residual units, "
                    f"configured {n_dil}")
            for j, u in enumerate(units):
                dconvs = [c for c in u["convs"] if wv(c).shape[-1] > 1]
                pconvs = [c for c in u["convs"] if wv(c).shape[-1] == 1]
                if len(dconvs) != 1 or len(pconvs) != 1:
                    raise OnnxConversionError(
                        f"upsample stage {i} unit {j}: expected one dilated "
                        f"conv + one 1x1 conv, found kernels "
                        f"{[wv(c).shape[-1] for c in u['convs']]}")
                c1, c2 = dconvs[0], pconvs[0]
                w1 = wv(c1)
                if w1.shape[-1] != cfg.resblock_kernel:
                    raise OnnxConversionError(
                        f"stage {i} unit {j}: dilated kernel "
                        f"{w1.shape[-1]} != {cfg.resblock_kernel}")
                d_got = int(c1.attrs.get("dilations", [1])[0])
                if d_got != cfg.resblock_dilations[j]:
                    raise OnnxConversionError(
                        f"stage {i} unit {j}: dilation {d_got} != "
                        f"{cfg.resblock_dilations[j]}")
                rp = f"decoder.upsample.{i}.res.{j}"
                sd[rp + ".conv1.weight"] = w1
                sd[rp + ".conv1.bias"] = bias(c1, w1.shape[0])
                w2 = wv(c2)
                sd[rp + ".conv2.weight"] = w2
                sd[rp + ".conv2.bias"] = bias(c2, w2.shape[0])
                site_of[id(c1)] = ("res1", rp)
                site_of[id(c2)] = ("res2", rp)

    books, mats, muls64, muls_h, tconv_i = [], [], [], [], 0
    for node in model.nodes:
        op = node.op_type
        if id(node) in wnodes:
            continue
        if op == "Gather" and node.inputs and node.inputs[0] in init:
            t = np.asarray(init[node.inputs[0]], np.float32)
            books.extend(t if t.ndim == 3 else [t])
        elif op == "Conv":
            if id(node) in res_ids:
                continue                         # mapped with its unit above
            cw = wv(node)
            cb = bias(node, cw.shape[0])
            if cfg.general_upsampler and cw.shape[0] == 1:
                key, want_k = "decoder.final_conv", cfg.final_conv_kernel
            elif cw.shape[1] == cfg.embed_dim:
                key, want_k = "decoder.pre_conv", cfg.pre_conv_kernel
            elif "decoder.post_conv1.weight" not in sd:
                key, want_k = "decoder.post_conv1", 2 * cfg.lookahead + 1
            else:
                key, want_k = "decoder.post_conv2", cfg.post_conv_kernel
            if cw.shape[-1] != want_k:
                raise OnnxConversionError(
                    f"{key}: Conv weight {cw.shape} has kernel "
                    f"{cw.shape[-1]}, derived {want_k}")
            sd[key + ".weight"], sd[key + ".bias"] = cw, cb
            site_of[id(node)] = ("post", key)
        elif op == "ConvTranspose":
            key = f"decoder.upsample.{tconv_i}"
            cw = wv(node)
            if cfg.general_upsampler \
                    and cw.shape[-1] != cfg.upsample_kernels[tconv_i]:
                raise OnnxConversionError(
                    f"{key}: ConvTranspose kernel {cw.shape[-1]} != "
                    f"configured {cfg.upsample_kernels[tconv_i]}")
            sd[key + ".weight"] = cw
            sd[key + ".bias"] = bias(node, cw.shape[1])
            site_of[id(node)] = ("up", key)
            tconv_i += 1
        elif op in ("MatMul", "Gemm") and len(node.inputs) > 1:
            mv = _const_eval(model, node.inputs[1], prod, cache)
            if mv is not None and mv.ndim == 2:
                # torch layout: MatMul stores [in, out] (transpose back);
                # Gemm keeps [out, in] when transB=1
                if op == "Gemm" and node.attrs.get("transB"):
                    mats.append(mv)
                else:
                    mats.append(np.ascontiguousarray(mv.T))
        elif op == "Mul":
            if id(node) in snake_nodes:
                continue     # snake alphas are anchored to convs below
            for name in node.inputs:
                if name in init and init[name].ndim == 1:
                    v = np.asarray(init[name], np.float32)
                    if v.size == cfg.head_dim:
                        muls64.append(v)
                    elif v.size == cfg.hidden:
                        muls_h.append(v)

    L = cfg.n_layers
    checks = [
        (len(books) == cfg.num_codebooks,
         f"{len(books)} codebooks != {cfg.num_codebooks}"),
        (len(mats) == 7 * L, f"{len(mats)} linears != 7*{L}"),
        (len(muls64) == 2 * L,
         f"{len(muls64)} head-dim norm vectors != 2*{L} (q_norm,k_norm)"),
        (len(muls_h) == 2 * L + 1,
         f"{len(muls_h)} hidden norm vectors != 2*{L}+1 (ln1,ln2,final)"),
        (tconv_i == len(cfg.upsample_factors),
         f"{tconv_i} ConvTranspose != {len(cfg.upsample_factors)}"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise OnnxConversionError(
            "structural mapping failed: " + "; ".join(bad))

    for q, t in enumerate(books):
        sd[f"quantizer.codebooks.{q}.weight"] = np.asarray(t, np.float32)
    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
             "mlp.down_proj")
    shapes = [(cfg.hidden, cfg.n_heads * cfg.head_dim)] * 3 + [
        (cfg.n_heads * cfg.head_dim, cfg.hidden),
        (cfg.hidden, cfg.ffn_dim), (cfg.hidden, cfg.ffn_dim),
        (cfg.ffn_dim, cfg.hidden)]
    for li in range(L):
        for j, (nm, (din, dout)) in enumerate(zip(names, shapes)):
            m = mats[7 * li + j]
            if m.shape != (dout, din):     # torch layout [out, in]
                raise OnnxConversionError(
                    f"layer {li} {nm}: weight {m.shape} != {(dout, din)} — "
                    "linear order differs from q,k,v,o,gate,up,down")
            sd[f"decoder.layers.{li}.{nm}.weight"] = m
        sd[f"decoder.layers.{li}.self_attn.q_norm.weight"] = muls64[2 * li]
        sd[f"decoder.layers.{li}.self_attn.k_norm.weight"] = \
            muls64[2 * li + 1]
        sd[f"decoder.layers.{li}.input_layernorm.weight"] = muls_h[2 * li]
        sd[f"decoder.layers.{li}.post_attention_layernorm.weight"] = \
            muls_h[2 * li + 1]
    sd["decoder.norm.weight"] = muls_h[2 * L]

    if getattr(cfg, "activation", "gelu") == "snake":
        # anchor each alpha to its adjacent conv (pre-activation: the conv
        # consuming the snake's output; post-activation: the conv producing
        # its input) instead of relying on global node order, which silently
        # swaps same-sized alphas when the export emits them out of band
        uses = _consumers(model)
        assigned: Dict[str, str] = {}
        for alpha, _mul, producer, consumer in _snake_sites(model, prod,
                                                            uses):
            akey = exp_size = None
            if cfg.general_upsampler and consumer is not None \
                    and id(consumer) in site_of:
                kind, key = site_of[id(consumer)]
                if kind == "up":        # pre-act of a ConvTranspose stage
                    akey = key + ".alpha"
                    exp_size = sd[key + ".weight"].shape[0]   # C_in (IOH)
                elif kind == "res1":
                    akey = key + ".alpha1"
                    exp_size = sd[key + ".conv1.weight"].shape[1]
                elif kind == "res2":
                    akey = key + ".alpha2"
                    exp_size = sd[key + ".conv2.weight"].shape[1]
                else:                   # the 1-channel output conv
                    akey = key + ".alpha"
                    exp_size = sd[key + ".weight"].shape[1]
            elif producer is not None and id(producer) in site_of:
                kind, key = site_of[id(producer)]
                akey = key + ".alpha"
                exp_size = (sd[key + ".weight"].shape[1] if kind == "up"
                            else sd[key + ".weight"].shape[0])
            if akey is None:
                raise OnnxConversionError(
                    f"snake alpha {alpha!r} has no adjacent conv anchor "
                    "(neither its input's producer nor its output's "
                    "consumer is a mapped Conv/ConvTranspose)")
            if akey in assigned:
                raise OnnxConversionError(
                    f"two snake alphas anchor to {akey}: "
                    f"{assigned[akey]!r} and {alpha!r}")
            v = np.asarray(init[alpha], np.float32)
            if v.size != exp_size:
                raise OnnxConversionError(
                    f"{akey}: alpha size {v.size} != site channels "
                    f"{exp_size}")
            assigned[akey] = alpha
            sd[akey] = v
        want_alphas = [k for k in _expected_vocoder_keys(cfg)
                       if k.rsplit(".", 1)[-1].startswith("alpha")]
        missing = [k for k in want_alphas if k not in sd]
        if missing:
            raise OnnxConversionError(
                f"snake: {len(missing)} alpha site(s) unanchored: "
                f"{missing[:6]}")
    return sd


def convert_vocoder_onnx(path: str, cfg=None, force: bool = False,
                         return_cfg: bool = False):
    """`qwen3_tts_decoder.onnx` -> models/vocoder.py pytree.

    Validates the graph against the derived architecture first (every
    mismatch is reported; fatal unless `force`), then maps initializers by
    preserved torch names when possible, structurally otherwise. A graph in
    the BigVGAN/DAC upsampler family (kernel != stride ConvTranspose,
    residual dilated units, snake) auto-upgrades the config via
    derive_vocoder_config; pass `return_cfg=True` to get (params, cfg) —
    the caller needs the derived cfg to run models/vocoder.decode.
    """
    cfg = cfg or VocoderConfig()
    model = onnx_mod.read_model(path)
    if not cfg.general_upsampler:
        # the graph, not the caller, knows its upsampler family
        try:
            derived = derive_vocoder_config(model, cfg)
        except OnnxConversionError as e:
            print(f"  [..] family derivation inconclusive ({e}); keeping "
                  f"the configured family", file=sys.stderr)
            derived = cfg
        if derived != cfg:
            print(f"  [..] graph is in the "
                  f"{'general (BigVGAN/DAC)' if derived.general_upsampler else 'sequential'}"
                  f" upsampler family: kernels="
                  f"{derived.upsample_kernels}, resblock_dilations="
                  f"{derived.resblock_dilations}, activation="
                  f"{derived.activation} — converting with the derived "
                  f"config", file=sys.stderr)
            cfg = derived
    report = validate_vocoder_onnx(model, cfg)
    bad = {k: v for k, v in report.items()
           if not v.startswith("verified")}
    for k, v in sorted(report.items()):
        print(f"  [{'ok' if v.startswith('verified') else '!!'}] {k}: {v}",
              file=sys.stderr)
    if bad and not force:
        raise OnnxConversionError(
            f"{path}: graph contradicts the derived architecture "
            f"({sorted(bad)}); re-run with --force to convert anyway")

    expected = _expected_vocoder_keys(cfg)
    sd = sd_from_onnx(model, expected)
    if not all(k in sd for k in expected):
        try:
            sd = _structural_vocoder_sd(model, cfg)
        except OnnxConversionError as e:
            # map or precisely explain: classify every initializer's
            # consumer subgraph in the failure message
            diag = explain_unmapped(model, set())
            interesting = [d for d in diag if d[2] != "unclassified"]
            listing = "; ".join(f"{n}{list(s)}: {g}"
                                for n, s, g in (interesting or diag)[:10])
            raise OnnxConversionError(
                f"{e} | per-initializer diagnosis: {listing}") from None
    params = convert_vocoder_state_dict(sd, cfg)
    return (params, cfg) if return_cfg else params


def _structural_encoder_sd(model, kind: str, cfg) -> Dict[str, np.ndarray]:
    """Anonymous-initializer fallback for the encoder graphs: classify
    every weighted op by shape + consumer (strided Conv -> down/subsample
    stages, MatMul grouped 7-per-layer for the bidirectional stack, shape-
    distinguished tail projections, Gather/distance-MatMul codebooks,
    1-D hidden Muls -> norms). Mirrors _structural_vocoder_sd."""
    init = model.initializers
    prod = _producers(model)
    uses = _consumers(model)
    cache: Dict[str, Any] = {}
    wnodes = _weight_subgraph_nodes(model, prod)

    def wv(node, idx=1):
        v = _const_eval(model, node.inputs[idx], prod, cache)
        if v is None:
            raise OnnxConversionError(
                f"{node.op_type} weight is neither an initializer nor a "
                f"foldable constant subgraph: "
                f"{_producer_chain(model, node.inputs[idx], prod)}")
        return v

    def bias_of(node, n_out):
        if len(node.inputs) > 2:
            v = _const_eval(model, node.inputs[2], prod, cache)
            if v is not None:
                return v
        # torch exports often split the bias into a following Add
        for c, _ in uses.get(node.outputs[0], ()):
            if c.op_type == "Add":
                for name in c.inputs:
                    v = init.get(name)
                    if v is not None and v.ndim == 1 and v.size == n_out:
                        return np.asarray(v, np.float32)
        return np.zeros(n_out, np.float32)

    H, L = cfg.hidden, cfg.n_layers
    factors = (cfg.downsample_factors if kind == "audio"
               else cfg.subsample_factors)
    stage_prefix = ("encoder.downsample" if kind == "audio"
                    else "encoder.subsample")

    sd: Dict[str, np.ndarray] = {}
    convs, mats, mat_nodes, muls_h, books = [], [], [], [], []
    for node in model.nodes:
        if id(node) in wnodes:
            continue
        op = node.op_type
        if op == "Conv":
            convs.append(node)
        elif op == "Gather" and node.inputs and node.inputs[0] in init:
            t = np.asarray(init[node.inputs[0]], np.float32)
            if t.ndim == 3:
                books.extend(t)
            elif t.ndim == 2 and t.shape[0] == cfg.code_vocab:
                books.append(t)
        elif op in ("MatMul", "Gemm") and len(node.inputs) > 1:
            mv = _const_eval(model, node.inputs[1], prod, cache)
            if mv is not None and mv.ndim == 2:
                m = (mv if op == "Gemm" and node.attrs.get("transB")
                     else np.ascontiguousarray(mv.T))   # torch [out, in]
                mats.append(m)
                mat_nodes.append(node)
        elif op == "Mul":
            for name in node.inputs:
                v = init.get(name)
                if v is not None and v.ndim == 1 and v.size == H:
                    muls_h.append(np.asarray(v, np.float32))

    if len(convs) != len(factors):
        raise OnnxConversionError(
            f"{kind} encoder: {len(convs)} strided Conv stages, derived "
            f"{len(factors)} ({factors})")
    for i, (node, s) in enumerate(zip(convs, factors)):
        cw_ = wv(node)
        if cw_.shape[-1] != s or node.attrs.get("strides", [s])[0] != s:
            raise OnnxConversionError(
                f"{stage_prefix}.{i}: Conv kernel/stride "
                f"{cw_.shape[-1]}/{node.attrs.get('strides')}, derived "
                f"kernel == stride == {s}")
        sd[f"{stage_prefix}.{i}.weight"] = cw_
        sd[f"{stage_prefix}.{i}.bias"] = bias_of(node, cw_.shape[0])

    # tail projections are shape-distinguished from the 7-per-layer stack
    nhd = cfg.n_heads * cfg.head_dim
    if kind == "audio":
        tails = {"encoder.latent_proj": (cfg.latent_dim, H)}
        # codebook distance MatMuls ([latent, code_vocab] constants) are
        # neither stack nor tail weights
        drop_shapes = {(cfg.code_vocab, cfg.latent_dim)}
    else:
        tails = {"pooling.attention": (1, H),
                 "projection": (cfg.out_dim, 2 * H)}
        drop_shapes = set()
    stack_mats, stack_nodes, mm_books = [], [], []
    tail_found: Dict[str, Tuple[np.ndarray, Any]] = {}
    for m, node in zip(mats, mat_nodes):
        shape = tuple(m.shape)
        hit = next((k for k, s_ in tails.items()
                    if s_ == shape and k not in tail_found), None)
        if hit:
            tail_found[hit] = (m, node)
        elif shape in drop_shapes:
            # distance MatMul against codebook_q^T: the torch-layout
            # constant [code_vocab, latent_dim] IS the codebook — the
            # fallback source when no Gather carries the tables
            mm_books.append(m)
        elif shape in {(nhd, H), (H, nhd), (cfg.ffn_dim, H),
                       (H, cfg.ffn_dim)}:
            stack_mats.append(m)
            stack_nodes.append(node)
    if kind == "audio" and not books and mm_books:
        books = mm_books
    missing_tails = [k for k in tails if k not in tail_found]
    if missing_tails:
        raise OnnxConversionError(
            f"{kind} encoder: tail projection(s) {missing_tails} with "
            f"shapes {[tails[k] for k in missing_tails]} not found among "
            f"{[tuple(m.shape) for m in mats]}")
    if len(stack_mats) != 7 * L:
        raise OnnxConversionError(
            f"{kind} encoder: {len(stack_mats)} stack linears != 7*{L} "
            "(q,k,v,o,gate,up,down per layer)")
    if len(muls_h) != 2 * L + 1:
        raise OnnxConversionError(
            f"{kind} encoder: {len(muls_h)} hidden norm vectors != "
            f"2*{L}+1 (ln1,ln2,final)")

    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
             "mlp.down_proj")
    shapes = [(nhd, H)] * 3 + [(H, nhd), (cfg.ffn_dim, H),
                               (cfg.ffn_dim, H), (H, cfg.ffn_dim)]
    for li in range(L):
        for j, (nm, want) in enumerate(zip(names, shapes)):
            m = stack_mats[7 * li + j]
            if tuple(m.shape) != want:
                raise OnnxConversionError(
                    f"{kind} encoder layer {li} {nm}: weight {m.shape} != "
                    f"{want} — linear order differs from "
                    "q,k,v,o,gate,up,down")
            sd[f"encoder.layers.{li}.{nm}.weight"] = m
        sd[f"encoder.layers.{li}.input_layernorm.weight"] = muls_h[2 * li]
        sd[f"encoder.layers.{li}.post_attention_layernorm.weight"] = \
            muls_h[2 * li + 1]
    sd["encoder.norm.weight"] = muls_h[2 * L]

    for key, (m, node) in tail_found.items():
        sd[key + ".weight"] = m
        sd[key + ".bias"] = bias_of(node, m.shape[0])
    if kind == "speaker":
        sd.pop("pooling.attention.bias", None)   # attn pooling has no bias
    if kind == "audio":
        if len(books) != cfg.num_codebooks:
            raise OnnxConversionError(
                f"audio encoder: {len(books)} RVQ codebooks != "
                f"{cfg.num_codebooks}")
        for q, t in enumerate(books):
            sd[f"quantizer.codebooks.{q}.weight"] = np.asarray(t,
                                                               np.float32)
    return sd


def write_encoder_onnx(path: str, params: Dict[str, Any], kind: str,
                       cfg=None, anonymize: bool = False) -> None:
    """Synthesize a torch-idiom encoder graph (node skeleton + IO contract
    of the reference's encoder ONNX files, src/models/onnx.rs:97-163) —
    fixture generator for the named and structural converter paths.
    `params` may hold tensors (on any device)."""
    if cfg is None:
        cfg = AudioEncoderConfig() if kind == "audio" \
            else SpeakerEncoderConfig()
    exp = (enc.export_audio_encoder_state_dict if kind == "audio"
           else enc.export_speaker_encoder_state_dict)
    sd = exp(params, cfg)
    init: Dict[str, np.ndarray] = {}
    nodes: list = []
    counter = [0]

    def iname(torch_name):
        if not anonymize:
            return torch_name
        counter[0] += 1
        return f"onnx::W_{counter[0]}"

    def vname():
        counter[0] += 1
        return f"v_{counter[0]}"

    def matmul(x, torch_key, bias_key=None):
        n = iname(torch_key + ".weight")
        init[n] = np.ascontiguousarray(
            np.asarray(sd[torch_key + ".weight"], np.float32).T)
        out = vname()
        nodes.append(onnx_mod.OnnxNode("MatMul", [x, n], [out]))
        if bias_key:
            bn = iname(bias_key)
            init[bn] = np.asarray(sd[bias_key], np.float32)
            out2 = vname()
            nodes.append(onnx_mod.OnnxNode("Add", [out, bn], [out2]))
            return out2
        return out

    def vec_mul(x, torch_key):
        n = iname(torch_key)
        init[n] = np.asarray(sd[torch_key], np.float32)
        out = vname()
        nodes.append(onnx_mod.OnnxNode("Mul", [x, n], [out]))
        return out

    def conv(x, torch_key, stride):
        w = np.asarray(sd[torch_key + ".weight"], np.float32)
        wn, bn = iname(torch_key + ".weight"), iname(torch_key + ".bias")
        init[wn] = w
        init[bn] = np.asarray(sd[torch_key + ".bias"], np.float32)
        out, g = vname(), vname()
        nodes.append(onnx_mod.OnnxNode(
            "Conv", [x, wn, bn], [out],
            attrs={"kernel_shape": [int(w.shape[-1])],
                   "strides": [int(stride)]}))
        nodes.append(onnx_mod.OnnxNode("Gelu", [out], [g]))
        return g

    x = "input_values" if kind == "audio" else "mels"
    factors = (cfg.downsample_factors if kind == "audio"
               else cfg.subsample_factors)
    prefix = ("encoder.downsample" if kind == "audio"
              else "encoder.subsample")
    for i, s in enumerate(factors):
        x = conv(x, f"{prefix}.{i}", s)

    for li in range(cfg.n_layers):
        p = f"encoder.layers.{li}."
        h = vec_mul(x, p + "input_layernorm.weight")
        q = matmul(h, p + "self_attn.q_proj")
        k = matmul(h, p + "self_attn.k_proj")
        v = matmul(h, p + "self_attn.v_proj")
        sc, sm, av = vname(), vname(), vname()
        nodes.append(onnx_mod.OnnxNode("MatMul", [q, k], [sc]))
        nodes.append(onnx_mod.OnnxNode("Softmax", [sc], [sm]))
        nodes.append(onnx_mod.OnnxNode("MatMul", [sm, v], [av]))
        o = matmul(av, p + "self_attn.o_proj")
        r1 = vname()
        nodes.append(onnx_mod.OnnxNode("Add", [x, o], [r1]))
        h2 = vec_mul(r1, p + "post_attention_layernorm.weight")
        g = matmul(h2, p + "mlp.gate_proj")
        sg, gated = vname(), vname()
        nodes.append(onnx_mod.OnnxNode("Sigmoid", [g], [sg]))
        nodes.append(onnx_mod.OnnxNode("Mul", [g, sg], [gated]))
        u = matmul(h2, p + "mlp.up_proj")
        gu = vname()
        nodes.append(onnx_mod.OnnxNode("Mul", [gated, u], [gu]))
        d = matmul(gu, p + "mlp.down_proj")
        r2 = vname()
        nodes.append(onnx_mod.OnnxNode("Add", [r1, d], [r2]))
        x = r2
    x = vec_mul(x, "encoder.norm.weight")

    if kind == "audio":
        x = matmul(x, "encoder.latent_proj", "encoder.latent_proj.bias")
        # RVQ encode per codebook: distance MatMul -> ArgMax -> Gather ->
        # residual Sub (a plausible export of iterative nearest-codebook)
        residual = x
        code_outs = []
        for q in range(cfg.num_codebooks):
            bn = iname(f"quantizer.codebooks.{q}.weight")
            init[bn] = np.asarray(sd[f"quantizer.codebooks.{q}.weight"],
                                  np.float32)
            tn, dist, idx, sel, nxt = (vname() for _ in range(5))
            nodes.append(onnx_mod.OnnxNode(
                "Transpose", [bn], [tn], attrs={"perm": [1, 0]}))
            nodes.append(onnx_mod.OnnxNode("MatMul", [residual, tn],
                                           [dist]))
            nodes.append(onnx_mod.OnnxNode("ArgMax", [dist], [idx]))
            nodes.append(onnx_mod.OnnxNode("Gather", [bn, idx], [sel]))
            nodes.append(onnx_mod.OnnxNode("Sub", [residual, sel], [nxt]))
            residual = nxt
            code_outs.append(idx)
        cat = vname()
        nodes.append(onnx_mod.OnnxNode("Concat", code_outs, [cat],
                                       attrs={"axis": -1}))
        nodes.append(onnx_mod.OnnxNode("Identity", [cat], ["audio_codes"]))
        io = (("input_values", onnx_mod.FLOAT, (1, None)),
              ("audio_codes", onnx_mod.INT64,
               (1, None, cfg.num_codebooks)))
    else:
        aw = matmul(x, "pooling.attention")
        a = vname()
        nodes.append(onnx_mod.OnnxNode("Softmax", [aw], [a]))
        wsum, mean = vname(), vname()
        nodes.append(onnx_mod.OnnxNode("Mul", [a, x], [wsum]))
        nodes.append(onnx_mod.OnnxNode(
            "ReduceSum", [wsum], [mean], attrs={"axes": [1]}))
        dev, sq, var, std, cat = (vname() for _ in range(5))
        nodes.append(onnx_mod.OnnxNode("Sub", [x, mean], [dev]))
        nodes.append(onnx_mod.OnnxNode("Mul", [dev, dev], [sq]))
        nodes.append(onnx_mod.OnnxNode(
            "ReduceSum", [sq], [var], attrs={"axes": [1]}))
        nodes.append(onnx_mod.OnnxNode("Sqrt", [var], [std]))
        nodes.append(onnx_mod.OnnxNode("Concat", [mean, std], [cat],
                                       attrs={"axis": -1}))
        out = matmul(cat, "projection", "projection.bias")
        nodes.append(onnx_mod.OnnxNode("Identity", [out], ["spk_emb"]))
        io = (("mels", onnx_mod.FLOAT, (1, None, cfg.n_mels)),
              ("spk_emb", onnx_mod.FLOAT, (1, cfg.out_dim)))
    onnx_mod.write_model(path, init, nodes, inputs=[io[0]],
                         outputs=[io[1]],
                         graph_name=f"qwen3_tts_{kind}_encoder")


def convert_encoder_onnx(path: str, kind: str, cfg=None) -> Dict[str, Any]:
    """Codec/speaker encoder ONNX -> pytree: preserved torch names when
    possible, structural (shape + consumer-op) mapping otherwise."""
    cfg = cfg or (AudioEncoderConfig() if kind == "audio"
                  else SpeakerEncoderConfig())
    model = onnx_mod.read_model(path)
    ins = [n for n, _, _ in model.inputs]
    outs = [n for n, _, _ in model.outputs]
    want_in, want_out = (("input_values", "audio_codes")
                         if kind == "audio" else ("mels", "spk_emb"))
    if want_in not in ins or want_out not in outs:
        raise OnnxConversionError(
            f"{path}: expected I/O {want_in!r}->{want_out!r} "
            f"(src/models/onnx.rs:97-163), graph has {ins}->{outs}")
    conv = (enc.convert_audio_encoder_state_dict if kind == "audio"
            else enc.convert_speaker_encoder_state_dict)
    exp = (enc.export_audio_encoder_state_dict if kind == "audio"
           else enc.export_speaker_encoder_state_dict)
    init = (enc.init_audio_encoder if kind == "audio"
            else enc.init_speaker_encoder)
    expected = list(exp(_zeros_like(init(None, cfg, device="meta")), cfg))
    sd = sd_from_onnx(model, expected)
    if not all(k in sd for k in expected):
        try:
            sd = _structural_encoder_sd(model, kind, cfg)
        except OnnxConversionError as e:
            missing = [k for k in expected if k not in sd]
            raise OnnxConversionError(
                f"{path}: initializers are anonymized or renamed; the "
                f"structural mapper also failed: {e}. Name map missed "
                f"{len(missing)} tensors (first: {missing[:4]}); graph "
                f"initializers: {sorted(model.initializers)[:12]}...") \
                from None
    return conv(sd, cfg)


def write_vocoder_onnx(path: str, params: Dict[str, Any], cfg=None,
                       anonymize: bool = False) -> None:
    """Write a vocoder pytree as an ONNX graph in the torch-export idiom
    (same node skeleton / initializer layout / IO contract as the reference's
    `qwen3_tts_decoder.onnx`, src/models/onnx.rs:342-496). Fixture generator
    for round-trip tests of both converter paths: named (torch parameter
    names preserved) and `anonymize=True` (`onnx::MatMul_N`-style names,
    MatMul weights stored transposed — exercising the structural mapper).
    `params` may hold tensors (on any device)."""
    cfg = cfg or VocoderConfig()
    sd = export_vocoder_state_dict(params, cfg)
    L, H = cfg.n_layers, cfg.hidden

    init: Dict[str, np.ndarray] = {}
    nodes: list = []
    counter = [0]

    def iname(torch_name):
        if not anonymize:
            return torch_name
        counter[0] += 1
        return f"onnx::W_{counter[0]}"

    def vname():
        counter[0] += 1
        return f"v_{counter[0]}"

    def matmul(x, torch_key):
        w = sd[torch_key]                       # torch layout [out, in]
        n = iname(torch_key)
        init[n] = np.ascontiguousarray(np.asarray(w, np.float32).T)
        out = vname()
        nodes.append(onnx_mod.OnnxNode("MatMul", [x, n], [out]))
        return out

    def vec_mul(x, torch_key):
        n = iname(torch_key)
        init[n] = np.asarray(sd[torch_key], np.float32)
        out = vname()
        nodes.append(onnx_mod.OnnxNode("Mul", [x, n], [out]))
        return out

    def snake(x, akey):
        """Emit the snake subgraph x + sin^2(alpha*x)/alpha when the
        params carry an alpha at this site (cfg.activation == 'snake');
        `akey` is the full state-dict alpha key."""
        if akey not in sd:
            return x
        an = iname(akey)
        init[an] = np.asarray(sd[akey], np.float32)
        ax, sn, sq, dv, out = (vname() for _ in range(5))
        nodes.append(onnx_mod.OnnxNode("Mul", [x, an], [ax]))
        nodes.append(onnx_mod.OnnxNode("Sin", [ax], [sn]))
        nodes.append(onnx_mod.OnnxNode("Mul", [sn, sn], [sq]))
        nodes.append(onnx_mod.OnnxNode("Div", [sq, an], [dv]))
        nodes.append(onnx_mod.OnnxNode("Add", [x, dv], [out]))
        return out

    def conv(x, torch_key, op="Conv", strides=None, pads=None,
             dilations=None):
        w = np.asarray(sd[torch_key + ".weight"], np.float32)
        wn, bn = iname(torch_key + ".weight"), iname(torch_key + ".bias")
        init[wn] = w
        init[bn] = np.asarray(sd[torch_key + ".bias"], np.float32)
        out = vname()
        attrs = {"kernel_shape": [int(w.shape[-1])]}
        if strides:
            attrs["strides"] = [int(strides)]
        if pads is not None:
            attrs["pads"] = [int(pads[0]), int(pads[1])]
        if dilations is not None:
            attrs["dilations"] = [int(dilations)]
        nodes.append(onnx_mod.OnnxNode(op, [x, wn, bn], [out], attrs=attrs))
        return out

    # RVQ codebook sum
    parts = []
    for q in range(cfg.num_codebooks):
        n = iname(f"quantizer.codebooks.{q}.weight")
        init[n] = np.asarray(sd[f"quantizer.codebooks.{q}.weight"],
                             np.float32)
        out = vname()
        nodes.append(onnx_mod.OnnxNode("Gather", [n, "audio_codes"], [out]))
        parts.append(out)
    x = parts[0]
    for p in parts[1:]:
        s = vname()
        nodes.append(onnx_mod.OnnxNode("Add", [x, p], [s]))
        x = s

    cat = vname()
    nodes.append(onnx_mod.OnnxNode(
        "Concat", ["pre_conv_history", x], [cat], attrs={"axis": 2}))
    nodes.append(onnx_mod.OnnxNode(
        "Slice", [cat], ["next_pre_conv_history"]))
    x = snake(conv(cat, "decoder.pre_conv"), "decoder.pre_conv.alpha")

    for li in range(L):
        p = f"decoder.layers.{li}."
        h = vec_mul(x, p + "input_layernorm.weight")
        q = vec_mul(matmul(h, p + "self_attn.q_proj.weight"),
                    p + "self_attn.q_norm.weight")
        k = vec_mul(matmul(h, p + "self_attn.k_proj.weight"),
                    p + "self_attn.k_norm.weight")
        v = matmul(h, p + "self_attn.v_proj.weight")
        kc, vc2 = vname(), vname()
        nodes.append(onnx_mod.OnnxNode(
            "Concat", [f"past_key_{li}", k], [kc if li else f"next_key_{li}"],
            attrs={"axis": 2}))
        nodes.append(onnx_mod.OnnxNode(
            "Concat", [f"past_value_{li}", v],
            [vc2 if li else f"next_value_{li}"], attrs={"axis": 2}))
        if li:      # keep every next_* name emitted exactly once
            nodes.append(onnx_mod.OnnxNode(
                "Identity", [kc], [f"next_key_{li}"]))
            nodes.append(onnx_mod.OnnxNode(
                "Identity", [vc2], [f"next_value_{li}"]))
        sc, sm, av = vname(), vname(), vname()
        nodes.append(onnx_mod.OnnxNode(
            "MatMul", [q, f"next_key_{li}"], [sc]))
        nodes.append(onnx_mod.OnnxNode("Softmax", [sc], [sm]))
        nodes.append(onnx_mod.OnnxNode(
            "MatMul", [sm, f"next_value_{li}"], [av]))
        o = matmul(av, p + "self_attn.o_proj.weight")
        r1 = vname()
        nodes.append(onnx_mod.OnnxNode("Add", [x, o], [r1]))
        h2 = vec_mul(r1, p + "post_attention_layernorm.weight")
        g = matmul(h2, p + "mlp.gate_proj.weight")
        sg, gated = vname(), vname()
        nodes.append(onnx_mod.OnnxNode("Sigmoid", [g], [sg]))
        nodes.append(onnx_mod.OnnxNode("Mul", [g, sg], [gated]))
        u = matmul(h2, p + "mlp.up_proj.weight")
        gu = vname()
        nodes.append(onnx_mod.OnnxNode("Mul", [gated, u], [gu]))
        d = matmul(gu, p + "mlp.down_proj.weight")
        r2 = vname()
        nodes.append(onnx_mod.OnnxNode("Add", [r1, d], [r2]))
        x = r2

    x = vec_mul(x, "decoder.norm.weight")
    nodes.append(onnx_mod.OnnxNode(
        "Identity", [x], ["next_latent_buffer"]))
    cat2 = vname()
    nodes.append(onnx_mod.OnnxNode(
        "Concat", ["latent_buffer", x], [cat2], attrs={"axis": 2}))
    x = snake(conv(cat2, "decoder.post_conv1"), "decoder.post_conv1.alpha")
    cat3 = vname()
    nodes.append(onnx_mod.OnnxNode(
        "Concat", ["conv_history", x], [cat3], attrs={"axis": 2}))
    x = snake(conv(cat3, "decoder.post_conv2"), "decoder.post_conv2.alpha")
    nodes.append(onnx_mod.OnnxNode(
        "Identity", [x], ["next_conv_history"]))
    if cfg.general_upsampler:
        # DAC/BigVGAN family: act -> ConvTranspose(k != s, explicit pads)
        # -> residual dilated units; final conv -> Tanh
        pads = voc.stage_pads(cfg)
        for i, s in enumerate(cfg.upsample_factors):
            p = f"decoder.upsample.{i}"
            x = snake(x, p + ".alpha")
            x = conv(x, p, op="ConvTranspose", strides=s, pads=pads[i])
            for j, d in enumerate(cfg.resblock_dilations):
                rp = f"{p}.res.{j}"
                reach = d * (cfg.resblock_kernel - 1)
                y = snake(x, rp + ".alpha1")
                y = conv(y, rp + ".conv1", dilations=d,
                         pads=(reach // 2, reach - reach // 2))
                y = snake(y, rp + ".alpha2")
                y = conv(y, rp + ".conv2")
                r = vname()
                nodes.append(onnx_mod.OnnxNode("Add", [x, y], [r]))
                x = r
        x = snake(x, "decoder.final_conv.alpha")
        kf = cfg.final_conv_kernel
        x = conv(x, "decoder.final_conv",
                 pads=((kf - 1) // 2, kf - 1 - (kf - 1) // 2))
        t = vname()
        nodes.append(onnx_mod.OnnxNode("Tanh", [x], [t]))
        x = t
    else:
        for i, s in enumerate(cfg.upsample_factors):
            x = conv(x, f"decoder.upsample.{i}", op="ConvTranspose",
                     strides=s)
            x = snake(x, f"decoder.upsample.{i}.alpha")
    nodes.append(onnx_mod.OnnxNode("Identity", [x], ["final_wav"]))
    nodes.append(onnx_mod.OnnxNode(
        "Shape", [x], ["valid_samples"]))

    F = onnx_mod.FLOAT
    inputs = [("audio_codes", onnx_mod.INT64, (1, None, cfg.num_codebooks)),
              ("is_last", F, (1,)),
              ("pre_conv_history", F, (1, cfg.embed_dim, None)),
              ("latent_buffer", F, (1, H, None)),
              ("conv_history", F, (1, H, None))]
    outputs = [("final_wav", F, (1, None)),
               ("valid_samples", onnx_mod.INT64, (1,)),
               ("next_pre_conv_history", F, (1, cfg.embed_dim, None)),
               ("next_latent_buffer", F, (1, H, None)),
               ("next_conv_history", F, (1, H, None))]
    for i in range(L):
        inputs += [(f"past_key_{i}", F, (1, cfg.n_heads, None, cfg.head_dim)),
                   (f"past_value_{i}", F,
                    (1, cfg.n_heads, None, cfg.head_dim))]
        outputs += [(f"next_key_{i}", F,
                     (1, cfg.n_heads, None, cfg.head_dim)),
                    (f"next_value_{i}", F,
                     (1, cfg.n_heads, None, cfg.head_dim))]
    onnx_mod.write_model(path, init, nodes, inputs, outputs,
                         graph_name="qwen3_tts_decoder")


def convert_torch_state_dict(state_dict: Dict[str, "np.ndarray"],
                             name_map: Dict[str, str]) -> Dict[str, Any]:
    """Generic torch-export hook: flat {torch_name: tensor} + {torch_name:
    'tree/path'} -> nested numpy tree for checkpoint.save_tree."""
    out: Dict[str, Any] = {}
    for tname, path in name_map.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(state_dict[tname])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.convert_weights",
        description="Convert the reference's release (llama.cpp GGUFs, "
                    "ONNX graphs or torch state dicts) into a directory "
                    "TtsEngine(model_dir=...) loads.")
    ap.add_argument("--talker", help="qwen3_tts_talker.gguf")
    ap.add_argument("--predictor", help="qwen3_tts_predictor.gguf")
    ap.add_argument("--vocoder",
                    help="qwen3_tts_decoder.onnx, or .npz of the "
                         "codec-decoder torch state dict")
    ap.add_argument("--audio-encoder",
                    help="qwen3_tts_codec_encoder.onnx or .npz state dict")
    ap.add_argument("--speaker-encoder",
                    help="qwen3_tts_speaker_encoder.onnx or .npz state dict")
    ap.add_argument("--force", action="store_true",
                    help="convert even when the ONNX graph contradicts the "
                         "derived architecture (mismatches are printed)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for kind, path in (("talker", args.talker), ("predictor", args.predictor)):
        if not path:
            continue
        cfg, params = convert_llama_gguf(path, kind)
        out_path = os.path.join(args.out, f"{kind}.npz")
        checkpoint.save_tree(out_path, params)
        print(f"{kind}: {path} -> {out_path}  ({cfg})")

    def _convert_sd(path, converter, out_name):
        sd = dict(np.load(path))
        try:
            params = converter(sd)
        except KeyError as e:
            got = "\n  ".join(sorted(sd))
            print(f"{out_name}: missing tensor {e}.\nState dict contains:"
                  f"\n  {got}\nAdjust the name map in qwen3_tts_tpu_torch/"
                  f"tools/convert_weights.py to match.", file=sys.stderr)
            raise SystemExit(2)
        out_path = os.path.join(args.out, out_name)
        checkpoint.save_tree(out_path, params)
        print(f"{out_name[:-4]}: {path} -> {out_path}")

    def _convert_onnx(path, converter, out_name, **kw):
        params = converter(path, **kw)
        out_path = os.path.join(args.out, out_name)
        checkpoint.save_tree(out_path, params)
        print(f"{out_name[:-4]}: {path} -> {out_path}")

    if args.vocoder:
        if args.vocoder.endswith(".onnx"):
            params, vcfg = convert_vocoder_onnx(args.vocoder,
                                                force=args.force,
                                                return_cfg=True)
            out_path = os.path.join(args.out, "vocoder.npz")
            checkpoint.save_tree(out_path, params)
            # persist the (possibly graph-derived) architecture so the
            # engine deserializes the npz against the right config — this
            # is what makes a BigVGAN/DAC-family release actually servable
            save_vocoder_config(os.path.join(args.out,
                                             "vocoder_config.json"), vcfg)
            print(f"vocoder: {args.vocoder} -> {out_path} "
                  f"(family={'general' if vcfg.general_upsampler else 'sequential'},"
                  f" activation={vcfg.activation})")
        else:
            _convert_sd(args.vocoder, convert_vocoder_state_dict,
                        "vocoder.npz")
    if args.audio_encoder:
        if args.audio_encoder.endswith(".onnx"):
            _convert_onnx(args.audio_encoder,
                          lambda p: convert_encoder_onnx(p, "audio"),
                          "audio_encoder.npz")
        else:
            _convert_sd(args.audio_encoder,
                        enc.convert_audio_encoder_state_dict,
                        "audio_encoder.npz")
    if args.speaker_encoder:
        if args.speaker_encoder.endswith(".onnx"):
            _convert_onnx(args.speaker_encoder,
                          lambda p: convert_encoder_onnx(p, "speaker"),
                          "speaker_encoder.npz")
        else:
            _convert_sd(args.speaker_encoder,
                        enc.convert_speaker_encoder_state_dict,
                        "speaker_encoder.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
