"""The port's ONNX ingestion against the JAX package's, on the CPU.

`qwen3_tts_tpu_torch/assets/onnx.py` (the protobuf reader and writer) and
`qwen3_tts_tpu_torch/tools/convert_weights.py` (the vocoder and encoder
converters, `main`) are held to `qwen3_tts_tpu/assets/onnx.py` and
`tools/convert_weights.py` on the same inputs, made from numpy seeds:

  * the wire format: written bytes equal, each reader reads the other's
    file, the refusals raise with the JAX package's messages;
  * the vocoder, both upsampler families, gelu and snake, named and
    anonymized initializers, the weight-norm fold, torch state dicts: the
    port's conversion of a graph the JAX tool wrote equals the JAX tool's
    leaf for leaf, and both equal the tree written (the weight-norm fold:
    rtol 1e-6, it recomputes g * v / ||v||); the port's written graph
    equals the JAX tool's byte for byte; the validation reports, derived
    configs, unmapped-initializer lists and the errors on broken graphs
    equal;
  * the audio and speaker encoders the same way, and the six state-dict
    functions of `models/encoders.py`;
  * `main` end to end on one directory of raw artifacts (llama GGUFs, the
    decoder and encoder graphs): equal `.npz` arrays and
    `vocoder_config.json`; the port's engine on its output against the
    JAX engine on JAX's: greedy codes equal, the waveform within rtol
    1e-5 / atol 1e-6 and 1e-5 of its peak, the clone voice's codes equal
    and its speaker embedding within atol 1e-5 (f32 FFTs of two
    libraries, as tests/test_torch_clone.py holds it).

Two configs: the tiny one, and WIDE, narrow but with every shape
collision of `EngineConfig()`: hidden == heads x head_dim (the trunk's q,
k, v and o all square, told apart by graph order alone), ffn == 4 x
hidden, embed_dim == hidden / 2, and in the general family snake alphas
as wide as hidden, embed_dim and head_dim.
"""

import dataclasses
import filecmp
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import convert_weights as jcw  # noqa: E402
import qwen3_tts_tpu as J  # noqa: E402
from qwen3_tts_tpu.assets import llama_gguf as jllama  # noqa: E402
from qwen3_tts_tpu.assets import onnx as jonnx  # noqa: E402
from qwen3_tts_tpu.core import config as jconfig  # noqa: E402
from qwen3_tts_tpu.models import encoders as jenc  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.tts import generate as jgenerate  # noqa: E402
import qwen3_tts_tpu_torch as T  # noqa: E402
from qwen3_tts_tpu_torch.assets import checkpoint as tcheckpoint  # noqa: E402
from qwen3_tts_tpu_torch.assets import onnx as tonnx  # noqa: E402
from qwen3_tts_tpu_torch.core import config as tconfig  # noqa: E402
from qwen3_tts_tpu_torch.models import encoders as tenc  # noqa: E402
from qwen3_tts_tpu_torch.tools import convert_weights as tcw  # noqa: E402
from qwen3_tts_tpu_torch.tts import generate as tgenerate  # noqa: E402
from qwen3_tts_tpu_torch.utils.audio import AudioSample  # noqa: E402

TINY = jconfig.tiny_engine_config()
WIDE = dataclasses.replace(
    TINY,
    vocoder=dataclasses.replace(TINY.vocoder, embed_dim=64, hidden=128,
                                n_heads=4, head_dim=32, ffn_dim=512),
    audio_encoder=dataclasses.replace(TINY.audio_encoder, hidden=128,
                                      latent_dim=64, n_heads=4, head_dim=32,
                                      ffn_dim=512),
    speaker_encoder=dataclasses.replace(TINY.speaker_encoder, hidden=128,
                                        n_heads=4, head_dim=32, ffn_dim=512))
CONFIGS = {"tiny": TINY, "wide": WIDE}
WAV_RTOL, WAV_ATOL, WAV_PEAK = 1e-5, 1e-6, 1e-5


def _vocoder_cfg(size, family="seq", activation="gelu"):
    cfg = dataclasses.replace(CONFIGS[size].vocoder, activation=activation)
    if family == "general":
        cfg = dataclasses.replace(cfg, upsample_kernels=(10, 10, 10, 8, 8),
                                  resblock_dilations=(1, 3),
                                  resblock_kernel=7, final_conv_kernel=7)
    return cfg


def _random_tree(skeleton, seed, zero=()):
    """numpy f32 leaves with the shapes of `skeleton`'s (the port's meta
    tree, whose paths are the JAX package's), N(0, 0.05), alphas in
    [0.5, 1.5), the keys in `zero` zeroed."""
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        shape = tuple(node.shape)
        if name in zero:
            return np.zeros(shape, np.float32)
        if name.startswith("alpha"):
            return (0.5 + rng.random(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return fill(skeleton)


def _vocoder_params(cfg, seed=0):
    # the decoder's unused head slot is not in the state dict (nor the
    # graph): zero, so a round trip is exact; the matmul upsampler's bias
    # is one C_out bias tiled over the stride
    p = _random_tree(tcw.voc.init_vocoder(None, _tc(cfg), device="meta"),
                     seed, zero=("head",))
    if not cfg.general_upsampler:
        for st, s in zip(p["up"], cfg.upsample_factors):
            st["b"] = np.tile(st["b"][:len(st["b"]) // s], s)
    return p


def _encoder_params(kind, cfg, seed=0):
    init = tenc.init_audio_encoder if kind == "audio" \
        else tenc.init_speaker_encoder
    return _random_tree(init(None, _tc(cfg), device="meta"), seed)


def _encoder_cfg(kind, size):
    return CONFIGS[size].audio_encoder if kind == "audio" \
        else CONFIGS[size].speaker_encoder


def _tc(cfg):
    """The port's twin of one of the JAX package's config dataclasses."""
    if cfg is None:
        return None
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _leaves(tree):
    """(path, numpy leaf) in the JAX package's order (sorted dict keys)."""
    return [(k, np.asarray(v)) for k, v in tcheckpoint.flatten(tree)]


def assert_trees_equal(got, want):
    """Bit for bit: the same paths, shapes, dtypes and values."""
    got, want = _leaves(got), _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_same_error(fn_port, fn_jax, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_jax()
    with pytest.raises(exc) as got:
        fn_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return str(want.value)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _rewrite(path, m):
    jonnx.write_model(path, m.initializers, m.nodes, m.inputs, m.outputs)


# ------------------------------------------------------------- wire format
def _wire_fixture():
    inits = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "i64": np.asarray([-3, 5, 2**40], np.int64),
        "f16": np.asarray([[0.5, -2.0]], np.float16),
        "i8": np.asarray([1, -7], np.int8),
        "scalar": np.float32(3.25).reshape(()),
        "transposed": np.arange(6, dtype=np.float32).reshape(2, 3).T,
    }
    attrs = {"kernel_shape": [3], "strides": [2], "alpha": 0.5,
             "mode": "reflect", "raw": b"\x00\x01", "flag": True,
             "neg": -4, "scales": [0.25, -1.5]}
    io = ([("x", 1, (1, None, 4))], [("y", 1, (1, None, 3))])
    return inits, attrs, io


def _write_wire(mod, path):
    inits, attrs, (ins, outs) = _wire_fixture()
    nodes = [mod.OnnxNode("Conv", ["x", "f32"], ["y"], name="c0",
                          attrs=dict(attrs)),
             mod.OnnxNode("Identity", ["y"], ["z"])]
    mod.write_model(path, inits, nodes, inputs=ins, outputs=outs,
                    graph_name="g")


def test_written_bytes_equal_jax(tmp_path):
    _write_wire(jonnx, str(tmp_path / "j.onnx"))
    _write_wire(tonnx, str(tmp_path / "t.onnx"))
    assert _read(tmp_path / "t.onnx") == _read(tmp_path / "j.onnx")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_reads_the_others_file(tmp_path, writer):
    path = str(tmp_path / "m.onnx")
    _write_wire(jonnx if writer == "jax" else tonnx, path)
    got, want = tonnx.read_model(path), jonnx.read_model(path)
    assert got.graph_name == want.graph_name == "g"
    assert list(got.initializers) == list(want.initializers)
    inits, attrs, _ = _wire_fixture()
    for k, w in want.initializers.items():
        g = got.initializers[k]
        assert g.dtype == w.dtype == inits[k].dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, inits[k])
    assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
            for n in got.nodes] == [(n.op_type, n.inputs, n.outputs, n.name,
                                     n.attrs) for n in want.nodes]
    assert got.nodes[0].attrs["mode"] == b"reflect"
    assert got.inputs == want.inputs and got.outputs == want.outputs
    assert got.ops() == want.ops() == {"Conv": 1, "Identity": 1}
    # what the port read, written over the file it was read from (the
    # reader's mapping is closed and its arrays are copies): the same bytes
    before = _read(path)
    tonnx.write_model(path, got.initializers, got.nodes, got.inputs,
                      got.outputs, graph_name=got.graph_name)
    assert _read(path) == before


def _tensor_field(extra: bytes, dtype_code=1, dims=(2,), raw=None):
    body = b"".join(jonnx._vi(1, d) for d in dims) + jonnx._vi(2, dtype_code)
    body += jonnx._ld(8, b"w") + extra
    if raw is not None:
        body += jonnx._ld(9, raw)
    graph = jonnx._ld(2, b"g") + jonnx._ld(5, body)
    return jonnx._vi(1, 8) + jonnx._ld(7, graph)


REFUSALS = {
    "not_onnx": b"\x99" * 64,
    "empty": b"",
    "no_graph": jonnx._vi(1, 8) + jonnx._ld(2, b"producer"),
    "external_data": _tensor_field(jonnx._ld(13, jonnx._ld(1, b"location"))),
    "external_location": _tensor_field(jonnx._vi(14, 1)),
    "bfloat16": _tensor_field(b"", dtype_code=16, raw=b"\x00" * 4),
    "size_mismatch": _tensor_field(b"", dims=(3,), raw=b"\x00" * 8),
    "truncated": _tensor_field(b"", raw=b"\x00" * 8)[:-3],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_jax_message(tmp_path, case):
    path = str(tmp_path / f"{case}.onnx")
    with open(path, "wb") as f:
        f.write(REFUSALS[case])
    assert_same_error(lambda: tonnx.read_model(path),
                      lambda: jonnx.read_model(path))


def test_write_refuses_bfloat16_as_jax(tmp_path):
    import ml_dtypes
    arr = np.zeros(3, ml_dtypes.bfloat16)
    assert_same_error(
        lambda: tonnx.write_model(str(tmp_path / "t.onnx"), {"w": arr}),
        lambda: jonnx.write_model(str(tmp_path / "j.onnx"), {"w": arr}))


# ---------------------------------------------------------------- vocoder
# the tiny config in both families; WIDE in the general one, whose trunk
# is the sequential family's and whose snake alphas collide as well
VOC_CASES = [(size, family, act, anon)
             for size, family in (("tiny", "seq"), ("tiny", "general"),
                                  ("wide", "general"))
             for act in ("gelu", "snake") for anon in (False, True)]


@pytest.mark.parametrize("size,family,act,anon", VOC_CASES)
def test_vocoder_graph_equals_jax(tmp_path, size, family, act, anon):
    """Write, validate, derive and convert one vocoder graph with both
    tools: the port's bytes equal JAX's, its conversion of JAX's graph
    equals JAX's and the tree written, under the given config and under
    the default one (the family and geometry derived from the graph)."""
    cfg = _vocoder_cfg(size, family, act)
    params = _vocoder_params(cfg, seed=1)
    pj, pt = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jcw.write_vocoder_onnx(pj, params, cfg, anonymize=anon)
    tcw.write_vocoder_onnx(pt, params, _tc(cfg), anonymize=anon)
    assert _read(pt) == _read(pj)

    report = tcw.validate_vocoder_onnx(tonnx.read_model(pj), _tc(cfg))
    assert report == jcw.validate_vocoder_onnx(jonnx.read_model(pj), cfg)
    assert all(v.startswith("verified") for v in report.values()), report

    got = tcw.convert_vocoder_onnx(pj, _tc(cfg))
    assert_trees_equal(got, jcw.convert_vocoder_onnx(pj, cfg))
    assert_trees_equal(got, params)

    derived = tcw.derive_vocoder_config(tonnx.read_model(pj))
    want = jcw.derive_vocoder_config(jonnx.read_model(pj))
    assert dataclasses.asdict(derived) == dataclasses.asdict(want)
    got2, cfg2 = tcw.convert_vocoder_onnx(pj, return_cfg=True)
    want2, jcfg2 = jcw.convert_vocoder_onnx(pj, return_cfg=True)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(dataclasses.replace(
        cfg, max_frames=cfg2.max_frames,
        upsample_pads=cfg2.upsample_pads,
        upsample_channels=cfg2.upsample_channels))
    if family == "general":
        assert cfg2.upsample_pads == tuple(
            pl for pl, _ in tcw.voc.stage_pads(_tc(cfg)))
        assert cfg2.upsample_channels == tuple(
            tcw.voc.up_channels(_tc(cfg))[1:])
    assert_trees_equal(got2, want2)
    assert_trees_equal(got2, params)


def _weight_norm_variant(m):
    """Every Conv / ConvTranspose weight W as torch weight_norm's export
    subgraph w = g * v / ||v||, v = W, g = ||W|| (tests/test_onnx.py)."""
    k = 0
    new_nodes = []
    for n in m.nodes:
        if n.op_type in ("Conv", "ConvTranspose"):
            W = np.asarray(m.initializers.pop(n.inputs[1]), np.float32)
            k += 1
            v_n, g_n = f"wn_v_{k}", f"wn_g_{k}"
            m.initializers[v_n] = W
            m.initializers[g_n] = np.sqrt(
                (W ** 2).sum(axis=(1, 2), keepdims=True))
            nn, dv, mu = f"wn_n_{k}", f"wn_d_{k}", f"wn_w_{k}"
            new_nodes += [
                jonnx.OnnxNode("ReduceL2", [v_n], [nn],
                               attrs={"axes": [1, 2], "keepdims": 1}),
                jonnx.OnnxNode("Div", [v_n, nn], [dv]),
                jonnx.OnnxNode("Mul", [dv, g_n], [mu]),
            ]
            n.inputs[1] = mu
        new_nodes.append(n)
    m.nodes[:] = new_nodes


@pytest.mark.parametrize("size,family", [("tiny", "seq"),
                                         ("wide", "general")])
def test_weight_norm_fold_equals_jax(tmp_path, size, family):
    cfg = _vocoder_cfg(size, family, "snake" if family == "general"
                       else "gelu")
    params = _vocoder_params(cfg, seed=3)
    path = str(tmp_path / "wn.onnx")
    jcw.write_vocoder_onnx(path, params, cfg, anonymize=True)
    m = jonnx.read_model(path)
    _weight_norm_variant(m)
    _rewrite(path, m)

    report = tcw.validate_vocoder_onnx(tonnx.read_model(path), _tc(cfg))
    assert report == jcw.validate_vocoder_onnx(jonnx.read_model(path), cfg)
    assert report["conv.weight_norm"].startswith("verified (folded")
    assert tcw.explain_unmapped(tonnx.read_model(path), set()) \
        == jcw.explain_unmapped(jonnx.read_model(path), set())
    got = tcw.convert_vocoder_onnx(path, _tc(cfg))
    assert_trees_equal(got, jcw.convert_vocoder_onnx(path, cfg))
    for (k, g), (_, w) in zip(_leaves(got), _leaves(params)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=k)


# the broken graphs of tests/test_onnx.py: each a mutation of a named (or
# anonymized) tiny graph and whether --force converts it
def _break_stride(m, cfg):
    next(n for n in m.nodes
         if n.op_type == "ConvTranspose").attrs["strides"] = [7]


def _break_io(m, cfg):
    m.inputs[:] = [i for i in m.inputs if i[0] != "is_last"]


def _break_snake(m, cfg):
    conv = next(n for n in m.nodes if n.op_type == "Conv")
    out = conv.outputs[0]
    alpha = "snake_alpha_0"
    m.initializers[alpha] = np.full((1, cfg.hidden, 1), 0.7, np.float32)
    for n in m.nodes:
        n.inputs[:] = ["snake_out" if i == out else i for i in n.inputs]
    at = m.nodes.index(conv) + 1
    m.nodes[at:at] = [
        jonnx.OnnxNode("Mul", [out, alpha], ["snake_ax"]),
        jonnx.OnnxNode("Sin", ["snake_ax"], ["snake_sin"]),
        jonnx.OnnxNode("Mul", ["snake_sin", "snake_sin"], ["snake_sq"]),
        jonnx.OnnxNode("Div", ["snake_sq", alpha], ["snake_div"]),
        jonnx.OnnxNode("Add", [out, "snake_div"], ["snake_out"]),
    ]


def _break_residual(m, cfg):
    conv = [n for n in m.nodes if n.op_type == "Conv"][-1]
    out = conv.outputs[0]
    for n in m.nodes:
        n.inputs[:] = ["res_out" if i == out else i for i in n.inputs]
    m.nodes.insert(m.nodes.index(conv) + 1,
                   jonnx.OnnxNode("Add", [conv.inputs[0], out], ["res_out"]))


def _break_weight(m, cfg):
    conv = next(n for n in m.nodes if n.op_type == "Conv")
    m.nodes.insert(m.nodes.index(conv),
                   jonnx.OnnxNode("Relu", [conv.inputs[1]], ["computed_w"]))
    conv.inputs[1] = "computed_w"


BROKEN = {"stride": (_break_stride, False), "io": (_break_io, False),
          "snake": (_break_snake, True), "residual": (_break_residual, True),
          "weight": (_break_weight, True)}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_vocoder_graph_same_report_and_error(tmp_path, case):
    cfg = _vocoder_cfg("tiny")
    params = _vocoder_params(cfg, seed=5)
    breaker, anon = BROKEN[case]
    path = str(tmp_path / f"{case}.onnx")
    jcw.write_vocoder_onnx(path, params, cfg, anonymize=anon)
    m = jonnx.read_model(path)
    breaker(m, cfg)
    _rewrite(path, m)
    report = tcw.validate_vocoder_onnx(tonnx.read_model(path), _tc(cfg))
    assert report == jcw.validate_vocoder_onnx(jonnx.read_model(path), cfg)
    assert not all(v.startswith("verified") for v in report.values())
    assert tcw.explain_unmapped(tonnx.read_model(path), set()) \
        == jcw.explain_unmapped(jonnx.read_model(path), set())
    msg = assert_same_error(
        lambda: tcw.convert_vocoder_onnx(path, _tc(cfg)),
                            lambda: jcw.convert_vocoder_onnx(path, cfg),
                            exc=ValueError)
    if case in ("stride", "io"):
        assert "--force" in msg
        # --force converts anyway, to the tree written
        got = tcw.convert_vocoder_onnx(path, _tc(cfg), force=True)
        assert_trees_equal(got, jcw.convert_vocoder_onnx(path, cfg,
                                                         force=True))
        assert_trees_equal(got, params)
    else:
        assert_same_error(
            lambda: tcw.convert_vocoder_onnx(path, _tc(cfg), force=True),
            lambda: jcw.convert_vocoder_onnx(path, cfg, force=True),
            exc=ValueError)


@pytest.mark.parametrize("family,act", [("seq", "gelu"), ("seq", "snake"),
                                        ("general", "gelu"),
                                        ("general", "snake")])
def test_vocoder_state_dict_pair_equals_jax(family, act):
    cfg = _vocoder_cfg("tiny", family, act)
    params = _vocoder_params(cfg, seed=7)
    sd = tcw.export_vocoder_state_dict(params, _tc(cfg))
    want = jcw.export_vocoder_state_dict(params, cfg)
    assert list(sd) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(sd[k], w, err_msg=k)
    got = tcw.convert_vocoder_state_dict(want, _tc(cfg))
    assert_trees_equal(got, jcw.convert_vocoder_state_dict(want, cfg))
    assert_trees_equal(got, params)
    # a tree of tensors exports as its numpy twin does
    tensors = jax.tree.map(torch.from_numpy, params)
    sd_t = tcw.export_vocoder_state_dict(tensors, _tc(cfg))
    for k, w in want.items():
        np.testing.assert_array_equal(sd_t[k], w, err_msg=k)


def test_sd_from_onnx_prefix_and_torch_state_dict_hook():
    m = jonnx.OnnxModel(
        {"model.a.weight": np.ones((2, 3), np.float32),
         "model.b": np.arange(3, dtype=np.float32), "c": np.zeros(1)},
        [jonnx.OnnxNode("MatMul", ["x", "model.a.weight"], ["y"])], [], [])
    got = tcw.sd_from_onnx(m, ["a.weight", "b"])
    want = jcw.sd_from_onnx(m, ["a.weight", "b"])
    assert list(got) == list(want) == ["a.weight", "b", "c"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["a.weight"].shape == (3, 2)         # MatMul: transposed back
    name_map = {"a.weight": "x/w", "b": "x/b", "c": "c"}
    assert_trees_equal(tcw.convert_torch_state_dict(got, name_map),
                       jcw.convert_torch_state_dict(want, name_map))


# --------------------------------------------------------------- encoders
ENC_CASES = [(kind, size, anon) for kind in ("audio", "speaker")
             for size in ("tiny", "wide") for anon in (False, True)]


@pytest.mark.parametrize("kind,size,anon", ENC_CASES)
def test_encoder_graph_equals_jax(tmp_path, kind, size, anon):
    cfg = _encoder_cfg(kind, size)
    params = _encoder_params(kind, cfg, seed=11)
    pj, pt = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jcw.write_encoder_onnx(pj, params, kind, cfg, anonymize=anon)
    tcw.write_encoder_onnx(pt, params, kind, _tc(cfg), anonymize=anon)
    assert _read(pt) == _read(pj)
    got = tcw.convert_encoder_onnx(pj, kind, _tc(cfg))
    assert_trees_equal(got, jcw.convert_encoder_onnx(pj, kind, cfg))
    assert_trees_equal(got, params)


@pytest.mark.parametrize("kind,size", [(k, s) for k in ("audio", "speaker")
                                       for s in ("tiny", "wide")])
def test_encoder_state_dict_functions_equal_jax(kind, size):
    cfg = _encoder_cfg(kind, size)
    params = _encoder_params(kind, cfg, seed=13)
    exp = "export_audio_encoder_state_dict" if kind == "audio" \
        else "export_speaker_encoder_state_dict"
    conv = exp.replace("export_", "convert_")
    sd = getattr(tenc, exp)(params, _tc(cfg))
    want = getattr(jenc, exp)(params, cfg)
    assert list(sd) == list(want)
    for k, w in want.items():
        assert sd[k].shape == w.shape, k
        np.testing.assert_array_equal(sd[k], w, err_msg=k)
    got = getattr(tenc, conv)(want, _tc(cfg))
    assert_trees_equal(got, getattr(jenc, conv)(want, cfg))
    assert_trees_equal(got, params)
    assert_trees_equal(tenc._convert_stack_sd(want, "encoder.layers",
                                              cfg.n_layers),
                       jenc._convert_stack_sd(want, "encoder.layers",
                                              cfg.n_layers))


@pytest.mark.parametrize("size", ["tiny", "wide"])
def test_encoder_gatherless_codebooks_equal_jax(tmp_path, size):
    cfg = _encoder_cfg("audio", size)
    params = _encoder_params("audio", cfg, seed=17)
    path = str(tmp_path / "nogather.onnx")
    jcw.write_encoder_onnx(path, params, "audio", cfg, anonymize=True)
    m = jonnx.read_model(path)
    for n in m.nodes:
        if n.op_type == "Gather":
            n.inputs[0] = "not_an_initializer"
    _rewrite(path, m)
    got = tcw.convert_encoder_onnx(path, "audio", _tc(cfg))
    assert_trees_equal(got, jcw.convert_encoder_onnx(path, "audio", cfg))
    assert_trees_equal(got, params)


def _enc_wrong_stride(tmp_path):
    cfg = TINY.audio_encoder
    path = str(tmp_path / "bad_stride.onnx")
    jcw.write_encoder_onnx(path, _encoder_params("audio", cfg), "audio", cfg,
                           anonymize=True)
    m = jonnx.read_model(path)
    next(n for n in m.nodes if n.op_type == "Conv").attrs["strides"] = [7]
    _rewrite(path, m)
    return path, "audio", cfg


def _enc_io(tmp_path):
    path = str(tmp_path / "x.onnx")
    jonnx.write_model(path, {"w": np.zeros(3, np.float32)},
                      inputs=[("wav", 1, (1, None))],
                      outputs=[("codes", 7, (1, None, 16))])
    return path, "audio", None


def _enc_state_dict_only(tmp_path):
    cfg = TINY.audio_encoder
    sd = jenc.export_audio_encoder_state_dict(_encoder_params("audio", cfg),
                                              cfg)
    path = str(tmp_path / "anon.onnx")
    jonnx.write_model(path, {f"onnx::W_{i}": v
                             for i, v in enumerate(sd.values())},
                      inputs=[("input_values", 1, (1, None))],
                      outputs=[("audio_codes", 7, (1, None, 16))])
    return path, "audio", cfg


@pytest.mark.parametrize("make", [_enc_wrong_stride, _enc_io,
                                  _enc_state_dict_only])
def test_encoder_failures_equal_jax(tmp_path, make):
    path, kind, cfg = make(tmp_path)
    assert_same_error(
        lambda: tcw.convert_encoder_onnx(path, kind, _tc(cfg)),
                      lambda: jcw.convert_encoder_onnx(path, kind, cfg),
                      exc=ValueError)


# --------------------------------------------------------------- the tool
STEPS = 6
JCFG = J.tiny_engine_config(max_steps=STEPS)
TCFG = T.tiny_engine_config(max_steps=STEPS)
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, seed=1)
EMB = np.random.default_rng(0).normal(size=2048).astype(np.float32)
TEXT = "converted weights"


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A directory of raw artifacts in the reference's layout, from a
    seeded JAX engine (the tiny config; the vocoder at init scale 0.06, so
    that the waveform is far above the tolerances; encoders tied to it):
    the llama.cpp GGUFs, `qwen3_assets.gguf`, the decoder graph (named)
    and both encoder graphs (anonymized); then each tool's output."""
    je = J.TtsEngine(config=JCFG, random_weights=True, seed=3,
                     compile_cache=False)
    voc = jax.tree.map(np.asarray, jvoc.init_vocoder(
        jax.random.key(13), JCFG.vocoder, scale=0.06))
    voc["transformer"]["head"] = np.zeros_like(voc["transformer"]["head"])
    ae, se = jenc.random_encoders(jax.random.key(7), JCFG, voc)
    raw = tmp_path_factory.mktemp("release")
    je.save_checkpoint(str(raw))
    for name in os.listdir(raw):
        if name != "qwen3_assets.gguf":
            os.remove(raw / name)
    for kind in ("talker", "predictor"):
        jllama.export_llama_gguf(
            str(raw / f"qwen3_tts_{kind}.gguf"), getattr(JCFG, kind),
            jax.tree.map(np.asarray, je.models[kind]))
    jcw.write_vocoder_onnx(str(raw / "qwen3_tts_decoder.onnx"), voc,
                           JCFG.vocoder)
    for kind, enc, name in (("audio", ae, "qwen3_tts_codec_encoder"),
                            ("speaker", se, "qwen3_tts_speaker_encoder")):
        jcw.write_encoder_onnx(str(raw / f"{name}.onnx"),
                               jax.tree.map(np.asarray, enc.params), kind,
                               anonymize=True,
                               cfg=getattr(JCFG, f"{kind}_encoder"))
    argv = ["--talker", str(raw / "qwen3_tts_talker.gguf"),
            "--predictor", str(raw / "qwen3_tts_predictor.gguf"),
            "--vocoder", str(raw / "qwen3_tts_decoder.onnx"),
            "--audio-encoder", str(raw / "qwen3_tts_codec_encoder.onnx"),
            "--speaker-encoder", str(raw / "qwen3_tts_speaker_encoder.onnx")]
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        # main converts an encoder graph at the default config's geometry
        # (neither tool derives it from the graph): the tiny one's here
        for mod in (jconfig, tcw):
            mp.setattr(mod, "AudioEncoderConfig",
                       lambda: JCFG.audio_encoder)
            mp.setattr(mod, "SpeakerEncoderConfig",
                       lambda: JCFG.speaker_encoder)
        for side, tool in (("jax", jcw), ("port", tcw)):
            out = raw.parent / f"out_{side}"
            assert tool.main(argv + ["--out", str(out)]) == 0
            shutil.copy(raw / "qwen3_assets.gguf", out)
            outs[side] = out
    return raw, outs


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_main_outputs_equal_jax(release):
    _, outs = release
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) == [
        "audio_encoder.npz", "predictor.npz", "qwen3_assets.gguf",
        "speaker_encoder.npz", "talker.npz", "vocoder.npz",
        "vocoder_config.json"]
    for name in names:
        if not name.endswith(".npz"):
            assert filecmp.cmp(outs["port"] / name, outs["jax"] / name,
                               shallow=False), name
            continue
        got, want = _npz(outs["port"] / name), _npz(outs["jax"] / name)
        assert list(got) == list(want), name
        for k, w in want.items():
            assert got[k].dtype == w.dtype, (name, k)
            np.testing.assert_array_equal(got[k], w, err_msg=f"{name} {k}")
    with open(outs["port"] / "vocoder_config.json") as f:
        derived = json.load(f)
    assert {k: derived[k] for k in ("hidden", "n_layers", "embed_dim",
                                    "ffn_dim", "lookahead")} == {
        k: getattr(JCFG.vocoder, k) for k in ("hidden", "n_layers",
                                              "embed_dim", "ffn_dim",
                                              "lookahead")}


def _greedy(eng, sampler):
    eng.set_sampler_config(sampler(**GREEDY))
    return eng


def _codes(eng, jax_side):
    voice = (J if jax_side else T).VoiceFile(speaker_embedding=EMB.tolist())
    d = eng._prompt_for_voice(TEXT, voice, None)
    b, o = eng._pad_prompts([d.embeds])
    c = eng.config
    if jax_side:
        codes, n = jgenerate.generate_codes(
            eng.models, c.talker, c.predictor, b, o, jax.random.key(0), 0.0,
            0, 1.0, STEPS)
        return np.asarray(codes), np.asarray(n)
    codes, n = tgenerate.generate_codes(
        eng.models, c.talker, c.predictor, b, o, None, 0.0, 0, 1.0, STEPS)
    return codes.numpy(), n.numpy()


def test_engine_on_converted_release_matches_jax(release, tmp_path):
    raw, outs = release
    je = _greedy(J.TtsEngine(model_dir=str(outs["jax"]), config=JCFG,
                             compile_cache=False), J.SamplerConfig)
    te = _greedy(T.TtsEngine(model_dir=str(outs["port"]), config=TCFG,
                             device="cpu"), T.SamplerConfig)
    assert te.encoder is not None and te.speaker_encoder is not None
    assert te.config.vocoder == tconfig.load_vocoder_config(
        str(outs["port"] / "vocoder_config.json"))
    jc, jn = _codes(je, True)
    tc, tn = _codes(te, False)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)

    want = je.generate_with_voice(TEXT, J.VoiceFile(
        speaker_embedding=EMB.tolist())).samples
    got = te.generate_with_voice(TEXT, T.VoiceFile(
        speaker_embedding=EMB.tolist())).samples
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    peak = np.abs(want).max()
    assert peak >= 100 * WAV_ATOL
    assert np.abs(got - want).max() <= WAV_PEAK * peak

    ref = str(tmp_path / "ref.wav")
    AudioSample(samples=(0.1 * np.random.default_rng(5).standard_normal(
        3 * 2000 + 700)).astype(np.float32), sample_rate=24000).save_wav(ref)
    jv = je.create_voice_file(ref, "reference words")
    tv = te.create_voice_file(ref, "reference words")
    assert tv.audio_codes == jv.audio_codes and len(tv.audio_codes) == 48
    assert tv.ref_text == jv.ref_text
    np.testing.assert_allclose(tv.speaker_embedding, jv.speaker_embedding,
                               rtol=0, atol=1e-5)


def test_main_force_and_refusal_equal_jax(release, tmp_path):
    """A graph that contradicts the derived architecture (no `is_last`
    input): refused without --force by both tools alike, converted with it
    to equal files."""
    raw, _ = release
    src = str(tmp_path / "io.onnx")
    m = jonnx.read_model(str(raw / "qwen3_tts_decoder.onnx"))
    _break_io(m, JCFG.vocoder)
    _rewrite(src, m)
    argv = ["--vocoder", src, "--out"]
    assert "--force" in assert_same_error(
        lambda: tcw.main(argv + [str(tmp_path / "t0")]),
        lambda: jcw.main(argv + [str(tmp_path / "j0")]))
    for side, tool in (("j", jcw), ("t", tcw)):
        assert tool.main(argv + [str(tmp_path / side), "--force"]) == 0
    assert_trees_equal(_npz(tmp_path / "t" / "vocoder.npz"),
                       _npz(tmp_path / "j" / "vocoder.npz"))
    assert _read(tmp_path / "t" / "vocoder_config.json") \
        == _read(tmp_path / "j" / "vocoder_config.json")


def test_main_state_dicts_equal_jax(tmp_path, monkeypatch):
    """`--vocoder` / `--audio-encoder` / `--speaker-encoder` given torch
    state dicts (.npz), which convert at the default configs' geometry:
    the defaults set to the tiny config's in both packages."""
    cfg = TINY
    voc = _vocoder_params(cfg.vocoder, seed=19)
    ae = _encoder_params("audio", cfg.audio_encoder, seed=23)
    se = _encoder_params("speaker", cfg.speaker_encoder, seed=29)
    files = {}
    for flag, sd in (
            ("--vocoder", jcw.export_vocoder_state_dict(voc, cfg.vocoder)),
            ("--audio-encoder", jenc.export_audio_encoder_state_dict(
                ae, cfg.audio_encoder)),
            ("--speaker-encoder", jenc.export_speaker_encoder_state_dict(
                se, cfg.speaker_encoder))):
        files[flag] = str(tmp_path / f"{flag[2:]}.npz")
        np.savez(files[flag], **sd)
    argv = [a for kv in files.items() for a in kv]
    # the default geometry refuses them, in both tools alike
    for tool, side in ((jcw, "j0"), (tcw, "t0")):
        with pytest.raises(SystemExit) as e:
            tool.main(argv + ["--out", str(tmp_path / side)])
        assert e.value.code == 2
    for mod, name, value in (
            (jconfig, "VocoderConfig", lambda: cfg.vocoder),
            (tcw, "VocoderConfig", lambda: cfg.vocoder),
            (jenc, "AudioEncoderConfig", lambda: cfg.audio_encoder),
            (tenc, "AudioEncoderConfig", lambda: cfg.audio_encoder),
            (jenc, "SpeakerEncoderConfig", lambda: cfg.speaker_encoder),
            (tenc, "SpeakerEncoderConfig", lambda: cfg.speaker_encoder)):
        monkeypatch.setattr(mod, name, value)
    for tool, side in ((jcw, "j"), (tcw, "t")):
        assert tool.main(argv + ["--out", str(tmp_path / side)]) == 0
    for name, want in (("vocoder.npz", voc), ("audio_encoder.npz", ae),
                       ("speaker_encoder.npz", se)):
        got = _npz(tmp_path / "t" / name)
        assert_trees_equal(got, _npz(tmp_path / "j" / name))
        assert_trees_equal(got, dict(_leaves(want)))
