"""The port's weight loading and saving against the JAX package, on the
tiny f32 config (and a tiny bf16 one): GGUF containers and llama.cpp's
quantized blocks, the llama GGUF decoder layout, `.npz` checkpoints in
both directions (greedy codes equal, waveforms allclose), the reference's
GGUF directory layout, the per-quant subdirectory, bf16 on disk, the
downloader, and `generate_long`.

The JAX engine draws the weights; the port loads what JAX wrote, and JAX
loads what the port wrote. Nothing touches the network: the downloader
runs offline or with `urllib.request.urlopen` patched.
"""

import dataclasses
import hashlib
import io
import json
import os
import shutil
import struct
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu as J
from qwen3_tts_tpu import download as jdownload
from qwen3_tts_tpu.assets import gguf as jgguf
from qwen3_tts_tpu.assets import llama_gguf as jllama
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.tts import generate as jgenerate
import qwen3_tts_tpu_torch as T
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch import download as tdownload
from qwen3_tts_tpu_torch.assets import checkpoint as tcheckpoint
from qwen3_tts_tpu_torch.assets import gguf as tgguf
from qwen3_tts_tpu_torch.assets import llama_gguf as tllama
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.tts import generate as tgenerate

STEPS = 6
JCFG = J.tiny_engine_config(max_steps=STEPS)
TCFG = T.tiny_engine_config(max_steps=STEPS)
WAV_RTOL, WAV_ATOL = 1e-5, 1e-6     # tests/test_checkpoint_engine.py:31
EMB = np.random.default_rng(0).normal(size=64).astype(np.float32).tolist()
TEXT = "loaded weights"


def _greedy(eng, sampler):
    eng.set_sampler_config(sampler(temperature=0.0, top_k=0, top_p=1.0,
                                   seed=1))
    return eng


def jax_engine(**kw):
    kw.setdefault("config", JCFG)
    return _greedy(J.TtsEngine(compile_cache=False, **kw), J.SamplerConfig)


def port_engine(**kw):
    kw.setdefault("config", TCFG)
    return _greedy(T.TtsEngine(device="cpu", **kw), T.SamplerConfig)


def jax_codes(je, text=TEXT):
    d = je._prompt_for_voice(text, J.VoiceFile(speaker_embedding=EMB), None)
    b, o = je._pad_prompts([d.embeds])
    c = je.config
    codes, n = jgenerate.generate_codes(
        je.models, c.talker, c.predictor, b, o, jax.random.key(0), 0.0, 0,
        1.0, STEPS)
    return np.asarray(codes), np.asarray(n)


def port_codes(te, text=TEXT):
    d = te._prompt_for_voice(text, T.VoiceFile(speaker_embedding=EMB), None)
    b, o = te._pad_prompts([d.embeds])
    c = te.config
    codes, n = tgenerate.generate_codes(
        te.models, c.talker, c.predictor, b, o, None, 0.0, 0, 1.0, STEPS)
    return codes.numpy(), n.numpy()


def assert_same_output(je, te, text=TEXT):
    """Greedy codes equal, the waveform allclose (and within 1e-5 of the
    waveform's peak)."""
    jc, jn = jax_codes(je, text)
    tc, tn = port_codes(te, text)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    want = je.generate_with_voice(text, J.VoiceFile(speaker_embedding=EMB))
    got = te.generate_with_voice(text, T.VoiceFile(speaker_embedding=EMB))
    assert len(got.samples) == len(want.samples) > 0
    np.testing.assert_allclose(got.samples, want.samples, rtol=WAV_RTOL,
                               atol=WAV_ATOL)
    peak = np.abs(want.samples).max()
    assert np.abs(got.samples - want.samples).max() <= 1e-5 * peak


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_np(tree):
    return {k: _port_np(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.float().numpy()


def assert_tree_equal(got, want):
    """Port tensors against JAX arrays, bit for bit (bf16 compared as bit
    patterns)."""
    got = dict(tcheckpoint.flatten(got))
    want = {k: np.asarray(v) for k, v in tcheckpoint.flatten(want)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """JAX's seeded engine and the checkpoint directory it wrote."""
    je = jax_engine(random_weights=True, seed=3)
    d = tmp_path_factory.mktemp("jax_ckpt")
    je.save_checkpoint(str(d))
    return je, d


# ------------------------------------------------------------------ GGUF
def _container(rng):
    tensors = {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32),
               "c.bias": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    meta = {"general.name": "port", "x.count": 7, "x.theta": 1.5e6,
            "x.flag": True, "x.sections": [24, 20, 20, 0]}
    return tensors, meta


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gguf_container_read_by_the_other_package(tmp_path, writer):
    tensors, meta = _container(np.random.default_rng(1))
    path = str(tmp_path / "c.gguf")
    write, read = ((jgguf.write_gguf, tgguf.GGUFFile) if writer == "jax"
                   else (tgguf.write_gguf, jgguf.GGUFFile))
    write(path, tensors, meta)
    f = read(path)
    assert f.metadata == meta
    assert set(f.tensors) == set(tensors)
    for name, arr in tensors.items():
        got = f.read_tensor(name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr)
    with open(path, "rb") as fh:      # the two writers write the same bytes
        mine = fh.read()
    other = str(tmp_path / "o.gguf")
    (tgguf.write_gguf if writer == "jax" else jgguf.write_gguf)(
        other, tensors, meta)
    with open(other, "rb") as fh:
        assert fh.read() == mine


def _quant_blocks(kind, n_blocks, rng):
    """Random blocks of a llama.cpp quant type with finite f16 scales."""
    size = {"q8_0": 34, "q4_k": 144, "q5_k": 176, "q6_k": 210}[kind]
    raw = rng.integers(0, 256, (n_blocks, size), dtype=np.uint8)

    def f16(start, n):
        vals = rng.standard_normal((n_blocks, n)) * 0.05
        raw[:, start:start + 2 * n] = vals.astype(np.float16).view(
            np.uint8).reshape(n_blocks, -1)

    if kind == "q8_0":
        f16(0, 1)
    elif kind == "q6_k":
        f16(208, 1)
    else:
        f16(0, 2)                 # d, dmin
    return raw.tobytes()


def _write_quant_gguf(path, name, ggml_type, shape, raw):
    """A one-tensor GGUF v3 file whose data is `raw` (type `ggml_type`)."""
    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, 1, 0))
        b = name.encode()
        f.write(struct.pack("<Q", len(b)) + b)
        f.write(struct.pack("<I", len(shape)))
        for d in reversed(shape):
            f.write(struct.pack("<Q", d))
        f.write(struct.pack("<IQ", ggml_type, 0))
        f.write(b"\x00" * ((-f.tell()) % 32))
        f.write(raw)


@pytest.mark.parametrize("kind,ggml_type,block", [
    ("q8_0", 8, 32), ("q4_k", 12, 256), ("q5_k", 13, 256),
    ("q6_k", 14, 256)])
def test_dequant_bit_exact_with_jax(tmp_path, kind, ggml_type, block):
    rng = np.random.default_rng(ggml_type)
    n_blocks = 6
    raw = _quant_blocks(kind, n_blocks, rng)
    count = n_blocks * block
    want = getattr(jgguf, f"dequant_{kind}")(raw, count)
    got = getattr(tgguf, f"dequant_{kind}")(raw, count)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and through a file, as a quantized GGUF decoder is read
    shape = (count // 64, 64)
    path = str(tmp_path / f"{kind}.gguf")
    _write_quant_gguf(path, "w", ggml_type, shape, raw)
    a = tgguf.GGUFFile(path).read_tensor("w")
    b = jgguf.GGUFFile(path).read_tensor("w")
    assert a.shape == shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# -------------------------------------------------- llama.cpp decoder layout
@pytest.mark.parametrize("kind", ["talker", "predictor"])
def test_llama_gguf_jax_export_port_convert(tmp_path, kind):
    cfg = getattr(JCFG, kind)
    params = _np(jdecoder.init_decoder(jax.random.key(5), cfg))
    path = str(tmp_path / f"qwen3_tts_{kind}.gguf")
    jllama.export_llama_gguf(path, cfg, params)
    tcfg, got = tllama.convert_llama_gguf(path, kind)
    jcfg, want = jllama.convert_llama_gguf(path, kind)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert type(tcfg).__name__ == type(jcfg).__name__
    flat_got, flat_want = dict(tcheckpoint.flatten(got)), dict(
        tcheckpoint.flatten(want))
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], w, err_msg=k)
        np.testing.assert_array_equal(
            flat_got[k], dict(tcheckpoint.flatten(params))[k], err_msg=k)


@pytest.mark.parametrize("kind", ["talker", "predictor"])
def test_llama_gguf_port_export_jax_convert(tmp_path, kind):
    cfg = getattr(TCFG, kind)
    g = torch.Generator().manual_seed(6)
    params = tdecoder.init_decoder(g, cfg)
    path = str(tmp_path / f"qwen3_tts_{kind}.gguf")
    tllama.export_llama_gguf(path, cfg, params)
    jcfg, got = jllama.convert_llama_gguf(path, kind)
    tcfg = tllama.config_from_gguf(tgguf.GGUFFile(path), kind)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for field in ("hidden", "n_layers", "n_q_heads", "n_kv_heads",
                  "head_dim", "ffn_dim", "vocab", "mrope_sections"):
        assert getattr(tcfg, field) == getattr(cfg, field), field
    want = dict(tcheckpoint.flatten(_port_np(params)))
    for k, w in tcheckpoint.flatten(got):
        np.testing.assert_array_equal(w, want[k], err_msg=k)


def _reference_layout(je, d):
    """Turn a JAX checkpoint directory into the reference's layout: the
    llama.cpp GGUF decoders, no decoder .npz."""
    for kind in ("talker", "predictor"):
        jllama.export_llama_gguf(str(d / f"qwen3_tts_{kind}.gguf"),
                                 getattr(je.config, kind),
                                 _np(je.models[kind]))
        os.remove(d / f"{kind}.npz")


def test_gguf_geometry_mismatch_same_error(tmp_path, jax_saved):
    _, src = jax_saved
    d = tmp_path / "m"
    shutil.copytree(src, d)
    os.remove(d / "talker.npz")
    wrong = dataclasses.replace(JCFG.talker, n_layers=3)
    jllama.export_llama_gguf(
        str(d / "qwen3_tts_talker.gguf"), wrong,
        _np(jdecoder.init_decoder(jax.random.key(0), wrong)))
    with pytest.raises(ValueError, match="n_layers") as want:
        J.TtsEngine(model_dir=str(d), config=JCFG, compile_cache=False)
    with pytest.raises(ValueError) as got:
        T.TtsEngine(model_dir=str(d), config=TCFG, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- engines
def test_engine_round_trip_jax_to_port(jax_saved):
    je, d = jax_saved
    te = port_engine(model_dir=str(d))
    assert_tree_equal(te.models["talker"], je.models["talker"])
    assert_tree_equal(te.models["predictor"], je.models["predictor"])
    assert_tree_equal(te.vocoder_params, je.vocoder_params)
    assert te.encoder is None and te.speaker_encoder is None
    assert_same_output(je, te)


def test_engine_round_trip_port_to_jax(tmp_path, jax_saved):
    je, _ = jax_saved
    # the port holds JAX's weights (the bridge), saves, and JAX loads
    te = _greedy(convert.engine_from_jax_arrays(
        _np({k: je.models[k] for k in ("talker", "predictor")})
        | {"assets": je.models["assets"]}, _np(je.vocoder_params), TCFG,
        device="cpu"), T.SamplerConfig)
    te.save_checkpoint(str(tmp_path))
    for name in ("talker.npz", "predictor.npz", "vocoder.npz",
                 "vocoder_config.json", "qwen3_assets.gguf"):
        assert (tmp_path / name).exists(), name
    je2 = jax_engine(model_dir=str(tmp_path))
    for kind in ("talker", "predictor"):
        for (k, a), (_, b) in zip(
                tcheckpoint.flatten(je2.models[kind]),
                tcheckpoint.flatten(je.models[kind])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)
    assert_same_output(je2, te)
    assert_same_output(je, te)


def test_engine_loads_reference_gguf_layout(tmp_path, jax_saved):
    je, src = jax_saved
    d = tmp_path / "gguf"
    shutil.copytree(src, d)
    _reference_layout(je, d)
    assert sorted(os.listdir(d)) == [
        "qwen3_assets.gguf", "qwen3_tts_predictor.gguf",
        "qwen3_tts_talker.gguf", "vocoder.npz", "vocoder_config.json"]
    te = port_engine(model_dir=str(d))
    assert_tree_equal(te.models["talker"], je.models["talker"])
    assert_same_output(je, te)


@pytest.mark.parametrize("where", ["subdir", "flat"])
def test_engine_quant_subdir_first(tmp_path, where):
    """quant="q8_0" loads `gguf_q8_0/` when it holds the weights, the flat
    directory otherwise: the same resolution as JAX's."""
    flat = jax_engine(random_weights=True, seed=8)
    flat.save_checkpoint(str(tmp_path))
    want = flat
    if where == "subdir":
        sub = jax_engine(random_weights=True, seed=9)
        sub.save_checkpoint(str(tmp_path / jdownload.quant_dir("q8_0")))
        want = sub
    assert tdownload.quant_dir("q8_0") == "gguf_q8_0"
    te = port_engine(model_dir=str(tmp_path), quant="q8_0")
    je = jax_engine(model_dir=str(tmp_path), quant="q8_0")
    assert_tree_equal(te.models["talker"], want.models["talker"])
    assert_tree_equal(te.models["talker"], je.models["talker"])
    np.testing.assert_array_equal(te.models["assets"].text_table.numpy(),
                                  np.asarray(want.models["assets"].text_table))


def test_missing_weights_same_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="download_models") as want:
        J.TtsEngine(model_dir=str(tmp_path), config=JCFG,
                    compile_cache=False)
    with pytest.raises(FileNotFoundError) as got:
        T.TtsEngine(model_dir=str(tmp_path), config=TCFG, device="cpu")
    assert str(got.value) == str(want.value)
    # assets present, decoder weights absent
    jax_engine(random_weights=True, seed=1).save_checkpoint(str(tmp_path))
    os.remove(tmp_path / "predictor.npz")
    with pytest.raises(FileNotFoundError) as want:
        J.TtsEngine(model_dir=str(tmp_path), config=JCFG,
                    compile_cache=False)
    with pytest.raises(FileNotFoundError) as got:
        T.TtsEngine(model_dir=str(tmp_path), config=TCFG, device="cpu")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- bf16
BF16 = dict(dtype="bfloat16")


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    cfg = dataclasses.replace(
        JCFG, talker=dataclasses.replace(JCFG.talker, **BF16),
        predictor=dataclasses.replace(JCFG.predictor, **BF16))
    je = jax_engine(config=cfg, random_weights=True, seed=4)
    d = tmp_path_factory.mktemp("jax_bf16")
    je.save_checkpoint(str(d))
    tcfg = dataclasses.replace(
        TCFG, talker=dataclasses.replace(TCFG.talker, **BF16),
        predictor=dataclasses.replace(TCFG.predictor, **BF16))
    return je, d, tcfg


def test_bf16_jax_checkpoint_loads_bit_for_bit(jax_bf16):
    """JAX's save_checkpoint leaves bf16 leaves as `|V2` arrays, which its
    own loader refuses; the port reads them as bf16 bit patterns."""
    je, d, tcfg = jax_bf16
    with np.load(d / "talker.npz") as z:
        assert z["layers/wqkv"].dtype == np.dtype("V2")
    with pytest.raises(ValueError):
        J.TtsEngine(model_dir=str(d), config=je.config, compile_cache=False)
    te = port_engine(model_dir=str(d), config=tcfg)
    assert te.models["talker"]["head"].dtype == torch.bfloat16
    assert_tree_equal(te.models["talker"], je.models["talker"])
    assert_tree_equal(te.models["predictor"], je.models["predictor"])
    jc, jn = jax_codes(je)
    tc, tn = port_codes(te)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)


def test_bf16_port_save_loads_in_jax(tmp_path, jax_bf16):
    je, d, tcfg = jax_bf16
    te = port_engine(model_dir=str(d), config=tcfg)
    te.save_checkpoint(str(tmp_path))
    with np.load(tmp_path / "talker.npz") as z:
        assert z["layers/wqkv"].dtype == np.float32
    je2 = jax_engine(model_dir=str(tmp_path), config=je.config)
    assert_tree_equal(te.models["talker"], je2.models["talker"])
    assert_tree_equal(te.models["predictor"], je2.models["predictor"])
    te2 = port_engine(model_dir=str(tmp_path), config=tcfg)
    assert_tree_equal(te2.models["talker"], je.models["talker"])


# ------------------------------------------------------------ downloader
class _Resp(io.BytesIO):
    def __init__(self, payload: bytes, status=200):
        super().__init__(payload)
        self.status = status
        self.headers = {"Content-Length": str(len(payload))}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _serve(monkeypatch, payload: bytes):
    def fake_urlopen(req, timeout=None):
        if getattr(req, "get_method", lambda: "GET")() == "HEAD":
            return _Resp(b"")
        rng = req.headers.get("Range") if hasattr(req, "headers") else None
        if rng:
            start = int(rng.split("=")[1].rstrip("-"))
            return _Resp(payload[start:], status=206)
        return _Resp(payload)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)


def _tree(root, payload):
    """A model directory: one good file, one tampered, a checksum
    sidecar naming both, the rest missing."""
    good = "tokenizer/tokenizer.json"
    bad = "gguf_q8_0/qwen3_assets.gguf"
    for rel, data in ((good, payload), (bad, b"tampered")):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)
    sums = {rel: hashlib.sha256(payload).hexdigest() for rel in (good, bad)}
    with open(os.path.join(root, "checksums.json"), "w") as f:
        json.dump(sums, f)


@pytest.mark.parametrize("mode", ["offline", "served", "served_wrong"])
def test_downloader_statuses_equal_jax(tmp_path, monkeypatch, mode):
    payload = b"model-bytes" * 300
    if mode != "offline":
        served = payload if mode == "served" else b"other-bytes" * 300
        _serve(monkeypatch, served)
    results, files = [], []
    for name, mod in (("jax", jdownload), ("port", tdownload)):
        root = str(tmp_path / name)
        _tree(root, payload)
        d = mod.Downloader(offline=mode == "offline",
                           progress=lambda *a: None)
        assert d.missing(root, "q8_0") == jdownload.Downloader(
            offline=True).missing(root, "q8_0")
        results.append(d.check_and_download(root, "q8_0"))
        files.append(sorted(
            os.path.relpath(os.path.join(r, f), root)
            for r, _, fs in os.walk(root) for f in fs))
    assert results[0] == results[1]
    assert files[0] == files[1]
    assert results[0]["tokenizer/tokenizer.json"] == "exists"
    assert set(results[0].values()) == {
        "offline": {"exists", "missing"},
        "served": {"exists", "downloaded"},
        "served_wrong": {"exists", "downloaded", "corrupt"}}[mode]
    assert tdownload.manifest("q5_k_m") == jdownload.manifest("q5_k_m")
    assert tdownload.QUANT_DIRS == jdownload.QUANT_DIRS


def test_engine_download_models_offline(tmp_path):
    got = T.TtsEngine.download_models(str(tmp_path), "q5_k_m", offline=True)
    want = J.TtsEngine.download_models(str(tmp_path), "q5_k_m", offline=True)
    assert got == want and set(got.values()) == {"missing"}


# ---------------------------------------------------------- generate_long
LONG_TEXTS = [
    "First sentence here. Second one follows! Is this the third? "
    "And a fourth; then the fifth sentence closes the text.",
    "今天天气很好。我们去公园散步吧！你觉得怎么样？好的。" * 2,
    "a run-on sentence without any ender that keeps going well past the "
    "chunk limit of forty-eight byte tokens and then some more words",
]
# the 48-byte cut of the run-on text lands inside the two-byte "é": the
# decoded prefix ends in U+FFFD, and the same string occurs later in the
# text, so JAX's `in` test keeps it as a chunk and cuts 48 characters
X = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTU"          # 47 bytes
TRAP = X + "\u00e9" + "0123456789" + X + "\ufffd" + "tail"


@pytest.fixture(scope="module")
def long_engines(jax_saved):
    je, d = jax_saved
    return je, port_engine(model_dir=str(d))


def _jax_chunks(je, text, monkeypatch):
    seen = []

    def record(texts, voices, instruct=None):
        seen.extend(texts)
        return [J.AudioSample(samples=np.zeros(1, np.float32),
                              sample_rate=24000, channels=1) for _ in texts]

    monkeypatch.setattr(je, "generate_batch", record)
    je.generate_long(text, J.VoiceFile(speaker_embedding=EMB))
    return seen


@pytest.mark.parametrize("i", range(len(LONG_TEXTS)))
def test_long_chunks_equal_jax(long_engines, monkeypatch, i):
    je, te = long_engines
    text = LONG_TEXTS[i]
    want = _jax_chunks(je, text, monkeypatch)
    got = te._long_chunks(text, 48)
    assert len(got) > 1
    assert got == want
    assert all(len(te.tokenizer.encode(c)) <= 48 for c in got)


def test_long_chunks_keep_every_character(long_engines, monkeypatch):
    """JAX's `head not in cur` guard keeps a decoded prefix found later in
    the text and drops characters; the port's `startswith` keeps them."""
    je, te = long_engines
    jchunks = _jax_chunks(je, TRAP, monkeypatch)
    assert "".join(jchunks) != TRAP          # the fault, in JAX's copy
    chunks = te._long_chunks(TRAP, 48)
    assert "".join(chunks) == TRAP


@pytest.mark.parametrize("pause_s", [0.0, 0.05])
def test_generate_long_is_the_batch_concatenated(long_engines, pause_s):
    je, te = long_engines
    text = LONG_TEXTS[0]
    voice = T.VoiceFile(speaker_embedding=EMB)
    chunks = te._long_chunks(text, 48)
    got = te.generate_long(text, voice, pause_s=pause_s)
    pieces = te.generate_batch(chunks, [voice] * len(chunks))
    pause = np.zeros(int(pause_s * 24000), np.float32)
    parts = []
    for k, p in enumerate(pieces):
        parts += ([pause] if k else []) + [p.samples]
    np.testing.assert_array_equal(got.samples, np.concatenate(parts))
    want = je.generate_long(text, J.VoiceFile(speaker_embedding=EMB),
                            pause_s=pause_s)
    np.testing.assert_allclose(got.samples, want.samples, rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_generate_long_short_text_is_one_call(long_engines):
    _, te = long_engines
    voice = T.VoiceFile(speaker_embedding=EMB)
    np.testing.assert_array_equal(
        te.generate_long("short", voice).samples,
        te.generate_with_voice("short", voice).samples)
