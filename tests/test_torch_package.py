"""Package-level properties of the port: it never imports JAX, its configs
equal the JAX package's field by field, its copied modules behave alike,
and its kernel sources are where the build looks for them."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import qwen3_tts_tpu.core.config as jconfig
import qwen3_tts_tpu.core.protocol as jprotocol
import qwen3_tts_tpu_torch.core.config as tconfig
import qwen3_tts_tpu_torch.core.protocol as tprotocol
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "qwen3_tts_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, qwen3_tts_tpu_torch, qwen3_tts_tpu_torch.convert, "
            "qwen3_tts_tpu_torch.ops.chain, qwen3_tts_tpu_torch.tts.engine, "
            "qwen3_tts_tpu_torch.parallel.pipeline, "
            "qwen3_tts_tpu_torch.tools.mosaic_probe, "
            "qwen3_tts_tpu_torch.assets.checkpoint, "
            "qwen3_tts_tpu_torch.assets.gguf, "
            "qwen3_tts_tpu_torch.assets.llama_gguf, "
            "qwen3_tts_tpu_torch.assets.onnx, "
            "qwen3_tts_tpu_torch.tools.convert_weights, "
            "qwen3_tts_tpu_torch.download, qwen3_tts_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'qwen3_tts_tpu.'))] "
            "+ [m for m in ('triton', 'qwen3_tts_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_convert_weights_runs_without_jax():
    """`python -m qwen3_tts_tpu_torch.tools.convert_weights --help` as a
    user runs it, and the same module run in a process that then lists
    what it imported: neither `jax` nor the JAX package's modules nor
    `tools/convert_weights.py`."""
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.tools.convert_weights",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--vocoder" in proc.stdout and "--audio-encoder" in proc.stdout
    code = ("import runpy, sys; "
            "sys.argv = ['convert_weights', '--help']\n"
            "try:\n"
            "    runpy.run_module('qwen3_tts_tpu_torch.tools.convert_weights',"
            " run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'qwen3_tts_tpu.')) or m in ('qwen3_tts_tpu', "
            "'convert_weights')]\n"
            "assert not bad, bad\n"
            "assert 'qwen3_tts_tpu_torch.assets.onnx' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax():
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for line in f:
                    s = line.strip()
                    assert not s.startswith(("import jax", "from jax",
                                             "import qwen3_tts_tpu ",
                                             "from qwen3_tts_tpu ",
                                             "from qwen3_tts_tpu.")), \
                        (name, s)


@pytest.mark.parametrize("make", ["EngineConfig", "tiny_engine_config"])
def test_configs_equal_jax_field_by_field(make):
    t = getattr(tconfig, make)()
    j = getattr(jconfig, make)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_protocol_constants_equal_jax():
    names = [n for n in dir(jprotocol) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tprotocol, n) == getattr(jprotocol, n), n


def test_unflatten_npz_paths():
    flat = {"layers/wqkv": np.zeros((2, 3)), "up/0/w": np.ones(2),
            "up/1/w": np.zeros(1), "head": np.ones(4)}
    tree = convert.unflatten(flat)
    assert set(tree) == {"layers", "up", "head"}
    assert isinstance(tree["up"], list) and len(tree["up"]) == 2
    params = convert.decoder_from_numpy(flat)
    assert tuple(params["layers"]["wqkv"].shape) == (2, 3)


def test_trace_build_has_its_own_key(monkeypatch):
    """The persistent kernels' traces build into a library of their own
    key (-DKERNEL_TRACE), set once before the process loads one."""
    monkeypatch.setattr(build, "DEFINES", [])
    monkeypatch.setattr(build, "_lib", None)
    key = build.source_hash()
    build.trace_build()
    build.trace_build()
    assert build.DEFINES == ["-DKERNEL_TRACE"]
    assert build.source_hash() != key
    monkeypatch.setattr(build, "DEFINES", [])
    monkeypatch.setattr(build, "_lib", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        build.trace_build()


def test_kernel_sources_and_build_key():
    names = {os.path.basename(p) for p in build.sources()}
    assert {"gemv.cu", "decode_attention.cu", "qmatmul.cu",
            "probes.cu", "predictor_frame.cu", "persistent.cuh",
            "talker_step.cu"} <= names
    assert len(build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # int8_panel launches kernel A (qmatmul_launch), not a probe kernel
    probes = {f"probe_{n}_launch" for n in (
        "hbm_scratch", "fori_dma", "argmax", "dyn_sublane", "rot", "onehot",
        "dyn_col_dma")}
    assert set(build.SIGNATURES) == {
        "gemv_launch", "gemv_int8_launch", "gemv_int4_launch",
        "gemv_blocks_per_sm", "qmatmul_map", "qmatmul_launch",
        "decode_attention_launch", "predictor_frame_query",
        "predictor_frame_launch", "talker_step_query",
        "talker_step_launch"} | probes
    # every C entry point the build binds is defined in a source
    text = "".join(open(p).read() for p in build.sources())
    for name in build.SIGNATURES:
        assert f"int {name}(" in text, name


def test_engine_without_device_needs_cuda(monkeypatch):
    """`TtsEngine()` with no `device` means the CUDA card: where there is
    none it raises instead of quietly running the plain versions on the
    CPU; `device="cpu"` still builds a CPU engine."""
    import torch
    from qwen3_tts_tpu_torch import TtsEngine, tiny_engine_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TtsEngine(config=tiny_engine_config(), random_weights=True)
    eng = TtsEngine(config=tiny_engine_config(), random_weights=True,
                    device="cpu")
    assert eng.device.type == "cpu"


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def test_engine_bridge_without_device_needs_cuda(monkeypatch):
    """`convert.engine_from_jax_arrays` without `device` means the CUDA
    card, as `TtsEngine()` does: where there is none it raises instead of
    quietly building a CPU engine; `device="cpu"` builds one."""
    import torch
    from qwen3_tts_tpu_torch import TtsEngine, tiny_engine_config
    cfg = tiny_engine_config()
    src = TtsEngine(config=cfg, random_weights=True, device="cpu")
    a = src.models["assets"]
    models = {"talker": _numpy_tree(src.models["talker"]),
              "predictor": _numpy_tree(src.models["predictor"]),
              "assets": {k: getattr(a, k).numpy() for k in (
                  "text_table", "codec_tables", "proj_weight", "proj_bias")}}
    voc = _numpy_tree(src.vocoder_params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.engine_from_jax_arrays(models, voc, cfg)
    eng = convert.engine_from_jax_arrays(models, voc, cfg, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.models["talker"]["head"].device.type == "cpu"


@pytest.mark.parametrize("M,K,N,splits", [(1, 2048, 4096, 4),
                                          (1, 6144, 2048, 8),
                                          (1, 1024, 1024, 8),
                                          (32, 2048, 12288, 1)])
def test_gemv_k_chunk_fills_the_card(M, K, N, splits):
    """B's K split (the cluster size) doubles until about one block runs on
    each of 132 SMs, at most 8 ways and within one wave of resident
    blocks (2 a SM here)."""
    from qwen3_tts_tpu_torch.ops import gemv
    got = gemv.gemv_splits(M, K, N, 2, sms=132, per_sm=2)
    assert got == splits
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    blocks = -(-N // gemv.TILE_N) * -(-M // mt) * splits
    assert blocks <= 264 or splits == 1
    assert blocks >= 132 * 7 // 8 or splits == gemv.MAX_SPLITS


@pytest.mark.parametrize("M,K,N,splits", [(1, 2048, 4096, 4),
                                          (1, 2048, 2048, 8),
                                          (1, 2048, 12288, 2),
                                          (1, 6144, 2048, 8),
                                          (2, 2048, 12288, 2),
                                          (1, 512, 4096, 2)])
def test_gemv4_k_split_fills_the_card(M, K, N, splits):
    """B4's K split doubles as B's does (up to about one block per SM,
    within one wave of 2 resident blocks a SM), capped at 8 and at the
    packed groups; the main path's plans are the fastest splits measured
    on the H100 (chip_smoke.py split_times)."""
    from qwen3_tts_tpu_torch.ops import gemv
    assert gemv.gemv4_splits(M, K, N, sms=132, per_sm=2) == splits
    assert splits <= K // (2 * gemv.GROUP4)


def _c_params(name, text):
    """The parameter types of `int name(...)` in the C sources: "P" for a
    pointer, "F" for a float, "I" for an int."""
    head = text[text.index(f"int {name}("):]
    params = head[len(f"int {name}("):head.index(")")].split(",")
    kinds = []
    for p in params:
        p = p.strip()
        kinds.append("P" if "*" in p else "F" if p.startswith("float")
                     else "I")
    return kinds


def test_signatures_match_the_c_entry_points():
    """ctypes passes each argument as SIGNATURES says: a pointer where the C
    function takes one, a float for a float, an int for an int, as many as
    it takes."""
    import ctypes
    text = "".join(open(p).read() for p in build.sources())
    code = {ctypes.c_void_p: "P", ctypes.c_float: "F", ctypes.c_int: "I",
            ctypes.c_longlong: "I"}
    for name, argtypes in build.SIGNATURES.items():
        assert [code[a] for a in argtypes] == _c_params(name, text), name


_TALKER_INT8 = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048),
                (2048, 2176)]


@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (64, 128, 192, 1088)
                                   for K, N in _TALKER_INT8]
                         + [(1, 128, 128), (37, 2048, 2176), (300, 256, 384),
                            (1, 2048, 4096)])
def test_qmatmul_plan_covers_each_tile_once(M, K, N):
    """Kernel A's plan: its blocks cover every (output row, column, K
    element) exactly once, each rank's K range whole 64 x 128 TMA boxes;
    the cluster is at most 8 ranks, the row tile one the kernel has, and
    the ring (two stages at least where a rank has more than one chunk)
    and the partial tile fit 227 KB of shared memory."""
    from qwen3_tts_tpu_torch.ops import quant
    p = quant.qmatmul_plan(M, K, N, sms=132)
    nx, ny, nz = N // p.bn, -(-M // p.mt), p.splits     # the launch's grid
    assert p.bn in (128, 256) and p.mt in quant.A_MT
    assert p.bn == 128 or p.mt <= quant.A_WIDE_MT
    assert p.splits in quant.A_SPLITS and p.splits <= 8
    assert 1 <= p.stages <= quant.A_MAX_STAGES
    assert quant.qmatmul_smem(p.mt, p.bn, p.stages) <= quant.A_SMEM
    assert (K // quant.A_BK) % p.splits == 0
    chunks = K // quant.A_BK // p.splits
    assert min(2, chunks) <= p.stages <= chunks
    cover = np.zeros((M, N // quant.A_BOX_N, K // quant.A_BK), np.int32)
    for bx in range(nx):
        for by in range(ny):
            for bz in range(nz):
                rows = slice(by * p.mt, min(M, (by + 1) * p.mt))
                cols = slice(bx * p.bn // quant.A_BOX_N,
                             (bx + 1) * p.bn // quant.A_BOX_N)
                ks = slice(bz * chunks, (bz + 1) * chunks)
                assert rows.start < M
                cover[rows, cols, ks] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("B,nk,T", [(1, 8, 256), (1, 8, 1024), (1, 8, 32),
                                    (2, 8, 600), (32, 8, 4096), (2, 2, 16)])
def test_attention_split_plan_covers_the_cache(B, nk, T):
    """The split count comes from B, nk and the capacity alone: a power of
    two up to 8, more only while B * nk clusters leave SMs idle and the
    cache has 32 slots a split; the same at 4096 slots as at 256."""
    from qwen3_tts_tpu_torch.ops import flash_decode
    s = flash_decode.attention_splits(B, nk, T, sms=132)
    assert 1 <= s <= flash_decode.MAX_SPLITS and s & (s - 1) == 0
    if s > 1:
        assert B * nk * s // 2 < 132 and (s // 2) * 32 < T
    if T >= 256:
        assert s == flash_decode.attention_splits(B, nk, 4096, sms=132)


def test_voice_file_and_audio_copies_roundtrip(tmp_path):
    from qwen3_tts_tpu_torch.utils.audio import AudioSample
    from qwen3_tts_tpu_torch.utils.voice_file import VoiceFile
    v = VoiceFile.load(os.path.join(REPO, "speakers", "vivian.json"))
    assert v.name == "vivian" and v.spk_emb.shape == (2048,)
    a = AudioSample(samples=np.linspace(-1, 1, 100, dtype=np.float32))
    a.save_wav(str(tmp_path / "a.wav"))
    b = AudioSample.load_wav(str(tmp_path / "a.wav"))
    # saved as round(x * 32767), read back as s16 / 32768
    np.testing.assert_allclose(b.samples, a.samples, atol=2 / 32767)


def test_facade_matches_jax():
    """The package exports the JAX package's facade, and PromptBuilder's
    build_core, build_custom_prompt and build_clone_prompt equal JAX's on
    the same tables."""
    import jax
    import qwen3_tts_tpu as J
    import qwen3_tts_tpu_torch as T
    from qwen3_tts_tpu.assets import tables as jtables
    assert set(J.__all__) == set(T.__all__)
    T.cleanup()
    a = jtables.random_assets(jax.random.key(2), text_vocab=256,
                              codec_rows=2176, dim=64, proj_dim=32)
    ta = convert.assets_from_numpy(
        np.asarray(a.text_table), np.asarray(a.codec_tables),
        np.asarray(a.proj_weight), np.asarray(a.proj_bias))
    def builders(cls):
        return {k for k in vars(cls) if k.startswith("build")}
    assert builders(J.PromptBuilder) == builders(T.PromptBuilder)
    ref = np.random.default_rng(3).integers(0, 2048, size=(4, 16))
    spk = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    for builder in ("build_core", "build_custom_prompt",
                    "build_clone_prompt"):
        kw = dict(text_ids=[5, 6, 7], lang_id=2050, instruct_ids=[9, 10])
        if builder == "build_custom_prompt":
            kw["spk_id"] = 3065
        if builder == "build_clone_prompt":
            kw.update(ref_codes=ref, ref_text_ids=[11, 12], spk_emb=spk)
        want = getattr(J.PromptBuilder, builder)(a, **kw)
        got = getattr(T.PromptBuilder, builder)(ta, **kw)
        np.testing.assert_allclose(got.embeds.numpy(),
                                   np.asarray(want.embeds), rtol=0,
                                   atol=1e-7)
        np.testing.assert_array_equal(got.text_ids, want.text_ids)
