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
            "qwen3_tts_tpu_torch.ops.chain, qwen3_tts_tpu_torch.tts.engine; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'qwen3_tts_tpu.'))] "
            "+ [m for m in ('triton', 'qwen3_tts_tpu') if m in sys.modules]; "
            "assert not bad, bad")
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


def test_kernel_sources_and_build_key():
    names = {os.path.basename(p) for p in build.sources()}
    assert {"gemv.cu", "decode_attention.cu"} <= names
    assert len(build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.SIGNATURES) == {"gemv_launch", "decode_attention_launch"}


@pytest.mark.parametrize("M,K,N,chunk", [(1, 2048, 4096, 64),
                                         (1, 6144, 2048, 128),
                                         (1, 1024, 1024, 32),
                                         (32, 2048, 12288, 256)])
def test_gemv_k_chunk_fills_the_card(M, K, N, chunk):
    from qwen3_tts_tpu_torch.ops import gemv
    assert gemv.k_chunk(M, K, N) == chunk


@pytest.mark.parametrize("B,nk,T", [(1, 8, 256), (1, 8, 1024), (1, 8, 32),
                                    (2, 8, 600), (32, 8, 4096), (2, 2, 16)])
def test_attention_split_plan_covers_the_cache(B, nk, T):
    from qwen3_tts_tpu_torch.ops import flash_decode
    n_splits, per = flash_decode.split_plan(B, nk, T)
    tiles = -(-T // flash_decode.TILE)
    assert n_splits * per >= tiles > (n_splits - 1) * per
    # whole tiles per range: at least half the ranges that fill the card
    assert 2 * n_splits >= min(tiles, -(-264 // (B * nk)))


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
