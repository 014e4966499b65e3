"""The port's int8 / int4 quantization against the JAX package's
(`qwen3_tts_tpu/ops/quant.py`) on the CPU: the same numpy inputs through
both.

  * quantizers, `unpack4`, `dequant4_dt`, `quantize_decoder_params`:
    exactly equal (the port keeps JAX's order of f32 operations, rounds
    half to even and packs through uint8);
  * the products (`qmatmul`'s CPU branch, `qmatmul4`, the panel order,
    `linear`), kernel A's plain version against `_pallas_qmatmul` in
    interpret mode, and gemv's plain int8 / int4 versions against the TPU
    kernels' `stream_matmul` math (x @ deq * sc, then the epilogue):
    atol 1e-5 in f32 (reduction order differs).

Kernels A, B8 and B4 themselves are held against these plain versions on
the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch import TtsEngine, convert
from qwen3_tts_tpu_torch.ops import gemv, quant

ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(K=512, N=384, seed=0):
    """A weight with the corner cases of the quantizers: an all-zero
    column (the 1e-8 floor) and an all-zero k-group of another."""
    w = (0.05 * np.random.default_rng(seed).standard_normal((K, N))).astype(
        np.float32)
    w[:, 3] = 0.0
    w[:128, 5] = 0.0
    return w


def _both(w, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(w).astype(jd), torch.from_numpy(w).to(td)


def _equal(t, j):
    t = t.float() if t.is_floating_point() else t
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(
        t.numpy().dtype))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_int8_exact(dtype):
    jw, tw = _both(_weights(), dtype)
    j, t = jquant.quantize(jw), quant.quantize(tw)
    assert t["q"].dtype == torch.int8 and t["scale"].dtype == torch.float32
    for k in ("q", "scale"):
        _equal(t[k], j[k])
    _equal(quant.dequantize(t), jquant.dequantize(j))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_int4_and_unpack_exact(dtype):
    jw, tw = _both(_weights(), dtype)
    j, t = jquant.quantize_int4(jw), quant.quantize_int4(tw)
    assert t["q4"].shape == (256, 384) and t["m8"].shape == (4, 384)
    assert t["q4"].dtype == t["m8"].dtype == torch.int8
    for k in ("q4", "m8", "scale"):
        _equal(t[k], j[k])
    _equal(quant.unpack4(t["q4"]), jquant.unpack4(j["q4"]))
    _equal(quant.dequantize4(t), jquant.dequantize4(j))
    # the packing wraps: high nibbles >= 8 give negative int8 bytes
    assert int(t["q4"].min()) < 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequant4_dt_exact(dtype):
    jw, tw = _both(_weights(seed=1), "float32")
    j, t = jquant.quantize_int4(jw), quant.quantize_int4(tw)
    jd, td = DTYPES[dtype]
    got = quant.dequant4_dt(t["q4"], t["m8"], td)
    assert got.dtype == td
    _equal(got, jquant.dequant4_dt(j["q4"], j["m8"], jd).astype(jnp.float32))


def test_quantize_int4_rejects_ragged_rows():
    with pytest.raises(ValueError, match="multiples of 256"):
        quant.quantize_int4(torch.zeros(384, 16))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_decoder_params_exact(kind):
    cfg = tiny_engine_config().talker
    if kind == "int4":
        import dataclasses
        cfg = dataclasses.replace(cfg, hidden=256, n_q_heads=2, n_kv_heads=2,
                                  head_dim=128, ffn_dim=256,
                                  mrope_sections=(32, 16, 16, 0))
    jp = jdecoder.init_decoder(jax.random.key(2), cfg)
    jq = jquant.quantize_decoder_params(jp, kind=kind)
    tq = quant.quantize_decoder_params(
        convert.decoder_from_numpy(jax.tree.map(np.asarray, jp)), kind=kind)
    flat_j = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tq))
    for path, leaf in flat_j:
        node = tq
        for p in path:
            node = node[p.key]
        _equal(node, leaf)


# ------------------------------------------------------------ repair
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_bridge_keeps_quantized_scale_f32(kind):
    """A quantized tree of a bf16 config crosses `convert` with f32 scales
    and int8 q / q4 / m8, as the JAX package keeps them."""
    import dataclasses
    cfg = dataclasses.replace(tiny_engine_config().talker, hidden=256,
                              n_q_heads=2, n_kv_heads=2, head_dim=128,
                              ffn_dim=256, mrope_sections=(32, 16, 16, 0),
                              dtype="bfloat16")
    jq = jquant.quantize_decoder_params(
        jdecoder.init_decoder(jax.random.key(3), cfg), kind=kind)
    tq = convert.decoder_from_numpy(jax.tree.map(np.asarray, jq),
                                    dtype=torch.bfloat16)
    for w in [tq["layers"][n] for n in ("wqkv", "wo", "w_gu", "w_down")] \
            + [tq["head"]]:
        assert w["scale"].dtype == torch.float32
        for k in ("q", "q4", "m8"):
            if k in w:
                assert w[k].dtype == torch.int8, k
    _equal(tq["head"]["scale"], jq["head"]["scale"])
    assert tq["layers"]["ln1"].dtype == torch.bfloat16


def test_engine_quant_names_checkpoint_loading(tmp_path):
    """`quant=` picks a checkpoint's per-quant subdirectory, as in the JAX
    engine, and selects no quantized kernels: a random engine keeps it as
    a name, a loaded one reads `gguf_<quant>/` before the flat
    directory."""
    eng = TtsEngine(quant="q8_0", config=tiny_engine_config(),
                    random_weights=True, device="cpu")
    assert eng.quant == "q8_0"
    eng.save_checkpoint(str(tmp_path / "gguf_q8_0"))
    loaded = TtsEngine(model_dir=str(tmp_path), quant="q8_0",
                       config=tiny_engine_config(), device="cpu")
    assert torch.equal(loaded.models["talker"]["head"],
                       eng.models["talker"]["head"])
    with pytest.raises(FileNotFoundError, match="no embedding tables"):
        TtsEngine(model_dir=str(tmp_path), config=tiny_engine_config(),
                  device="cpu")


# ------------------------------------------------------------ products
def _x(M, K, seed=4):
    return np.random.default_rng(seed).standard_normal((M, K)).astype(
        np.float32)


@pytest.mark.parametrize("K,N", [(256, 128), (96, 40)],
                         ids=["lane_aligned", "ragged"])
def test_qmatmul_cpu_branch(K, N):
    w, x = _weights(K, N), _x(5, K)
    jw, tw = jquant.quantize(jnp.asarray(w)), quant.quantize(
        torch.from_numpy(w))
    _close(quant.qmatmul(torch.from_numpy(x).reshape(5, 1, K), tw),
           jquant.qmatmul(jnp.asarray(x).reshape(5, 1, K), jw))


def test_qmatmul_kernel_plain_matches_pallas_interpret():
    w, x = _weights(256, 256, seed=5), _x(3, 256, seed=6)
    jw = jquant.quantize(jnp.asarray(w))
    tw = quant.quantize(torch.from_numpy(w))
    ref = jquant._pallas_qmatmul(jnp.asarray(x), jw["q"], jw["scale"],
                                 tile_n=128, interpret=True)
    got = quant.qmatmul_kernel_plain(torch.from_numpy(x), tw["q"],
                                     tw["scale"])
    _close(got, ref)
    # the wrapper takes the plain version for CPU tensors
    _close(quant.qmatmul_kernel(torch.from_numpy(x), tw["q"], tw["scale"]),
           ref)


def test_qmatmul4_and_panel_order():
    w, x = _weights(512, 128, seed=7), _x(4, 512, seed=8)
    jw = jquant.quantize_int4(jnp.asarray(w))
    tw = quant.quantize_int4(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    _close(quant.qmatmul4(tx, tw), jquant.qmatmul4(jnp.asarray(x), jw))
    # the panel order, compared with the column scale applied (its raw sums
    # of nib * m8 run to ~1e4, where one f32 ulp is ~1e-3)
    ref = jquant.panel_matmul4(jnp.asarray(x), jw["q4"], jw["m8"],
                               jnp.float32) * jw["scale"]
    _close(quant.panel_matmul4_plain(tx, tw["q4"], tw["m8"]) * tw["scale"],
           ref)
    # the two orders agree to f32 reduction order
    _close(quant.qmatmul4(tx, tw), ref)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_linear_matches_jax(kind):
    w, x = _weights(512, 96, seed=9), _x(6, 512, seed=10)
    q = {"dense": lambda a: a, "int8": jquant.quantize,
         "int4": jquant.quantize_int4}[kind]
    tq = {"dense": lambda a: a, "int8": quant.quantize,
          "int4": quant.quantize_int4}[kind]
    xs = x.reshape(2, 3, 512)
    got = quant.linear(torch.from_numpy(xs), tq(torch.from_numpy(w)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 96)
    _close(got, jquant.linear(jnp.asarray(xs), q(jnp.asarray(w))))


# ------------------------------------------------------------ gemv plain
def _stream_matmul_ref(x, jw, kind, col0, n, epilogue, res):
    """The TPU kernels' stream_matmul for a quantized weight, then the
    epilogue (f32 model dtype: the dt round trips are exact)."""
    cols = slice(col0, col0 + n)
    xj = jnp.asarray(x)
    if kind == "int8":
        acc = xj @ jw["q"][:, cols].astype(jnp.float32)
    else:
        acc = jquant.panel_matmul4(xj, jw["q4"][:, cols], jw["m8"][:, cols],
                                   jnp.float32)
    acc = acc * jw["scale"][cols]
    return acc + res if epilogue == gemv.EPI_ADD_F32 else acc


@pytest.mark.parametrize("epilogue", [gemv.EPI_STORE_DT, gemv.EPI_F32,
                                      gemv.EPI_F32_ROUND_DT,
                                      gemv.EPI_ADD_F32])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_gemv_quantized_plain_matches_stream_matmul(kind, epilogue):
    K, N, col0, n = 512, 4 * 64, 2 * 64, 64      # a head-like column slice
    w, x = _weights(K, N, seed=11), _x(3, K, seed=12)
    res = np.random.default_rng(13).standard_normal((3, n)).astype(
        np.float32)
    jfn = jquant.quantize if kind == "int8" else jquant.quantize_int4
    tfn = quant.quantize if kind == "int8" else quant.quantize_int4
    jw, tw = jfn(jnp.asarray(w)), tfn(torch.from_numpy(w))
    out = torch.from_numpy(res.copy()) \
        if epilogue == gemv.EPI_ADD_F32 else None
    tx = torch.from_numpy(x)
    if kind == "int8":
        got = gemv.gemv_int8(tx, tw["q"], tw["scale"], col0=col0, n=n,
                             epilogue=epilogue, out=out)
    else:
        got = gemv.gemv_int4(tx, tw["q4"], tw["m8"], tw["scale"], col0=col0,
                             n=n, epilogue=epilogue, out=out)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    _close(got, _stream_matmul_ref(x, jw, kind, col0, n, epilogue, res))
