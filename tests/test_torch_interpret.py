"""The port against the JAX package's Pallas kernels themselves, run in
interpret mode on the CPU (marked slow, like the JAX kernel suites), on f32
tiny shapes: decode attention, the fused talker step and the fused
predictor frame, with dense, int8 and int4 weights. The port runs its
kernels' plain versions here. Tolerances: atol 1e-5 for attention, 1e-4
for the step's hidden and logits (f32, different reduction order; the int4
panel order is the same on both sides); codes exact.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import PredictorConfig, TalkerConfig
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import flash_decode as jflash
from qwen3_tts_tpu.ops import fused_predictor as jfused_predictor
from qwen3_tts_tpu.ops import fused_talker as jfused_talker
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch.ops import flash_decode, fused_predictor
from qwen3_tts_tpu_torch.ops import fused_talker

pytestmark = pytest.mark.slow

TC = TalkerConfig(hidden=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
                  head_dim=16, ffn_dim=128, vocab=2176, max_seq=512,
                  mrope_sections=(4, 2, 2, 0), dtype="float32")
PC = PredictorConfig(hidden=32, n_layers=2, n_q_heads=2, n_kv_heads=2,
                     head_dim=16, ffn_dim=64, max_seq=32,
                     mrope_sections=(8, 0, 0, 0), dtype="float32")
# int4 needs widths in whole packed groups (multiples of 256)
TC4 = dataclasses.replace(TC, hidden=256, n_q_heads=2, n_kv_heads=2,
                          head_dim=128, ffn_dim=256,
                          mrope_sections=(32, 16, 16, 0))
PC4 = dataclasses.replace(PC, hidden=256, n_q_heads=2, n_kv_heads=2,
                          head_dim=128, ffn_dim=256,
                          mrope_sections=(64, 0, 0, 0))
KINDS = {"dense": (TC, PC), "int8": (TC, PC), "int4": (TC4, PC4)}


def _quantized(params, kind):
    if kind == "dense":
        return params
    return jquant.quantize_decoder_params(params, kind=kind)


def _close(t, j, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


def test_decode_attention_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    L, B, nq, nk, T, hd = 2, 2, 4, 2, 512, 16
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, nq, hd), (B, nk, hd), (B, nk, hd)))
    kc, vc = (rng.standard_normal((L, B, nk, T, hd)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([300, 0], np.int32)
    vfrom = np.asarray([5, 0], np.int32)
    ref = jflash.decode_attention_stacked(
        *(jnp.asarray(a) for a in (q, kc, vc, kn, vn)), jnp.int32(1),
        jnp.asarray(lens), jnp.asarray(vfrom), interpret=True)
    got = flash_decode.decode_attention_stacked(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), 1,
        torch.from_numpy(lens), torch.from_numpy(vfrom))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_talker_step_matches_pallas_interpret(kind):
    TC, _ = KINDS[kind]
    ks = jax.random.split(jax.random.key(0), 3)
    B, S = 2, 5
    pad = np.asarray([0, 3], np.int32)
    jp = _quantized(jdecoder.init_decoder(ks[0], TC), kind)
    x = 0.1 * jax.random.normal(ks[1], (B, S, TC.hidden))
    pos = jnp.maximum(jnp.arange(S)[None] - jnp.asarray(pad)[:, None], 0)
    _, _, jcache = jdecoder.forward(
        jp, TC, x, pos, jdecoder.init_kv_cache(TC, B), jnp.int32(0),
        kv_valid_from=jnp.asarray(pad))
    fb = 0.1 * jax.random.normal(ks[2], (B, TC.hidden))
    slot = np.full((B,), S, np.int32)
    jh, jl, jk, jv = jfused_talker.talker_step_fused(
        jp, TC, fb, jnp.asarray(slot - pad), jnp.asarray(slot),
        jnp.asarray(slot), jnp.asarray(pad), jcache["k"], jcache["v"],
        interpret=True)
    tp = convert.decoder_from_numpy(jax.tree.map(np.asarray, jp))
    th, tl, tk, tv = fused_talker.talker_step_fused(
        tp, TC, torch.from_numpy(np.array(fb)),
        torch.from_numpy(slot - pad), S, torch.from_numpy(slot),
        torch.from_numpy(pad), torch.from_numpy(np.array(jcache["k"])),
        torch.from_numpy(np.array(jcache["v"])))
    _close(th, jh, 1e-4)
    _close(tl, jl, 1e-4)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_frame_codes_match_pallas_interpret(kind):
    TC, PC = KINDS[kind]
    k1, k2 = jax.random.split(jax.random.key(3))
    jp = _quantized(jdecoder.init_decoder(k1, PC), kind)
    ja = jtables.random_assets(k2, text_vocab=64, codec_rows=2176,
                               dim=TC.hidden, proj_dim=PC.hidden)
    jptab, rows = jfused_predictor.make_ptab(ja, PC)
    rng = np.random.default_rng(1)
    h1024 = rng.standard_normal((3, PC.hidden)).astype(np.float32)
    code0 = np.asarray([11, 3000, -4], np.int32)
    ref = jfused_predictor.frame_codes_fused(
        jp, PC, jptab, rows, jnp.asarray(h1024), jnp.asarray(code0),
        interpret=True)
    tp = convert.decoder_from_numpy(jax.tree.map(np.asarray, jp))
    ta = convert.assets_from_numpy(
        np.asarray(ja.text_table), np.asarray(ja.codec_tables),
        np.asarray(ja.proj_weight), np.asarray(ja.proj_bias))
    ptab, trows = fused_predictor.make_ptab(ta, PC)
    assert trows == rows
    got = fused_predictor.frame_codes_fused(
        tp, PC, ptab, trows, torch.from_numpy(h1024),
        torch.from_numpy(code0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
