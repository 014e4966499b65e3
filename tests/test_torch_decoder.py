"""The port's decoder, fused talker step and fused predictor frame against
the JAX package on the tiny f32 config.

On the CPU the JAX `talker.step` and `predictor.frame_codes` take their XLA
path, which the JAX kernel suites hold equal to the Pallas kernels in f32
(to ~1e-7). The port's fused functions run their kernels' plain versions
here. Tolerances: hidden/logits atol 1e-4 (f32, different reduction order
and, in the fused step, an f32 residual against XLA's); codes exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.models import predictor as jpredictor
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops import fused_predictor, fused_talker

CFG = tiny_engine_config()
TC, PC = CFG.talker, CFG.predictor
ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def talker_params():
    jp = jdecoder.init_decoder(jax.random.key(1), TC)
    return jp, convert.decoder_from_numpy(_np(jp))


@pytest.fixture(scope="module")
def prefilled(talker_params):
    """Left-padded batch of 2 through prefill in both packages."""
    jp, tp = talker_params
    rng = np.random.default_rng(0)
    B, S = 2, 9
    x = (0.1 * rng.standard_normal((B, S, TC.hidden))).astype(np.float32)
    pad = np.asarray([0, 4], np.int32)
    x[1, :4] = 0.0
    T = 32
    jh, jl, jcache = jtalker.prefill(
        jp, TC, jnp.asarray(x), jnp.asarray(pad),
        jdecoder.init_kv_cache(TC, B, length=T))
    tcache = tdecoder.init_kv_cache(TC, B, length=T)
    th, tl, tcache = ttalker.prefill(tp, TC, torch.from_numpy(x),
                                     torch.from_numpy(pad), tcache)
    return dict(x=x, pad=pad, S=S, jh=jh, jl=jl, jcache=jcache, th=th, tl=tl,
                tcache=tcache)


def test_forward_prefill_left_padded_batch(prefilled):
    p = prefilled
    _close(p["th"], p["jh"])
    _close(p["tl"], p["jl"])
    for name in ("k", "v"):
        _close(p["tcache"][name], p["jcache"][name])


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_talker_step_fused_matches_jax_step(talker_params, prefilled, fn):
    jp, tp = talker_params
    p = prefilled
    rng = np.random.default_rng(1)
    fb = (0.1 * rng.standard_normal((2, TC.hidden))).astype(np.float32)
    slot = p["S"]
    jh, jl, jcache = jtalker.step(jp, TC, jnp.asarray(fb), jnp.int32(slot),
                                  jnp.asarray(p["pad"]), p["jcache"])
    tk = p["tcache"]["k"].clone()
    tv = p["tcache"]["v"].clone()
    pad = torch.from_numpy(p["pad"])
    slot_b = torch.full((2,), slot, dtype=torch.int32)
    step = fused_talker.talker_step_fused_plain if fn == "plain" \
        else fused_talker.talker_step_fused
    th, tl, tk, tv = step(tp, TC, torch.from_numpy(fb), slot_b - pad, slot,
                          slot_b, pad, tk, tv)
    _close(th, jh)
    _close(tl, jl)
    _close(tk, jcache["k"])
    _close(tv, jcache["v"])


def test_decoder_forward_single_token_matches_jax(talker_params, prefilled):
    """forward at S == 1 goes through decode attention (pre-update)."""
    jp, tp = talker_params
    p = prefilled
    rng = np.random.default_rng(2)
    x = (0.1 * rng.standard_normal((2, 1, TC.hidden))).astype(np.float32)
    pos = (p["S"] - p["pad"])[:, None].astype(np.int32)
    jh, jl, jcache = jdecoder.forward(
        jp, TC, jnp.asarray(x), jnp.asarray(pos), p["jcache"],
        jnp.int32(p["S"]), kv_valid_from=jnp.asarray(p["pad"]))
    cache = {k: v.clone() for k, v in p["tcache"].items()}
    th, tl, cache = tdecoder.forward(
        tp, TC, torch.from_numpy(x), torch.from_numpy(pos), cache, p["S"],
        kv_valid_from=torch.from_numpy(p["pad"]))
    _close(th, jh)
    _close(tl, jl)
    _close(cache["k"], jcache["k"])


def test_head_logits_column_slice_matches_jax(talker_params):
    jp, tp = talker_params
    h = np.random.default_rng(4).standard_normal((3, TC.hidden)).astype(
        np.float32)
    ref = jdecoder.head_logits(jp, jnp.asarray(h), jnp.int32(128), 256)
    _close(tdecoder.head_logits(tp, torch.from_numpy(h), 128, 256), ref)


PRED_CONFIGS = {
    "mha": PC,
    "gqa": dataclasses.replace(PC, n_q_heads=4, n_kv_heads=2, head_dim=8,
                               mrope_sections=(4, 0, 0, 0)),
}


@pytest.fixture(scope="module", params=sorted(PRED_CONFIGS))
def predictor_setup(request):
    pc = PRED_CONFIGS[request.param]
    k1, k2 = jax.random.split(jax.random.key(7))
    jp = jdecoder.init_decoder(k1, pc)
    ja = jtables.random_assets(k2, text_vocab=64, codec_rows=2176,
                               dim=TC.hidden, proj_dim=pc.hidden)
    ta = convert.assets_from_numpy(
        np.asarray(ja.text_table), np.asarray(ja.codec_tables),
        np.asarray(ja.proj_weight), np.asarray(ja.proj_bias))
    tp = convert.decoder_from_numpy(_np(jp))
    ptab, rows = fused_predictor.make_ptab(ta, pc)
    return pc, jp, ja, tp, ta, ptab, rows


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_frame_codes_fused_matches_jax(predictor_setup, fn):
    pc, jp, ja, tp, ta, ptab, rows = predictor_setup
    rng = np.random.default_rng(3)
    h1024 = rng.standard_normal((4, pc.hidden)).astype(np.float32)
    # in range, past the real rows (bias row), negative (clamps to 0)
    code0 = np.asarray([17, 2100, 3000, -5], np.int32)
    ref = jpredictor.frame_codes(jp, pc, ja, jnp.asarray(h1024),
                                 jnp.asarray(code0))
    frame = fused_predictor.frame_codes_fused_plain if fn == "plain" \
        else fused_predictor.frame_codes_fused
    got = frame(tp, pc, ptab, rows, torch.from_numpy(h1024),
                torch.from_numpy(code0))
    assert got.dtype == torch.int32 and got.shape == (4, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_make_ptab_matches_codec_embedding_1024(predictor_setup):
    pc, _, ja, _, _, ptab, rows = predictor_setup
    assert rows == 2176
    assert ptab.shape[1] > rows             # at least one bias row
    q = np.arange(16)[:, None]
    codes = np.asarray([0, 5, 2175])[None]
    ref = ja.codec_embedding_1024(jnp.asarray(q), jnp.asarray(codes))
    _close(ptab[:, [0, 5, 2175]], ref, atol=1e-6)
    # rows past the real ones hold the projection bias (an OOB code's value)
    _close(ptab[:, -1], np.broadcast_to(np.asarray(ja.proj_bias),
                                        (16, pc.hidden)), atol=0)
