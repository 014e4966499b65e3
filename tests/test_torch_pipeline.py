"""The port's offline slice as a whole against the JAX package, on the tiny
f32 config: greedy codes, frame counts, waveforms and the engine's output.

Both packages run the same weights (the JAX package's seeded init, carried
over by `qwen3_tts_tpu_torch.convert`) on the same numpy inputs. On the CPU
the JAX loop takes its XLA path and the port its kernels' plain versions.
"""

import json

import jax
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import SamplerConfig as JSamplerConfig
from qwen3_tts_tpu import TtsEngine as JTtsEngine
from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.models import vocoder as jvocoder
from qwen3_tts_tpu.tts import generate as jgenerate
from qwen3_tts_tpu_torch import SamplerConfig, convert
from qwen3_tts_tpu_torch.tts import generate as tgenerate

CFG = tiny_engine_config(max_steps=6)
WAV_ATOL = 1e-4     # f32 on both sides; reduction order differs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    k1, k2, k3, k4 = jax.random.split(jax.random.key(0), 4)
    jm = {
        "talker": jdecoder.init_decoder(k1, CFG.talker),
        "predictor": jdecoder.init_decoder(k2, CFG.predictor),
        "assets": jtables.random_assets(
            k3, text_vocab=256, codec_rows=2176,
            dim=CFG.talker.hidden, proj_dim=CFG.predictor.hidden),
    }
    jv = jvocoder.init_vocoder(k4, CFG.vocoder)
    a = jm["assets"]
    tm = {
        "talker": convert.decoder_from_numpy(_np(jm["talker"])),
        "predictor": convert.decoder_from_numpy(_np(jm["predictor"])),
        "assets": convert.assets_from_numpy(
            np.asarray(a.text_table), np.asarray(a.codec_tables),
            np.asarray(a.proj_weight), np.asarray(a.proj_bias)),
    }
    tv = convert.vocoder_from_numpy(_np(jv))
    return jm, jv, tm, tv


def _batch(lengths, seed=1):
    """Left-padded prompt batch [B, S, H] and pad offsets, from numpy."""
    rng = np.random.default_rng(seed)
    S = max(lengths)
    x = np.zeros((len(lengths), S, CFG.talker.hidden), np.float32)
    for b, n in enumerate(lengths):
        x[b, S - n:] = 0.1 * rng.standard_normal((n, CFG.talker.hidden))
    pad = np.asarray([S - n for n in lengths], np.int32)
    return x, pad


@pytest.mark.parametrize("lengths", [(7,), (7, 4)], ids=["b1", "b2_padded"])
def test_generate_codes_greedy_exact(weights, lengths):
    jm, _, tm, _ = weights
    x, pad = _batch(lengths)
    jcodes, jn = jgenerate.generate_codes(
        jm, CFG.talker, CFG.predictor, jax.numpy.asarray(x),
        jax.numpy.asarray(pad), jax.random.key(0), 0.0, 0, 1.0,
        CFG.max_steps)
    tcodes, tn = tgenerate.generate_codes(
        tm, CFG.talker, CFG.predictor, torch.from_numpy(x),
        torch.from_numpy(pad), None, 0.0, 0, 1.0, CFG.max_steps)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert int(tn.min()) > 0


def test_generate_codes_step_cap_and_ignore_eos(weights):
    jm, _, tm, _ = weights
    x, pad = _batch((5,), seed=3)
    jcodes, jn = jgenerate.generate_codes(
        jm, CFG.talker, CFG.predictor, jax.numpy.asarray(x),
        jax.numpy.asarray(pad), jax.random.key(0), 0.0, 0, 1.0,
        CFG.max_steps, ignore_eos=True, step_cap=jax.numpy.int32(4))
    tcodes, tn = tgenerate.generate_codes(
        tm, CFG.talker, CFG.predictor, torch.from_numpy(x),
        torch.from_numpy(pad), None, 0.0, 0, 1.0, CFG.max_steps,
        ignore_eos=True, step_cap=4)
    assert int(tn[0]) == int(jn[0]) == 4
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))


def test_generate_audio_matches(weights):
    jm, jv, tm, tv = weights
    x, pad = _batch((7, 4), seed=2)
    jwav, jn = jgenerate.generate_audio(
        jm, jv, CFG.talker, CFG.predictor, CFG.vocoder, jax.numpy.asarray(x),
        jax.numpy.asarray(pad), jax.random.key(0), 0.0, 0, 1.0,
        CFG.max_steps)
    twav, tn = tgenerate.generate_audio(
        tm, tv, CFG.talker, CFG.predictor, CFG.vocoder, torch.from_numpy(x),
        torch.from_numpy(pad), None, 0.0, 0, 1.0, CFG.max_steps)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert twav.shape == tuple(jwav.shape)
    np.testing.assert_allclose(twav.numpy(), np.asarray(jwav), rtol=0,
                               atol=WAV_ATOL)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    with open(sdir / "vivian.json", "w") as f:
        json.dump({"name": "vivian", "spk_id": 3065,
                   "spk_emb": emb.tolist()}, f)
    cfg = tiny_engine_config(max_steps=8)
    jeng = JTtsEngine(config=cfg, random_weights=True, seed=0,
                      speakers_dir=str(sdir), compile_cache=False)
    jeng.set_sampler_config(JSamplerConfig(temperature=0.0, top_k=0,
                                           top_p=1.0, seed=42))
    teng = convert.engine_from_jax_arrays(
        _np({k: jeng.models[k] for k in ("talker", "predictor")})
        | {"assets": jeng.models["assets"]},
        _np(jeng.vocoder_params), cfg, speakers_dir=str(sdir))
    teng.set_sampler_config(SamplerConfig(temperature=0.0, top_k=0,
                                          top_p=1.0, seed=42))
    return jeng, teng


@pytest.mark.parametrize("text", ["hello", "a longer sentence here"])
def test_engine_generate_with_voice_matches_jax(engines, text):
    jeng, teng = engines
    jaudio = jeng.generate_with_voice(text, jeng.get_speaker("vivian"))
    taudio = teng.generate_with_voice(text, teng.get_speaker("vivian"))
    assert taudio.sample_rate == jaudio.sample_rate
    assert len(taudio.samples) == len(jaudio.samples) > 0
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0,
                               atol=WAV_ATOL)


def test_engine_generate_batch_matches_single(engines):
    _, teng = engines
    v = teng.get_speaker("vivian")
    single = teng.generate_with_voice("hello", v)
    batch = teng.generate_batch(["hello", "a longer sentence here"], [v, v])
    assert len(batch) == 2
    np.testing.assert_allclose(batch[0].samples, single.samples, rtol=0,
                               atol=WAV_ATOL)


def test_engine_speaker_fallback(engines):
    _, teng = engines
    assert teng.get_speaker("does-not-exist").name == "vivian"
