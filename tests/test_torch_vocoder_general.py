"""The port's general vocoder family (BigVGAN/DAC upsampler: transposed
convs with kernel != stride, residual dilated units, a final conv) and the
snake activation, against the JAX package on the CPU, tiny f32 config (the
general config of tests/test_vocoder.py:321).

Weights are the JAX package's seeded init at scale 0.06 (carried over by
`qwen3_tts_tpu_torch.convert`): at JAX's default 0.02 the general path's
waveform peaks near 1e-8 and every tolerance would pass anything; at 0.08
snake saturates the tanh head.

Tolerances:
  * port against JAX: atol 1e-5 x the waveform's peak (f32 on both sides,
    convolutions summed in another order; measured <= 1.2e-6 x peak);
  * the port chunked against its one-shot: atol 2e-6 x the peak. JAX
    holds its own to rtol 1e-4, atol 1e-12 (tests/test_vocoder.py:331,
    "bit-exact"); torch's CPU convolutions give equal bits at ~5% of the
    samples only, because a window of another extent is summed in another
    order, and then samples near zero miss that rtol (0.2-0.6% of them,
    by up to 1.4e-10 at a 2.8e-4 peak). Measured <= 5.2e-7 x peak;
  * a bf16 trunk (`with_dtype`): atol 1e-2 x peak against JAX's bf16 trunk
    (both round the transformer's matmuls to bf16, in another order;
    measured <= 4.9e-3 x peak).

The configs are the JAX package's dataclasses; the port takes them as its
own (same fields) and its loader returns its own class, so configs are
compared field by field.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import SamplerConfig as JSamplerConfig
from qwen3_tts_tpu import TtsEngine as JTtsEngine
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import vocoder as jvocoder
from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, convert
from qwen3_tts_tpu_torch.assets import checkpoint
from qwen3_tts_tpu_torch.core.config import (load_vocoder_config,
                                             save_vocoder_config)
from qwen3_tts_tpu_torch.models import vocoder as tvocoder

CFG = tiny_engine_config().vocoder
GCFG = dataclasses.replace(CFG, upsample_kernels=(10, 10, 10, 8, 8),
                           resblock_dilations=(1, 3), resblock_kernel=7,
                           final_conv_kernel=7)
GCFG_SNAKE = dataclasses.replace(GCFG, activation="snake")
SNAKE = dataclasses.replace(CFG, activation="snake")
F = CFG.frame_samples
SCALE = 0.06
JAX_TOL = 1e-5        # x peak, port against JAX
SELF_TOL = 2e-6       # x peak, chunked against one-shot
BF16_TOL = 1e-2       # x peak, bf16 trunk against JAX's bf16 trunk

FAMILIES = {"general": GCFG, "general_snake": GCFG_SNAKE,
            "matmul_snake": SNAKE}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """{family: (JAX params, port params)} on the same weights."""
    out = {}
    for i, (name, cfg) in enumerate(FAMILIES.items()):
        jp = jvocoder.init_vocoder(jax.random.key(i + 1), cfg, scale=SCALE)
        if cfg.activation == "snake":
            # alphas off their init value of 1, so each site's own is used
            jp = jax.tree_util.tree_map_with_path(
                lambda path, a: a + 0.5 * jnp.cos(
                    jnp.arange(a.size, dtype=jnp.float32))
                if "alpha" in jax.tree_util.keystr(path) else a, jp)
        out[name] = (jp, convert.vocoder_from_numpy(_np(jp)))
    return out


def _codes(n_frames, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.code_vocab, size=(batch, n_frames, 16)
                        ).astype(np.int32)


def _jax_oneshot(jp, cfg, codes):
    wav, valid, _ = jvocoder.decode(
        jp, cfg, jnp.asarray(codes), jvocoder.init_state(cfg, codes.shape[0]),
        True)
    return [np.asarray(wav)[b, : int(valid[b])] for b in range(len(valid))]


def _port_oneshot(tp, cfg, codes):
    wav, valid, _ = tvocoder.decode(
        tp, cfg, torch.from_numpy(codes),
        tvocoder.init_state(cfg, codes.shape[0]), True)
    return [wav[b, : int(valid[b])].numpy() for b in range(len(valid))]


def _chunked(tp, cfg, codes, size=4):
    state = tvocoder.init_state(cfg, 1)
    pieces = []
    total = codes.shape[1]
    for s in range(0, total, size):
        wav, valid, state = tvocoder.decode(
            tp, cfg, torch.from_numpy(codes[:, s:s + size]), state,
            s + size >= total)
        pieces.append(wav[0, : int(valid[0])].numpy())
    return np.concatenate(pieces)


def _close(got, want, tol=JAX_TOL):
    assert got.shape == want.shape
    if want.size == 0:
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _self_close(got, want):
    _close(got, want, SELF_TOL)


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize("cfg", [
    CFG, GCFG, GCFG_SNAKE,
    dataclasses.replace(GCFG, upsample_pads=(0, 5, 2, 4, 0)),
    dataclasses.replace(GCFG, upsample_channels=(64, 48, 40, 33, 32),
                        resblock_dilations=(1, 3, 9)),
    dataclasses.replace(GCFG, resblock_dilations=(), final_conv_kernel=3),
], ids=["matmul", "general", "snake", "pads", "channels", "no_res"])
def test_up_context_and_schedules_match_jax(cfg):
    assert tvocoder.up_context(cfg) == jvocoder.up_context(cfg)
    if cfg.general_upsampler:
        assert tvocoder.stage_pads(cfg) == jvocoder.stage_pads(cfg)
        assert tvocoder.up_channels(cfg) == jvocoder.up_channels(cfg)
        ctx_l, ctx_r = tvocoder.up_context(cfg)
        assert ctx_l > 0 and ctx_r > 0
    else:
        assert tvocoder.up_context(cfg) == (0, 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_tree_matches_jax(family):
    """Same tree paths and shapes as the JAX package's init, so a
    checkpoint of either loads in the other; snake sites carry alphas
    (none on the matmul path's last stage), gelu sites none."""
    cfg = FAMILIES[family]
    jp = jvocoder.init_vocoder(jax.random.key(0), cfg)
    tp = tvocoder.init_vocoder(torch.Generator().manual_seed(0), cfg)
    want = {k: tuple(np.shape(v)) for k, v in
            checkpoint.flatten(_np(jp))}
    got = {k: tuple(v.shape) for k, v in checkpoint.flatten(tp)}
    assert got == want
    alphas = [k for k in got if "alpha" in k]
    assert bool(alphas) == (cfg.activation == "snake")
    n_up = len(cfg.upsample_factors)
    assert f"up/{n_up - 1}/alpha" not in got or cfg.general_upsampler
    state = tvocoder.init_state(cfg, 2)
    assert tuple(state.up_hist.shape) == (2, cfg.hidden,
                                          sum(tvocoder.up_context(cfg)))


# -------------------------------------------------------------- decoding
@pytest.mark.parametrize("family", list(FAMILIES))
def test_oneshot_matches_jax(params, family):
    jp, tp = params[family]
    cfg = FAMILIES[family]
    codes = _codes(11, seed=3)
    want = _jax_oneshot(jp, cfg, codes)[0]
    got = _port_oneshot(tp, cfg, codes)[0]
    assert got.shape == (11 * F,)
    assert np.abs(want).max() > 1e-4
    _close(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("total", [9, 11])
def test_chunked_equals_oneshot(params, family, total):
    """Chunked decode (4-frame calls, is_last on the final one) against
    one-shot: the overlap-recompute window with per-layer masks is the
    one-shot computation for every emitted sample (see the module
    docstring for the tolerance)."""
    jp, tp = params[family]
    cfg = FAMILIES[family]
    codes = _codes(total, seed=total)
    one = _port_oneshot(tp, cfg, codes)[0]
    got = _chunked(tp, cfg, codes)
    _self_close(got, one)
    _close(got, _jax_oneshot(jp, cfg, codes)[0])


def test_valid_and_widths_match_jax(params):
    """Per call: the same valid counts as JAX, and wav is (N + LA + ctx_r)
    frames wide (the emission delay), the first chunk holding back
    LA + ctx_r frames."""
    jp, tp = params["general"]
    ctx_r = tvocoder.up_context(GCFG)[1]
    codes = _codes(13, seed=4)
    js, ts = jvocoder.init_state(GCFG, 1), tvocoder.init_state(GCFG, 1)
    for s in range(0, 13, 4):
        part = codes[:, s:s + 4]
        last = s + 4 >= 13
        jw, jv, js = jvocoder.decode(jp, GCFG, jnp.asarray(part), js, last)
        tw, tv, ts = tvocoder.decode(tp, GCFG, torch.from_numpy(part), ts,
                                     last)
        n = part.shape[1]
        assert tuple(tw.shape) == (1, (n + CFG.lookahead + ctx_r) * F)
        assert tv.tolist() == np.asarray(jv).tolist()
        if s == 0:
            assert int(tv[0]) == max(4 - CFG.lookahead - ctx_r, 0) * F
        _close(tw[0, : int(tv[0])].numpy(), np.asarray(jw)[0, : int(jv[0])])
    np.testing.assert_allclose(ts.up_hist.numpy(), np.asarray(js.up_hist),
                               rtol=0, atol=1e-5 * np.abs(
                                   np.asarray(js.up_hist)).max())


@pytest.mark.parametrize("family", ["general", "general_snake"])
def test_flush_drains_pending(params, family):
    """A stream that ends between calls: decode without is_last, then
    flush, gives the one-shot samples, and JAX's flush."""
    jp, tp = params[family]
    cfg = FAMILIES[family]
    codes = _codes(7, seed=5)
    one = _port_oneshot(tp, cfg, codes)[0]
    state = tvocoder.init_state(cfg, 1)
    w1, v1, state = tvocoder.decode(tp, cfg, torch.from_numpy(codes), state,
                                    False)
    w2, v2, _ = tvocoder.flush(tp, cfg, state)
    got = np.concatenate([w1[0, : int(v1[0])].numpy(),
                          w2[0, : int(v2[0])].numpy()])
    _self_close(got, one)
    js = jvocoder.init_state(cfg, 1)
    _, _, js = jvocoder.decode(jp, cfg, jnp.asarray(codes), js, False)
    jw2, jv2, _ = jvocoder.flush(jp, cfg, js)
    assert v2.tolist() == np.asarray(jv2).tolist()
    _close(w2[0, : int(v2[0])].numpy(), np.asarray(jw2)[0, : int(jv2[0])])


def test_short_stream_ends_on_its_first_call(params):
    """Fewer frames than the upsampler's context, flushed on the first call
    (both window edges are stream edges), and the same in 1-frame calls."""
    jp, tp = params["general"]
    codes = _codes(2, seed=6)
    assert 2 < sum(tvocoder.up_context(GCFG))
    one = _port_oneshot(tp, GCFG, codes)[0]
    assert one.shape == (2 * F,)
    _close(one, _jax_oneshot(jp, GCFG, codes)[0])
    _self_close(_chunked(tp, GCFG, codes, size=1), one)


def test_per_row_is_last_matches_jax(params):
    jp, tp = params["general"]
    codes = _codes(4, batch=2, seed=7)
    last = np.asarray([True, False])
    jw, jv, _ = jvocoder.decode(jp, GCFG, jnp.asarray(codes),
                                jvocoder.init_state(GCFG, 2),
                                jnp.asarray(last))
    tw, tv, _ = tvocoder.decode(tp, GCFG, torch.from_numpy(codes),
                                tvocoder.init_state(GCFG, 2),
                                torch.from_numpy(last))
    assert tv.tolist() == np.asarray(jv).tolist()
    assert tv[0] == 4 * F and tv[1] < 4 * F
    for b in range(2):
        _close(tw[b, : int(tv[b])].numpy(), np.asarray(jw)[b, : int(jv[b])])
    solo = _port_oneshot(tp, GCFG, codes[:1])[0]
    _close(tw[0, : int(tv[0])].numpy(), solo)


def test_gather_row_and_reset_row(params):
    """A row taken out of a batch and flushed alone gives the solo stream's
    samples; reset_row returns the row to the stream-start state."""
    jp, tp = params["general"]
    codes = _codes(5, batch=3, seed=8)
    state = tvocoder.init_state(GCFG, 3)
    _, _, state = tvocoder.decode(tp, GCFG, torch.from_numpy(codes), state,
                                  False)
    w_row, v_row, _ = tvocoder.flush(tp, GCFG,
                                     tvocoder.gather_row(state, 1))
    solo = tvocoder.init_state(GCFG, 1)
    _, _, solo = tvocoder.decode(tp, GCFG, torch.from_numpy(codes[1:2]),
                                 solo, False)
    w_solo, v_solo, _ = tvocoder.flush(tp, GCFG, solo)
    assert v_row.tolist() == v_solo.tolist() and int(v_row[0]) > 0
    _close(w_row.numpy(), w_solo.numpy())
    assert float(state.up_hist[1].abs().max()) > 0
    tvocoder.reset_row(state, 1)
    assert int(state.frames_done[1]) == 0
    assert float(state.up_hist[1].abs().max()) == 0.0
    assert float(state.up_hist[0].abs().max()) > 0


@pytest.mark.parametrize("family", ["general_snake", "matmul_snake"])
def test_with_dtype_bf16_matches_jax(params, family):
    """A bf16 transformer trunk (`with_dtype`) with snake: the trunk cast,
    the alphas and convolutions kept f32, as in JAX."""
    jp, tp = params[family]
    cfg = dataclasses.replace(FAMILIES[family], dtype="bfloat16")
    jb, tb = jvocoder.with_dtype(jp, cfg), tvocoder.with_dtype(tp, cfg)
    assert tb["transformer"]["layers"]["wqkv"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32
               for k, v in checkpoint.flatten(tb)
               if not k.startswith("transformer/"))
    codes = _codes(6, seed=9)
    want = _jax_oneshot(jb, cfg, codes)[0]
    got = _port_oneshot(tb, cfg, codes)[0]
    _close(got, want, BF16_TOL)


# ------------------------------------------------------ through the engine
@pytest.fixture(scope="module")
def general_engines(tmp_path_factory):
    """A JAX engine with the general snake vocoder saved by the JAX
    package; the port loads the directory (its config names the default
    vocoder: vocoder_config.json must switch it)."""
    cfg = dataclasses.replace(tiny_engine_config(max_steps=10),
                              vocoder=GCFG_SNAKE)
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    (sdir / "vivian.json").write_text(json.dumps(
        {"name": "vivian", "spk_emb": emb.tolist()}))
    jeng = JTtsEngine(config=cfg, random_weights=True, seed=3,
                      speakers_dir=str(sdir), compile_cache=False)
    jeng.vocoder_params = jvocoder.init_vocoder(jax.random.key(9),
                                                GCFG_SNAKE, scale=SCALE)
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0, seed=1)
    jeng.set_sampler_config(JSamplerConfig(**greedy))
    model_dir = tmp_path_factory.mktemp("general_ckpt")
    jeng.save_checkpoint(str(model_dir))
    teng = TtsEngine(model_dir=str(model_dir),
                     config=tiny_engine_config(max_steps=10), device="cpu",
                     speakers_dir=str(sdir))
    teng.set_sampler_config(SamplerConfig(**greedy))
    return jeng, teng, model_dir


def test_engine_model_dir_general_vocoder_matches_jax(general_engines):
    jeng, teng, model_dir = general_engines
    want_cfg = dataclasses.asdict(GCFG_SNAKE)
    assert dataclasses.asdict(teng.config.vocoder) == want_cfg
    assert dataclasses.asdict(load_vocoder_config(
        str(model_dir / "vocoder_config.json"))) == want_cfg
    assert "final" in teng.vocoder_params
    want = jeng.generate_with_voice("general vocoder", jeng.get_speaker(
        "vivian"))
    got = teng.generate_with_voice("general vocoder", teng.get_speaker(
        "vivian"))
    assert len(got.samples) == len(want.samples) > 0
    _close(got.samples, want.samples)


def test_engine_stream_general_vocoder(general_engines):
    """generate_stream through VocoderPipeline with the wider general-path
    chunks: whole frames, trimmed by valid, equal to JAX's stream.

    Against the offline waveform only the frames before the last LA +
    ctx_l agree, in JAX as in the port: the offline path decodes the
    frame bucket in one call, so the lookahead of the last frames sees the
    zero-code frames past EOS, where the stream's flush sees zeros (on the
    matmul path the last LA frames differ the same way)."""
    jeng, teng, model_dir = general_engines
    voice = teng.get_speaker("vivian")
    chunks = []
    streamed = teng.generate_stream("general vocoder", voice,
                                    on_chunk=chunks.append)
    offline = teng.generate_with_voice("general vocoder", voice)
    jstream = jeng.generate_stream("general vocoder",
                                   jeng.get_speaker("vivian"))
    assert len(streamed.samples) == len(offline.samples) \
        == len(jstream.samples) > 0
    for c in chunks:
        assert len(c) % F == 0 and len(c) > 0
    np.testing.assert_array_equal(np.concatenate(chunks), streamed.samples)
    _close(streamed.samples, jstream.samples)
    head = len(offline.samples) - (GCFG.lookahead
                                   + tvocoder.up_context(GCFG)[0]) * F
    assert head > 0
    _self_close(streamed.samples[:head], offline.samples[:head])
    out = model_dir / "resaved"
    teng.save_checkpoint(str(out))
    save_vocoder_config(str(out / "again.json"), teng.config.vocoder)
    assert dataclasses.asdict(load_vocoder_config(
        str(out / "vocoder_config.json"))) == dataclasses.asdict(
        load_vocoder_config(str(out / "again.json"))) \
        == dataclasses.asdict(GCFG_SNAKE)


def test_f32_exact_scopes_tf32_across_threads():
    """The TF32 switches are process-global and the vocoder runs on a
    worker thread beside generation: inside every overlapping
    `f32_exact` scope both are off, and only the last exit restores the
    caller's values (a lost update of the scope count would restore them
    early or never). On the CPU the switches are plain flags, and
    `torch.device("cuda")` needs no card; a CPU scope changes nothing."""
    import os
    import sys
    import threading

    from qwen3_tts_tpu_torch.core.precision import f32_exact

    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    interval = sys.getswitchinterval()
    bad = []

    def worker():
        for _ in range(200):
            with f32_exact("cuda"):
                if torch.get_float32_matmul_precision() != "highest" \
                        or torch.backends.cudnn.allow_tf32:
                    bad.append(1)

    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        with f32_exact("cpu"):
            assert torch.backends.cudnn.allow_tf32
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 1) + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
