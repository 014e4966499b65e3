"""The port's `models/predictor.py` against the JAX package's, and Jacobi
decoding in the port's generation loop (`QWEN3_TTS_PRED_JACOBI=1`).

Small f32 predictors (2 layers; the 256-wide config of JAX's own int4 test
for int4 weights) with the JAX package's seeded weights carried over by
`qwen3_tts_tpu_torch.convert`, the same numpy inputs on both sides. On
the CPU the port's products and attention take their plain versions and
JAX its XLA path. Codes: exact. The counterparts are
`tests/test_generate.py:202-248` and `tests/test_fused_predictor.py`.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import PredictorConfig, tiny_engine_config
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.models import predictor as jpredictor
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.tts import generate as jgenerate
from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, convert, serving
from qwen3_tts_tpu_torch.assets import tables as ttables
from qwen3_tts_tpu_torch.core.config import tiny_engine_config as ttiny
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.models import predictor
from qwen3_tts_tpu_torch.tts import generate as tgenerate

PC = PredictorConfig(hidden=32, n_layers=2, n_q_heads=2, n_kv_heads=2,
                     head_dim=16, ffn_dim=64, max_seq=32,
                     mrope_sections=(8, 0, 0, 0), dtype="float32")
# int4 takes widths in whole packed groups (multiples of 256)
PC4 = PredictorConfig(hidden=256, n_layers=2, n_q_heads=2, n_kv_heads=2,
                      head_dim=128, ffn_dim=256, max_seq=32,
                      mrope_sections=(64, 0, 0, 0), dtype="float32")
CONFIGS = {"dense": PC, "int8": PC, "int4": PC4}
B = 3
CFG = tiny_engine_config(max_steps=6)
JACOBI = "QWEN3_TTS_PRED_JACOBI"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def frame(request):
    """(kind, cfg, JAX's frame_codes_jacobi on these weights (jitted once:
    its draft an array, zeros for JAX's None), port params, port assets,
    h1024, code0, JAX's frame_codes), B = 3."""
    kind = request.param
    cfg = CONFIGS[kind]
    k1, k2 = jax.random.split(jax.random.key(21))
    jp = jdecoder.init_decoder(k1, cfg)
    if kind != "dense":
        jp = jquant.quantize_decoder_params(jp, kind=kind)
    ja = jtables.random_assets(k2, text_vocab=64, codec_rows=2176, dim=64,
                               proj_dim=cfg.hidden)
    ta = convert.assets_from_numpy(
        np.asarray(ja.text_table), np.asarray(ja.codec_tables),
        np.asarray(ja.proj_weight), np.asarray(ja.proj_bias))
    tp = convert.decoder_from_numpy(_np(jp))
    rng = np.random.default_rng(21)
    h1024 = rng.standard_normal((B, cfg.hidden)).astype(np.float32)
    code0 = rng.integers(0, 2048, B).astype(np.int32)
    want = np.asarray(jpredictor.frame_codes(jp, cfg, ja, jnp.asarray(h1024),
                                             jnp.asarray(code0)))
    jacobi = jax.jit(lambda h, c, d: jpredictor.frame_codes_jacobi(
        jp, cfg, ja, h, c, d))
    return kind, cfg, jacobi, tp, ta, h1024, code0, want


def test_frame_codes_matches_jax(frame):
    """frame_codes, dense / int8 / int4 weights, B = 3: codes equal to
    JAX's predictor.frame_codes."""
    _, cfg, _, tp, ta, h1024, code0, want = frame
    got = predictor.frame_codes(tp, cfg, ta, torch.from_numpy(h1024),
                                torch.from_numpy(code0))
    assert got.dtype == torch.int32 and got.shape == (B, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), code0)


@pytest.mark.parametrize("draft", ["zero", "oracle", "adversarial"])
def test_frame_codes_jacobi_matches_jax_and_frame_codes(frame, draft):
    """tests/test_generate.py:221 on the port: frame_codes_jacobi with the
    zero, oracle and adversarial ((want + 7) % 2048) drafts equals JAX's
    frame_codes_jacobi and frame_codes; the oracle draft takes one pass,
    no draft more than 15."""
    _, cfg, jacobi, tp, ta, h1024, code0, want = frame
    d = {"zero": None, "oracle": want[:, 1:],
         "adversarial": (want[:, 1:] + 7) % 2048}[draft]
    jgot = np.asarray(jacobi(
        jnp.asarray(h1024), jnp.asarray(code0),
        jnp.zeros((B, 15), jnp.int32) if d is None else jnp.asarray(d)))
    got = predictor.frame_codes_jacobi(
        tp, cfg, ta, torch.from_numpy(h1024), torch.from_numpy(code0),
        None if d is None else torch.from_numpy(d.copy()))
    assert got.dtype == torch.int32 and got.shape == (B, 16)
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(got.numpy(), want)
    passes = predictor.frame_codes_jacobi.passes
    assert 1 <= passes <= 15
    if draft == "oracle":
        assert passes == 1


def test_jacobi_pass_counters():
    """`.passes` is the last call's count and `.passes_total` their sum
    since it was set to 0; a 15-code frame never takes more than 15."""
    cfg = PC
    g = torch.Generator().manual_seed(3)
    tp = tdecoder.init_decoder(g, cfg, scale=0.5)
    ta = ttables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                               proj_dim=cfg.hidden)
    h = torch.randn(2, cfg.hidden, generator=g)
    c0 = torch.randint(0, 2048, (2,), generator=g)
    predictor.frame_codes_jacobi.passes_total = 0
    seen = []
    for _ in range(2):
        out = predictor.frame_codes_jacobi(tp, cfg, ta, h, c0)
        seen.append(predictor.frame_codes_jacobi.passes)
        assert torch.equal(out, predictor.frame_codes(tp, cfg, ta, h, c0))
    assert all(1 <= p <= 15 for p in seen)
    assert predictor.frame_codes_jacobi.passes_total == sum(seen)


# ------------------------------------------------------------ the loop
@pytest.fixture(scope="module")
def weights():
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    jm = {
        "talker": jdecoder.init_decoder(k1, CFG.talker),
        "predictor": jdecoder.init_decoder(k2, CFG.predictor),
        "assets": jtables.random_assets(
            k3, text_vocab=256, codec_rows=2176,
            dim=CFG.talker.hidden, proj_dim=CFG.predictor.hidden),
    }
    a = jm["assets"]
    tm = {
        "talker": convert.decoder_from_numpy(_np(jm["talker"])),
        "predictor": convert.decoder_from_numpy(_np(jm["predictor"])),
        "assets": convert.assets_from_numpy(
            np.asarray(a.text_table), np.asarray(a.codec_tables),
            np.asarray(a.proj_weight), np.asarray(a.proj_bias)),
    }
    return jm, tm


def _batch(lengths, seed=1):
    rng = np.random.default_rng(seed)
    S = max(lengths)
    x = np.zeros((len(lengths), S, CFG.talker.hidden), np.float32)
    for b, n in enumerate(lengths):
        x[b, S - n:] = 0.1 * rng.standard_normal((n, CFG.talker.hidden))
    return x, np.asarray([S - n for n in lengths], np.int32)


def _port_codes(tm, x, pad):
    return tgenerate.generate_codes(
        tm, CFG.talker, CFG.predictor, torch.from_numpy(x),
        torch.from_numpy(pad), None, 0.0, 0, 1.0, CFG.max_steps,
        ignore_eos=True)


def test_jacobi_generation_matches_default_and_jax(weights, monkeypatch):
    """tests/test_generate.py:248 on the port: with QWEN3_TTS_PRED_JACOBI=1
    generate_codes (the previous frame's codes as the draft) gives the
    default path's codes, and JAX's generate_codes with the variable set."""
    jm, tm = weights
    x, pad = _batch((7, 4))
    base, n_base = _port_codes(tm, x, pad)
    monkeypatch.setenv(JACOBI, "1")
    jax.clear_caches()      # a trace-time knob in JAX
    try:
        jcodes, jn = jgenerate.generate_codes(
            jm, CFG.talker, CFG.predictor, jnp.asarray(x), jnp.asarray(pad),
            jax.random.key(0), 0.0, 0, 1.0, CFG.max_steps, ignore_eos=True)
        jcodes, jn = np.asarray(jcodes), np.asarray(jn)
    finally:
        monkeypatch.delenv(JACOBI)
        jax.clear_caches()
    monkeypatch.setenv(JACOBI, "1")
    predictor.frame_codes_jacobi.passes_total = 0
    jac, n_jac = _port_codes(tm, x, pad)
    # the Jacobi path ran: one call a frame, at least one pass each
    assert predictor.frame_codes_jacobi.passes_total >= CFG.max_steps
    np.testing.assert_array_equal(n_jac.numpy(), n_base.numpy())
    np.testing.assert_array_equal(jac.numpy(), base.numpy())
    np.testing.assert_array_equal(n_jac.numpy(), jn)
    np.testing.assert_array_equal(jac.numpy(), jcodes)


def test_frame_body_keeps_the_draft(weights, monkeypatch):
    """init_state's prev_codes are zeros [B, 15] int32; each frame body
    hands them to the Jacobi expansion as its draft and keeps codes 1-15
    of its frame as the next draft."""
    _, tm = weights
    x, pad = _batch((5, 3))
    st = tgenerate.init_state(tm, CFG.talker, torch.from_numpy(x),
                              torch.from_numpy(pad), None, 0.0, 1.0)
    assert st["prev_codes"].dtype == torch.int32
    assert torch.equal(st["prev_codes"], torch.zeros(2, 15, dtype=torch.int32))
    drafts = []
    jacobi = predictor.frame_codes_jacobi

    def spy(params, cfg, assets, h, c0, draft=None):
        drafts.append(draft.clone())
        return jacobi(params, cfg, assets, h, c0, draft)

    monkeypatch.setenv(JACOBI, "1")
    monkeypatch.setattr(tgenerate, "predictor",
                        types.SimpleNamespace(frame_codes_jacobi=spy))
    frames = []
    for _ in range(3):
        st, codes, _ = tgenerate._frame_body(tm, CFG.talker, CFG.predictor, 0,
                                             st, ignore_eos=True)
        frames.append(codes)
        assert torch.equal(st["prev_codes"], codes[:, 1:])
    assert torch.equal(drafts[0], torch.zeros(2, 15, dtype=torch.int32))
    for d, prev in zip(drafts[1:], frames[:-1]):
        assert torch.equal(d, prev[:, 1:])


def test_jacobi_stream_fns_match_default(weights, monkeypatch):
    """make_stream_fns' step with QWEN3_TTS_PRED_JACOBI=1 gives the
    default path's codes and active masks, call by call."""
    _, tm = weights
    x, pad = _batch((6, 4), seed=4)

    def run():
        prefill, step = tgenerate.make_stream_fns(
            CFG.talker, CFG.predictor, top_k=0, frames_per_call=2)
        st = prefill(tm, torch.from_numpy(x), torch.from_numpy(pad), None,
                     0.0, 1.0)
        out = []
        for _ in range(3):
            st, codes, active = step(tm, st)
            out.append((codes, active))
        return out

    base = run()
    monkeypatch.setenv(JACOBI, "1")
    predictor.frame_codes_jacobi.passes_total = 0
    jac = run()
    assert predictor.frame_codes_jacobi.passes_total >= 6
    for (bc, ba), (jc, ja) in zip(base, jac):
        assert torch.equal(ja, ba) and torch.equal(jc, bc)
    assert bool(base[0][1].any())


def test_jacobi_serving_matches_default(tmp_path, monkeypatch):
    """A greedy ServingEngine run (two rows, three staggered streams, a
    row recycled: the admitted row keeps the previous stream's draft)
    gives each stream the default path's codes with
    QWEN3_TTS_PRED_JACOBI=1."""
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    (tmp_path / "vivian.json").write_text(json.dumps(
        {"name": "vivian", "spk_id": 3065, "spk_emb": emb.tolist()}))
    eng = TtsEngine(config=ttiny(max_steps=6),
                    random_weights=True, seed=0, speakers_dir=str(tmp_path),
                    device="cpu")
    eng.set_sampler_config(SamplerConfig(temperature=0.0, top_k=0, top_p=1.0,
                                         seed=1))
    voice = eng.get_speaker("vivian")
    texts = ["first utterance", "second one", "the third text"]

    def run():
        srv = serving.ServingEngine(eng, max_streams=2)
        ids, pending = [], list(texts)
        while pending or srv.slots.active() > 0:
            while pending:
                sid = srv.submit(pending[0], voice)
                if sid is None:
                    break
                ids.append(sid)
                pending.pop(0)
            srv.step()
        assert srv._state["prev_codes"].shape == (2, 15)
        return [srv.streams[s].frame_codes() for s in ids]

    base = run()
    monkeypatch.setenv(JACOBI, "1")
    predictor.frame_codes_jacobi.passes_total = 0
    jac = run()
    assert predictor.frame_codes_jacobi.passes_total > 0
    assert len(base) == len(jac) == 3
    for b, j in zip(base, jac):
        assert len(b) > 0
        np.testing.assert_array_equal(j, b)
