"""The port's continuous-batching serving (`qwen3_tts_tpu_torch.serving`)
against the JAX package's on the CPU, tiny f32 config. Mirrors
tests/test_serving.py and the serving cases of tests/test_context_caps.py,
and holds one frame body with ragged per-row cache slots against JAX's.

Both packages run the same weights (the JAX engine's seeded init, carried
over by `convert.engine_from_jax_arrays`); the vocoder is the JAX
package's init at scale 0.06, as in tests/test_torch_clone.py, so that a
waveform tolerance means something at the tiny config. Both run the same
schedule of submits and ticks.

Tolerances:
  * greedy codes and frame counts: equal, per stream, recorded at each
    tick (the port keeps them on the stream, JAX's are read off its step);
  * waveforms, port against JAX and port serving against the port's solo
    stream: rtol 1e-5, atol 1e-6, max|d| <= 1e-5 x the peak, and a peak of
    at least 100 x atol (tests/test_torch_clone.py's rule: f32 on both
    sides, batched and one-row products summed in another order);
  * a window against the full cache: equal (array_equal);
  * one frame body: hidden, logits and the cache rtol = atol = 1e-5 (f32,
    the same products in another order), codes equal.
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
from qwen3_tts_tpu import serving as jserving
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import vocoder as jvocoder
from qwen3_tts_tpu.tts import generate as jgenerate
from qwen3_tts_tpu.utils.voice_file import VoiceFile as JVoiceFile
from qwen3_tts_tpu_torch import SamplerConfig, VoiceFile, convert
from qwen3_tts_tpu_torch import serving as tserving
from qwen3_tts_tpu_torch.core import protocol as P
from qwen3_tts_tpu_torch.parallel import pipeline as tpipeline
from qwen3_tts_tpu_torch.tts import generate as tgenerate

CFG = tiny_engine_config(max_steps=8)
FS = CFG.vocoder.frame_samples
WAV_RTOL, WAV_ATOL, WAV_PEAK = 1e-5, 1e-6, 1e-5
VOC_SCALE = 0.06
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, seed=1)
TEXTS = ["first utterance", "second one", "the third text"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    """Waveforms allclose and within WAV_PEAK x the reference's peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    peak = np.abs(want).max()
    assert peak >= 100 * WAV_ATOL      # atol alone cannot pass a wrong wave
    assert np.abs(got - want).max() <= WAV_PEAK * peak


def _speakers(tmp_path_factory):
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    with open(sdir / "vivian.json", "w") as f:
        json.dump({"name": "vivian", "spk_id": 3065,
                   "spk_emb": emb.tolist()}, f)
    return str(sdir)


def _engine_pair(cfg, sdir, seed=0):
    """(JAX engine, port engine) on the same weights, greedy."""
    jeng = JTtsEngine(config=cfg, random_weights=True, seed=seed,
                      speakers_dir=sdir, compile_cache=False)
    jeng.set_sampler_config(JSamplerConfig(**GREEDY))
    jeng.vocoder_params = jvocoder.with_dtype(
        jvocoder.init_vocoder(jax.random.key(13), cfg.vocoder,
                              scale=VOC_SCALE), cfg.vocoder)
    teng = convert.engine_from_jax_arrays(
        _np({k: jeng.models[k] for k in ("talker", "predictor")})
        | {"assets": jeng.models["assets"]},
        _np(jeng.vocoder_params), cfg, device="cpu", speakers_dir=sdir)
    teng.set_sampler_config(SamplerConfig(**GREEDY))
    return jeng, teng


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return _engine_pair(CFG, _speakers(tmp_path_factory))


def _record_jax(srv):
    """Wrap a JAX ServingEngine's step so that each stream's active frames'
    codes are kept, by stream id; `_jax_codes` trims them to the stream's
    kept frames."""
    per = {}
    fn = srv._step_fn

    def step_fn(models, state):
        state, codes, active = fn(models, state)
        c, a = np.asarray(codes), np.asarray(active)
        for slot, sid in srv._slot_stream.items():
            per.setdefault(sid, []).append(c[slot][a[slot]])
        return state, codes, active

    srv._step_fn = step_fn
    return per


def _jax_codes(srv, per, sid):
    got = per.get(sid, [])
    c = np.concatenate(got) if got else np.zeros((0, 16), np.int32)
    return c[: srv.streams[sid].frames]


def _staggered(srv, voice):
    """tests/test_serving.py:29-58's schedule: stream 0 alone for a tick,
    stream 1 admitted mid-flight, stream 2 refused while the batch is full
    and admitted once a row frees."""
    s0 = srv.submit(TEXTS[0], voice)
    assert s0 is not None
    srv.step()
    s1 = srv.submit(TEXTS[1], voice)
    assert s1 is not None
    assert srv.submit(TEXTS[2], voice) is None
    for _ in range(64):
        srv.step()
        if srv.result(s0) is not None or srv.result(s1) is not None:
            break
    s2 = srv.submit(TEXTS[2], voice)
    assert s2 is not None
    srv.run_until_drained()
    return [s0, s1, s2]


def _same_streams(tsrv, jsrv, per, tids, jids):
    """Each port stream's codes and frame count equal JAX's, its waveform
    within the tolerance of JAX's."""
    assert len(tids) == len(jids)
    for t, j in zip(tids, jids):
        ts, js = tsrv.streams[t], jsrv.streams[j]
        assert ts.done and js.done and ts.error is None and js.error is None
        assert ts.frames == js.frames > 0
        np.testing.assert_array_equal(ts.frame_codes(),
                                      _jax_codes(jsrv, per, j))
        assert len(ts.result.samples) == ts.frames * FS
        _close(ts.result.samples, js.result.samples)


def _solo_stream(teng, text, voice):
    """The port's solo generate_stream: (samples, codes [N, 16])."""
    sent = []
    submit = tpipeline.VocoderPipeline.submit

    def recording(self, codes, is_final=False):
        sent.append(np.asarray(codes)[0])
        return submit(self, codes, is_final)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline.VocoderPipeline, "submit", recording)
        audio = teng.generate_stream(text, voice)
    return audio.samples, np.concatenate(sent)


# ------------------------------------------------------------ staggered
def test_staggered_streams_match_jax_and_solo(engines):
    """tests/test_serving.py:29 on the port: the staggered streams' codes
    and frame counts equal JAX's serving, their waveforms JAX's, and each
    stream equals its own solo generate_stream (codes equal, waveform
    within the tolerance) and its offline waveform before the last LA
    frames."""
    jeng, teng = engines
    tsrv = tserving.ServingEngine(teng, max_streams=2)
    jsrv = jserving.ServingEngine(jeng, max_streams=2)
    per = _record_jax(jsrv)
    tids = _staggered(tsrv, teng.get_speaker("vivian"))
    jids = _staggered(jsrv, jeng.get_speaker("vivian"))
    _same_streams(tsrv, jsrv, per, tids, jids)
    # the batch state: per-row slots on the device, every row done
    st = tsrv._state
    assert st["slot"].dtype == torch.int32 and tuple(st["slot"].shape) == (2,)
    assert bool(st["done"].all())
    assert tsrv.slots.active() == 0 and not tsrv._slot_stream
    for sid, text in zip(tids, TEXTS):
        samples, codes = _solo_stream(teng, text, teng.get_speaker("vivian"))
        s = tsrv.streams[sid]
        np.testing.assert_array_equal(s.frame_codes(), codes)
        _close(s.result.samples, samples)
        # the offline waveform: whole frames alike, and equal before its
        # last LA frames (ROADMAP queue 3: the offline tail reads the
        # zero-code frames past EOS)
        offline = teng.generate_with_voice(text, teng.get_speaker("vivian"))
        assert len(offline.samples) == len(s.result.samples)
        n = len(offline.samples) - CFG.vocoder.lookahead * FS
        assert n > 0
        _close(s.result.samples[:n], offline.samples[:n])


def test_chunk_callbacks_concatenate_to_the_result(engines):
    """tests/test_serving.py:61: chunks are whole frames, at most (4 +
    lookahead) frames, and concatenate to the result; JAX's chunks have
    the same sizes."""
    jeng, teng = engines
    sizes = []
    for srv_cls, eng in ((tserving.ServingEngine, teng),
                         (jserving.ServingEngine, jeng)):
        srv = srv_cls(eng, max_streams=1)
        chunks = []
        sid = srv.submit("callback test", eng.get_speaker("vivian"),
                         on_chunk=chunks.append)
        srv.run_until_drained()
        out = srv.result(sid)
        assert out is not None and len(chunks) >= 1
        np.testing.assert_array_equal(np.concatenate(chunks), out.samples)
        sizes.append([len(c) for c in chunks])
    lim = (P.STREAM_CHUNK_FRAMES + CFG.vocoder.lookahead) * FS
    assert all(n % FS == 0 and 0 < n <= lim for n in sizes[0])
    assert sizes[0] == sizes[1]


def _fill_and_drain(srv, voice, texts):
    """Submit `texts` as rows free, ticking between; the stream ids."""
    ids, pending = [], list(texts)
    while pending or srv.slots.active() > 0:
        while pending:
            sid = srv.submit(pending[0], voice)
            if sid is None:
                break
            ids.append(sid)
            pending.pop(0)
        srv.step()
    return ids


def test_row_reuse_four_streams_on_two_rows(engines):
    """tests/test_serving.py:74: 4 streams on 2 rows recycle the rows; each
    stream equals JAX's."""
    jeng, teng = engines
    texts = ["a", "bb", "ccc", "dddd"]
    tsrv = tserving.ServingEngine(teng, max_streams=2)
    jsrv = jserving.ServingEngine(jeng, max_streams=2)
    per = _record_jax(jsrv)
    tids = _fill_and_drain(tsrv, teng.get_speaker("vivian"), texts)
    jids = _fill_and_drain(jsrv, jeng.get_speaker("vivian"), texts)
    assert len(tids) == 4
    assert {tsrv.streams[s].slot for s in tids} == {0, 1}
    _same_streams(tsrv, jsrv, per, tids, jids)


@pytest.mark.parametrize("rows,window", [(16, None), (32, 256)],
                         ids=["16_rows", "32_rows_window_256"])
def test_full_batch_fills_then_admits_again(engines, rows, window):
    """tests/test_serving.py:92 and :165: every row admitted at once, the
    next submit refused, all drained with JAX's codes, frame counts and
    waveforms, and the freed rows admit again."""
    jeng, teng = engines
    tsrv = tserving.ServingEngine(teng, max_streams=rows, kv_window=window)
    jsrv = jserving.ServingEngine(jeng, max_streams=rows, kv_window=window)
    per = _record_jax(jsrv)
    ids = []
    for srv, eng in ((tsrv, teng), (jsrv, jeng)):
        voice = eng.get_speaker("vivian")
        sids = [srv.submit(f"utterance {i}", voice) for i in range(rows)]
        assert all(s is not None for s in sids)
        assert srv.slots.active() == rows
        assert srv.submit("over capacity", voice) is None
        srv.run_until_drained()
        ids.append(sids)
    assert tsrv._state["cache"]["k"].shape[3] == (window or CFG.talker.max_seq)
    _same_streams(tsrv, jsrv, per, *ids)
    again = tsrv.submit("again", teng.get_speaker("vivian"))
    assert again is not None and tsrv.streams[again].error is None
    tsrv.run_until_drained()
    assert tsrv.result(again).samples.size > 0


def test_kv_window_matches_full_cache(engines):
    """tests/test_serving.py:129: a 256-slot window gives the full cache's
    output exactly, its cache dim 3 is the window, and both equal JAX's."""
    jeng, teng = engines
    voice = VoiceFile(speaker_embedding=[0.0] * 64)
    full = tserving.ServingEngine(teng, max_streams=2)
    win = tserving.ServingEngine(teng, max_streams=2, kv_window=256)
    assert win._state is None
    sid_f = full.submit("window parity", voice)
    sid_w = win.submit("window parity", voice)
    for srv in (full, win):
        while srv.step():
            pass
    np.testing.assert_array_equal(full.result(sid_f).samples,
                                  win.result(sid_w).samples)
    np.testing.assert_array_equal(full.streams[sid_f].frame_codes(),
                                  win.streams[sid_w].frame_codes())
    assert win._state["cache"]["k"].shape[3] == 256
    assert full._state["cache"]["k"].shape[3] == CFG.talker.max_seq
    jsrv = jserving.ServingEngine(jeng, max_streams=2, kv_window=256)
    per = _record_jax(jsrv)
    jsid = jsrv.submit("window parity",
                       JVoiceFile(speaker_embedding=[0.0] * 64))
    while jsrv.step():
        pass
    _same_streams(win, jsrv, per, [sid_w], [jsid])


def test_idle_row_past_the_vocoder_capacity(engines):
    """A row that holds no stream for more ticks than the vocoder's KV
    capacity allows (max_frames / chunk_frames = 8 here) does not stop the
    batch: streams admitted one after another into the other row equal
    JAX's, whose idle row runs on past the capacity with clamped writes."""
    jeng, teng = engines
    texts = [f"turn {i}" for i in range(6)]
    ticks = []
    out = []
    for srv, eng in ((tserving.ServingEngine(teng, max_streams=2), teng),
                     (jserving.ServingEngine(jeng, max_streams=2), jeng)):
        per = _record_jax(srv) if eng is jeng else None
        sids, n = [], 0
        for t in texts:
            sids.append(srv.submit(t, eng.get_speaker("vivian")))
            while srv.slots.active():
                srv.step()
                n += 1
        ticks.append(n)
        out.append((srv, per, sids))
    cap_ticks = CFG.vocoder.max_frames // P.STREAM_CHUNK_FRAMES
    assert ticks[0] == ticks[1] > cap_ticks
    assert {out[0][0].streams[s].slot for s in out[0][2]} == {0}
    (tsrv, _, tids), (jsrv, per, jids) = out
    _same_streams(tsrv, jsrv, per, tids, jids)


@pytest.mark.parametrize("limit", ["window", "context"])
def test_oversized_prompt_rejected(tmp_path_factory, limit):
    """A prompt that fills the KV window (tests/test_serving.py:152) or the
    talker context (tests/test_context_caps.py:61) is reported on its
    stream with an empty result, as in JAX, and its row is free at once:
    a well-sized stream is admitted after it."""
    if limit == "window":
        cfg, kw, text = CFG, dict(kv_window=8), \
            "this prompt is far too long for the window"
    else:
        cfg = dataclasses.replace(CFG, talker=dataclasses.replace(
            CFG.talker, max_seq=48))
        kw, text = {}, "a" * 300
    jeng, teng = _engine_pair(cfg, _speakers(tmp_path_factory))
    errors = []
    for srv, v in ((tserving.ServingEngine(teng, max_streams=2, **kw),
                    VoiceFile(speaker_embedding=[0.0] * 64)),
                   (jserving.ServingEngine(jeng, max_streams=2, **kw),
                    JVoiceFile(speaker_embedding=[0.0] * 64))):
        sid = srv.submit(text, v)
        assert sid is not None
        s = srv.streams[sid]
        assert s.done and s.error is not None
        assert srv.result(sid).samples.size == 0
        assert srv.slots.active() == 0
        errors.append(s.error)
        if limit == "context":
            ok = srv.submit("ok", v)
            assert ok is not None and srv.streams[ok].error is None
    assert limit in errors[0] and errors[0] == errors[1]


def test_failed_submission_does_not_poison_batch(engines):
    """tests/test_serving.py:105: a stream whose prompt build fails is
    reported failed and its row recycled; the next stream equals JAX's."""

    class BadVoice:
        audio_codes = []
        ref_text = ""

        @property
        def spk_emb(self):
            raise ValueError("corrupt embedding")

    jeng, teng = engines
    tsrv = tserving.ServingEngine(teng, max_streams=1)
    bad = tsrv.submit("x", BadVoice())
    s = tsrv.streams[bad]
    assert s.done and "corrupt embedding" in s.error
    assert tsrv.slots.active() == 0
    assert tsrv._state is not None and bool(tsrv._state["done"].all())
    good = tsrv.submit("recovered", teng.get_speaker("vivian"))
    tsrv.run_until_drained()
    jsrv = jserving.ServingEngine(jeng, max_streams=1)
    per = _record_jax(jsrv)
    jgood = jsrv.submit("recovered", jeng.get_speaker("vivian"))
    jsrv.run_until_drained()
    _same_streams(tsrv, jsrv, per, [good], [jgood])


def test_stops_at_vocoder_capacity(tmp_path_factory):
    """tests/test_context_caps.py:88: a stream stops at the vocoder's
    streaming capacity less a chunk, with whole frames, as JAX's does."""
    cfg = tiny_engine_config(max_steps=1000)
    cfg = dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, max_seq=512),
        vocoder=dataclasses.replace(cfg.vocoder, max_frames=12))
    jeng, teng = _engine_pair(cfg, _speakers(tmp_path_factory), seed=1)
    tsrv = tserving.ServingEngine(teng, max_streams=2)
    jsrv = jserving.ServingEngine(jeng, max_streams=2)
    per = _record_jax(jsrv)
    tid = tsrv.submit("hello world", teng.get_speaker("vivian"))
    jid = jsrv.submit("hello world", jeng.get_speaker("vivian"))
    tsrv.run_until_drained(max_ticks=100)
    jsrv.run_until_drained(max_ticks=100)
    s = tsrv.streams[tid]
    assert s.done
    assert s.frames <= cfg.vocoder.max_frames - P.STREAM_CHUNK_FRAMES
    assert len(s.result.samples) == s.frames * FS
    _same_streams(tsrv, jsrv, per, [tid], [jid])


# ----------------------------------------------------- ragged frame body
def test_frame_body_ragged_slots_match_jax(engines):
    """One `_frame_body` with a ragged [B] slot against JAX's on the same
    state: rows at slots 5 and 30, one at the cache's last slot (cap - 1)
    and a done row at the cap (its write clamped to cap - 1): hidden,
    logits, codes, active, the next slots and the whole cache."""
    jeng, teng = engines
    tc = CFG.talker
    T, B = 64, 4
    rng = np.random.default_rng(7)
    shape = (tc.n_layers, B, tc.n_kv_heads, T, tc.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    slot = np.asarray([5, 30, T - 1, T], np.int32)
    pad = np.asarray([0, 2, 0, 1], np.int32)
    hidden = rng.standard_normal((B, tc.hidden)).astype(np.float32)
    logits = rng.standard_normal((B, tc.vocab)).astype(np.float32)
    done = np.asarray([False, False, False, True])
    jstate = dict(
        key=jax.random.key(0), hidden=jnp.asarray(hidden),
        logits=jnp.asarray(logits),
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v)},
        slot=jnp.asarray(slot), step=jnp.int32(0), pad_offset=jnp.asarray(pad),
        done=jnp.asarray(done), n_frames=jnp.zeros((B,), jnp.int32),
        temperature=jnp.float32(0.0), top_p=jnp.float32(1.0),
        prev_codes=jnp.zeros((B, 15), jnp.int32))
    tstate = dict(
        generator=None, hidden=torch.from_numpy(hidden),
        logits=torch.from_numpy(logits),
        cache={"k": torch.from_numpy(k.copy()),
               "v": torch.from_numpy(v.copy())},
        slot=torch.from_numpy(slot), step=0, pad_offset=torch.from_numpy(pad),
        done=torch.from_numpy(done), n_frames=torch.zeros(B, dtype=torch.int32),
        temperature=0.0, top_p=1.0)
    jnew, jcodes, jactive = jgenerate._frame_body(
        jeng.models, tc, CFG.predictor, 0, jstate)
    with torch.inference_mode():
        tnew, tcodes, tactive = tgenerate._frame_body(
            teng.models, tc, CFG.predictor, 0, tstate)
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(tactive.numpy(), [True, True, True, False])
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tnew["slot"].numpy(), np.asarray(jnew["slot"]))
    np.testing.assert_array_equal(tnew["slot"].numpy(), [6, 31, T, T])
    np.testing.assert_array_equal(tnew["done"].numpy(), np.asarray(jnew["done"]))
    for name in ("hidden", "logits"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name, orig in (("k", k), ("v", v)):
        got, want = tnew["cache"][name].numpy(), np.asarray(
            jnew["cache"][name])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        # each row wrote only its own (clamped) slot
        changed = np.argwhere((got != orig).any(axis=(0, 2, 4)))
        assert sorted(map(tuple, changed)) == [(0, 5), (1, 30), (2, T - 1),
                                               (3, T - 1)]


def test_frame_body_int_slot_stays_on_the_host(engines, monkeypatch):
    """With a host-int slot (the offline and stream paths) `_frame_body`
    keeps the slot a Python int and hands the talker step an int: no
    tensor of the slot is made or read."""
    _, teng = engines
    seen = []
    step = tgenerate.talker.step

    def spy(params, cfg, fb, slot, *args):
        seen.append(slot)
        return step(params, cfg, fb, slot, *args)

    monkeypatch.setattr(tgenerate.talker, "step", spy)
    prefill, step_fn = tgenerate.make_stream_fns(CFG.talker, CFG.predictor,
                                                 top_k=0, frames_per_call=2)
    x = torch.zeros(1, 9, CFG.talker.hidden)
    with torch.inference_mode():
        st = prefill(teng.models, x, torch.zeros(1, dtype=torch.int32), None,
                     0.0, 1.0)
        st, _, _ = step_fn(teng.models, st)
    assert seen == [9, 10] and all(type(s) is int for s in seen)
    assert type(st["slot"]) is int and st["slot"] == 11
