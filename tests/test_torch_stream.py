"""The port's streaming path against the JAX package on the CPU, tiny f32
config: `make_stream_fns`, the chunked vocoder (`decode` against a carried
state, `flush`, `gather_row`, `reset_row`), `VocoderPipeline` and
`TtsEngine.generate_stream`. Mirrors the JAX package's own streaming tests
(test_generate, test_vocoder, test_pipeline, test_engine,
test_context_caps).

Both packages run the same weights (the JAX package's seeded init, carried
over by `qwen3_tts_tpu_torch.convert`) on the same numpy inputs; the port
runs its kernels' plain versions on the CPU.

Tolerances:
  * greedy codes and frame counts: exact (argmax of f32 logits);
  * waveforms, port against JAX: atol 1e-4 (the offline waveform
    tolerance of tests/test_torch_pipeline.py), f32 on both sides,
    convolutions and matmuls summed in another order;
  * waveforms, port against the port (chunked against one-shot, pipeline
    against inline): atol 1e-5, the same kernels on the same data, only
    the extents of the attention and convolutions differ.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
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
from qwen3_tts_tpu.utils.voice_file import VoiceFile as JVoiceFile
from qwen3_tts_tpu_torch import SamplerConfig, VoiceFile, convert
from qwen3_tts_tpu_torch.core import protocol as P
from qwen3_tts_tpu_torch.models import vocoder as tvocoder
from qwen3_tts_tpu_torch.parallel.pipeline import VocoderPipeline
from qwen3_tts_tpu_torch.tts import generate as tgenerate

CFG = tiny_engine_config(max_steps=10)
VCFG = CFG.vocoder
LA = VCFG.lookahead
FS = VCFG.frame_samples
WAV_ATOL = 1e-4      # port vs JAX (see the module docstring)
SELF_ATOL = 1e-5     # port vs port


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
    jv = jvocoder.init_vocoder(k4, VCFG)
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
    return x, np.asarray([S - n for n in lengths], np.int32)


def _codes(n_frames, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VCFG.code_vocab, size=(batch, n_frames, 16)
                        ).astype(np.int32)


def _trim(wav, valid):
    return [np.asarray(wav)[b, : int(valid[b])] for b in range(len(valid))]


# --------------------------------------------------------- make_stream_fns
@pytest.mark.parametrize("lengths", [(6,), (7, 4)], ids=["b1", "b2_padded"])
@pytest.mark.parametrize("fpc", [1, 4])
def test_stream_fns_greedy_match_jax_generate_codes(weights, fpc, lengths):
    """tests/test_generate.py:84 on the port against JAX: the streaming
    step's greedy codes, row by row while active, equal JAX's offline
    `generate_codes`, and so the port's own offline loop."""
    jm, _, tm, _ = weights
    x, pad = _batch(lengths, seed=6)
    jcodes, jn = jgenerate.generate_codes(
        jm, CFG.talker, CFG.predictor, jnp.asarray(x), jnp.asarray(pad),
        jax.random.key(3), 0.0, 0, 1.0, CFG.max_steps)
    tcodes, tn = tgenerate.generate_codes(
        tm, CFG.talker, CFG.predictor, torch.from_numpy(x),
        torch.from_numpy(pad), None, 0.0, 0, 1.0, CFG.max_steps)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))

    prefill_fn, step_fn = tgenerate.make_stream_fns(
        CFG.talker, CFG.predictor, top_k=0, frames_per_call=fpc)
    B = len(lengths)
    state = prefill_fn(tm, torch.from_numpy(x), torch.from_numpy(pad), None,
                       0.0, 1.0)
    assert state["cache"]["k"].shape[3] == CFG.talker.max_seq
    got = [[] for _ in range(B)]
    for _ in range(-(-CFG.max_steps // fpc)):
        state, codes, active = step_fn(tm, state)
        assert tuple(codes.shape) == (B, fpc, 16)
        assert tuple(active.shape) == (B, fpc)
        assert codes.dtype == torch.int32 and active.dtype == torch.bool
        # inactive frames hold zero codes
        assert not codes[~active].any()
        for b in range(B):
            got[b] += [c for c, a in zip(codes[b].numpy(), active[b].numpy())
                       if a]
        if bool(state["done"].all()):
            break
    for b in range(B):
        n = int(np.asarray(jn)[b])
        assert n > 0 and int(tn[b]) == n
        g = np.stack(got[b][:CFG.max_steps]) if got[b] else np.zeros((0, 16))
        np.testing.assert_array_equal(g[:n], np.asarray(jcodes)[b, :n])


def test_stream_fns_cache_len(weights):
    """`cache_len` bounds the talker window, None is max_seq (as in JAX)."""
    _, _, tm, _ = weights
    x, pad = _batch((5,))
    prefill_fn, _ = tgenerate.make_stream_fns(
        CFG.talker, CFG.predictor, top_k=0, cache_len=64)
    state = prefill_fn(tm, torch.from_numpy(x), torch.from_numpy(pad), None,
                       0.0, 1.0)
    assert state["cache"]["k"].shape[3] == 64


# ------------------------------------------------------- chunked vocoder
@pytest.mark.parametrize("total", [9, 12])
def test_chunked_decode_matches_jax_oneshot(weights, total):
    """4-frame chunks against the default streaming state (`max_frames` KV
    slots) equal JAX's one-shot decode, and the port's own."""
    _, jv, _, tv = weights
    codes = _codes(total, seed=7)
    jw, jval, _ = jvocoder.decode(jv, VCFG, jnp.asarray(codes),
                                  jvocoder.init_state(VCFG, 1), True)
    want = _trim(jw, jval)[0]
    assert want.shape == (total * FS,)

    state = tvocoder.init_state(VCFG, 1)
    assert state.kv["k"].shape[3] == VCFG.max_frames
    chunks = []
    for start in range(0, total, P.STREAM_CHUNK_FRAMES):
        part = torch.from_numpy(codes[:, start:start + 4])
        wav, valid, state = tvocoder.decode(tv, VCFG, part, state,
                                            start + 4 >= total)
        chunks.append(_trim(wav, valid)[0])
    # the first chunk withholds the lookahead window, the last flushes it
    assert len(chunks[0]) == (4 - LA) * FS
    assert len(chunks[-1]) == (total - 4 * (len(chunks) - 1) + LA) * FS
    streamed = np.concatenate(chunks)
    np.testing.assert_allclose(streamed, want, rtol=0, atol=WAV_ATOL)
    ow, oval, _ = tvocoder.decode(tv, VCFG, torch.from_numpy(codes),
                                  tvocoder.init_state(VCFG, 1, frames=total),
                                  True)
    np.testing.assert_allclose(streamed, _trim(ow, oval)[0], rtol=0,
                               atol=SELF_ATOL)


def test_flush_matches_jax(weights):
    """tests/test_vocoder.py:170: a stream that ends between calls; the
    port's `flush` emits what JAX's does, and what an is_last call would."""
    _, jv, _, tv = weights
    codes = _codes(7, seed=4)
    js = jvocoder.init_state(VCFG, 1)
    jw1, jv1, js = jvocoder.decode(jv, VCFG, jnp.asarray(codes), js, False)
    jw2, jv2, _ = jvocoder.flush(jv, VCFG, js)

    ts = tvocoder.init_state(VCFG, 1)
    tw1, tv1, ts = tvocoder.decode(tv, VCFG, torch.from_numpy(codes), ts,
                                   False)
    tw2, tv2, fs = tvocoder.flush(tv, VCFG, ts)
    assert tv1.tolist() == np.asarray(jv1).tolist() == [(7 - LA) * FS]
    assert tv2.tolist() == np.asarray(jv2).tolist() == [LA * FS]
    assert tuple(tw2.shape) == (1, LA * FS)
    np.testing.assert_allclose(_trim(tw2, tv2)[0], _trim(jw2, jv2)[0],
                               rtol=0, atol=WAV_ATOL)
    # flush leaves frames_done and the KV cache as they were
    assert fs.frames_done.tolist() == [7]
    got = np.concatenate(_trim(tw1, tv1) + _trim(tw2, tv2))
    ref, vr, _ = tvocoder.decode(tv, VCFG, torch.from_numpy(codes),
                                 tvocoder.init_state(VCFG, 1), True)
    np.testing.assert_allclose(got, _trim(ref, vr)[0], rtol=0,
                               atol=SELF_ATOL)


def test_per_row_is_last_matches_jax(weights):
    """tests/test_vocoder.py:189: is_last flushes one row while the other
    keeps streaming."""
    _, jv, _, tv = weights
    codes = _codes(4, batch=2, seed=5)
    jw, jval, _ = jvocoder.decode(jv, VCFG, jnp.asarray(codes),
                                  jvocoder.init_state(VCFG, 2),
                                  jnp.asarray([True, False]))
    tw, tval, _ = tvocoder.decode(tv, VCFG, torch.from_numpy(codes),
                                  tvocoder.init_state(VCFG, 2),
                                  torch.tensor([True, False]))
    assert tval.tolist() == np.asarray(jval).tolist() \
        == [4 * FS, (4 - LA) * FS]
    for g, w in zip(_trim(tw, tval), _trim(jw, jval)):
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)


def test_gather_row_and_reset_row_match_jax(weights):
    """tests/test_vocoder.py:235 and the reset check of :457-459, on the
    default vocoder: a gathered row flushes as JAX's does and as a solo
    stream; `reset_row` gives JAX's state (zeroed in place in the port)."""
    _, jv, _, tv = weights
    codes = _codes(5, batch=3, seed=6)
    js = jvocoder.init_state(VCFG, 3)
    _, _, js = jvocoder.decode(jv, VCFG, jnp.asarray(codes), js, False)
    jw, jval, _ = jvocoder.flush(jv, VCFG, jvocoder.gather_row(js, 1))

    ts = tvocoder.init_state(VCFG, 3)
    _, _, ts = tvocoder.decode(tv, VCFG, torch.from_numpy(codes), ts, False)
    row = tvocoder.gather_row(ts, 1)
    assert row.frames_done.tolist() == [5]
    tw, tval, _ = tvocoder.flush(tv, VCFG, row)
    assert tval.tolist() == np.asarray(jval).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=WAV_ATOL)
    # the gathered row is a copy: decoding it leaves the batch untouched
    before = ts.kv["k"].clone()
    tvocoder.decode(tv, VCFG, torch.from_numpy(codes[1:2]), row, False)
    assert torch.equal(ts.kv["k"], before)

    s1 = tvocoder.init_state(VCFG, 1)
    _, _, s1 = tvocoder.decode(tv, VCFG, torch.from_numpy(codes[1:2]), s1,
                               False)
    sw, sval, _ = tvocoder.flush(tv, VCFG, s1)
    assert sval.tolist() == tval.tolist()
    np.testing.assert_allclose(tw.numpy(), sw.numpy(), rtol=0,
                               atol=SELF_ATOL)

    jr = jvocoder.reset_row(js, 1)
    tr = tvocoder.reset_row(ts, 1)
    assert tr is ts                                   # in place
    assert int(tr.frames_done[1]) == 0
    for name in ("pre_conv_history", "latent_buffer", "conv_history",
                 "frames_done"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=WAV_ATOL, err_msg=name)
        assert not getattr(tr, name)[1].any(), name
    for k in tr.kv:
        np.testing.assert_allclose(tr.kv[k].numpy(), np.asarray(jr.kv[k]),
                                   rtol=0, atol=WAV_ATOL, err_msg=k)
        assert not tr.kv[k][:, 1].any()
    # the reset slot streams as a fresh one
    fresh = _codes(4, seed=9)
    both = np.concatenate([codes[:1, :4], fresh, codes[2:, :4]])
    rw, rval, _ = tvocoder.decode(tv, VCFG, torch.from_numpy(both), tr, True)
    ow, oval, _ = tvocoder.decode(tv, VCFG, torch.from_numpy(fresh),
                                  tvocoder.init_state(VCFG, 1), True)
    np.testing.assert_allclose(_trim(rw, rval)[1], _trim(ow, oval)[0],
                               rtol=0, atol=SELF_ATOL)


# ------------------------------------------------------- VocoderPipeline
def test_pipeline_matches_inline(weights):
    """tests/test_pipeline.py: threaded vocoding equals inline decoding
    (JAX's one-shot), in order, the close() flush included."""
    _, jv, _, tv = weights
    codes = _codes(10, seed=0)
    jw, jval, _ = jvocoder.decode(jv, VCFG, jnp.asarray(codes),
                                  jvocoder.init_state(VCFG, 1), True)
    want = _trim(jw, jval)[0]
    chunks = []
    pipe = VocoderPipeline(tv, VCFG, batch=1, on_chunk=chunks.append)
    for start in range(0, 10, 4):
        pipe.submit(codes[:, start:start + 4])
    got = pipe.close()          # drains the lookahead (no is_final was sent)
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)
    assert len(chunks) == 4     # 3 decode chunks + the close() flush
    np.testing.assert_array_equal(np.concatenate(chunks), got)


def test_pipeline_error_surfaces(weights):
    tv = weights[3]
    pipe = VocoderPipeline(tv, VCFG, batch=1)
    # wrong codebook count: the worker fails; close() raises, not hangs
    pipe.submit(np.zeros((1, 2, 7), np.int64))
    with pytest.raises(RuntimeError, match="vocoder pipeline failed"):
        pipe.close()


def test_pipeline_empty_stream(weights):
    pipe = VocoderPipeline(weights[3], VCFG, batch=1)
    assert pipe.close().shape == (0,)


def test_pipeline_submit_after_worker_failure_does_not_hang(weights):
    """Divergence from JAX, where a dead worker leaves `submit` blocking
    once the queue of 8 is full: here submitting more than 8 chunks after
    a failure raises, and close() returns. Run under its own 60 s limit."""
    tv = weights[3]
    pipe = VocoderPipeline(tv, VCFG, batch=1)
    outcome = {}

    def drive():
        pipe.submit(np.zeros((1, 2, 7), np.int32))    # kills the worker
        try:
            for _ in range(20):
                pipe.submit(_codes(4))
            outcome["submit"] = "no error"
        except RuntimeError as e:
            outcome["submit"] = str(e)
        try:
            pipe.close()
            outcome["close"] = "no error"
        except RuntimeError as e:
            outcome["close"] = str(e)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "submit or close blocked after a worker failure"
    assert "vocoder pipeline failed" in outcome["submit"]
    assert "vocoder pipeline failed" in outcome["close"]


# ------------------------------------------------------ generate_stream
def _speakers(tmp_path_factory):
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    with open(sdir / "vivian.json", "w") as f:
        json.dump({"name": "vivian", "spk_id": 3065,
                   "spk_emb": emb.tolist()}, f)
    return str(sdir)


def _engine_pair(cfg, sdir, seed=0):
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0, seed=42)
    jeng = JTtsEngine(config=cfg, random_weights=True, seed=seed,
                      speakers_dir=sdir, compile_cache=False)
    jeng.set_sampler_config(JSamplerConfig(**greedy))
    teng = convert.engine_from_jax_arrays(
        _np({k: jeng.models[k] for k in ("talker", "predictor")})
        | {"assets": jeng.models["assets"]},
        _np(jeng.vocoder_params), cfg, device="cpu", speakers_dir=sdir)
    teng.set_sampler_config(SamplerConfig(**greedy))
    return jeng, teng


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return _engine_pair(tiny_engine_config(max_steps=8),
                        _speakers(tmp_path_factory))


@pytest.mark.parametrize("text", ["stream me", "a longer sentence here"])
def test_generate_stream_matches_jax_and_offline(engines, text):
    """tests/test_engine.py:54 on the port: greedy streamed samples equal
    JAX's streamed samples and the port's offline output; every chunk is
    whole frames, at most (4 + lookahead) frames, and the chunks
    concatenate to the returned samples."""
    jeng, teng = engines
    jstream = jeng.generate_stream(text, jeng.get_speaker("vivian"))
    voice = teng.get_speaker("vivian")
    offline = teng.generate_with_voice(text, voice)
    chunks = []
    streamed = teng.generate_stream(text, voice, on_chunk=chunks.append)
    assert streamed.sample_rate == P.SAMPLE_RATE
    assert len(streamed.samples) == len(jstream.samples) \
        == len(offline.samples) > 0
    assert len(chunks) >= 1
    for c in chunks:
        assert len(c) % FS == 0
        assert 0 < len(c) <= (P.STREAM_CHUNK_FRAMES + LA) * FS
    np.testing.assert_array_equal(np.concatenate(chunks), streamed.samples)
    np.testing.assert_allclose(streamed.samples, jstream.samples, rtol=0,
                               atol=WAV_ATOL)
    np.testing.assert_allclose(streamed.samples, offline.samples, rtol=0,
                               atol=WAV_ATOL)


@pytest.mark.parametrize("eos_frame,max_steps,submits", [
    (5, 8, [(4, False), (1, True)]),     # EOS inside chunk 2: is_final
    (8, 16, [(4, False), (4, False)]),   # EOS between chunks: close() drains
    (99, 5, [(4, False), (1, False)]),   # the budget cuts chunk 2
], ids=["eos_in_chunk", "eos_between_chunks", "budget"])
def test_generate_stream_end_of_stream(engines, monkeypatch, eos_frame,
                                       max_steps, submits):
    """How a stream ends: the chunk that holds EOS is submitted with
    is_final; a stream that ends between chunks, or is cut by the frame
    budget, is drained by close(). EOS is forced at `eos_frame` by
    patching the EOS test, and the offline path, under the same patch,
    gives the same samples."""
    _, teng = engines
    calls, frames = [], [0]
    orig_submit = VocoderPipeline.submit

    def spy(self, codes, is_final=False):
        calls.append((codes.shape[1], is_final))
        return orig_submit(self, codes, is_final)

    def eos_at(code0):
        frames[0] += 1
        return torch.full_like(code0, frames[0] > eos_frame, dtype=torch.bool)

    monkeypatch.setattr(VocoderPipeline, "submit", spy)
    monkeypatch.setattr(tgenerate, "_is_eos", eos_at)
    voice = teng.get_speaker("vivian")
    teng.set_max_steps(max_steps)
    try:
        streamed = teng.generate_stream("hello", voice)
        frames[0] = 0
        offline = teng.generate_with_voice("hello", voice)
    finally:
        teng.set_max_steps(teng.config.max_steps)
    assert calls == submits
    n = min(eos_frame, max_steps)
    assert len(streamed.samples) == len(offline.samples) == n * FS
    np.testing.assert_allclose(streamed.samples, offline.samples, rtol=0,
                               atol=SELF_ATOL)


def test_warmup_runs_both_paths(engines):
    """`warmup` runs the offline and streaming paths once and leaves the
    engine's output as it was."""
    _, teng = engines
    voice = teng.get_speaker("vivian")
    before = teng.generate_stream("hello", voice).samples
    teng.warmup(prompt_buckets=(64,))
    assert len(teng._stream_fns) == 1
    np.testing.assert_array_equal(teng.generate_stream("hello", voice).samples,
                                  before)


# ------------------------------------------------------- context caps
def _capped_pair(tmp_path_factory, max_steps, talker_max_seq,
                 vocoder_max_frames):
    cfg = tiny_engine_config(max_steps=max_steps)
    cfg = dataclasses.replace(
        cfg,
        talker=dataclasses.replace(cfg.talker, max_seq=talker_max_seq),
        vocoder=dataclasses.replace(cfg.vocoder,
                                    max_frames=vocoder_max_frames))
    return _engine_pair(cfg, _speakers(tmp_path_factory), seed=1)


def _voices():
    emb = [0.01] * 2048
    return (JVoiceFile(ref_text="", audio_codes=[], speaker_embedding=emb),
            VoiceFile(ref_text="", audio_codes=[], speaker_embedding=emb))


def test_generate_stream_respects_context_and_vocoder_caps(
        tmp_path_factory):
    """tests/test_context_caps.py:63: the frame budget is min(max_steps,
    context room, vocoder max_frames); the port stops where JAX does."""
    jeng, teng = _capped_pair(tmp_path_factory, 500, 64, 8)
    jv, tv = _voices()
    chunks = []
    audio = teng.generate_stream("aaaa bbbb cccc", tv, on_chunk=chunks.append)
    frames = len(audio.samples) // FS
    assert len(audio.samples) % FS == 0
    assert 0 < frames <= teng.config.vocoder.max_frames
    jaudio = jeng.generate_stream("aaaa bbbb cccc", jv)
    np.testing.assert_allclose(audio.samples, jaudio.samples, rtol=0,
                               atol=WAV_ATOL)


def test_stream_matches_offline_under_cap(tmp_path_factory):
    """tests/test_context_caps.py:102: greedy streaming equals the offline
    path when both hit the same context cap, and equals JAX."""
    jeng, teng = _capped_pair(tmp_path_factory, 64, 16, 32)
    jv, tv = _voices()
    off = teng.generate_with_voice("xyz", tv)
    streamed = teng.generate_stream("xyz", tv)
    np.testing.assert_allclose(off.samples, streamed.samples, rtol=0,
                               atol=SELF_ATOL)
    np.testing.assert_allclose(streamed.samples,
                               jeng.generate_stream("xyz", jv).samples,
                               rtol=0, atol=WAV_ATOL)
