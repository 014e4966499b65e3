"""The port's HTTP serving daemon (`qwen3_tts_tpu_torch.server`) over a CPU
engine on 127.0.0.1, through a real socket. Mirrors tests/test_server.py:
health, speakers and stats, a /tts round trip, concurrent requests, a
chunked streamed WAV, the error paths and bounded admission; and holds the
port's deliberate divergence, the eviction of finished streams.

The engine is the tiny f32 config on the JAX package's seeded weights
(carried over by `convert.engine_from_jax_arrays`), greedy. Its vocoder is
the JAX package's init at scale 0.15, not the 0.06 of the other serving
tests: at 0.06 the tiny waveform peaks near 5 LSB of 16-bit PCM, where a
PCM comparison would hold almost nothing; at 0.15 it peaks near 0.3.

Tolerances: a response's 16-bit PCM equals `pcm16` of `ServingEngine`'s
result on the same engine within 1 LSB (the same f32 waveform, rounded to
PCM); a streamed response's PCM equals the non-streamed one exactly.
"""

import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import TtsEngine as JTtsEngine
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import vocoder as jvocoder
from qwen3_tts_tpu_torch import SamplerConfig, convert
from qwen3_tts_tpu_torch import server as server_mod
from qwen3_tts_tpu_torch.serving import ServingEngine

CFG = tiny_engine_config(max_steps=6)
FS = CFG.vocoder.frame_samples
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, seed=1)
VOC_SCALE = 0.15


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=64).astype(np.float32)
    (sdir / "vivian.json").write_text(json.dumps(
        {"name": "vivian", "spk_emb": emb.tolist()}))
    jeng = JTtsEngine(config=CFG, random_weights=True, seed=0,
                      speakers_dir=str(sdir), compile_cache=False)
    vp = jvocoder.with_dtype(jvocoder.init_vocoder(
        jax.random.key(13), CFG.vocoder, scale=VOC_SCALE), CFG.vocoder)
    eng = convert.engine_from_jax_arrays(
        _np({k: jeng.models[k] for k in ("talker", "predictor")})
        | {"assets": jeng.models["assets"]}, _np(vp), CFG, device="cpu",
        speakers_dir=str(sdir))
    eng.set_sampler_config(SamplerConfig(**GREEDY))
    return eng


def _serve(engine, **kw):
    srv = server_mod.TtsServer(engine, **kw)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                server_mod.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd


@pytest.fixture(scope="module")
def served(engine):
    srv, httpd = _serve(engine, max_streams=2)
    yield srv, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    srv.shutdown()


def _req(port, method, path, body=None, raw=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path, body=raw if raw is not None else (
        json.dumps(body) if body is not None else None))
    r = c.getresponse()
    data = r.read()
    headers = dict(r.getheaders())
    c.close()
    return r.status, headers, data


def _pcm(data):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    return np.frombuffer(data[44:], "<i2")


def test_health(served):
    _, port = served
    status, headers, data = _req(port, "GET", "/health")
    assert status == 200 and headers["Content-Type"] == "application/json"
    body = json.loads(data)
    assert body["status"] == "ok" and body["active_streams"] == 0


def test_speakers(served):
    _, port = served
    status, _, data = _req(port, "GET", "/speakers")
    assert status == 200 and json.loads(data)["speakers"] == ["vivian"]


def test_stats(served):
    _, port = served
    status, _, data = _req(port, "GET", "/stats")
    s = json.loads(data)
    assert status == 200
    assert s["max_streams"] == 2 and s["kv_window"] is None
    assert s["active_streams"] == 0 and s["uptime_s"] >= 0
    assert {"streams_served", "frames_served",
            "audio_seconds_served"} <= set(s)


def test_tts_roundtrip_equals_serving(served, engine):
    """The WAV's PCM is `ServingEngine`'s result for the same request, as
    16-bit PCM, within 1 LSB."""
    _, port = served
    status, headers, data = _req(port, "POST", "/tts",
                                 {"text": "hello server"})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    pcm = _pcm(data)
    assert len(pcm) > 0 and len(pcm) % FS == 0
    assert int.from_bytes(data[40:44], "little") == 2 * len(pcm)
    direct = ServingEngine(engine, max_streams=2)
    sid = direct.submit("hello server", engine.get_speaker("vivian"))
    direct.run_until_drained()
    want = np.frombuffer(server_mod.pcm16(direct.result(sid).samples), "<i2")
    assert len(pcm) == len(want)
    assert np.abs(pcm.astype(np.int32) - want).max() <= 1
    assert np.abs(want).max() >= 1000      # a waveform, not rounding noise


def test_concurrent_requests(served):
    _, port = served
    results = {}

    def hit(i):
        results[i] = _req(port, "POST", "/tts", {"text": f"req {i}"})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert len(results) == 3
    for status, headers, data in results.values():
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        pcm = _pcm(data)
        assert len(pcm) > 0 and len(pcm) % FS == 0


def test_streaming_response_equals_non_streamed(served):
    """A chunked streamed WAV (max-length header placeholder) whose PCM is
    the non-streamed response's."""
    _, port = served
    status, headers, data = _req(port, "POST", "/tts",
                                 {"text": "stream me", "stream": True})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["Transfer-Encoding"] == "chunked"
    assert int.from_bytes(data[40:44], "little") \
        == 2 * CFG.max_steps * FS
    streamed = _pcm(data)
    _, _, whole = _req(port, "POST", "/tts", {"text": "stream me"})
    assert len(streamed) > 0
    np.testing.assert_array_equal(streamed, _pcm(whole))


def test_bad_request(served):
    _, port = served
    assert _req(port, "POST", "/tts", {"no_text": 1})[0] == 400
    assert _req(port, "POST", "/tts", raw=b"not json")[0] == 400
    assert _req(port, "POST", "/tts", [1, 2])[0] == 400
    assert _req(port, "GET", "/nope")[0] == 404
    assert _req(port, "POST", "/nope", {"text": "x"})[0] == 404


def test_admission_timeout_no_spin(engine):
    """A full batch rejects a new submission after admit_timeout (bounded
    admission) instead of spinning forever."""
    srv = server_mod.TtsServer(engine, max_streams=1, admit_timeout=0.2)
    # stop the scheduler so that the single row never drains
    srv._stop = True
    with srv._cond:
        srv._cond.notify_all()
    srv._thread.join(timeout=10)
    assert not srv._thread.is_alive()
    voice = engine.get_speaker("vivian")
    assert srv.serving.submit("occupies the row", voice) is not None
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        srv.submit("rejected", voice)
    assert time.monotonic() - t0 < 5.0


def test_finished_streams_are_evicted(engine):
    """The port's divergence from the JAX daemon: once a request has read
    its stream, the stream leaves `serving.streams` and only /stats keeps
    it. After three requests (plain, streamed, plain) the streams are gone
    and /stats counts 3 with their frames; a stream released before it
    finished goes when it finishes and counts; a failed prompt goes at
    once and does not count."""

    class BadVoice:
        audio_codes = []
        ref_text = ""

        @property
        def spk_emb(self):
            raise ValueError("corrupt embedding")

    srv, httpd = _serve(engine, max_streams=2)
    port = httpd.server_address[1]

    def stats():
        return json.loads(_req(port, "GET", "/stats")[2])

    try:
        frames = 0
        for body in ({"text": "first"}, {"text": "second", "stream": True},
                     {"text": "third"}):
            status, _, data = _req(port, "POST", "/tts", body)
            assert status == 200
            frames += len(_pcm(data)) // FS
        assert not srv.serving.streams and not srv._counted
        s = stats()
        assert s["streams_served"] == 3 and s["frames_served"] == frames
        assert s["audio_seconds_served"] == round(frames * FS / 24000, 2)

        sid = srv.submit("orphan", engine.get_speaker("vivian"))
        srv.release(sid)
        assert sid in srv._orphans
        deadline = time.monotonic() + 60
        while srv.serving.streams and time.monotonic() < deadline:
            srv.wait_progress(timeout=1.0)
        assert not srv.serving.streams and not srv._orphans
        s = stats()
        assert s["streams_served"] == 4 and s["frames_served"] > frames

        bad = srv.submit("x", BadVoice())
        assert srv.serving.streams[bad].error is not None
        srv.release(bad)
        assert not srv.serving.streams and not srv._counted
        assert stats()["streams_served"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()


def test_concurrent_stress_counts_every_request(engine):
    """12 request threads (more than the host's cores here), half of them
    streamed, on 2 rows, with the interpreter switching threads every
    10 us: every request answers 200, none is left in `serving.streams`,
    and /stats counts each request and each frame once (a lost update of
    the counters or of the streams would break this)."""
    import sys

    srv, httpd = _serve(engine, max_streams=2, admit_timeout=120.0)
    port = httpd.server_address[1]
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _req(port, "POST", "/tts",
                    {"text": f"stress {i}", "stream": i % 2 == 1})))
            for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert sorted(results) == list(range(12))
        frames = 0
        for status, _, data in results.values():
            assert status == 200
            frames += len(_pcm(data)) // FS
        assert not srv.serving.streams and not srv._counted
        s = json.loads(_req(port, "GET", "/stats")[2])
        assert s["streams_served"] == 12 and s["frames_served"] == frames
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()


def test_main_runs_on_the_card_or_raises():
    """The daemon's engine is on the card unless `--device cpu` asks for
    the CPU: without a card, `main` raises before it listens, with no
    quiet fallback."""
    args = server_mod.build_parser().parse_args([])
    assert args.device == "cuda" and args.host == "127.0.0.1"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.main(["--tiny", "--random-weights", "--port", "0"])
