"""Voice cloning in the port against the JAX package on the CPU, tiny f32
config: the TTSC cache, the mel frontend, the RVQ, the audio and speaker
encoders, the clone prompt, and the engine's cloning entry points
(`generate_with_voice` / `generate_batch` / `generate_stream` with a clone
`VoiceFile`, `generate`, `process_reference`, `create_voice_file`).

Both packages run the same weights (the JAX package's seeded init, carried
over by `qwen3_tts_tpu_torch.convert`, encoder codebooks tied to the
vocoder's tables) on the same numpy inputs. The engines' vocoder is the
JAX package's init at scale 0.06, as in tests/test_torch_vocoder_general.py:
at the default 0.02 the tiny config's waveform peaks near 1e-7 and a
waveform tolerance would pass anything. Every engine entry point is held
to JAX by its greedy codes and frame counts (equal) and by its waveform.

Tolerances:
  * codes (RVQ, audio encoder, greedy generation): equal;
  * log-mel: atol 1e-5 (f32 on both sides; pocketfft against XLA's FFT,
    measured <= 2.4e-6 at 10 s);
  * speaker embedding: atol 1e-5 (measured <= 1.8e-7);
  * prompts: atol 1e-6 (sums of the same table rows);
  * waveforms: rtol 1e-5, atol 1e-6 and max|d| <= 1e-5 x the peak, as
    tests/test_torch_checkpoint.py holds the preset path (convolutions
    summed in another order);
  * a stream against the offline waveform: the same bound on all but the
    last LA frames. The offline path decodes the frame bucket in one call,
    so the lookahead of the last frames reads the zero-code frames past
    EOS where the stream's flush reads zeros, in JAX as in the port
    (ROADMAP queue 3); the stream is held whole to JAX's stream.
"""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import SamplerConfig as JSamplerConfig
from qwen3_tts_tpu import TtsEngine as JTtsEngine
from qwen3_tts_tpu.assets import checkpoint as jcheckpoint
from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import encoders as jencoders
from qwen3_tts_tpu.models import mel as jmel
from qwen3_tts_tpu.models import vocoder as jvocoder
from qwen3_tts_tpu.parallel import pipeline as jpipeline
from qwen3_tts_tpu.tts import generate as jgenerate
from qwen3_tts_tpu.tts import prompt as jprompt
from qwen3_tts_tpu.utils import cache as jcache
from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, VoiceFile, convert
from qwen3_tts_tpu_torch.core import protocol as P
from qwen3_tts_tpu_torch.models import encoders as tencoders
from qwen3_tts_tpu_torch.models import mel as tmel
from qwen3_tts_tpu_torch.parallel import pipeline as tpipeline
from qwen3_tts_tpu_torch.tts import generate as tgenerate
from qwen3_tts_tpu_torch.tts import engine as engine_mod
from qwen3_tts_tpu_torch.tts import prompt as tprompt
from qwen3_tts_tpu_torch.utils import cache as tcache
from qwen3_tts_tpu_torch.utils.audio import AudioSample

CFG = tiny_engine_config(max_steps=8)
WAV_RTOL, WAV_ATOL, WAV_PEAK = 1e-5, 1e-6, 1e-5
VOC_SCALE = 0.06
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, seed=42)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(n, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)


def _wav(path, n, seed=0, rate=24000):
    AudioSample(samples=_audio(n, seed), sample_rate=rate).save_wav(str(path))
    return str(path)


def _close(got, want):
    """Waveforms allclose and within WAV_PEAK x the reference's peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL)
    peak = np.abs(want).max()
    assert peak >= 100 * WAV_ATOL      # atol alone cannot pass a wrong wave
    assert np.abs(got - want).max() <= WAV_PEAK * peak


def _same_codes(got, want):
    """(codes, n_frames) of an engine's offline call, whose frame extent is
    the bucket (rows zero past the step cap), equal to `_codes`' result."""
    (gc, gn), (wc, wn) = got, want
    np.testing.assert_array_equal(gn, wn)
    steps = wc.shape[1]
    np.testing.assert_array_equal(gc[:, :steps], wc)
    assert not gc[:, steps:].any()


@contextlib.contextmanager
def _recording():
    """The codes each package's engine entry points make: the port's
    offline `generate_codes` results (codes [B, steps, 16], n_frames [B])
    and, for both packages, the chunks a stream submits to its vocoder
    pipeline. JAX's offline path is one jitted program, so its codes are
    taken through `_codes` instead."""
    rec = {"offline": [], "stream": [], "jax_stream": []}
    gen = tgenerate.generate_codes
    tsubmit = tpipeline.VocoderPipeline.submit
    jsubmit = jpipeline.VocoderPipeline.submit

    def offline(*args, **kw):
        c, n = gen(*args, **kw)
        rec["offline"].append((c.cpu().numpy(), n.cpu().numpy()))
        return c, n

    def tstream(self, codes, is_final=False):
        rec["stream"].append(np.asarray(codes))
        return tsubmit(self, codes, is_final)

    def jstream(self, codes, is_final=False):
        rec["jax_stream"].append(np.asarray(codes))
        return jsubmit(self, codes, is_final)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgenerate, "generate_codes", offline)
        mp.setattr(tpipeline.VocoderPipeline, "submit", tstream)
        mp.setattr(jpipeline.VocoderPipeline, "submit", jstream)
        yield rec


# ------------------------------------------------------------------- cache
def test_ttsc_cache_byte_compatible_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 2048, size=5 * 16)
    emb = rng.standard_normal(2048).astype(np.float32)
    tcache.save_cache(str(tmp_path / "t.cache"), codes, emb)
    jcache.save_cache(str(tmp_path / "j.cache"), codes, emb)
    assert (tmp_path / "t.cache").read_bytes() \
        == (tmp_path / "j.cache").read_bytes()
    for load, path in ((jcache.load_cache, "t.cache"),
                       (tcache.load_cache, "j.cache")):
        c, e = load(str(tmp_path / path))
        assert c.dtype == np.int64 and e.dtype == np.float32
        np.testing.assert_array_equal(c, codes)
        np.testing.assert_array_equal(e, emb)
    data = (tmp_path / "t.cache").read_bytes()
    (tmp_path / "bad.cache").write_bytes(b"XXXX" + data[4:])
    (tmp_path / "short.cache").write_bytes(data[:-4])
    for name, match in (("bad.cache", "magic"), ("short.cache", "truncated")):
        with pytest.raises(ValueError, match=match):
            tcache.load_cache(str(tmp_path / name))


# --------------------------------------------------------------------- mel
@pytest.mark.parametrize("n", [0, 255, 256, 300, 5000, 24011],
                         ids=lambda n: f"n{n}")
def test_compute_mel_matches_jax(n):
    """Empty below n_fft - 2 * padding samples, one frame at the edge, the
    reference's zero-filled reflection for a signal shorter than the
    padding (300 < 384), and whole seconds."""
    a = _audio(n, seed=n)
    want = jmel.compute_mel(a)
    got = tmel.compute_mel(a)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mel_host_half_equals_jax():
    cfg = CFG.mel
    np.testing.assert_array_equal(tmel.mel_filterbank(cfg),
                                  jmel.mel_filterbank(cfg))
    np.testing.assert_array_equal(tmel.hann_window(cfg.n_fft),
                                  jmel.hann_window(cfg.n_fft))
    a = _audio(50, seed=3)
    for pad in (10, 49, 50, 384):
        np.testing.assert_array_equal(tmel.reflect_pad(a, pad),
                                      jmel.reflect_pad(a, pad))


# --------------------------------------------------------------------- RVQ
def test_rvq_encode_equals_jax():
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((12, 16)).astype(np.float32)
    cb = (0.5 * rng.standard_normal((16, 64, 16))).astype(np.float32)
    want = np.asarray(jencoders.rvq_encode(jax.numpy.asarray(lat),
                                           jax.numpy.asarray(cb)))
    got = tencoders.rvq_encode(torch.from_numpy(lat), torch.from_numpy(cb))
    assert tuple(got.shape) == (12, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rvq_recovers_exact_codes_and_first_index_on_ties():
    """Latents built as a sum of one codeword per stage (codebooks of
    geometrically decaying scale, as tests/test_encoders.py:16 builds them)
    come back as those codes; a duplicated codeword takes the first index,
    as jnp.argmax does."""
    rng = np.random.default_rng(3)
    Q, V, D = 4, 32, 24
    cb = np.stack([rng.standard_normal((V, D)) * (0.35 ** q)
                   for q in range(Q)]).astype(np.float32)
    cb[:, 7] = cb[:, 3]
    codes = rng.integers(0, V, size=(6, Q))
    codes[codes == 7] = 3
    lat = sum(cb[q][codes[:, q]] for q in range(Q)).astype(np.float32)
    got = tencoders.rvq_encode(torch.from_numpy(lat), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), codes)
    want = np.asarray(jencoders.rvq_encode(jax.numpy.asarray(lat),
                                           jax.numpy.asarray(cb)))
    np.testing.assert_array_equal(want, codes)


# ---------------------------------------------------------------- encoders
@pytest.fixture(scope="module")
def encoder_pair():
    from qwen3_tts_tpu.models import vocoder as jvocoder
    jv = jvocoder.init_vocoder(jax.random.key(4), CFG.vocoder)
    jae, jse = jencoders.random_encoders(jax.random.key(5), CFG, jv)
    tae, tse = convert.encoders_from_numpy(_np(jae.params), _np(jse.params),
                                           CFG)
    return jae, jse, tae, tse, jv


@pytest.mark.parametrize("n", [0, 1999, 6005, 40000],
                         ids=lambda n: f"n{n}")
def test_audio_encoder_codes_equal_jax(encoder_pair, n):
    jae, _, tae, _, _ = encoder_pair
    a = _audio(n, seed=n + 1)
    want = jae.encode(a)
    got = tae.encode(a)
    assert got.dtype == np.int64 and got.shape == (n // 2000 * 16,)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < CFG.audio_encoder.code_vocab)).all()


def test_random_encoders_tie_codebooks_to_the_vocoder():
    g = torch.Generator().manual_seed(0)
    from qwen3_tts_tpu_torch.models import vocoder as tvocoder
    tv = tvocoder.init_vocoder(g, CFG.vocoder)
    ae, se = tencoders.random_encoders(g, CFG, tv)
    assert ae.params["codebooks"].data_ptr() == tv["embed"].data_ptr()
    # a codeword of the vocoder's first table is its own first code
    cb = tv["embed"]
    codes = torch.randint(0, cb.shape[1], (5,), generator=g)
    got = tencoders.rvq_encode(cb[0][codes], cb)
    assert got[:, 0].tolist() == codes.tolist()
    assert se.encode(_audio(48000)).shape == (CFG.speaker_encoder.out_dim,)


@pytest.mark.parametrize("n", [1024, 1300, 24000, 77777],
                         ids=lambda n: f"n{n}")
def test_speaker_encoder_matches_jax(encoder_pair, n):
    """1024 samples give 4 mel frames ((n - 256) // 256 + 1), the
    subsampling's minimum: a real embedding; 1023 give 3, and zeros."""
    _, jse, _, tse, _ = encoder_pair
    a = _audio(n, seed=n + 2)
    want = jse.encode(a)
    got = tse.encode(a)
    assert got.dtype == np.float32 and got.shape == (2048,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 0
    short = _audio(1023)
    np.testing.assert_array_equal(tse.encode(short), np.zeros(2048))
    np.testing.assert_array_equal(jse.encode(short), np.zeros(2048))


def test_load_encoders_from_jax_npz(encoder_pair, tmp_path):
    jae, jse, _, _, _ = encoder_pair
    jcheckpoint.save_pytree(str(tmp_path / "audio_encoder.npz"), jae.params)
    jcheckpoint.save_pytree(str(tmp_path / "speaker_encoder.npz"),
                            jse.params)
    ae, se = tencoders.load_encoders(str(tmp_path), CFG)
    a = _audio(14000, seed=9)
    np.testing.assert_array_equal(ae.encode(a), jae.encode(a))
    np.testing.assert_allclose(se.encode(a), jse.encode(a), rtol=0,
                               atol=1e-5)
    os.remove(tmp_path / "speaker_encoder.npz")
    with pytest.raises(FileNotFoundError):
        tencoders.load_encoders(str(tmp_path), CFG)


# ------------------------------------------------------------------ prompt
def test_clone_prompt_matches_jax():
    a = jtables.random_assets(jax.random.key(2), text_vocab=256,
                              codec_rows=2176, dim=64, proj_dim=32)
    ta = convert.assets_from_numpy(
        np.asarray(a.text_table), np.asarray(a.codec_tables),
        np.asarray(a.proj_weight), np.asarray(a.proj_bias))
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 2048, size=(7, 16))
    spk = rng.standard_normal(64).astype(np.float32)
    want = jprompt.build_clone_mid_block(a, ref, [11, 12])
    got = tprompt.build_clone_mid_block(ta, ref.reshape(-1), [11, 12])
    assert tuple(got.shape) == want.shape == (4 + 7 + 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for kw in (dict(lang_id=2050, instruct_ids=[9, 10]),
               dict(lang_id=None)):
        want = jprompt.build_clone_prompt(a, [5, 6], ref, [11, 12], spk, **kw)
        got = tprompt.build_clone_prompt(ta, [5, 6], ref, [11, 12], spk, **kw)
        np.testing.assert_allclose(got.embeds.numpy(),
                                   np.asarray(want.embeds), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.text_ids, want.text_ids)
        np.testing.assert_array_equal(got.spk_emb, want.spk_emb)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) on the same weights and encoders, greedy,
    with a vivian preset and a clone voice made by the JAX engine."""
    sdir = tmp_path_factory.mktemp("speakers")
    emb = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    with open(sdir / "vivian.json", "w") as f:
        json.dump({"name": "vivian", "spk_id": 3065,
                   "spk_emb": emb.tolist()}, f)
    jeng = JTtsEngine(config=CFG, random_weights=True, seed=0,
                      speakers_dir=str(sdir), compile_cache=False)
    jeng.set_sampler_config(JSamplerConfig(**GREEDY))
    jeng.vocoder_params = jvocoder.with_dtype(
        jvocoder.init_vocoder(jax.random.key(13), CFG.vocoder,
                              scale=VOC_SCALE), CFG.vocoder)
    jeng.encoder, jeng.speaker_encoder = jencoders.random_encoders(
        jax.random.key(7), CFG, jeng.vocoder_params)
    teng = convert.engine_from_jax_arrays(
        _np({k: jeng.models[k] for k in ("talker", "predictor")})
        | {"assets": jeng.models["assets"]},
        _np(jeng.vocoder_params), CFG, device="cpu", speakers_dir=str(sdir))
    teng.set_sampler_config(SamplerConfig(**GREEDY))
    teng.encoder, teng.speaker_encoder = convert.encoders_from_numpy(
        _np(jeng.encoder.params), _np(jeng.speaker_encoder.params), CFG)
    return jeng, teng


@pytest.fixture(scope="module")
def clone_voice(engines, tmp_path_factory):
    jeng, _ = engines
    path = _wav(tmp_path_factory.mktemp("ref") / "ref.wav", 3 * 2000 + 700,
                seed=11)
    return path, jeng.create_voice_file(path, "reference words")


def _codes(eng, texts, voices, jax_side):
    """Greedy (codes, n_frames) of one padded batch, as the offline path
    makes them."""
    datas = [eng._prompt_for_voice(t, v, None) for t, v in zip(texts, voices)]
    b, o = eng._pad_prompts([d.embeds for d in datas])
    cfg = eng.config
    if jax_side:
        c, n = jgenerate.generate_codes(
            eng.models, cfg.talker, cfg.predictor, b, o, jax.random.key(0),
            0.0, 0, 1.0, cfg.max_steps)
        return np.asarray(c), np.asarray(n)
    c, n = tgenerate.generate_codes(
        eng.models, cfg.talker, cfg.predictor, b, o, None, 0.0, 0, 1.0,
        cfg.max_steps)
    return c.numpy(), n.numpy()


def test_create_voice_file_equals_jax(engines, clone_voice):
    _, teng = engines
    path, jvoice = clone_voice
    voice = teng.create_voice_file(path, "reference words")
    assert voice.audio_codes == jvoice.audio_codes
    assert len(voice.audio_codes) == 3 * 16
    np.testing.assert_allclose(voice.speaker_embedding,
                               jvoice.speaker_embedding, rtol=0, atol=1e-5)
    assert voice.ref_text == "reference words"


def test_generate_with_clone_voice_matches_jax(engines, clone_voice):
    jeng, teng = engines
    _, jvoice = clone_voice
    voice = VoiceFile(ref_text=jvoice.ref_text,
                      audio_codes=list(jvoice.audio_codes),
                      speaker_embedding=list(jvoice.speaker_embedding))
    for text in ("clone me", "a second clone sentence"):
        jc, jn = _codes(jeng, [text], [jvoice], True)
        tc, tn = _codes(teng, [text], [voice], False)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)
        want = jeng.generate_with_voice(text, jvoice)
        got = teng.generate_with_voice(text, voice)
        _close(got.samples, want.samples)


def test_generate_from_reference_audio_matches_jax(engines, tmp_path):
    jeng, teng = engines
    os.makedirs(tmp_path / "j")
    jpath = _wav(tmp_path / "j" / "ref.wav", 4 * 2000, seed=12)
    tpath = _wav(tmp_path / "t.wav", 4 * 2000, seed=12)
    want = jeng.generate("hello clone", jpath, "ref words")
    with _recording() as rec:
        got = teng.generate("hello clone", tpath, "ref words")
    _close(got.samples, want.samples)
    # both wrote their sidecars, with equal codes
    jc, je = jcache.load_cache(os.path.splitext(jpath)[0] + ".cache")
    tc, te = tcache.load_cache(str(tmp_path / "t.cache"))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-5)
    # the port generated JAX's greedy codes for the clone prompt of this
    # reference and its transcript
    voice = VoiceFile(ref_text="ref words", audio_codes=[int(c) for c in jc],
                      speaker_embedding=[float(x) for x in je])
    want_c, want_n = _codes(jeng, ["hello clone"], [voice], True)
    [recorded] = rec["offline"]
    _same_codes(recorded, (want_c, want_n))
    assert len(got.samples) == int(want_n[0]) * CFG.vocoder.frame_samples


def test_process_reference_cache_short_circuit(engines, tmp_path,
                                              monkeypatch):
    """process_reference writes a TTSC sidecar, a second call reads it with
    the encoders poisoned (tests/test_engine.py:96-125), an unreadable
    sidecar is ignored, and a failed write is tolerated."""
    _, teng = engines
    saved = teng.encoder, teng.speaker_encoder
    path = _wav(tmp_path / "ref.wav", 3 * 2000, seed=2)
    try:
        vf = teng.create_voice_file(path, "ref text")
        vf.save(str(tmp_path / "voice.json"))
        assert VoiceFile.load(str(tmp_path / "voice.json")).audio_codes \
            == vf.audio_codes
        codes, emb = teng.process_reference(path)
        cache_path = tmp_path / "ref.cache"
        assert cache_path.exists()
        c2, e2 = tcache.load_cache(str(cache_path))
        np.testing.assert_array_equal(np.asarray(codes).reshape(-1), c2)
        np.testing.assert_array_equal(c2, vf.audio_codes)
        np.testing.assert_allclose(emb, e2, rtol=1e-6)
        teng.encoder = teng.speaker_encoder = None
        c3, e3 = teng.process_reference(path)
        np.testing.assert_array_equal(c3, c2)
        np.testing.assert_array_equal(e3, e2)
        # a corrupt sidecar falls through to the (absent) encoders
        cache_path.write_bytes(b"JUNK")
        with pytest.raises(RuntimeError, match="not loaded"):
            teng.process_reference(path)
        # a sidecar that cannot be written is not an error
        teng.encoder, teng.speaker_encoder = saved
        os.remove(cache_path)

        def refuse(*args):
            raise OSError("read-only")

        monkeypatch.setattr(engine_mod.feature_cache, "save_cache", refuse)
        c4, _ = teng.process_reference(path)
        np.testing.assert_array_equal(c4, c2)
        assert not cache_path.exists()
    finally:
        teng.encoder, teng.speaker_encoder = saved


def test_sample_rate_and_missing_encoder_errors(engines, tmp_path):
    _, teng = engines
    bad = _wav(tmp_path / "bad.wav", 4000, rate=16000)
    with pytest.raises(ValueError, match="Expected 24000Hz audio, found "
                                         "16000Hz"):
        teng.create_voice_file(bad, "x")
    bare = TtsEngine(config=CFG, random_weights=True, seed=1, device="cpu",
                     speakers_dir=None)
    assert bare.encoder is None and bare.speaker_encoder is None
    good = _wav(tmp_path / "good.wav", 4000)
    with pytest.raises(RuntimeError, match="Cloning requires encoder"):
        bare.create_voice_file(good, "x")
    with pytest.raises(RuntimeError, match="not loaded"):
        bare.generate("x", good, "y")


def test_clone_stream_equals_offline(engines, clone_voice):
    """A streamed clone request submits the offline request's greedy codes
    (equal to JAX's) to the vocoder and gives JAX's streamed samples; it
    agrees with the offline samples before the last LA frames (module
    docstring)."""
    jeng, teng = engines
    _, jvoice = clone_voice
    text = "stream the clone"
    chunks = []
    with _recording() as rec:
        streamed = teng.generate_stream(text, jvoice, on_chunk=chunks.append)
        jstream = jeng.generate_stream(text, jvoice)
    offline = teng.generate_with_voice(text, jvoice)
    jc, jn = _codes(jeng, [text], [jvoice], True)
    n = int(jn[0])
    assert n > 0
    for key in ("stream", "jax_stream"):
        got = np.concatenate(rec[key], axis=1)
        assert got.shape == (1, n, 16), key
        np.testing.assert_array_equal(got[0], jc[0, :n])
    assert len(streamed.samples) == len(offline.samples) \
        == n * CFG.vocoder.frame_samples
    np.testing.assert_array_equal(np.concatenate(chunks), streamed.samples)
    _close(streamed.samples, jstream.samples)
    head = (n - CFG.vocoder.lookahead) * CFG.vocoder.frame_samples
    assert head > 0
    _close(streamed.samples[:head], offline.samples[:head])


def test_batch_mixing_preset_and_clone(engines, clone_voice):
    jeng, teng = engines
    _, jvoice = clone_voice
    texts = ["preset row", "clone row in the batch"]
    voices = [teng.get_speaker("vivian"), jvoice]
    jvoices = [jeng.get_speaker("vivian"), jvoice]
    with _recording() as rec:
        got = teng.generate_batch(texts, voices)
    want = jeng.generate_batch(texts, jvoices)
    jc, jn = _codes(jeng, texts, jvoices, True)
    [(tc, tn)] = rec["offline"]
    _same_codes((tc, tn), (jc, jn))
    assert tc.shape[2] == P.NUM_CODEBOOKS
    for b, (g, w, t, v) in enumerate(zip(got, want, texts, voices)):
        n = int(jn[b])
        assert len(g.samples) == n * CFG.vocoder.frame_samples
        _close(g.samples, w.samples)
        # each row is the request made alone: its codes and its samples
        sc, sn = _codes(teng, [t], [v], False)
        assert int(sn[0]) == n
        np.testing.assert_array_equal(tc[b, :n], sc[0, :n])
        _close(g.samples, teng.generate_with_voice(t, v).samples)


def test_engine_loads_encoders_from_model_dir(engines, tmp_path):
    """save_checkpoint writes the encoders beside the weights when the
    engine has them; TtsEngine(model_dir=...) loads them (missing files
    leave them None) and clones as the in-memory engine does."""
    _, teng = engines
    teng.save_checkpoint(str(tmp_path))
    assert (tmp_path / "audio_encoder.npz").exists()
    eng = TtsEngine(model_dir=str(tmp_path), config=CFG, device="cpu",
                    speakers_dir=None)
    eng.set_sampler_config(SamplerConfig(**GREEDY))
    path = _wav(tmp_path / "ref.wav", 2 * 2000, seed=5)
    assert eng.create_voice_file(path, "r") \
        == teng.create_voice_file(path, "r")
    os.remove(tmp_path / "audio_encoder.npz")
    eng2 = TtsEngine(model_dir=str(tmp_path), config=CFG, device="cpu",
                     speakers_dir=None)
    assert eng2.encoder is None and eng2.speaker_encoder is None
