"""The port's CLI (`python -m qwen3_tts_tpu_torch.cli`) against the JAX
package's: the flag surface (plus `--device`), CPU runs end to end
(offline, `--stream`, `--long`, a checkpoint directory), the error paths
and their messages, and the refusal of `--long` with `--stream`.

Every run is offline: `QWEN3_TTS_OFFLINE=1` or `--no-download`.
"""

import json

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import cli as jcli
from qwen3_tts_tpu_torch import TtsEngine, tiny_engine_config
from qwen3_tts_tpu_torch import cli
from qwen3_tts_tpu_torch.utils.audio import AudioSample


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_OFFLINE", "1")


@pytest.fixture
def speakers(tmp_path):
    sdir = tmp_path / "speakers"
    sdir.mkdir()
    emb = np.random.default_rng(0).normal(size=64).tolist()
    (sdir / "vivian.json").write_text(json.dumps(
        {"name": "vivian", "spk_emb": emb}))
    return sdir


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.required)
            for a in parser._actions if a.option_strings}


def test_flag_surface_is_jax_plus_device():
    ours, theirs = _options(cli.build_parser()), _options(jcli.build_parser())
    assert set(ours) == set(theirs) | {"device"}
    for dest, spec in theirs.items():
        assert ours[dest] == spec, dest
    assert ours["device"][:2] == (("--device",), "cuda")
    args = cli.build_parser().parse_args([
        "--model-dir", "m", "--quant", "q8_0", "--text", "t",
        "--voice-file", "v.json", "--ref-audio", "r.wav",
        "--ref-text", "rt", "--save-voice", "sv.json",
        "--output", "o.wav", "--max-steps", "100",
        "--speakers-dir", "s", "--speaker", "vivian",
        "--instruction", "Happy", "--temperature", "0.5",
        "--top-k", "20", "--top-p", "0.8", "--seed", "7",
        "--compile-cache", "c", "--device", "cpu"])
    assert args.text == "t" and args.seed == 7 and args.device == "cpu"


def _wav_ok(path, max_frames):
    audio = AudioSample.load_wav(str(path))
    assert 0 < audio.duration()
    assert len(audio.samples) <= max_frames * 2000
    assert np.isfinite(audio.samples).all()


@pytest.mark.parametrize("mode", ["offline", "stream", "long"])
def test_cli_cpu_tiny_random_weights(tmp_path, speakers, mode):
    out = tmp_path / "out.wav"
    text = ("First sentence of the text. A second sentence follows it! "
            "And a third one ends here.") if mode == "long" else "cli test"
    flags = {"offline": [], "stream": ["--stream"], "long": ["--long"]}
    rc = cli.main([
        "--text", text, "--tiny", "--random-weights", "--device", "cpu",
        "--speakers-dir", str(speakers), "--max-steps", "5",
        "--temperature", "0", "--seed", "1", "--output", str(out),
        *flags[mode]])
    assert rc == 0
    _wav_ok(out, 5 * (3 if mode == "long" else 1))


def test_cli_loads_a_checkpoint_dir(tmp_path, speakers, capsys):
    """The CLI on a directory the port's save_checkpoint wrote gives the
    engine's own greedy waveform."""
    cfg = tiny_engine_config()
    eng = TtsEngine(config=cfg, random_weights=True, seed=2, device="cpu",
                    speakers_dir=str(speakers))
    models = tmp_path / "models"
    eng.save_checkpoint(str(models))
    out = tmp_path / "o.wav"
    rc = cli.main(["--text", "from disk", "--tiny", "--no-download",
                   "--model-dir", str(models), "--device", "cpu",
                   "--speakers-dir", str(speakers), "--max-steps", "4",
                   "--temperature", "0", "--seed", "1", "--output", str(out)])
    assert rc == 0
    from qwen3_tts_tpu_torch import SamplerConfig
    eng.set_max_steps(4)
    eng.set_sampler_config(SamplerConfig(temperature=0.0, top_k=40,
                                         top_p=0.9, seed=1))
    want = eng.generate_with_voice("from disk", eng.get_speaker("vivian"))
    want.save_wav(str(tmp_path / "want.wav"))
    assert out.read_bytes() == (tmp_path / "want.wav").read_bytes()


def test_cli_missing_model_dir_same_message(tmp_path, capsys):
    args = ["--text", "hi", "--tiny", "--model-dir", str(tmp_path / "none"),
            "--quant", "q8_0", "--compile-cache", "off"]
    assert jcli.main(args) == 1
    want = capsys.readouterr().err
    assert cli.main(args + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err
    assert "gguf_q8_0/qwen3_tts_talker.gguf" in got
    assert "Failed to load models: no embedding tables" in got

    def lines(err):
        return [ln for ln in err.splitlines()
                if ln.startswith(("Failed", "Missing", "  "))]
    assert lines(got) == lines(want)


def test_cli_bad_voice_file(tmp_path, capsys):
    rc = cli.main(["--text", "x", "--tiny", "--random-weights",
                   "--device", "cpu",
                   "--voice-file", str(tmp_path / "missing.json")])
    assert rc == 1
    assert "Failed to load voice file" in capsys.readouterr().err


def test_cli_refuses_long_with_stream(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--text", "x", "--tiny", "--random-weights", "--device",
                  "cpu", "--long", "--stream"])
    assert e.value.code == 2
    assert "--long and --stream cannot be combined" in \
        capsys.readouterr().err


def test_cli_device_cuda_needs_a_card(monkeypatch, speakers):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--text", "x", "--tiny", "--random-weights",
                  "--speakers-dir", str(speakers)])


def test_cli_profile_writes_a_trace(tmp_path, speakers):
    prof = tmp_path / "prof"
    rc = cli.main(["--text", "p", "--tiny", "--random-weights", "--device",
                   "cpu", "--speakers-dir", str(speakers), "--max-steps",
                   "2", "--profile", str(prof), "--output",
                   str(tmp_path / "p.wav")])
    assert rc == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_cli_missing_required_flag():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([])


def test_cli_ref_audio_save_voice(tmp_path, speakers, capsys):
    """--ref-audio --ref-text --save-voice on a directory the port saved,
    with the encoders written beside it: exit 0, a WAV, and a voice JSON
    that loads and clones."""
    from qwen3_tts_tpu_torch import VoiceFile
    from qwen3_tts_tpu_torch.assets import checkpoint
    from qwen3_tts_tpu_torch.models import encoders

    cfg = tiny_engine_config()
    eng = TtsEngine(config=cfg, random_weights=True, seed=3, device="cpu",
                    speakers_dir=str(speakers))
    models = tmp_path / "models"
    eng.save_checkpoint(str(models))
    ae, se = encoders.random_encoders(torch.Generator().manual_seed(1), cfg,
                                      eng.vocoder_params)
    checkpoint.save_tree(str(models / "audio_encoder.npz"), ae.params)
    checkpoint.save_tree(str(models / "speaker_encoder.npz"), se.params)
    ref = tmp_path / "ref.wav"
    AudioSample(samples=0.1 * np.random.default_rng(4).standard_normal(
        3 * 2000).astype(np.float32)).save_wav(str(ref))
    out, voice = tmp_path / "clone.wav", tmp_path / "voice.json"
    base = ["--text", "clone from the cli", "--tiny", "--no-download",
            "--model-dir", str(models), "--device", "cpu",
            "--speakers-dir", str(speakers), "--max-steps", "4",
            "--temperature", "0", "--seed", "1"]
    assert cli.main(base + ["--output", str(out), "--ref-audio", str(ref),
                            "--ref-text", "the reference",
                            "--save-voice", str(voice)]) == 0
    printed = capsys.readouterr().out
    assert f"Creating voice from reference: {ref}" in printed
    assert f"Saved new voice file to: {voice}" in printed
    _wav_ok(out, 4)
    vf = VoiceFile.load(str(voice))
    assert vf.ref_text == "the reference"
    assert len(vf.audio_codes) == 3 * 16
    assert vf.audio_codes == [int(c) for c in ae.encode(
        AudioSample.load_wav(str(ref)).samples)]
    # the saved voice through --voice-file gives the same waveform
    out2 = tmp_path / "again.wav"
    assert cli.main(base + ["--output", str(out2), "--voice-file",
                            str(voice)]) == 0
    assert out2.read_bytes() == out.read_bytes()


def test_cli_ref_audio_without_encoders_same_message(tmp_path, speakers,
                                                     capsys):
    """Without encoder checkpoints both CLIs exit 1 with JAX's message."""
    ref = tmp_path / "ref.wav"
    AudioSample(samples=np.zeros(4000, np.float32)).save_wav(str(ref))
    args = ["--text", "x", "--tiny", "--random-weights", "--max-steps", "2",
            "--speakers-dir", str(speakers), "--ref-audio", str(ref),
            "--output", str(tmp_path / "o.wav")]
    assert jcli.main(args + ["--compile-cache", "off"]) == 1
    want = capsys.readouterr().err
    assert cli.main(args + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err
    assert "Feature extraction failed: AudioEncoder/SpeakerEncoder not " \
           "loaded" in got
    assert got.splitlines()[-1] == want.splitlines()[-1]
