"""The port's `tools/validate_release.py` against a fixture release that
the port's own writers make (`save_checkpoint`, `export_llama_gguf`,
`write_vocoder_onnx`), in the downloader's layout
(`src/download.rs:55-101`): tokenizer/tokenizer.json,
onnx/qwen3_tts_decoder.onnx, gguf/{qwen3_assets,qwen3_tts_talker,
qwen3_tts_predictor}.gguf. The four cases of `tests/test_validate_release.py`
on the CPU (`--device cpu`), the JAX tool's check names and statuses on the
same fixture, and the port's one divergence: the tokenizer check without
the `tokenizers` library.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys

import pytest
import torch

from qwen3_tts_tpu_torch import TtsEngine
from qwen3_tts_tpu_torch.assets.llama_gguf import export_llama_gguf
from qwen3_tts_tpu_torch.core.config import (load_vocoder_config,
                                             tiny_engine_config)
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.tools import convert_weights as cw
from qwen3_tts_tpu_torch.tools import validate_release

CFG = tiny_engine_config()
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _write_tokenizer_json(path):
    """A real (tiny) HF tokenizer.json, so the validator takes the
    tokenizer's own path (tests/test_validate_release.py's fixture)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {w: i for i, w in enumerate(
        ["[UNK]", "hello", "from", "the", "release", "validator", "world"])}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tok.save(path)


@pytest.fixture(scope="module")
def release_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    eng = TtsEngine(config=CFG, random_weights=True, seed=3, device="cpu",
                    speakers_dir=str(root / "none"))
    qdir = root / "gguf"
    eng.save_checkpoint(str(qdir))
    # decoders ship as llama.cpp GGUF (what the downloader fetches)
    for kind in ("talker", "predictor"):
        export_llama_gguf(str(qdir / f"qwen3_tts_{kind}.gguf"),
                          getattr(CFG, kind), eng.models[kind])
    for stale in ("talker.npz", "predictor.npz", "vocoder.npz",
                  "vocoder_config.json"):
        os.remove(qdir / stale)     # the validator must regenerate these
    os.makedirs(root / "onnx")
    cw.write_vocoder_onnx(str(root / "onnx" / "qwen3_tts_decoder.onnx"),
                          eng.vocoder_params, CFG.vocoder)
    _write_tokenizer_json(str(root / "tokenizer" / "tokenizer.json"))
    # a preset speaker of the tiny geometry
    os.makedirs(root / "preset_speakers")
    (root / "preset_speakers" / "vivian.json").write_text(json.dumps({
        "name": "vivian", "ref_text": "", "audio_codes": [],
        "speaker_embedding": [0.01] * CFG.talker.hidden}))
    return str(root)


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


TINY_ARGV = ["--geometry", "tiny", "--steps", "6", "--quant-gate", "0"]


@pytest.fixture(scope="module")
def tiny_run(release_dir, tmp_path_factory):
    """The port's tool once on a copy of the fixture, as the JAX package's
    test runs its tool (tiny geometry, quant gate 0, a WAV written): (exit
    code, report, the copy, the WAV)."""
    tmp = tmp_path_factory.mktemp("tiny_run")
    rdir = str(tmp / "release")
    shutil.copytree(release_dir, rdir)
    wav = str(tmp / "validated.wav")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = validate_release.main(["--model-dir", rdir, "--device", "cpu",
                                    "--wav-out", wav] + TINY_ARGV)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), rdir, wav


def _copy(release_dir, tmp_path, name):
    path = str(tmp_path / name)
    shutil.copytree(release_dir, path)
    return path


def test_validator_passes_on_fixture_release(tiny_run):
    """tests/test_validate_release.py:80 on the port."""
    rc, report, rdir, wav = tiny_run
    assert rc == 0, report
    assert report["pass"] is True, report
    for name in ("manifest", "tokenizer", "assets_gguf", "talker_gguf",
                 "predictor_gguf", "vocoder_onnx", "synthesis"):
        assert report["checks"][name]["status"] == "pass", report["checks"]
    # encoders absent from the fixture: skipped, not failed
    assert report["checks"]["audio_encoder_onnx"]["status"] == "skip"
    assert report["checks"]["quant_agreement"]["status"] == "pass"
    assert "int8" in report["checks"]["quant_agreement"]["detail"]
    assert os.path.exists(wav) and os.path.getsize(wav) > 44
    # the conversion's outputs landed in the release (engine-loadable)
    assert os.path.exists(os.path.join(rdir, "gguf", "vocoder.npz"))
    assert os.path.exists(os.path.join(rdir, "gguf", "vocoder_config.json"))


def test_validator_fails_loud_on_missing_file(release_dir, tmp_path, capsys):
    """tests/test_validate_release.py:111 on the port."""
    broken = _copy(release_dir, tmp_path, "broken")
    os.remove(os.path.join(broken, "gguf", "qwen3_tts_talker.gguf"))
    rc = validate_release.main(["--model-dir", broken, "--geometry", "tiny",
                                "--skip-synthesis", "--device", "cpu"])
    report = _report(capsys)
    assert rc == 1
    assert report["pass"] is False
    assert report["checks"]["manifest"]["status"] == "fail"
    assert "qwen3_tts_talker.gguf" in report["checks"]["manifest"]["detail"]


def test_validator_general_vocoder_release(release_dir, tmp_path, capsys):
    """tests/test_validate_release.py:125 on the port: a decoder.onnx in
    the BigVGAN/DAC family is derived, converted, its vocoder_config.json
    persisted, and the synthesis serves it."""
    gdir = _copy(release_dir, tmp_path, "grelease")
    gcfg = dataclasses.replace(
        CFG.vocoder, upsample_kernels=(10, 10, 10, 8, 8),
        resblock_dilations=(1, 3), resblock_kernel=7, final_conv_kernel=7,
        activation="snake")
    p = voc.init_vocoder(torch.Generator().manual_seed(5), gcfg)
    p["transformer"]["head"] = torch.zeros_like(p["transformer"]["head"])
    cw.write_vocoder_onnx(os.path.join(gdir, "onnx",
                                       "qwen3_tts_decoder.onnx"), p, gcfg)
    rc = validate_release.main(["--model-dir", gdir, "--geometry", "tiny",
                                "--steps", "4", "--quant-gate", "0",
                                "--device", "cpu"])
    report = _report(capsys)
    assert rc == 0, report
    assert "general" in report["checks"]["vocoder_onnx"]["detail"]
    assert report["checks"]["synthesis"]["status"] == "pass", report["checks"]
    saved = load_vocoder_config(os.path.join(gdir, "gguf",
                                             "vocoder_config.json"))
    assert saved.general_upsampler and saved.activation == "snake"


def test_validator_auto_geometry(release_dir, tmp_path, capsys):
    """tests/test_validate_release.py:146 on the port: the geometry read
    from the GGUF metadata, the synthesis run end to end on it."""
    rdir = _copy(release_dir, tmp_path, "auto")
    rc = validate_release.main(["--model-dir", rdir, "--geometry", "auto",
                                "--steps", "4", "--quant-gate", "0",
                                "--device", "cpu"])
    report = _report(capsys)
    assert rc == 0, report
    assert report["checks"]["talker_gguf"]["status"] == "pass"
    assert "hidden=64" in report["checks"]["talker_gguf"]["detail"]
    assert report["checks"]["synthesis"]["status"] == "pass", report["checks"]


def test_check_names_and_statuses_match_jax_tool(release_dir, tiny_run,
                                                 tmp_path, capsys):
    """The JAX package's tool and the port's on the same fixture (a copy
    each, the same arguments): the same checks in the same order with the
    same statuses, the same pass and exit code."""
    sys.path.insert(0, TOOLS)
    try:
        import validate_release as jvalidate
    finally:
        sys.path.remove(TOOLS)
    jdir = _copy(release_dir, tmp_path, "jax")
    jrc = jvalidate.main(["--model-dir", jdir] + TINY_ARGV)
    jrep = _report(capsys)
    trc, trep, _, _ = tiny_run
    assert trc == jrc == 0, (trep, jrep)
    assert trep["pass"] is jrep["pass"] is True
    assert list(trep["checks"]) == list(jrep["checks"])
    assert ({k: v["status"] for k, v in trep["checks"].items()}
            == {k: v["status"] for k, v in jrep["checks"].items()})


def test_tokenizer_check_without_the_tokenizers_library(release_dir,
                                                        tmp_path, capsys,
                                                        monkeypatch):
    """Where `tokenizers` is not installed the tokenizer check reads
    tokenizer.json as JSON and reports skip with its reason (the release
    still passes); a tokenizer.json that is not JSON fails it."""
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "tokenizers" else real(name, *a))
    rdir = _copy(release_dir, tmp_path, "notok")
    argv = ["--model-dir", rdir, "--geometry", "tiny", "--skip-synthesis",
            "--device", "cpu"]
    assert validate_release.main(argv) == 0
    check = _report(capsys)["checks"]["tokenizer"]
    assert check["status"] == "skip"
    assert "not installed" in check["detail"]
    assert "WordLevel, 7 vocab entries" in check["detail"]
    with open(os.path.join(rdir, "tokenizer", "tokenizer.json"), "w") as f:
        f.write("{not json")
    assert validate_release.main(argv) == 1
    assert _report(capsys)["checks"]["tokenizer"]["status"] == "fail"
