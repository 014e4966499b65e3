"""TtsEngine: the public orchestration layer. Port of
`qwen3_tts_tpu/tts/engine.py`: preset-speaker synthesis and voice cloning.

Weight sources, in this order:
  * `weights=(models, vocoder_params)`: weights built elsewhere
    (`convert.engine_from_jax_arrays` bridges the JAX package's), dense or
    quantized: talker and predictor trees from
    `ops.quant.quantize_decoder_params` run the int8 / int4 kernels;
  * `random_weights=True`: seeded random weights drawn from a
    `torch.Generator` on the engine's device, with the JAX engine's shapes;
  * `model_dir`: a checkpoint directory, the per-quant subdirectory
    (`download.quant_dir(quant)`, e.g. `gguf_q8_0/`) first and the flat
    directory second: `qwen3_assets.gguf` (or the NPY tables),
    `{talker,predictor}.npz` or the reference's llama.cpp
    `qwen3_tts_{talker,predictor}.gguf` (k-quants dequantised to the model
    dtype at load, as in JAX: loaded weights are dense), `vocoder.npz` and
    `vocoder_config.json` (which may name the general upsampler family or
    snake), and the optional `audio_encoder.npz` / `speaker_encoder.npz`.
    `save_checkpoint` writes such a directory (`assets/checkpoint.py` says
    how its f32-on-disk rule differs from the JAX package's). Leaves load
    one at a time straight to the device.

Cloning: `create_voice_file(wav, ref_text)` encodes 24 kHz reference audio
into a `VoiceFile` (codes from the audio encoder, an embedding from the
speaker encoder); `generate(text, wav, ref_text)` does the same through
`process_reference`, whose TTSC `.cache` sidecar (`utils/cache.py`) skips
the encoders the next time; a `VoiceFile` with `audio_codes` takes the
clone prompt on every generation path. The encoders come from
`model_dir` (missing files leave them None, as in JAX) or are set by the
caller (`models.encoders.random_encoders`); without them the cloning
entry points raise RuntimeError.

Generation paths:
  * offline: `generate_with_voice` / `generate_batch` run prompt assembly,
    the generation loop (`tts/generate.py`) and the one-shot vocoder;
  * stream: `generate_stream` runs the 4-frame step of `make_stream_fns`
    and hands each chunk's codes to a `VocoderPipeline` worker, which
    vocodes them against the carried state and delivers ~333 ms waveform
    chunks through `on_chunk`.

Deliberate divergences from the JAX engine:
  * `device=None` means the CUDA card and raises where there is none; CPU
    use passes `device="cpu"` (the plain versions of the kernels);
  * no persistent compilation cache: the JAX engine turns on a
    process-global XLA cache at construction; PyTorch runs eagerly and
    the kernels build once per checkout (`kernels/build.py`). `warmup`
    builds them and runs each path once, so the first request pays for
    neither nvcc nor Triton's JIT;
  * the offline loop reads `done` back at most once per 4 frames, the
    stream loop once per 4-frame chunk (see `tts/generate.py`);
  * `generate_long` keeps a decoded token prefix as a chunk only where it
    is a prefix of the text (`startswith`; JAX tests `in`, which drops or
    repeats characters when the prefix occurs later in the text);
  * `save_checkpoint` also writes the encoders when the engine has them
    (the JAX engine's writes none), so a saved directory clones.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..assets import checkpoint, tables
from ..core import protocol as P
from ..core.config import (EngineConfig, SamplerConfig, load_vocoder_config,
                           save_vocoder_config)
from ..download import Downloader, quant_dir
from ..models import decoder, encoders, vocoder
from ..utils import cache as feature_cache
from ..utils.audio import AudioSample
from ..utils.tokenizer import load_tokenizer
from ..utils.voice_file import VoiceFile
from . import generate, prompt


def default_device(device=None) -> torch.device:
    """The engine's device: the CUDA card when none is given. A CUDA device
    where there is none raises: there is no quiet fallback to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TtsEngine: no CUDA device (torch.cuda.is_available() is False);"
            " pass device=\"cpu\" to run the kernels' plain versions on the "
            "CPU")
    return dev


def random_weights(cfg: EngineConfig, seed: int, device):
    """(models, vocoder params) of `TtsEngine(random_weights=True, seed)`:
    four generators on `device` seeded seed * 4 + i."""
    gens = []
    for i in range(4):
        g = torch.Generator(device=device)
        g.manual_seed(seed * 4 + i)
        gens.append(g)
    assets = tables.random_assets(
        gens[0],
        text_vocab=P.TEXT_VOCAB if cfg.talker.hidden >= 2048 else 1024,
        codec_rows=3072 if cfg.talker.hidden >= 2048 else 2176,
        dim=cfg.talker.hidden, proj_dim=cfg.predictor.hidden, device=device)
    models = {
        "talker": decoder.init_decoder(gens[1], cfg.talker, device=device),
        "predictor": decoder.init_decoder(gens[2], cfg.predictor,
                                          device=device),
        "assets": assets,
    }
    return models, vocoder.init_vocoder(gens[3], cfg.vocoder, device=device)


class TtsEngine:
    def __init__(
        self,
        model_dir: Optional[str] = None,
        config: Optional[EngineConfig] = None,
        *,
        quant: str = "none",
        random_weights: bool = False,
        seed: int = 0,
        speakers_dir: Optional[str] = None,
        device=None,
        weights: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
    ):
        self.config = config or EngineConfig()
        self.device = default_device(device)
        self.model_dir = model_dir
        # `quant` picks a checkpoint's per-quant subdirectory, as in JAX
        self.quant = quant
        self.max_steps = self.config.max_steps
        self.sampler_config = SamplerConfig()
        self.speakers: Dict[str, VoiceFile] = {}
        self._stream_fns: Dict[int, Tuple[Callable, Callable]] = {}
        # the cloning encoders: optional, like the reference's .ok() loads
        self.encoder: Optional[encoders.AudioEncoder] = None
        self.speaker_encoder: Optional[encoders.SpeakerEncoder] = None

        if weights is not None:
            self.models, self.vocoder_params = weights
        elif random_weights:
            self.models, self.vocoder_params = self._random_weights(seed)
        elif model_dir is not None:
            self.models, self.vocoder_params = self._load(model_dir)
            self._load_optional_encoders(model_dir)
        else:
            raise ValueError("need model_dir or random_weights=True")
        # a bf16 vocoder trunk is cast once here; checkpoints store f32
        self.vocoder_params = vocoder.with_dtype(self.vocoder_params,
                                                 self.config.vocoder)
        self.tokenizer = load_tokenizer(model_dir or "")

        sdir = speakers_dir
        if sdir is None and model_dir is not None:
            cand = os.path.join(model_dir, "preset_speakers")
            sdir = cand if os.path.isdir(cand) else "speakers"
        if sdir and os.path.isdir(sdir):
            self.load_speakers(sdir)

    def _random_weights(self, seed: int):
        return random_weights(self.config, seed, self.device)

    def _load(self, model_dir: str):
        """The checkpoint directory's weights (see the module docstring)."""
        qdir = os.path.join(model_dir, quant_dir(self.quant))

        def resolve(name):
            cand = os.path.join(qdir, name)
            return cand if os.path.exists(cand) \
                else os.path.join(model_dir, name)

        dev = self.device
        assets = tables.load_assets(
            qdir if os.path.exists(os.path.join(qdir, "qwen3_assets.gguf"))
            else model_dir, device=dev)
        # a converted release persists its vocoder architecture beside
        # vocoder.npz: decode against that, keeping the caller's dtype
        vcfg_path = resolve("vocoder_config.json")
        if os.path.exists(vcfg_path):
            vcfg = dataclasses.replace(load_vocoder_config(vcfg_path),
                                       dtype=self.config.vocoder.dtype)
            if vcfg != self.config.vocoder:
                self.config = dataclasses.replace(self.config, vocoder=vcfg)
        cfg = self.config
        models = {
            "talker": self._load_decoder(resolve, "talker", cfg.talker),
            "predictor": self._load_decoder(resolve, "predictor",
                                            cfg.predictor),
            "assets": assets,
        }
        like = vocoder.init_vocoder(None, cfg.vocoder, device="meta")
        return models, checkpoint.load_tree(resolve("vocoder.npz"), like,
                                            device=dev)

    def _load_decoder(self, resolve, kind: str, cfg):
        """The .npz checkpoint first; the reference's own
        `qwen3_tts_{kind}.gguf` (llama.cpp layout) second, which is what
        the downloader fetches (no conversion step)."""
        npz = resolve(f"{kind}.npz")
        if os.path.exists(npz):
            like = decoder.init_decoder(None, cfg, device="meta")
            return checkpoint.load_tree(npz, like, device=self.device)
        gpath = resolve(f"qwen3_tts_{kind}.gguf")
        if os.path.exists(gpath):
            from ..assets.llama_gguf import convert_llama_gguf
            gcfg, params = convert_llama_gguf(gpath, kind)
            for field in ("hidden", "n_layers", "n_q_heads", "n_kv_heads",
                          "head_dim", "ffn_dim"):
                got, want = getattr(gcfg, field), getattr(cfg, field)
                if got != want:
                    raise ValueError(
                        f"{gpath}: GGUF {field}={got} but the engine config "
                        f"says {want}")
            return convert.decoder_from_numpy(params, self.device,
                                              getattr(torch, cfg.dtype))
        raise FileNotFoundError(
            f"no {kind} weights: tried {npz} and {gpath} "
            f"(run TtsEngine.download_models or tools/convert_weights.py)")

    def _load_optional_encoders(self, model_dir: str) -> None:
        """Encoders are optional: preset-speaker synthesis works without
        them; cloning raises (src/tts/engine.rs:107-120, 289-295)."""
        try:
            self.encoder, self.speaker_encoder = encoders.load_encoders(
                model_dir, self.config, device=self.device)
        except FileNotFoundError:
            self.encoder = self.speaker_encoder = None

    def save_checkpoint(self, out_dir: str) -> None:
        """Write every weight as a directory `TtsEngine(model_dir=...)`
        loads, in both packages: `{talker,predictor,vocoder}.npz` (bf16
        leaves as f32), `vocoder_config.json` (f32, the checkpoint's dtype),
        the assets as `qwen3_assets.gguf` and, when the engine has them,
        `audio_encoder.npz` and `speaker_encoder.npz`."""
        os.makedirs(out_dir, exist_ok=True)
        for kind in ("talker", "predictor"):
            checkpoint.save_tree(os.path.join(out_dir, f"{kind}.npz"),
                                 self.models[kind])
        checkpoint.save_tree(os.path.join(out_dir, "vocoder.npz"),
                             self.vocoder_params)
        save_vocoder_config(
            os.path.join(out_dir, "vocoder_config.json"),
            dataclasses.replace(self.config.vocoder, dtype="float32"))
        tables.save_assets(os.path.join(out_dir, "qwen3_assets.gguf"),
                           self.models["assets"])
        if self.encoder is not None and self.speaker_encoder is not None:
            checkpoint.save_tree(os.path.join(out_dir, "audio_encoder.npz"),
                                 self.encoder.params)
            checkpoint.save_tree(
                os.path.join(out_dir, "speaker_encoder.npz"),
                self.speaker_encoder.params)

    @staticmethod
    def download_models(model_dir: str = "models", quant: str = "none",
                        offline: Optional[bool] = None) -> Dict[str, str]:
        """Fetch (or verify) the model manifest for `quant` into
        `model_dir`. Returns {relative path: exists|downloaded|missing|
        corrupt}; offline, it reports instead of fetching."""
        return Downloader(offline=offline).check_and_download(model_dir,
                                                              quant)

    # ------------------------------------------------------------- settings
    def set_max_steps(self, steps: int) -> None:
        self.max_steps = int(steps)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, prompt_buckets: Sequence[int] = (64,),
               batch_sizes: Sequence[int] = (1,)) -> None:
        """Build the kernels (nvcc at first use, Triton's JIT at the first
        launch of each variant) and run each prompt bucket and batch size
        through the offline path (prefill, two frames, one-shot vocoder)
        and the streaming path, so the first request pays for neither.
        Nothing is compiled per shape beyond that: PyTorch runs eagerly."""
        cfg = self.config
        sc = self.sampler_config
        dim = int(self.models["assets"].text_table.shape[1])
        for b in batch_sizes:
            for s in prompt_buckets:
                if s >= cfg.talker.max_seq:
                    continue
                fake = [torch.zeros(s, dim, device=self.device)
                        for _ in range(b)]
                batch, offsets = self._pad_prompts(fake)
                bucket, steps = self._offline_extents(int(batch.shape[1]))
                with torch.inference_mode():
                    generate.generate_audio(
                        self.models, self.vocoder_params, cfg.talker,
                        cfg.predictor, cfg.vocoder, batch, offsets,
                        self._generator(), sc.temperature, sc.top_k,
                        sc.top_p, bucket, step_cap=min(steps, 2))
                self._sync()
        for b in batch_sizes:
            self.warmup_streaming(prompt_buckets, batch=b)

    def warmup_streaming(self, prompt_buckets: Sequence[int] = (64,),
                         batch: int = 1) -> None:
        """Run each prompt bucket through the streaming prefill and one
        stream step, and one chunk through the vocoder, for `batch`
        rows."""
        cfg = self.config
        sc = self.sampler_config
        dim = int(self.models["assets"].text_table.shape[1])
        prefill_fn, step_fn = self._get_stream_fns()
        with torch.inference_mode():
            for s in prompt_buckets:
                if s >= cfg.talker.max_seq:
                    continue
                fake = [torch.zeros(s, dim, device=self.device)
                        for _ in range(batch)]
                b_arr, offsets = self._pad_prompts(fake)
                state = prefill_fn(self.models, b_arr, offsets,
                                   self._generator(), sc.temperature,
                                   sc.top_p)
                step_fn(self.models, state)
            vocoder.decode(
                self.vocoder_params, cfg.vocoder,
                torch.zeros(batch, P.STREAM_CHUNK_FRAMES, P.NUM_CODEBOOKS,
                            dtype=torch.int32, device=self.device),
                vocoder.init_state(cfg.vocoder, batch, device=self.device),
                False)
        self._sync()

    def _get_stream_fns(self):
        """Memoised (prefill, step) pair for the sampler's top_k."""
        top_k = self.sampler_config.top_k
        if top_k not in self._stream_fns:
            self._stream_fns[top_k] = generate.make_stream_fns(
                self.config.talker, self.config.predictor, top_k=top_k,
                frames_per_call=P.STREAM_CHUNK_FRAMES)
        return self._stream_fns[top_k]

    def set_sampler_config(self, config: SamplerConfig) -> None:
        self.sampler_config = config

    def get_sampler_config(self) -> SamplerConfig:
        return self.sampler_config

    def load_speakers(self, speakers_dir: str) -> None:
        for name in sorted(os.listdir(speakers_dir)):
            if not name.endswith(".json") or name == "index.json":
                continue
            try:
                self.speakers[name[:-5]] = VoiceFile.load(
                    os.path.join(speakers_dir, name))
            except (ValueError, KeyError, OSError):
                continue

    def get_speaker(self, id_or_name: str) -> VoiceFile:
        """Lookup with the vivian fallback."""
        if id_or_name in self.speakers:
            return self.speakers[id_or_name]
        for v in self.speakers.values():
            if v.name == id_or_name:
                return v
        if "vivian" in self.speakers:
            return self.speakers["vivian"]
        if self.speakers:
            return next(iter(self.speakers.values()))
        raise RuntimeError("No speakers loaded in engine!")

    # ----------------------------------------------------------- generation
    def _prompt_for_voice(self, text: str, voice: VoiceFile,
                          instruct: Optional[str]) -> prompt.PromptData:
        ids = self.tokenizer.encode(text)
        instruct_ids = self.tokenizer.encode(instruct) if instruct else None
        lang = self.config.lang_id
        if not voice.audio_codes:
            # preset path: spk_emb-only prompt (src/tts/engine.rs:398-412)
            return prompt.build_core(
                self.models["assets"], ids, lang_id=lang,
                spk_emb=self._fit_spk(voice.spk_emb),
                instruct_ids=instruct_ids)
        return prompt.build_clone_prompt(
            self.models["assets"], ids, voice.codes_array,
            self.tokenizer.encode(voice.ref_text),
            self._fit_spk(voice.spk_emb), lang_id=lang,
            instruct_ids=instruct_ids)

    def _fit_spk(self, emb: np.ndarray) -> np.ndarray:
        """Truncate/zero-pad a speaker embedding to the table width."""
        dim = int(self.models["assets"].text_table.shape[1])
        emb = np.asarray(emb, np.float32).reshape(-1)
        if emb.size == dim:
            return emb
        out = np.zeros(dim, np.float32)
        out[: min(dim, emb.size)] = emb[:dim]
        return out

    def _pad_prompts(self, embeds_list):
        """Bucket-pad prompts, clamping the bucket to the talker context and
        rejecting prompts that alone exceed it."""
        max_seq = self.config.talker.max_seq
        for e in embeds_list:
            if len(e) >= max_seq:
                raise ValueError(
                    f"prompt length {len(e)} >= talker context {max_seq}")
        bucket = min(prompt.PROMPT_BUCKET, max_seq)
        cap = max_seq - min(P.STREAM_CHUNK_FRAMES * 2, max_seq // 4)
        return prompt.pad_batch(embeds_list, bucket=bucket, cap=cap)

    def _offline_extents(self, prompt_cols: int):
        """(frame extent, exact step cap), bucketed as the JAX engine does
        so both packages size their caches and vocoder alike."""
        cfg = self.config
        room = cfg.talker.max_seq - prompt_cols
        steps = min(self.max_steps, max(room, 1), cfg.vocoder.max_frames)
        bucket = steps
        for b in (16, 32, 64, 128, 256, 512, 1024):
            if steps <= b <= max(room, 1) and b <= cfg.vocoder.max_frames:
                bucket = b
                break
        return bucket, steps

    def _generator(self) -> torch.Generator:
        seed = self.sampler_config.seed
        if seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _run_inference(self, datas: List[prompt.PromptData]
                       ) -> List[AudioSample]:
        cfg = self.config
        sc = self.sampler_config
        batch, offsets = self._pad_prompts([d.embeds for d in datas])
        bucket, steps = self._offline_extents(int(batch.shape[1]))
        with torch.inference_mode():
            wav, n_frames = generate.generate_audio(
                self.models, self.vocoder_params, cfg.talker, cfg.predictor,
                cfg.vocoder, batch, offsets, self._generator(),
                sc.temperature, sc.top_k, sc.top_p, bucket, step_cap=steps)
        wav = wav.cpu().numpy()
        n_frames = n_frames.cpu().numpy()
        return [AudioSample(
            samples=wav[b, : int(n_frames[b]) * cfg.vocoder.frame_samples
                        ].astype(np.float32),
            sample_rate=P.SAMPLE_RATE, channels=1)
            for b in range(wav.shape[0])]

    def generate_with_voice(self, text: str, voice: VoiceFile,
                            instruct: Optional[str] = None) -> AudioSample:
        data = self._prompt_for_voice(text, voice, instruct)
        return self._run_inference([data])[0]

    def generate_batch(self, texts: Sequence[str],
                       voices: Sequence[VoiceFile],
                       instruct: Optional[str] = None) -> List[AudioSample]:
        """Batched synthesis (ragged prompts left-padded)."""
        datas = [self._prompt_for_voice(t, v, instruct)
                 for t, v in zip(texts, voices)]
        return self._run_inference(datas)

    def generate(self, text: str, ref_audio_path: str, ref_text: str,
                 instruct: Optional[str] = None) -> AudioSample:
        """Clone from raw reference audio (src/tts/engine.rs:243-272)."""
        ref_codes, spk_emb = self.process_reference(ref_audio_path)
        ids = self.tokenizer.encode(text)
        instruct_ids = self.tokenizer.encode(instruct) if instruct else None
        data = prompt.build_clone_prompt(
            self.models["assets"], ids,
            np.asarray(ref_codes, np.int64).reshape(-1, P.NUM_CODEBOOKS),
            self.tokenizer.encode(ref_text), self._fit_spk(spk_emb),
            lang_id=self.config.lang_id, instruct_ids=instruct_ids)
        return self._run_inference([data])[0]

    def _require_encoders(self, message: str) -> None:
        if self.encoder is None or self.speaker_encoder is None:
            raise RuntimeError(message)

    def process_reference(self, audio_path: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Reference audio -> (flat codes int64, speaker embedding f32),
        read from the TTSC sidecar `<audio>.cache` when it holds a valid
        one, else encoded and written there (a failed write is ignored;
        src/tts/engine.rs:275-302). The sample rate is not checked, as in
        JAX: `create_voice_file` checks it."""
        cache_path = os.path.splitext(audio_path)[0] + ".cache"
        if os.path.exists(cache_path):
            try:
                return feature_cache.load_cache(cache_path)
            except ValueError:
                pass
        self._require_encoders(
            "AudioEncoder/SpeakerEncoder not loaded (required for "
            "processing raw audio)")
        audio = AudioSample.load_wav(audio_path)
        codes = self.encoder.encode(audio.samples)
        emb = self.speaker_encoder.encode(audio.samples)
        try:
            feature_cache.save_cache(cache_path, codes, emb)
        except OSError:
            pass
        return codes, emb

    def create_voice_file(self, audio_path: str, ref_text: str) -> VoiceFile:
        """A VoiceFile from 24 kHz reference audio and its transcript
        (src/tts/engine.rs:324-387)."""
        self._require_encoders(
            "AudioEncoder/SpeakerEncoder not loaded. Cloning requires "
            "encoder checkpoints in <model_dir>.")
        audio = AudioSample.load_wav(audio_path)
        if audio.sample_rate != 24000:
            raise ValueError(
                f"Expected 24000Hz audio, found {audio.sample_rate}Hz")
        codes = self.encoder.encode(audio.samples)
        emb = self.speaker_encoder.encode(audio.samples)
        return VoiceFile(
            ref_text=ref_text,
            audio_codes=[int(c) for c in np.asarray(codes).reshape(-1)],
            speaker_embedding=[float(x) for x in np.asarray(emb)])

    def _long_chunks(self, text: str, max_chunk_tokens: int) -> List[str]:
        """Sentence-bounded chunks of at most `max_chunk_tokens` tokens, a
        run-on sentence cut at a token prefix that decodes to a prefix of
        the text (else at half its characters)."""
        tok = self.tokenizer
        sentences = [s for s in re.split(r"(?<=[。！？.!?;\n])\s*", text)
                     if s.strip()]
        chunks: List[str] = []
        cur = ""
        for s in sentences:
            cand = (cur + " " + s).strip() if cur else s
            if cur and len(tok.encode(cand)) > max_chunk_tokens:
                chunks.append(cur)
                cur = s
            else:
                cur = cand
            while len(tok.encode(cur)) > max_chunk_tokens:
                head = tok.decode(tok.encode(cur)[:max_chunk_tokens])
                # decode() of a prefix may not land on a character boundary
                # or may not be the text's prefix: cut at half the
                # characters then
                if not head or not cur.startswith(head):
                    head = cur[: max(1, len(cur) // 2)]
                chunks.append(head)
                cur = cur[len(head):].strip()
        if cur:
            chunks.append(cur)
        return chunks

    def generate_long(self, text: str, voice: VoiceFile,
                      instruct: Optional[str] = None,
                      max_chunk_tokens: int = 48,
                      pause_s: float = 0.0) -> AudioSample:
        """Text of any length: split at sentence boundaries into chunks of
        at most `max_chunk_tokens` tokens, all chunks synthesized with the
        same voice as one batch (`generate_batch`, ragged prompts
        left-padded), the waveforms concatenated in order with `pause_s`
        of silence between chunks."""
        if len(self.tokenizer.encode(text)) <= max_chunk_tokens:
            return self.generate_with_voice(text, voice, instruct)
        chunks = self._long_chunks(text, max_chunk_tokens)
        pieces = self.generate_batch(chunks, [voice] * len(chunks),
                                     instruct)
        pause = np.zeros(int(pause_s * P.SAMPLE_RATE), np.float32)
        wavs: List[np.ndarray] = []
        for i, p in enumerate(pieces):
            if i and pause.size:
                wavs.append(pause)
            wavs.append(np.asarray(p.samples, np.float32))
        return AudioSample(samples=np.concatenate(wavs) if wavs
                           else np.zeros(0, np.float32),
                           sample_rate=P.SAMPLE_RATE, channels=1)

    def generate_stream(self, text: str, voice: VoiceFile,
                        instruct: Optional[str] = None,
                        on_chunk: Optional[Callable[[np.ndarray], None]]
                        = None) -> AudioSample:
        """Streaming synthesis: ~333 ms (4-frame) waveform chunks delivered
        through `on_chunk` as soon as each chunk is vocoded, on a worker
        thread (`VocoderPipeline`); returns the whole waveform."""
        from ..parallel.pipeline import VocoderPipeline

        cfg = self.config
        sc = self.sampler_config
        data = self._prompt_for_voice(text, voice, instruct)
        batch, offsets = self._pad_prompts([data.embeds])
        prefill_fn, step_fn = self._get_stream_fns()
        # frame budget: max_steps, the talker context left after the
        # prompt, and the vocoder's streaming KV capacity (as in JAX)
        budget = min(self.max_steps,
                     max(cfg.talker.max_seq - int(batch.shape[1]), 1),
                     cfg.vocoder.max_frames)
        with torch.inference_mode():
            state = prefill_fn(self.models, batch, offsets, self._generator(),
                               sc.temperature, sc.top_p)
        pipe = VocoderPipeline(self.vocoder_params, cfg.vocoder, batch=1,
                               on_chunk=on_chunk)
        try:
            steps = 0
            while steps < budget:
                with torch.inference_mode():
                    state, codes, active = step_fn(self.models, state)
                # one host read per chunk: the chunk's active flags and done
                flags = torch.cat([active[0], state["done"][:1]]).cpu()
                n_new = min(int(flags[:-1].sum()), budget - steps)
                done = bool(flags[-1])
                steps += P.STREAM_CHUNK_FRAMES
                if n_new > 0:
                    # is_final on the EOS chunk flushes the vocoder
                    # lookahead; a stream that ends between chunks is
                    # drained by close()
                    pipe.submit(codes[:, :n_new].cpu().numpy(),
                                is_final=done)
                if done:
                    break
        except BaseException:
            # stop the worker before the error leaves; its own error, if
            # any, is secondary to this one
            try:
                pipe.close()
            except RuntimeError:
                pass
            raise
        samples = pipe.close()
        return AudioSample(samples=samples, sample_rate=P.SAMPLE_RATE,
                           channels=1)


def cleanup() -> None:
    """API parity with the reference's `cleanup` (which frees llama.cpp's
    backend): a no-op, since PyTorch frees tensors when they are
    dropped."""
