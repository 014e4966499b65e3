"""TtsEngine: the public orchestration layer. Port of
`qwen3_tts_tpu/tts/engine.py` for preset-speaker synthesis.

`TtsEngine(config=..., random_weights=True, seed=0)` draws seeded random
weights from a `torch.Generator` on the engine's device (the CUDA card
unless `device=` names another), with the JAX engine's shapes;
`weights=(models, vocoder_params)` takes weights built elsewhere
(`convert.engine_from_jax_arrays` bridges the JAX package's), dense or
quantized: talker and predictor trees from
`ops.quant.quantize_decoder_params` run the int8 / int4 kernels.

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
    stream loop once per 4-frame chunk (see `tts/generate.py`).

Loading checkpoints from `model_dir`, cloning and long text come later
(ROADMAP queue 1).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..assets import tables
from ..core import protocol as P
from ..core.config import EngineConfig, SamplerConfig
from ..models import decoder, vocoder
from ..utils.audio import AudioSample
from ..utils.tokenizer import load_tokenizer
from ..utils.voice_file import VoiceFile
from . import generate, prompt


def default_device() -> torch.device:
    """The engine's device when none is given: the CUDA card. There is no
    quiet fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "TtsEngine: no CUDA device (torch.cuda.is_available() is False);"
            " pass device=\"cpu\" to run the kernels' plain versions on the "
            "CPU")
    return torch.device("cuda")


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
        if quant != "none":
            # in the JAX engine `quant` only picks a checkpoint's per-quant
            # subdirectory (download.quant_dir)
            raise NotImplementedError(
                f"quant={quant!r} selects a checkpoint's per-quant "
                "subdirectory, and loading checkpoints is not ported yet "
                "(ROADMAP queue 1): pass quantized trees from "
                "ops.quant.quantize_decoder_params through weights=")
        self.config = config or EngineConfig()
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.model_dir = model_dir
        self.quant = quant
        self.max_steps = self.config.max_steps
        self.sampler_config = SamplerConfig()
        self.speakers: Dict[str, VoiceFile] = {}
        self._stream_fns: Dict[int, Tuple[Callable, Callable]] = {}

        if weights is not None:
            self.models, self.vocoder_params = weights
        elif random_weights:
            self.models, self.vocoder_params = self._random_weights(seed)
        else:
            raise NotImplementedError(
                "loading checkpoints is not ported yet (ROADMAP queue 1): "
                "use random_weights=True or weights=")
        self.tokenizer = load_tokenizer(model_dir or "")

        sdir = speakers_dir
        if sdir is None and model_dir is not None:
            cand = os.path.join(model_dir, "preset_speakers")
            sdir = cand if os.path.isdir(cand) else "speakers"
        if sdir and os.path.isdir(sdir):
            self.load_speakers(sdir)

    def _random_weights(self, seed: int):
        cfg = self.config
        dev = self.device
        gens = []
        for i in range(4):
            g = torch.Generator(device=dev)
            g.manual_seed(seed * 4 + i)
            gens.append(g)
        assets = tables.random_assets(
            gens[0],
            text_vocab=P.TEXT_VOCAB if cfg.talker.hidden >= 2048 else 1024,
            codec_rows=3072 if cfg.talker.hidden >= 2048 else 2176,
            dim=cfg.talker.hidden, proj_dim=cfg.predictor.hidden, device=dev)
        models = {
            "talker": decoder.init_decoder(gens[1], cfg.talker, device=dev),
            "predictor": decoder.init_decoder(gens[2], cfg.predictor,
                                              device=dev),
            "assets": assets,
        }
        return models, vocoder.init_vocoder(gens[3], cfg.vocoder, device=dev)

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
        if voice.audio_codes:
            raise NotImplementedError(
                "voice cloning is not ported yet (ROADMAP queue 1)")
        ids = self.tokenizer.encode(text)
        instruct_ids = self.tokenizer.encode(instruct) if instruct else None
        return prompt.build_core(
            self.models["assets"], ids, lang_id=self.config.lang_id,
            spk_emb=self._fit_spk(voice.spk_emb), instruct_ids=instruct_ids)

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
