"""Continuous-batching multi-stream serving. Port of
`qwen3_tts_tpu/serving.py`, the port's own copy.

A fixed device batch of `max_streams` rows runs one 4-frame stream step
(`tts/generate.make_stream_fns`) per tick; streams are admitted into free
rows mid-flight by copying their prefilled KV rows into the batch cache,
and released on EOS. Each row keeps its own cache slot (`slot` is a device
int32 [B]): a row admitted at its prompt's width runs beside rows hundreds
of slots further on, and the talker step masks every row to its own extent.

Correctness invariant (tested): a stream's greedy output is the one it has
running alone. Per-row attention bounds and per-row vocoder state keep
co-batched streams apart.

RNG policy: the batch has one `torch.Generator`. An admission makes the
admitted stream's generator (the engine's `_generator()`, seeded from the
sampler config) the batch's, as the JAX package folds the new stream's key
into the batch's. Greedy output does not depend on it; sampled co-batched
streams draw from the same distributions as solo runs, but not the same
sequence.

Each tick reads the device twice: once for the step's (codes, active,
done), once for the batched vocoder's (wav, valid). A stream that ends
adds one read for its vocoder flush. Host bookkeeping (the row lifecycle)
rides `runtime.SlotManager` (pure Python; the JAX package uses its native
library where it builds).

Deliberate divergences from the JAX package:
  * admission copies the prefilled row into the batch state in place (JAX
    builds a new state with `dynamic_update_slice`), and `reset_row`
    zeroes the row's vocoder state in place;
  * a stream keeps the codes of the frames it kept (`_Stream.codes`); JAX
    keeps only the waveform;
  * a prefill that raises releases its row before the error leaves
    `submit`;
  * a row with no stream restarts its vocoder position at 0 every tick.
    In JAX such a row advances a chunk a tick until it passes the
    vocoder's KV capacity (`max_frames`, 1024), where
    `dynamic_update_slice` clamps its writes; in PyTorch the write past
    the cache raises, so an idle row would stop the batch after
    max_frames / chunk_frames ticks. Live rows are unaffected: the frame
    cap ends every stream inside the capacity.
Everything runs under `torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import runtime
from .core import protocol as P
from .core.config import EngineConfig
from .models import decoder, vocoder
from .tts import generate
from .tts.engine import TtsEngine
from .utils.audio import AudioSample
from .utils.voice_file import VoiceFile


@dataclasses.dataclass
class _Stream:
    stream_id: int
    slot: int
    on_chunk: Optional[Callable[[np.ndarray], None]]
    pieces: List[np.ndarray] = dataclasses.field(default_factory=list)
    codes: List[np.ndarray] = dataclasses.field(default_factory=list)
    frames: int = 0              # generated frames kept (cap-clamped)
    emitted: int = 0             # waveform samples emitted so far
    done: bool = False
    result: Optional[AudioSample] = None
    error: Optional[str] = None

    def frame_codes(self) -> np.ndarray:
        """The kept frames' codes [frames, 16] int32."""
        if not self.codes:
            return np.zeros((0, P.NUM_CODEBOOKS), np.int32)
        return np.concatenate(self.codes)


class ServingEngine:
    """Multi-stream streaming TTS over one device batch, on the engine's
    device."""

    def __init__(self, engine: TtsEngine, max_streams: int = 4,
                 chunk_frames: int = P.STREAM_CHUNK_FRAMES,
                 kv_window: Optional[int] = None):
        """`kv_window` bounds every row's talker KV extent (256-aligned
        recommended): serving rarely needs max_seq = 4096 live slots a
        stream, and the full cache is ~469 MB a row on the full-width bf16
        talker; a 1024-slot window fits 4x the streams in the same memory.
        Streams whose prompt and frames would pass the window stop cleanly
        at it (the context cap's semantics)."""
        self.engine = engine
        self.cfg: EngineConfig = engine.config
        self.device = engine.device
        self.B = max_streams
        self.chunk_frames = chunk_frames
        self.kv_window = kv_window
        self.slots = runtime.SlotManager(max_streams)
        self.streams: Dict[int, _Stream] = {}
        self._slot_stream: Dict[int, int] = {}
        self._state = None      # the batch state, built at the first submit
        with torch.inference_mode():
            self._vstate = vocoder.init_state(self.cfg.vocoder, max_streams,
                                              device=self.device)
        sc = engine.sampler_config
        if chunk_frames == P.STREAM_CHUNK_FRAMES and kv_window is None:
            # the engine's memoised pair, which warmup_streaming() runs
            self._prefill_fn, self._step_fn = engine._get_stream_fns()
        else:
            self._prefill_fn, self._step_fn = generate.make_stream_fns(
                self.cfg.talker, self.cfg.predictor, top_k=sc.top_k,
                frames_per_call=chunk_frames, cache_len=kv_window)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run the batch step on a blank state (every row empty), one chunk
        through the batched vocoder, and the engine's one-row streaming
        prefill used at admission, so the first request builds nothing."""
        models = self.engine.models
        self._step_fn(models, self._blank_state())
        vocoder.decode(
            self.engine.vocoder_params, self.cfg.vocoder,
            torch.zeros(self.B, self.chunk_frames, P.NUM_CODEBOOKS,
                        dtype=torch.int32, device=self.device),
            vocoder.init_state(self.cfg.vocoder, self.B, device=self.device),
            False)
        self.engine.warmup_streaming(batch=1)

    # ------------------------------------------------------------------ admit
    def _blank_state(self):
        """`generate.init_state`'s dict for the whole batch, every row empty
        and done, its slot a device int32 [B]."""
        cfg = self.cfg.talker
        B, dev = self.B, self.device
        sc = self.engine.sampler_config
        return dict(
            generator=torch.Generator(device=dev).manual_seed(0),
            hidden=torch.zeros(B, cfg.hidden, dtype=getattr(torch, cfg.dtype),
                               device=dev),
            logits=torch.full((B, cfg.vocab), -1e9, dtype=torch.float32,
                              device=dev),
            cache=decoder.init_kv_cache(cfg, B, length=self.kv_window,
                                        device=dev),
            slot=torch.zeros(B, dtype=torch.int32, device=dev),
            step=0,
            pad_offset=torch.zeros(B, dtype=torch.int32, device=dev),
            done=torch.ones(B, dtype=torch.bool, device=dev),
            n_frames=torch.zeros(B, dtype=torch.int32, device=dev),
            temperature=float(sc.temperature),
            top_p=float(sc.top_p),
            prev_codes=torch.zeros(B, P.NUM_CODEBOOKS - 1, dtype=torch.int32,
                                   device=dev),
        )

    @torch.inference_mode()
    def submit(self, text: str, voice: VoiceFile,
               instruct: Optional[str] = None,
               on_chunk: Optional[Callable[[np.ndarray], None]] = None,
               ) -> Optional[int]:
        """Admit a stream. Returns stream_id, or None when the batch is full.
        A prompt that fails to build, or that fills the talker context or
        the KV window, is reported on its stream and frees its row."""
        slot, sid = self.slots.acquire()
        if slot is None:
            return None
        if self._state is None:
            self._state = self._blank_state()

        try:
            data = self.engine._prompt_for_voice(text, voice, instruct)
            # _pad_prompts rejects a prompt that alone fills the talker
            # context; a prompt that fills the window leaves no frame either
            batch1, offs1 = self.engine._pad_prompts([data.embeds])
            if self.kv_window is not None \
                    and batch1.shape[1] >= self.kv_window:
                raise ValueError(
                    f"prompt ({batch1.shape[1]} slots) fills the serving "
                    f"KV window ({self.kv_window})")
        except Exception as e:   # a bad voice or text must not poison the batch
            self.slots.release(slot)
            s = _Stream(stream_id=sid, slot=-1, on_chunk=on_chunk,
                        done=True, error=f"prompt build failed: {e}")
            s.result = AudioSample(samples=np.zeros(0, np.float32),
                                   sample_rate=P.SAMPLE_RATE, channels=1)
            self.streams[sid] = s
            return sid
        sc = self.engine.sampler_config
        try:
            st1 = self._prefill_fn(self.engine.models, batch1, offs1,
                                   self.engine._generator(), sc.temperature,
                                   sc.top_p)
            _scatter_row(self._state, st1, slot)
            vocoder.reset_row(self._vstate, slot)
        except BaseException:
            self.slots.release(slot)
            raise
        self.streams[sid] = _Stream(stream_id=sid, slot=slot,
                                    on_chunk=on_chunk)
        self._slot_stream[slot] = sid
        return sid

    # ------------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> int:
        """Advance every active stream by one chunk. Returns the number of
        active streams after the tick."""
        if self._state is None or self.slots.active() == 0:
            return 0
        self._state, codes, active = self._step_fn(self.engine.models,
                                                   self._state)
        B, F = active.shape
        # one host read: the chunk's codes, active flags and done
        host = torch.cat([codes.reshape(-1), active.reshape(-1).int(),
                          self._state["done"].int()]).cpu().numpy()
        n_codes = B * F * P.NUM_CODEBOOKS
        codes_h = host[:n_codes].reshape(B, F, P.NUM_CODEBOOKS)
        n_new = host[n_codes:n_codes + B * F].reshape(B, F).sum(axis=1)
        done = host[n_codes + B * F:].astype(bool)

        # vocode every row in one batched call, then trim per stream by the
        # row's valid samples (the vocoder withholds its lookahead window:
        # emission lags generation by `lookahead` frames until the flush)
        vcfg = self.cfg.vocoder
        if n_new.max(initial=0) > 0:
            wav, valid, self._vstate = vocoder.decode(
                self.engine.vocoder_params, vcfg,
                codes[:, : self.chunk_frames], self._vstate, False)
            idle = [r for r in range(B) if r not in self._slot_stream]
            if idle:
                # a row with no stream still advances a chunk a tick and
                # would run past the vocoder's KV capacity: it restarts at 0
                # (admission resets the whole row)
                self._vstate.frames_done[idle] = 0
            wav, valid = _to_host(wav, valid)
        else:
            wav = np.zeros((B, (self.chunk_frames + vcfg.lookahead)
                            * vcfg.frame_samples), np.float32)
            valid = np.zeros((B,), np.int64)

        # per-stream frame cap: max_steps AND the vocoder's streaming KV
        # capacity. A live row's vocoder state advances chunk_frames a tick
        # whether or not the generator emitted a whole chunk, so a stream
        # must end while ceil(frames / chunk) * chunk still fits max_frames:
        # hence the `- chunk_frames` headroom
        frame_cap = min(self.engine.max_steps,
                        vcfg.max_frames - self.chunk_frames)
        for slot, sid in list(self._slot_stream.items()):
            s = self.streams[sid]
            k = min(int(n_new[slot]), max(frame_cap - s.frames, 0))
            if k > 0:
                s.frames += k
                s.codes.append(codes_h[slot, :k].astype(np.int32))
                self.slots.mark_frames(slot, k)
            self._emit(s, wav[slot], int(valid[slot]))
            if bool(done[slot]) or s.frames >= frame_cap:
                # drain the row's withheld lookahead frames (the per-stream
                # analogue of the reference's is_last call)
                fwav, fvalid, _ = vocoder.flush(
                    self.engine.vocoder_params, vcfg,
                    vocoder.gather_row(self._vstate, slot))
                fwav, fvalid = _to_host(fwav, fvalid)
                self._emit(s, fwav[0], int(fvalid[0]))
                s.done = True
                s.result = AudioSample(
                    samples=(np.concatenate(s.pieces) if s.pieces
                             else np.zeros(0, np.float32)),
                    sample_rate=P.SAMPLE_RATE, channels=1)
                self.slots.mark_eos(slot)
                self.slots.release(slot)
                del self._slot_stream[slot]
                # the row stops emitting: done in place
                self._state["done"][slot] = True
        return self.slots.active()

    def _emit(self, s: _Stream, row_wav: np.ndarray, valid: int) -> None:
        """Append finalized samples, clamped so a stream never emits past its
        kept-frame budget (frames past EOS or the cap still went through the
        batched vocoder, but their samples lie past the budget and are
        dropped here)."""
        fs = self.cfg.vocoder.frame_samples
        e = min(valid, s.frames * fs - s.emitted)
        if e > 0:
            piece = row_wav[:e]
            s.pieces.append(piece)
            s.emitted += e
            if s.on_chunk is not None:
                s.on_chunk(piece)

    def run_until_drained(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if self.step() == 0 and self.slots.active() == 0:
                break

    def result(self, stream_id: int) -> Optional[AudioSample]:
        s = self.streams.get(stream_id)
        return s.result if s and s.done else None


def _to_host(wav: torch.Tensor, valid: torch.Tensor):
    """(wav [B, N] f32, valid [B] int64) on the host in one read; valid
    counts samples (< 2^24), exact in f32."""
    B = wav.shape[0]
    host = torch.cat([wav.float().reshape(-1), valid.float()]).cpu().numpy()
    return (host[:-B].reshape(B, -1),
            host[-B:].astype(np.int64))


def _scatter_row(big, small, row: int) -> None:
    """Copy a freshly prefilled one-row state into batch row `row`, in place.

    Cache positions are per row: the admitted row starts at its own prompt
    width while running rows keep their extents. Cache slots past a row's
    own extent are masked by its kv_len, so staggered admission does not
    interact. The copy takes the row's whole cache ([L, B, nk, T, hd], a
    `[:, row]` slice); slots past the prefill's extent, if its cache is
    shorter, are zeroed. The row's `prev_codes` (the Jacobi draft) stay as
    they are, as in JAX: a draft changes the passes, never the codes."""
    for name in ("k", "v"):
        b, s = big["cache"][name], small["cache"][name]
        T = s.shape[3]
        b[:, row, :, :T].copy_(s[:, 0])
        if T < b.shape[3]:
            b[:, row, :, T:].zero_()
    for name in ("hidden", "logits", "pad_offset"):
        big[name][row] = small[name][0]
    big["done"][row] = False
    big["n_frames"][row] = 0
    big["slot"][row] = int(small["slot"])
    big["generator"] = small["generator"]
    big["temperature"] = small["temperature"]
    big["top_p"] = small["top_p"]
