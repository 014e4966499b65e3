"""Talker -> vocoder pipelining: the port of
`qwen3_tts_tpu/parallel/pipeline.py`.

A worker thread owns the vocoder calls, the copy of each chunk's waveform
to the host and the `on_chunk` callback, while generation keeps launching
talker and predictor steps. Chunks are vocoded strictly in submission order
against the carried `VocoderState`, through a bounded queue (backpressure).
The worker launches on PyTorch's current (default) stream, the one
generation uses, so as in JAX the thread overlaps host work only (numpy
conversion, callbacks), not device work.

Deliberate divergence from the JAX version: there, a worker that has died
leaves `submit` (and `close`'s own `put`) blocking forever once the queue is
full. Here `submit` raises once the worker has failed, and `close` never
blocks on a full queue; it raises the worker's error as JAX does.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.config import VocoderConfig
from ..models import vocoder

_POLL_S = 0.05


class VocoderPipeline:
    """Worker thread that owns the vocoder calls of one stream batch."""

    def __init__(self, params, cfg: VocoderConfig, batch: int = 1,
                 on_chunk: Optional[Callable[[np.ndarray], None]] = None,
                 max_queue: int = 8):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.on_chunk = on_chunk
        self.device = params["embed"].device
        self.state = vocoder.init_state(cfg, batch, device=self.device)
        self.pieces: List[np.ndarray] = []
        self.error: Optional[BaseException] = None
        self._flushed = False
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _offer(self, item) -> bool:
        """Put `item`, waiting while the queue is full and the worker runs;
        False once the worker has ended (it will never take the item)."""
        while self._thread.is_alive():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _raise_failed(self) -> None:
        raise RuntimeError(f"vocoder pipeline failed: {self.error!r}")

    def submit(self, codes: np.ndarray, is_final: bool = False) -> None:
        """codes [B, n_frames, 16]; blocks while the queue is full
        (backpressure), raises once the worker has failed."""
        if self.error is not None:
            self._raise_failed()
        if not self._offer((np.asarray(codes, np.int32), bool(is_final))):
            if self.error is not None:
                self._raise_failed()
            raise RuntimeError("vocoder pipeline: submit after the stream "
                               "ended")

    def _run(self) -> None:
        try:
            # inference mode is thread-local: the worker enters its own
            with torch.inference_mode():
                self._loop()
        except BaseException as e:     # surfaced by submit() and close()
            self.error = e

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            codes, is_final = item
            if codes.shape[1] > 0:
                wav, valid, self.state = vocoder.decode(
                    self.params, self.cfg,
                    torch.from_numpy(codes).to(self.device), self.state,
                    is_final)
                self._flushed = is_final
            elif is_final:
                # stream ended between chunks: drain the lookahead window
                # (the reference's N=0 is_last call)
                wav, valid, self.state = vocoder.flush(self.params, self.cfg,
                                                       self.state)
                self._flushed = True
            else:
                continue
            piece = wav[0, : int(valid[0])].cpu().numpy()
            if piece.size:
                self.pieces.append(piece)
                if self.on_chunk is not None:
                    self.on_chunk(piece)
            if is_final:
                return

    def close(self) -> np.ndarray:
        """Flush, join, and return the concatenated waveform."""
        if not self._flushed:
            # emit any withheld lookahead frames before shutting down
            self._offer((np.zeros((self.batch, 0, self.cfg.num_codebooks),
                                  np.int32), True))
        self._offer(None)
        self._thread.join()
        if self.error is not None:
            self._raise_failed()
        return (np.concatenate(self.pieces) if self.pieces
                else np.zeros(0, np.float32))
