"""HTTP serving daemon: continuous-batched streaming TTS over a socket. Port
of `qwen3_tts_tpu/server.py`, the port's own copy.

A stdlib-only HTTP front end over `serving.ServingEngine`. A background
scheduler thread ticks the device batch; request threads submit streams and
block on their results (or stream chunks as they are vocoded).

Endpoints:
  GET  /health            -> {"status": "ok", "active_streams": N}
  GET  /stats             -> serving counters (streams served, frames,
                             audio seconds, uptime, config)
  GET  /speakers          -> {"speakers": [names...]}
  POST /tts               -> audio/wav
       body: {"text": "...", "speaker": "vivian", "instruct": null,
              "stream": false}
       with "stream": true the WAV payload is chunked-transfer encoded as
       chunks are vocoded (~333 ms of audio each; the header carries a
       max-length placeholder, as streamed WAV does).

Deliberate divergence from the JAX package: a finished stream leaves
`serving.streams` once its request has read the result (`TtsServer.release`;
JAX keeps every stream and its whole waveform for the daemon's lifetime).
Only the scalar counters of `/stats` outlive it. `ServingEngine.result`
keeps JAX's semantics for direct callers.

Run:  python -m qwen3_tts_tpu_torch.server --port 8973   (on the card)
      python -m qwen3_tts_tpu_torch.server --device cpu --tiny \\
          --random-weights --port 8973
"""

from __future__ import annotations

import argparse
import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .core import protocol as P
from .serving import ServingEngine


def wav_header(n_samples: int, sample_rate: int = P.SAMPLE_RATE) -> bytes:
    data_bytes = n_samples * 2
    return (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", data_bytes))


def pcm16(samples: np.ndarray) -> bytes:
    return np.clip(samples * 32767.0, -32768, 32767).astype("<i2").tobytes()


class TtsServer:
    """Owns the engine, the serving batch, and the scheduler thread.

    Synchronization is event-driven (no spin or poll loops): the scheduler
    notifies one Condition after every device tick, and submitters,
    waiters and chunk streamers block on it with predicates. Admission is
    bounded: when the device batch is full, submitters wait on the
    Condition up to `admit_timeout` and then fail (the HTTP layer answers
    503), so the backlog cannot grow without bound. Device work runs under
    `_lock`, on the scheduler thread (a tick) or a request thread (an
    admission's prefill).
    """

    def __init__(self, engine, max_streams: int = 4,
                 admit_timeout: float = 30.0,
                 kv_window: "int | None" = None):
        self.engine = engine
        self.serving = ServingEngine(engine, max_streams=max_streams,
                                     kv_window=kv_window)
        self._started = time.monotonic()
        self._streams_served = 0
        self._frames_served = 0
        self._counted: set = set()     # finished streams still held
        self._orphans: set = set()     # released before they finished
        self.admit_timeout = admit_timeout
        self._lock = threading.Lock()      # device access is single-threaded
        self._cond = threading.Condition()  # progress: tick / submit / done
        self._stop = False
        self._thread = threading.Thread(target=self._scheduler, daemon=True)
        self._thread.start()

    def _count(self, sid, s) -> None:
        """Add a finished stream to the counters, once (under `_lock`)."""
        if sid not in self._counted:
            self._counted.add(sid)
            if s.error is None:
                self._streams_served += 1
                self._frames_served += s.frames

    def _evict(self, sid) -> None:
        """Drop a finished stream, keeping only the counters (under
        `_lock`)."""
        self._count(sid, self.serving.streams.pop(sid))
        self._counted.discard(sid)
        self._orphans.discard(sid)

    def _scheduler(self) -> None:
        # inference mode is thread-local: this thread enters it itself
        with torch.inference_mode():
            while not self._stop:
                with self._lock:
                    active = self.serving.step()
                    for sid, st in list(self.serving.streams.items()):
                        if st.done:
                            self._count(sid, st)
                            if sid in self._orphans:
                                self._evict(sid)
                with self._cond:
                    self._cond.notify_all()    # streams advanced / completed
                    if active == 0 and not self._stop:
                        # idle: sleep until a submit (or shutdown)
                        # notifies; the timeout is only a liveness backstop
                        self._cond.wait(timeout=1.0)

    def submit(self, text, voice, instruct=None, on_chunk=None):
        deadline = time.monotonic() + self.admit_timeout
        while True:
            with self._lock:
                sid = self.serving.submit(text, voice, instruct=instruct,
                                          on_chunk=on_chunk)
            if sid is not None:
                with self._cond:
                    self._cond.notify_all()     # wake an idle scheduler
                return sid
            with self._cond:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no free stream slot within {self.admit_timeout}s")
                self._cond.wait(timeout=min(remaining, 1.0))

    def wait(self, sid, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                s = self.serving.streams.get(sid)
                if s is not None and s.done:
                    return s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"stream {sid} did not finish")
                self._cond.wait(timeout=min(remaining, 5.0))

    def wait_progress(self, timeout: float = 5.0) -> None:
        """Block until the next scheduler tick (chunk streamers use this
        between queue drains instead of polling)."""
        with self._cond:
            self._cond.wait(timeout=timeout)

    def is_done(self, sid) -> bool:
        s = self.serving.streams.get(sid)
        return s is not None and s.done

    def release(self, sid) -> None:
        """The request is done with stream `sid`: evict it now if it has
        finished, else as soon as it does."""
        with self._lock:
            s = self.serving.streams.get(sid)
            if s is None:
                return
            if s.done:
                self._evict(sid)
            else:
                self._orphans.add(sid)

    def stats(self) -> dict:
        frames = self._frames_served
        return {
            "active_streams": self.serving.slots.active(),
            "max_streams": self.serving.B,
            "kv_window": self.serving.kv_window,
            "streams_served": self._streams_served,
            "frames_served": frames,
            "audio_seconds_served": round(
                frames * P.FRAME_SAMPLES / P.SAMPLE_RATE, 2),
            "uptime_s": round(time.monotonic() - self._started, 1),
        }

    def shutdown(self) -> None:
        self._stop = True
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=5)


def make_handler(server: TtsServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {
                    "status": "ok",
                    "active_streams": server.serving.slots.active(),
                })
            elif self.path == "/stats":
                self._json(200, server.stats())
            elif self.path == "/speakers":
                self._json(200, {
                    "speakers": sorted(server.engine.speakers.keys()),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/tts":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                voice = server.engine.get_speaker(req.get("speaker", "vivian"))
            except RuntimeError as e:
                self._json(400, {"error": str(e)})
                return
            instruct = req.get("instruct")

            if req.get("stream"):
                self._stream(text, voice, instruct)
                return
            try:
                sid = server.submit(text, voice, instruct=instruct)
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
                return
            try:
                s = server.wait(sid)
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
                return
            finally:
                server.release(sid)
            if s.error:
                self._json(500, {"error": s.error})
                return
            samples = s.result.samples
            payload = wav_header(len(samples)) + pcm16(samples)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _stream(self, text, voice, instruct):
            chunk_q: "queue.Queue" = queue.Queue()
            try:
                sid = server.submit(text, voice, instruct=instruct,
                                    on_chunk=chunk_q.put)
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(chunk: bytes):
                    self.wfile.write(f"{len(chunk):X}\r\n".encode())
                    self.wfile.write(chunk + b"\r\n")

                # max-length header placeholder (players tolerate overlong
                # RIFF sizes on streamed WAV)
                send(wav_header(server.engine.max_steps * P.FRAME_SAMPLES))
                deadline = time.monotonic() + 300.0
                while True:
                    while not chunk_q.empty():     # drain what's vocoded
                        send(pcm16(chunk_q.get()))
                    if server.is_done(sid) and chunk_q.empty():
                        break
                    if time.monotonic() > deadline:
                        break                      # truncated stream
                    server.wait_progress(timeout=5.0)   # next device tick
            finally:
                server.release(sid)
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qwen3-tts-torch-serve")
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--speakers-dir", default="speakers")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8973)
    ap.add_argument("--max-streams", type=int, default=4)
    ap.add_argument("--kv-window", type=int, default=None,
                    help="per-row talker KV extent (256-aligned; e.g. "
                         "1024 fits 4x the streams of the full 4096-slot "
                         "cache)")
    ap.add_argument("--max-steps", type=int, default=512)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run each path once before "
                         "accepting requests")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (raises without a "
                         "card) or cpu (the kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from . import TtsEngine
    from .core.config import EngineConfig, tiny_engine_config

    config = tiny_engine_config() if args.tiny else EngineConfig()
    engine = TtsEngine(
        model_dir=None if args.random_weights else args.model_dir,
        config=config, random_weights=args.random_weights,
        speakers_dir=args.speakers_dir, device=args.device)
    engine.set_max_steps(args.max_steps)
    if args.warmup:
        print("warming up...", flush=True)
        engine.warmup()

    srv = TtsServer(engine, max_streams=args.max_streams,
                    kv_window=args.kv_window)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv))
    print(f"qwen3-tts serving on http://{args.host}:{args.port} "
          f"(max {args.max_streams} concurrent streams, device "
          f"{engine.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
