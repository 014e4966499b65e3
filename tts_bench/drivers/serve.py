"""Driver `serve`: `clients` closed-loop clients of one
`ServingEngine(engine, max_streams, kv_window)`, which runs one 4-frame
step of the whole device batch a tick and admits streams between ticks.

A client sends its next request when its previous one has delivered its
last chunk; the driver submits it at the next tick boundary, so the wait
counts in its first-chunk time. Client c sends its first request at tick
c * ramp_ticks / clients, so admissions spread over the ticks instead of
arriving in one wave that would repeat every stream's length. When the
window's seconds are up no client sends again, and the driver steps until
every stream sent has finished.

The engine's frame cap (`set_max_steps`) is the traffic's frame budget,
one for every stream. Every request carries the traffic's sampler, so the
batch's sampler, which is the last admitted stream's (the engine's RNG
policy), is the same on every tick.
"""

from __future__ import annotations

from tts_bench import generate, system


def _loop(ctx, srv, source, until: float, record: bool, clients: int,
          ramp_ticks: int) -> None:
    """Run the clients until `until` (or until `source` runs dry), then
    until every stream sent has finished."""
    rec = ctx.rec
    clock = rec.clock
    C = clients
    first_tick = [c * ramp_ticks // C for c in range(C)]
    ready = [None] * C          # when the client's last request finished
    busy = [False] * C
    active = {}                 # stream id -> (client, request)
    tick = 0
    while True:
        if clock() < until:
            for c in range(C):
                if busy[c] or tick < first_tick[c]:
                    continue
                r = next(source, None)
                if r is None:
                    until = clock()
                    break
                r.t_send = ready[c] if ready[c] is not None else clock()
                if record:
                    rec.requests.append(r)
                ctx.engine.set_sampler_config(
                    system.sampler(ctx.cell.traffic, r))
                with rec.span("serve.submit"):
                    sid = srv.submit(
                        r.text, ctx.engine.get_speaker(r.voice),
                        on_chunk=lambda p, r=r: r.on_chunk(p, clock))
                    if ctx.traced:
                        ctx.sync()
                if sid is None:
                    raise RuntimeError("a client found the batch full")
                s = srv.streams[sid]
                if s.done:          # refused at admission
                    r.error = s.error or "no audio"
                    ready[c] = clock()
                    continue
                r.row = s.slot
                busy[c] = True
                active[sid] = (c, r)
        if not active:
            if clock() >= until:
                return
            continue
        with rec.span("serve.step"):
            srv.step()
        tick += 1
        for sid, (c, r) in list(active.items()):
            s = srv.streams[sid]
            if s.done:
                r.codes = [s.frame_codes()]
                if s.error is not None:
                    r.error = s.error
                ready[c] = r.chunk_t[-1] if r.chunk_t else clock()
                busy[c] = False
                del active[sid]


def prepare(ctx) -> None:
    """The server at the traffic's batch and window; every shape the
    traffic uses warmed by its `warm` requests, run to their end."""
    from qwen3_tts_tpu_torch.serving import ServingEngine

    t = ctx.cell.traffic
    if t["frames"][0] != t["frames"][1]:
        raise ValueError("serving has one frame cap for every stream")
    ctx.engine.set_max_steps(t["frames"][0])
    srv = ServingEngine(ctx.engine, max_streams=t["max_streams"],
                        kv_window=t["kv_window"])
    ctx.state["srv"] = srv
    warm = [generate.Request(index=-1 - i, text="w" * n, voice="vivian",
                             frames=frames, sampler_seed=i)
            for i, (n, frames) in enumerate(t["warm"])]
    _loop(ctx, srv, iter(warm), float("inf"), False, len(warm), 0)


def window(ctx) -> None:
    t = ctx.cell.traffic
    _loop(ctx, ctx.state["srv"], ctx.requests, ctx.rec.t0 + ctx.seconds,
          True, t["clients"], t["ramp_ticks"])


def close(ctx) -> None:
    ctx.state.pop("srv", None)
