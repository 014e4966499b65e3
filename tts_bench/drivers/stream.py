"""Driver `stream`: one client at a time through
`TtsEngine.generate_stream`, which hands each 4-frame chunk's codes to a
`VocoderPipeline` worker that vocodes them and delivers the waveform
through `on_chunk`. A closed loop: the client sends its next request when
the previous one has returned, its last chunk delivered.

Before each request the driver sets the request's frame budget
(`set_max_steps`) and sampler (the traffic's, seeded per request). The
codes each chunk hands to the worker are kept for the check by a subclass
of the pipeline that records them and passes them on unchanged.
"""

from __future__ import annotations

import numpy as np

from tts_bench import generate, system


def run_one(ctx, r) -> None:
    """Send request `r` and wait for its last chunk."""
    eng, rec = ctx.engine, ctx.rec
    eng.set_max_steps(r.frames)
    eng.set_sampler_config(system.sampler(ctx.cell.traffic, r))
    ctx.state["current"] = r
    clock = rec.clock
    r.t_send = clock()
    with rec.span("stream.request"):
        try:
            eng.generate_stream(r.text, eng.get_speaker(r.voice),
                                on_chunk=lambda p: r.on_chunk(p, clock))
        except Exception as e:  # a failed request is counted, not fatal
            r.error = repr(e)
    ctx.state["current"] = None


def prepare(ctx) -> None:
    """Tap the pipeline's codes, then warm every shape the traffic uses:
    each prompt bucket and each partial last chunk (the traffic's `warm`
    list)."""
    from qwen3_tts_tpu_torch.parallel import pipeline

    base = pipeline.VocoderPipeline
    state = ctx.state

    class Tap(base):
        def submit(self, codes, is_final=False):
            r = state.get("current")
            if r is not None:
                r.codes.append(np.array(codes[0], np.int32))
            super().submit(codes, is_final)

    state["base"] = base
    pipeline.VocoderPipeline = Tap
    for i, (n, frames) in enumerate(ctx.cell.traffic["warm"]):
        run_one(ctx, generate.Request(index=-1 - i, text="w" * n,
                                      voice="vivian", frames=frames,
                                      sampler_seed=i))


def window(ctx) -> None:
    rec = ctx.rec
    end = rec.t0 + ctx.seconds
    while rec.clock() < end:
        r = next(ctx.requests)
        rec.requests.append(r)
        run_one(ctx, r)


def close(ctx) -> None:
    from qwen3_tts_tpu_torch.parallel import pipeline
    if "base" in ctx.state:
        pipeline.VocoderPipeline = ctx.state.pop("base")
