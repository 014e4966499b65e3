"""tick_ms.serve: the mean of the harness's spans around
`ServingEngine.step()`, which ends in a host read, so a span is the tick's
whole time: host launches, device and bookkeeping."""

UNIT, LAYER, MOVES = "ms", "serving", "audio_s_per_s"


def read(rec):
    t = rec.span_times("serve.step")
    return sum(t) / len(t) * 1e3 if t else None
