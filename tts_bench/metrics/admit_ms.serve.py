"""admit_ms.serve: the mean of the harness's spans around
`ServingEngine.submit()` followed by `torch.cuda.synchronize()` (the
traced run synchronises): prompt, prefill and the copy into the batch."""

UNIT, LAYER, MOVES = "ms", "serving admission", "first_chunk_ms_p95"


def read(rec):
    t = rec.span_times("serve.submit")
    return sum(t) / len(t) * 1e3 if t else None
