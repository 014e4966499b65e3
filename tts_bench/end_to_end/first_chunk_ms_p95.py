"""first_chunk_ms_p95: the 95th percentile, over every request sent in
the window, of the time from the client's send to its first `on_chunk`.
A request that failed or got no chunk counts as the whole window."""

from tts_bench.harness import percentile

UNIT = "ms"


def read(rec):
    if not rec.requests:
        return None
    v = [(r.chunk_t[0] - r.t_send) * 1e3
         if r.chunk_t and r.error is None else rec.window_s * 1e3
         for r in rec.requests]
    return percentile(v, 95)
