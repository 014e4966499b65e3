"""chunk_gap_ms_p95: the 95th percentile of every gap between successive
chunks of one stream, over all streams of the window. Playback stalls
where a gap passes the ~333 ms a 4-frame chunk plays."""

from tts_bench.harness import percentile

UNIT = "ms"


def read(rec):
    gaps = [(b - a) * 1e3 for r in rec.requests
            for a, b in zip(r.chunk_t, r.chunk_t[1:])]
    return percentile(gaps, 95) if gaps else None
