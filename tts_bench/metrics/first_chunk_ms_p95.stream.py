"""first_chunk_ms_p95.stream: the single stream's 95th percentile of the
time from send to first chunk, as the end-to-end `first_chunk_ms_p95`
reads it. One client completes too few requests in a run's window for the
tail to hold a bound, so here it is a per-layer figure of the loop."""

from tts_bench.harness import find

UNIT, LAYER, MOVES = "ms", "loop", "audio_s_per_s"


def read(rec):
    return find("end_to_end", "first_chunk_ms_p95").read(rec)
