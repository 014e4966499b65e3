"""chunk_gap_ms_p95.stream: the single stream's 95th percentile of every
gap between successive chunks, as the end-to-end `chunk_gap_ms_p95` reads
it. One client's tail swings with the host's vocoder thread by more than
half of any bound the contract allows at the longest window, so here it
is a per-layer figure of the loop."""

from tts_bench.harness import find

UNIT, LAYER, MOVES = "ms", "loop", "audio_s_per_s"


def read(rec):
    return find("end_to_end", "chunk_gap_ms_p95").read(rec)
