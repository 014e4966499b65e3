"""audio_s_per_s: seconds of audio delivered to `on_chunk` in the window,
over the window's wall time (first send to the last stream's end)."""

UNIT = "audio-s/s"


def read(rec):
    samples = sum(r.samples for r in rec.requests)
    return samples / 24000.0 / rec.window_s
