"""device_idle_share: the share of the traced window that the union of
the device's operations (kernels, copies, sets) does not cover."""

from tts_bench.harness import busy_s

UNIT, LAYER, MOVES = "%", "device", "audio_s_per_s"


def read(rec):
    if not rec.device_ops:
        return None
    return 100.0 * (1.0 - busy_s(rec) / rec.window_s)
