"""launches_per_frame: CUDA kernels in the traced window over the frames
served in it (whole frames of delivered audio, every stream)."""

UNIT, LAYER, MOVES = "kernels/frame", "loop", "audio_s_per_s"


def read(rec):
    n = len(rec.kernels())
    return n / rec.frames if n and rec.frames else None
