"""predictor_frame_roofline: the bound of the predictor frame kernel's
launches in the traced window (`roofline.predictor_frame` at the launch's
batch), over the device time of those launches."""

import re

from tts_bench import roofline

UNIT, LAYER, MOVES = "%", "kernels", "audio_s_per_s"
KERNEL = re.compile(r"(^|[^\w])predictor_frame[<(]")


def read(rec):
    ops = rec.kernels(KERNEL)
    if not ops:
        return None
    c, kind = rec.config["predictor"], rec.config["weights"]["predictor"]
    B = rec.traffic.get("max_streams") or 1
    n_b, n_o = roofline.predictor_frame(c, kind, B)
    ms, _ = roofline.bound(len(ops) * n_b, len(ops) * n_o,
                           "bf16" if kind == "dense" else "int8")
    return 100.0 * ms * 1e-3 / sum(b - a for _, a, b in ops)
