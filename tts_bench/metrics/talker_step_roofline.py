"""talker_step_roofline: the bound of the talker step kernel's launches in
the traced window (`roofline.talker_step`: the weights once a launch,
the served rows' live cache), over the device time of those launches."""

import re

from tts_bench import roofline
from tts_bench.harness import served_work

UNIT, LAYER, MOVES = "%", "kernels", "audio_s_per_s"
KERNEL = re.compile(r"(^|[^\w])talker_step[<(]")


def read(rec):
    ops = rec.kernels(KERNEL)
    if not ops or not rec.frames:
        return None
    c, kind = rec.config["talker"], rec.config["weights"]["talker"]
    w = served_work(rec)
    launch_b, launch_o = roofline.talker_step(c, kind, 0, 0.0)
    rows_b, rows_o = roofline.talker_step(c, kind, w["frames"], w["live"])
    n = len(ops)
    ms, _ = roofline.bound(n * launch_b + rows_b - launch_b,
                           n * launch_o + rows_o - launch_o,
                           "bf16" if kind == "dense" else "int8")
    return 100.0 * ms * 1e-3 / sum(b - a for _, a, b in ops)
