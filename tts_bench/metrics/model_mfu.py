"""model_mfu: the operations of the work served in the traced window
(every request's prefill; every served frame's talker step, predictor
expansion and vocoding), over the window's wall time and the card's bf16
peak (weight-only quantisation computes in bf16)."""

from tts_bench import roofline
from tts_bench.harness import served_work

UNIT, LAYER, MOVES = "%", "model step", "audio_s_per_s"


def read(rec):
    if not rec.device_ops or not rec.frames:
        return None
    c, kinds = rec.config, rec.config["weights"]
    w = served_work(rec)
    ops = sum(roofline.prefill(c["talker"], p) for p in w["prompts"])
    ops += roofline.talker_step(c["talker"], kinds["talker"], w["frames"],
                                w["live"])[1]
    ops += roofline.predictor_frame(c["predictor"], kinds["predictor"],
                                    w["frames"])[1]
    ops += roofline.vocoder_frames(c["vocoder"], w["frames"],
                                   w["voc_attended"])
    return 100.0 * ops / rec.window_s / roofline.PEAK_OPS_S["bf16"]
