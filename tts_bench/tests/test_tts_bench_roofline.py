"""The yardstick's byte and operation counts: by hand at a toy width, and
at full width against the bounds the port's kernel table was built on
(H100, 3.35 TB/s: the talker step dense B = 1 with 100 live slots 0.8475
ms, the predictor frame dense B = 1 1.0605 ms)."""

from __future__ import annotations

import pytest

from tts_bench import harness, roofline

FULL = harness.find("configs", "qwen3-tts-1.7b-bf16")
TOY = dict(hidden=4, n_layers=2, n_q_heads=2, n_kv_heads=1, head_dim=2,
           ffn_dim=8, vocab=10, dtype="bfloat16")


def test_toy_counts_by_hand():
    # a layer: qkv 4x8, wo 4x4, gate/up 4x16, down 8x4 -> 144 weights
    assert roofline.layer_macs(TOY) == 32 + 16 + 64 + 32
    assert roofline.stack_bytes(TOY, "dense") == 2 * 144 * 2
    # B = 1, 3 live slots: weights 2 * (288 + 40), kv a slot 2*2*1*2*2 = 16
    n_b, ops = roofline.talker_step(TOY, "dense", 1, 3.0)
    assert n_b == 656 + 3 * 16 + (16 + 2 * 4 * 2 + 10 * 4)
    assert ops == 2 * (288 + 40) + 4 * 2 * 2 * 2 * (3 + 1)
    assert roofline.matrix_bytes(256, 4, "int8", 2) == 256 * 4 + 16
    assert roofline.matrix_bytes(256, 4, "int4", 2) == 512 + 2 * 4 + 16


def test_full_width_bounds_match_the_kernel_table():
    ms, by = roofline.bound(*roofline.talker_step(FULL["talker"], "dense",
                                                  1, 100.0), "bf16")
    assert by == "bytes" and ms == pytest.approx(0.8475, abs=5e-5)
    ms, by = roofline.bound(*roofline.predictor_frame(FULL["predictor"],
                                                      "dense", 1), "bf16")
    assert by == "bytes" and ms == pytest.approx(1.0605, abs=5e-5)


def test_quantised_weights_move_fewer_bytes():
    t = FULL["talker"]
    dense = roofline.talker_step(t, "dense", 8, 800.0)[0]
    assert roofline.talker_step(t, "int8", 8, 800.0)[0] < dense / 1.9
    assert roofline.talker_step(t, "int4", 8, 800.0)[0] < dense / 3.5


def test_work_counts_grow_with_the_work():
    v = FULL["vocoder"]
    assert roofline.vocoder_frames(v, 8, 36) > 2 * roofline.vocoder_frames(
        v, 4, 10) * 0.99
    assert roofline.prefill(FULL["talker"], 128) > 2 * roofline.prefill(
        FULL["talker"], 64) * 0.99
