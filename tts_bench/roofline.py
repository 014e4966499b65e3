"""The yardstick's arithmetic: the H100's published peaks, `bound`, and
the bytes and operations of the served path's units of work, from a
configuration's widths, the batch and the weights' kind.

Bytes count what the work must move: each weight once a pass (the
predictor's 16 passes of a frame each read its layer stack: 218 MB in
bf16 does not stay on a chip with 50 MB of L2), the live cache once a row,
inputs read and outputs written once. Operations count two a weight
element a row and four a cached key's element a query head. Weight-only
quantisation still computes in bf16, so a whole step's share of the peak
(`model_mfu`) is taken against bf16's.

Kinds: "dense" (the decoder's dtype), "int8" (int8 values and an f32
scale a column), "int4" (packed nibbles, an int8 multiplier per 128 rows
and column, an f32 scale a column).
"""

from __future__ import annotations

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): HBM
# bytes/s and operations/s by the inputs' type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
GROUP4 = 128
NUM_CODEBOOKS, CODE_VOCAB = 16, 2048


def bound(n_bytes, ops=0.0, kind="f32"):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the type's peak rate."""
    b = n_bytes / HBM_BYTES_S * 1e3
    o = ops / PEAK_OPS_S[kind] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _elt(c: dict) -> int:
    return 2 if c["dtype"] in ("bfloat16", "float16") else 4


def matrix_bytes(K: int, N: int, kind: str, elt: int) -> int:
    if kind == "dense":
        return K * N * elt
    if kind == "int8":
        return K * N + 4 * N
    if kind == "int4":
        return K * N // 2 + (K // GROUP4) * N + 4 * N
    raise ValueError(f"weight kind {kind!r}")


def stage_shapes(c: dict):
    """(K, N) of a decoder layer's four products."""
    H, F = c["hidden"], c["ffn_dim"]
    nq, nk, hd = c["n_q_heads"], c["n_kv_heads"], c["head_dim"]
    return [(H, (nq + 2 * nk) * hd), (nq * hd, H), (H, 2 * F), (F, H)]


def layer_macs(c: dict) -> int:
    return sum(K * N for K, N in stage_shapes(c))


def stack_bytes(c: dict, kind: str) -> int:
    """The layer stack's weight bytes."""
    return c["n_layers"] * sum(matrix_bytes(K, N, kind, _elt(c))
                               for K, N in stage_shapes(c))


def talker_step(c: dict, kind: str, B: int, live: float):
    """(bytes, operations) of one talker step of B rows whose caches hold
    `live` valid slots in all (summed over the rows): the stack and the
    head once, each row's live keys and values, its new slot, x, the
    hidden and the f32 logits."""
    t = _elt(c)
    L, nk, hd = c["n_layers"], c["n_kv_heads"], c["head_dim"]
    kv = 2 * L * nk * hd * t
    w = stack_bytes(c, kind) + matrix_bytes(c["hidden"], c["vocab"], kind, t)
    n_b = w + live * kv + B * (kv + 2 * c["hidden"] * t + c["vocab"] * 4)
    macs = c["n_layers"] * layer_macs(c) + c["hidden"] * c["vocab"]
    ops = 2.0 * B * macs + 4.0 * L * c["n_q_heads"] * hd * (live + B)
    return n_b, ops


def predictor_frame(c: dict, kind: str, B: int):
    """(bytes, operations) of one frame's expansion for B rows: the stack
    once a pass (16 passes), 15 of the head's 16 slices, the 15 codec
    rows gathered a row (model dtype), the projected hidden (f32) and
    code_0 read, the 16 codes written."""
    t = _elt(c)
    nb = NUM_CODEBOOKS
    head = matrix_bytes(c["hidden"], nb * CODE_VOCAB, kind, t) * (nb - 1) \
        // nb
    n_b = nb * stack_bytes(c, kind) + head + (nb - 1) * B * c["hidden"] * t \
        + B * c["hidden"] * 4 + B * 4 + B * nb * 4
    ops = 2.0 * B * (nb * c["n_layers"] * layer_macs(c)
                     + (nb - 1) * c["hidden"] * CODE_VOCAB)
    return n_b, ops


def prefill(c: dict, rows: int):
    """Operations of a prompt of `rows` positions through the talker: every
    layer at every position, causal attention, the head at the last."""
    L, hd = c["n_layers"], c["head_dim"]
    attn = 4.0 * L * c["n_q_heads"] * hd * rows * (rows + 1) / 2
    return 2.0 * rows * L * layer_macs(c) + 2.0 * c["hidden"] * c["vocab"] \
        + attn


def vocoder_frames(v: dict, n: int, attended: float):
    """Operations of vocoding n frames (f32): the three convolutions, the
    transformer (its attention over `attended` cached frames in all, summed
    over the n: F (F + 1) / 2 for one stream of F frames) and the
    upsampler's matmuls."""
    E, H, la = v["embed_dim"], v["hidden"], v["lookahead"]
    t = dict(hidden=H, ffn_dim=v["ffn_dim"], n_q_heads=v["n_heads"],
             n_kv_heads=v["n_heads"], head_dim=v["head_dim"])
    conv = E * H * v["pre_conv_kernel"] + H * H * (2 * la + 1) \
        + H * H * v["post_conv_kernel"]
    chans = [H]
    for _ in v["upsample_factors"][:-1]:
        chans.append(max(32, chans[-1] // 2))
    chans.append(1)
    up, rows = 0, 1
    for i, s in enumerate(v["upsample_factors"]):
        up += rows * chans[i] * s * chans[i + 1]
        rows *= s
    macs = conv + v["n_layers"] * layer_macs(t) + up
    attn = 4.0 * v["n_layers"] * v["n_heads"] * v["head_dim"] * attended
    return 2.0 * n * macs + attn
