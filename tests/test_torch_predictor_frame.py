"""The predictor frame kernel's CPU-side parts (`ops/fused_predictor.py`,
`csrc/predictor_frame.cu`): the routing rule between the frame kernel and
the chain, the kernel's work plan and shared-memory sizing, its packed
weight layout, the plain reduction of the head stage's
block-partial argmaxes, and `frame_codes_fused` on the CPU against the JAX
package's `frame_codes_fused` (its Pallas kernel in interpret mode, as the
JAX package's own tests run it) and `predictor.frame_codes`.

The kernel itself runs on the card only (`tests/test_torch_kernels.py`,
marker `cuda`). Codes: exact. The kernel reads the weights from a packed
copy (`pack_units`: each 8-column unit's rows contiguous), held exact by
its round trip.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.assets import tables as jtables
from qwen3_tts_tpu.core.config import PredictorConfig
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.models import predictor as jpredictor
from qwen3_tts_tpu.ops import fused_predictor as jfused_predictor
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch.core import config as tconfig
from qwen3_tts_tpu_torch.core import protocol
from qwen3_tts_tpu_torch.ops import fused_predictor as fp

FULL = tconfig.EngineConfig().predictor
TINY = tconfig.tiny_engine_config().predictor
# the small int4-capable predictor of chip_smoke.py (widths in 256-row
# groups)
SMALL4 = dataclasses.replace(TINY, hidden=256, n_q_heads=2, n_kv_heads=2,
                             head_dim=128, ffn_dim=256,
                             mrope_sections=(64, 0, 0, 0))
CONFIGS = {"full": FULL, "tiny": TINY}
CONFIGS4 = {"full": FULL, "small4": SMALL4}     # int4-capable widths
H100_SMEM = 232448          # opt-in shared memory per block (H100)


def _meta_params(cfg, kind):
    """Predictor params of `cfg` on the meta device (shapes and kinds, no
    data): dense, int8 or int4, as quant.quantize_decoder_params lays them
    out."""
    L, H, F = cfg.n_layers, cfg.hidden, cfg.ffn_dim
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)

    def w(*shape):
        if kind == "dense":
            return torch.empty(shape, dtype=dt, device="meta")
        sc = torch.empty(shape[:-2] + shape[-1:], device="meta")
        if kind == "int8":
            return {"q": torch.empty(shape, dtype=torch.int8, device="meta"),
                    "scale": sc}
        k, n = shape[-2:]
        return {"q4": torch.empty(shape[:-2] + (k // 2, n), dtype=torch.int8,
                                  device="meta"),
                "m8": torch.empty(shape[:-2] + (k // 128, n),
                                  dtype=torch.int8, device="meta"),
                "scale": sc}

    return {"layers": {"wqkv": w(L, H, (nq + 2 * nk) * hd),
                       "wo": w(L, nq * hd, H), "w_gu": w(L, H, 2 * F),
                       "w_down": w(L, F, H)},
            "final_norm": torch.empty(H, dtype=dt, device="meta"),
            "head": w(H, cfg.vocab)}


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["small4"])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 9, 10, 12, 13, 16, 17])
def test_route(config, kind, B, monkeypatch):
    """Dense weights at B <= 10, int8 weights at B <= 13 and all-int4
    weights at B <= ROUTE_MAX_B["int4"] go to the frame kernel (every
    end-to-end run on it beat every run on the chain there on the card);
    larger batches to the chain, and frame_codes_fused takes that
    route."""
    assert fp.ROUTE_MAX_B == {"dense": 10, "int8": 13, "int4": 16}
    assert max(fp.ROUTE_MAX_B.values()) <= fp.MAX_B
    cfg = CONFIGS.get(config, SMALL4)
    params = _meta_params(cfg, kind)
    want = fp.CHAIN if B > fp.ROUTE_MAX_B[kind] else fp.KERNEL
    assert fp.frame_route(params, B) == want
    taken = []
    monkeypatch.setattr(fp, "predictor_frame_kernel",
                        lambda *a: taken.append(fp.KERNEL))
    monkeypatch.setattr(fp, "_frame", lambda *a: taken.append(fp.CHAIN))
    fp.frame_codes_fused(params, cfg, None, 0, None,
                         torch.zeros(B, dtype=torch.int32))
    assert taken == [want]


def test_route_mixed_dense_int8_is_kernel_and_int4_in_a_mix_is_chain():
    """Dense and int8 mix on the kernel route; int4 mixed with another
    kind goes to the chain (the kernel refuses the mix, as the TPU kernel
    and the chain do), all five int4 to the kernel."""
    params = _meta_params(SMALL4, "dense")
    mixed = dict(params, head=_meta_params(SMALL4, "int8")["head"])
    assert fp.frame_route(mixed, 4) == fp.KERNEL
    assert fp.frame_route(mixed, 10) == fp.KERNEL
    assert fp.frame_route(mixed, 11) == fp.CHAIN    # the dense limit
    assert fp.frame_route(mixed, fp.MAX_B + 1) == fp.CHAIN
    for other in ("dense", "int8"):
        base = _meta_params(SMALL4, other)
        one4 = dict(base, head=_meta_params(SMALL4, "int4")["head"])
        assert fp.frame_route(one4, 1) == fp.CHAIN
        four = _meta_params(SMALL4, "int4")
        one_other = dict(four, head=base["head"])
        assert fp.frame_route(one_other, 1) == fp.CHAIN
    assert fp.frame_route(_meta_params(SMALL4, "int4"), 1) == fp.KERNEL


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["small4"])
@pytest.mark.parametrize("nb", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 2, 16])
def test_work_plan_covers_each_column_once(config, nb, B):
    """Every output column of every stage goes to exactly one block, in
    contiguous ranges in block order; the residual's columns once. Every
    block holding wo columns computes every (row, kv head) attention unit
    in wo's prologue, the others none; each unit's k / v store at slot p
    falls to one block, and that block holds wo columns."""
    cfg = CONFIGS.get(config, SMALL4)
    plan = fp.frame_plan(cfg, B, nb)
    shapes = fp.stage_shapes(cfg)
    units = B * cfg.n_kv_heads
    for stage, ranges in plan.items():
        if stage in ("attention", "kv_store"):
            continue
        assert len(ranges) == nb
        if stage == "residual":
            total = cfg.hidden
        else:
            total = shapes[stage][1] // fp.UNIT
            assert shapes[stage][1] % fp.UNIT == 0
        owner = np.full(total, -1)
        for blk, (lo, hi) in enumerate(ranges):
            assert 0 <= lo <= hi <= total
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = blk
        assert (owner >= 0).all(), stage
        assert (np.diff(owner) >= 0).all()      # contiguous, block order
        if stage != "residual":
            for x in range(total):
                assert fp.unit_owner(x, total, nb) == owner[x]
    assert set(plan) == set(fp._STAGES) | {"attention", "kv_store",
                                           "residual"}
    for (lo, hi), (a0, a1) in zip(plan["wo"], plan["attention"]):
        assert (a0, a1) == ((0, units) if hi > lo else (0, 0))
    assert len(plan["kv_store"]) == units
    for u, blk in enumerate(plan["kv_store"]):
        lo, hi = plan["wo"][blk]
        assert hi > lo and plan["attention"][blk] == (0, units)
    assert fp.row_pass(B, 2) == {1: 1, 2: 2}.get(B, 4 if B <= 4 else 8)
    assert fp.row_pass(B, 4) == {1: 1, 2: 2}.get(B, 4)
    for t_bytes in (2, 4):                      # int4: at most MAX_MT4
        assert fp.row_pass(B, t_bytes, True) == min(fp.row_pass(B, t_bytes),
                                                    fp.MAX_MT4)


# the ring's walk at three widths: the tiny CPU config, a small one with
# grouped heads, and the full predictor cut to 2 layers
SMALL = PredictorConfig(hidden=256, n_layers=2, n_q_heads=4, n_kv_heads=2,
                        head_dim=64, ffn_dim=512, max_seq=32,
                        mrope_sections=(32, 0, 0, 0), dtype="bfloat16")
WALKS = {"tiny": TINY, "small": SMALL,
         "full": dataclasses.replace(FULL, n_layers=2)}
MIXED = ("int8", "dense", "int8", "dense", "int8")


@pytest.mark.parametrize("config", sorted(WALKS))
@pytest.mark.parametrize("kinds", ["dense", "int8", "int4", "mixed"])
@pytest.mark.parametrize("B", [1, 2, 5, 16])
def test_ring_chunks_cover_each_weight_row_once(config, kinds, B):
    """The producer's and the consumers' chunk sequence of a block, bf16
    and f32: stage after stage in the kernel's order (each layer's qkv,
    wo, gate/up, down, the head slice after each pass from the second),
    within a stage row pass, unit batch and rows in order; per stage and
    row pass, every packed row of every unit the block owns in exactly one
    chunk, each chunk at most a buffer, whole 16-byte copies, at least
    two rows; int4 chunks in whole pairs of groups, their multipliers
    within the buffer's last 64th (the small and full widths: the tiny
    one's are not whole groups)."""
    cfg = WALKS[config]
    if kinds == "int4" and config == "tiny":
        return
    kinds = MIXED if kinds == "mixed" else (kinds,) * 5
    int4 = "int4" in kinds
    nb = 132
    stages = fp.frame_stages(cfg)
    assert len(stages) == fp.frame_barriers(cfg)
    for t_bytes in (2, 4):
        mt = fp.row_pass(B, t_bytes, int4)
        for blk in (0, 57, nb - 1):
            seq = fp.chunk_sequence(cfg, B, nb, blk, kinds, t_bytes,
                                    fp.CHUNK)
            keys = [(s, rc, ul, r0) for s, _, _, _, rc, ul, _, r0, _ in seq]
            assert keys == sorted(keys) and len(set(keys)) == len(keys)
            seen = {}
            for s, st, l, q, rc, ul, nub, r0, rn in seq:
                assert stages[s] == (st, l, q)
                wb = fp.row_bytes(kinds[fp._STAGES.index(st)], t_bytes)
                assert nub * rn * wb <= fp.CHUNK and (rn * wb) % 16 == 0
                assert rn >= 2 and 1 <= nub <= fp.units_a_batch(mt)
                if int4:
                    g2 = 2 * fp.GROUP4_ROWS
                    assert rn % g2 == 0 and r0 % g2 == 0
                    assert nub * (rn // fp.GROUP4_ROWS) * 8 \
                        <= fp.CHUNK // 64
                for u in range(ul, ul + nub):
                    seen.setdefault((s, rc, u), []).append((r0, rn))
            shapes = fp.stage_shapes(cfg)
            for s, (st, l, q) in enumerate(stages):
                K, N = shapes[st]
                K = K // 2 if int4 else K
                lo, hi = fp.split_units(N // fp.UNIT, nb)[blk]
                for rc in range(-(-B // mt)):
                    for u in range(lo, hi):
                        rows = sorted(seen.pop((s, rc, u)))
                        assert rows[0][0] == 0
                        assert all(a + n == b for (a, n), (b, _)
                                   in zip(rows, rows[1:]))
                        assert rows[-1][0] + rows[-1][1] == K
            assert not seen


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["small4"])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16])
def test_shared_memory_plan_fits_a_block(config, kind, B):
    """In bf16 and in f32, the fixed part (staged x rows, scratch, the
    warps' head vectors) and the kernel's ring (kFRing buffers of CHUNK
    bytes, with int4 weights each a 64th longer for the multipliers) fit
    the H100's opt-in shared memory per block at every B <= 16, and the
    plan refuses what does not fit; a buffer holds at least two rows (int4:
    two groups) of every batch of every stage."""
    src = (pathlib.Path(fp.__file__).parent.parent / "csrc"
           / "predictor_frame.cu").read_text()
    assert int(re.search(r"constexpr int kFRing = (\d+);", src)[1]) \
        == fp.RING >= 2 and fp.CHUNK % 1024 == 0
    assert int(re.search(r"constexpr int kFMaxMT4 = (\d+);", src)[1]) \
        == fp.MAX_MT4
    assert int(re.search(r"constexpr int kFMaxB = (\d+);", src)[1]) \
        == fp.MAX_B
    if kind == "int4" and config == "tiny":
        return                          # int4 needs widths of 256 rows
    cfg = CONFIGS.get(config, SMALL4)
    int4 = kind == "int4"
    ring = fp.RING * (fp.CHUNK + (fp.CHUNK // 64 if int4 else 0))
    assert fp.ring_bytes(int4) == ring
    for t_bytes in (2, 4):
        fixed = fp.frame_smem_fixed(cfg, B, t_bytes, int4)
        assert fp.frame_smem(fixed, H100_SMEM, int4) == fixed + ring \
            <= H100_SMEM
        with pytest.raises(ValueError, match="no room"):
            fp.frame_smem(fixed, fixed + ring - 1, int4)
        wb = fp.row_bytes(kind, t_bytes)
        mt = fp.row_pass(B, t_bytes, int4)
        nub = fp.units_a_batch(mt)
        for K, _ in fp.stage_shapes(cfg).values():
            Kp = K // 2 if int4 else K
            rows = fp.chunk_rows(fp.CHUNK, nub, wb, Kp, int4)
            assert rows >= (2 * fp.GROUP4_ROWS if int4 else 2)
        if int4:
            assert mt <= fp.MAX_MT4


def test_ring_holds_a_stage_share_at_full_width():
    """At the full width, one x row, the ring holds the busiest block's
    largest stage (gate/up: 96 KiB dense bf16 of its 208 KiB a layer), so
    the producer runs at least a stage ahead of the consumers; in f32
    every row still streams through the ring (no first-rows-only
    staging)."""
    shapes = fp.stage_shapes(FULL)
    plan = fp.frame_plan(FULL, 1, 132)

    def share(blk, t_bytes, stages=fp._STAGES[:4]):
        return sum((plan[st][blk][1] - plan[st][blk][0]) * fp.UNIT
                   * shapes[st][0] * t_bytes for st in stages)

    busiest = max(range(132), key=lambda b: share(b, 2))
    assert share(busiest, 2) == 208 * 1024
    assert max(share(b, 2, (st,)) for b in range(132)
               for st in fp._STAGES) == 96 * 1024 <= fp.RING * fp.CHUNK
    f32 = dataclasses.replace(FULL, dtype="float32", n_layers=1)
    seq = fp.chunk_sequence(f32, 1, 132, busiest, ("dense",) * 5, 4,
                            fp.CHUNK)
    streamed = sum(nub * rn * fp.UNIT * 4 for s, st, *_, nub, r0, rn in seq
                   if st != "head")
    assert streamed == share(busiest, 4) * 16


def test_frame_barriers_match_the_kernel():
    """The host's count of grid barriers a frame (and the trace reader's
    stage list) is the kernel's frame_barriers: 64 L + 15, 527 at the full
    predictor's 8 layers."""
    from qwen3_tts_tpu_torch.tools import frame_measure as fm

    src = (pathlib.Path(fp.__file__).parent.parent / "csrc"
           / "predictor_frame.cu").read_text()
    body = re.search(r"constexpr int frame_barriers\(int L\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    for L in (1, 2, 8):
        cfg = dataclasses.replace(FULL, n_layers=L)
        kernel = eval(body, {"kCodes": protocol.NUM_CODEBOOKS, "L": L})
        assert fp.frame_barriers(cfg) == kernel == len(fm.frame_kinds(cfg))
        assert len(fp.frame_stages(cfg)) == kernel
    assert fp.frame_barriers(FULL) == 527


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("shape", [(1024, 3072), (2, 64, 128), (32, 96)])
def test_packed_weights_round_trip(dtype, shape):
    """The kernel's packed layout [.., N / 8, K, 8] holds unit u's columns
    [8 u, 8 u + 8) row by row, and unpacks to the weight exactly; a block's
    slice of units [lo, hi) is one contiguous range."""
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.integers(-127, 128, shape)).to(dtype)
    p = fp.pack_units(w)
    K, N = shape[-2:]
    assert p.shape == shape[:-2] + (N // fp.UNIT, K, fp.UNIT)
    assert p.is_contiguous()
    assert torch.equal(fp.unpack_units(p), w)
    for u in (0, N // fp.UNIT - 1):
        assert torch.equal(p[..., u, :, :],
                           w[..., u * fp.UNIT:(u + 1) * fp.UNIT])
    lo, hi = 1, N // fp.UNIT
    flat = p.reshape(-1)
    first = p[(0,) * (p.dim() - 3) + (lo,)].reshape(-1)
    start = lo * K * fp.UNIT
    assert torch.equal(flat[start:start + first.numel()], first)
    assert p[(0,) * (p.dim() - 3)][lo:hi].is_contiguous()


def test_packed_weight_is_kept_and_renewed():
    """`packed_weight` packs a weight once, and again after an in-place
    change."""
    w = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    a = fp.packed_weight(w)
    assert fp.packed_weight(w) is a
    w.mul_(2)
    b = fp.packed_weight(w)
    assert b is not a and torch.equal(fp.unpack_units(b), w)


def _crafted_logits(seed):
    """Logits [5, 2048] with ties inside a block, ties across blocks, a
    NaN, all -inf and a maximum at the last column."""
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy(rng.integers(-3, 4, (5, protocol.CODE_VOCAB))
                          .astype(np.float32))
    lg[0, [7, 8, 900, 2047]] = 9.0              # tie: 7 wins
    lg[1, [1000, 15, 1500]] = 9.0               # tie across blocks: 15
    lg[2, [3, 600]] = float("nan")              # a NaN: code CV
    lg[2, 4] = 1e30
    lg[3] = float("-inf")                       # all -inf: index 0
    lg[4, 2047] = 50.0
    return lg


@pytest.mark.parametrize("nb", [132, 114, 7, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_partials_reduce_to_torch_argmax(nb, seed):
    """Per-block (max, index) partials, reduced in any order, give JAX's
    `argmax_row` (qwen3_tts_tpu/ops/fused_predictor.py:465-469): the
    lowest index on ties, code CV for a row holding a NaN."""
    lg = _crafted_logits(seed)
    CV = protocol.CODE_VOCAB
    jl = jnp.asarray(lg.numpy())
    iota = jax.lax.broadcasted_iota(jnp.int32, jl.shape, 1)
    want = torch.from_numpy(np.asarray(jnp.min(jnp.where(
        jl >= jnp.max(jl, axis=-1, keepdims=True), iota, CV), axis=-1))
        .astype(np.int64))
    assert want[:4].tolist() == [7, 15, CV, 0]
    vals, idx = fp.block_partials(lg, nb)
    assert torch.equal(fp.reduce_partials(vals, idx), want)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(nb))
    assert torch.equal(fp.reduce_partials(vals[perm], idx[perm]), want)


def test_better_is_a_strict_total_order():
    pts = [(1.0, 3), (1.0, 5), (2.0, 9), (float("nan"), 4),
           (float("nan"), 2), (float("-inf"), 0), (float("-inf"), 2 ** 31 - 1)]
    for a in pts:
        assert not fp.better(*a, *a)
        for b in pts:
            if a != b:
                assert fp.better(*a, *b) != fp.better(*b, *a)


PC = PredictorConfig(hidden=32, n_layers=2, n_q_heads=2, n_kv_heads=2,
                     head_dim=16, ffn_dim=64, max_seq=32,
                     mrope_sections=(8, 0, 0, 0), dtype="float32")
# int4 needs widths in whole packed groups (multiples of 256): the
# 256-wide config of JAX's own int4 test (tests/test_fused_predictor.py)
PC4 = PredictorConfig(hidden=256, n_layers=2, n_q_heads=2, n_kv_heads=2,
                      head_dim=128, ffn_dim=256, max_seq=32,
                      mrope_sections=(64, 0, 0, 0), dtype="float32")


def _frame_inputs(kind, B, seed, cfg=PC):
    k1, k2 = jax.random.split(jax.random.key(seed))
    jp = jdecoder.init_decoder(k1, cfg)
    if kind != "dense":
        jp = jquant.quantize_decoder_params(jp, kind=kind)
    ja = jtables.random_assets(k2, text_vocab=64, codec_rows=2176,
                               dim=64, proj_dim=cfg.hidden)
    ta = convert.assets_from_numpy(
        np.asarray(ja.text_table), np.asarray(ja.codec_tables),
        np.asarray(ja.proj_weight), np.asarray(ja.proj_bias))
    tp = convert.decoder_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    h1024 = rng.standard_normal((B, cfg.hidden)).astype(np.float32)
    code0 = rng.integers(-3, 2300, B).astype(np.int32)
    return jp, ja, tp, ta, h1024, code0


@pytest.mark.parametrize("kind", ["dense", "int8"])
@pytest.mark.parametrize("B", [1, 3])
def test_frame_codes_fused_matches_jax_kernel(kind, B):
    """The kernel route of frame_codes_fused (on the CPU: its plain
    version) against JAX's frame_codes_fused, the Pallas kernel in
    interpret mode: codes exact."""
    jp, ja, tp, ta, h1024, code0 = _frame_inputs(kind, B, 5 + B)
    jptab, rows = jfused_predictor.make_ptab(ja, PC)
    ref = jfused_predictor.frame_codes_fused(
        jp, PC, jptab, rows, jnp.asarray(h1024), jnp.asarray(code0),
        interpret=True)
    ptab, trows = fp.make_ptab(ta, PC)
    assert fp.frame_route(tp, B) == fp.KERNEL
    got = fp.frame_codes_fused(tp, PC, ptab, trows, torch.from_numpy(h1024),
                               torch.from_numpy(code0))
    assert got.dtype == torch.int32 and got.shape == (B, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kern = fp.predictor_frame_kernel(tp, PC, ptab, trows,
                                     torch.from_numpy(h1024),
                                     torch.from_numpy(code0))
    assert torch.equal(kern, got)


@pytest.mark.parametrize("B", [1, 3])
def test_int4_frame_kernel_route_matches_jax(B):
    """All five predictor weights int4 at the small int4 width: the
    kernel route of frame_codes_fused (on the CPU: its plain version)
    against JAX's predictor.frame_codes on the same int4 weights (which
    JAX's own test holds equal to its Pallas kernel) and against that
    Pallas kernel in interpret mode: codes exact."""
    jp, ja, tp, ta, h1024, code0 = _frame_inputs("int4", B, 11 + B, PC4)
    ref = np.asarray(jpredictor.frame_codes(jp, PC4, ja, jnp.asarray(h1024),
                                            jnp.asarray(code0)))
    jptab, jrows = jfused_predictor.make_ptab(ja, PC4)
    pallas = jfused_predictor.frame_codes_fused(
        jp, PC4, jptab, jrows, jnp.asarray(h1024), jnp.asarray(code0),
        interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), ref)
    ptab, rows = fp.make_ptab(ta, PC4)
    assert fp.frame_route(tp, B) == fp.KERNEL
    got = fp.frame_codes_fused(tp, PC4, ptab, rows, torch.from_numpy(h1024),
                               torch.from_numpy(code0))
    assert got.dtype == torch.int32 and got.shape == (B, 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    kern = fp.predictor_frame_kernel(tp, PC4, ptab, rows,
                                     torch.from_numpy(h1024),
                                     torch.from_numpy(code0))
    assert torch.equal(kern, got)


def test_int4_kernel_refuses_a_mix_and_partial_groups():
    """The frame kernel takes int4 only as all five weights and only at
    widths of whole pairs of groups: a mix with int8, or int4 at a width
    that is not, raises on the CPU as on the card."""
    _, _, tp, ta, h1024, code0 = _frame_inputs("int4", 2, 4, PC4)
    ptab, rows = fp.make_ptab(ta, PC4)
    h, c0 = torch.from_numpy(h1024), torch.from_numpy(code0)
    _, _, tp8, _, _, _ = _frame_inputs("int8", 2, 4, PC4)
    mixed = dict(tp, head=tp8["head"])
    with pytest.raises(ValueError, match="all five"):
        fp.predictor_frame_kernel(mixed, PC4, ptab, rows, h, c0)
    narrow = dataclasses.replace(PC4, ffn_dim=128)
    with pytest.raises(ValueError, match="multiples of 256"):
        fp.predictor_frame_kernel(_meta_params(narrow, "int4"), narrow,
                                  ptab, rows, h, c0)


def test_frame_codes_with_a_nan_match_jax_kernel():
    """A NaN on the greedy path: column 100 of head slice 13 is NaN, so
    every row's code 14 is CV (JAX's `argmax_row`) and pass 15 takes
    ptab[14][sel(CV)]. The chain's plain version
    (`_frame(chain.PLAIN, ...)`), the chain on the kernels' op set and the
    routed `frame_codes_fused` (on the CPU: their plain versions) against
    JAX's frame_codes_fused, the Pallas kernel in interpret mode: codes
    exact."""
    from qwen3_tts_tpu_torch.ops import chain
    B, CV, slice_ = 3, protocol.CODE_VOCAB, 13
    jp, ja, tp, ta, h1024, code0 = _frame_inputs("dense", B, 21)
    head = np.array(jp["head"])
    head[:, slice_ * CV + 100] = np.nan
    jp = dict(jp, head=jnp.asarray(head))
    tp = dict(tp, head=torch.from_numpy(head))
    jptab, rows = jfused_predictor.make_ptab(ja, PC)
    ref = np.asarray(jfused_predictor.frame_codes_fused(
        jp, PC, jptab, rows, jnp.asarray(h1024), jnp.asarray(code0),
        interpret=True))
    nan = np.zeros(16, bool)
    nan[slice_ + 1] = True
    assert (ref[:, nan] == CV).all() and (ref[:, ~nan] != CV).all()
    ptab, trows = fp.make_ptab(ta, PC)
    h, c0 = torch.from_numpy(h1024), torch.from_numpy(code0)
    for got in (fp._frame(chain.PLAIN, tp, PC, ptab, trows, h, c0),
                fp._frame(chain.KERNELS, tp, PC, ptab, trows, h, c0),
                fp.frame_codes_fused(tp, PC, ptab, trows, h, c0)):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_frame_codes_fused_chain_route_matches_jax():
    """B = 17 takes the chain: against JAX's predictor.frame_codes."""
    jp, ja, tp, ta, h1024, code0 = _frame_inputs("dense", 17, 9)
    ref = jpredictor.frame_codes(jp, PC, ja, jnp.asarray(h1024),
                                 jnp.asarray(code0))
    ptab, rows = fp.make_ptab(ta, PC)
    assert fp.frame_route(tp, 17) == fp.CHAIN
    got = fp.frame_codes_fused(tp, PC, ptab, rows, torch.from_numpy(h1024),
                               torch.from_numpy(code0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kernel_refuses_what_it_does_not_take():
    """The frame kernel's checks run on every device: B past 16 and a head
    width it cannot split raise, on the CPU as on the card."""
    _, _, tp, ta, h1024, code0 = _frame_inputs("dense", 2, 3)
    ptab, rows = fp.make_ptab(ta, PC)
    h = torch.from_numpy(np.repeat(h1024, 9, axis=0))
    with pytest.raises(ValueError, match="B in"):
        fp.predictor_frame_kernel(tp, PC, ptab, rows, h,
                                  torch.zeros(18, dtype=torch.int32))
    odd = dataclasses.replace(PC, head_dim=12, mrope_sections=(6, 0, 0, 0))
    with pytest.raises(ValueError, match="head_dim"):
        fp.predictor_frame_kernel(tp, odd, ptab, rows,
                                  torch.from_numpy(h1024),
                                  torch.from_numpy(code0))


def _c_fields(src: str, struct: str) -> list:
    """The field names of `struct` in a kernel source, in order."""
    body = src[src.index(f"struct {struct} {{"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    names = []
    for decl in body.split(";"):
        parts = [p.strip() for p in decl.split(",") if p.strip()]
        if parts:
            names += [re.findall(r"\w+", re.sub(r"\[.*?\]", "", p))[-1]
                      for p in parts]
    return names


@pytest.mark.parametrize("kernel", ["predictor_frame", "talker_step"])
def test_args_and_trace_words_match_the_kernel(kernel):
    """The ctypes args of a persistent kernel name its C struct's fields in
    order (the trace pointer last for the predictor), its trace is guarded
    by the compile-time kTrace, and the trace words
    `tools/frame_measure.py` reads are the kernel's kTr constants, their
    words after every barrier's two stamps, apart and inside the trace
    buffer (the predictor's: a block's kTrStride words, its mode bits
    those of `fused_predictor.MODE`)."""
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.tools import frame_measure as fm

    src = (pathlib.Path(fp.__file__).parent.parent / "csrc"
           / f"{kernel}.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"\b(kTr\w+) = (\d+)", src)}
    full = tconfig.EngineConfig()
    if kernel == "predictor_frame":
        struct, args = "FrameArgs", fp._FrameArgs
        read = {"kTrT0": fm.F_T0, "kTrEnd": fm.F_END, "kTrNBar": fm.F_NBAR,
                "kTrFirst": fm.F_FIRST, "kTrCWait": fm.F_CWAIT,
                "kTrPWait": fm.F_PWAIT, "kTrAttn": fm.F_ATTN,
                "kTrProd": fm.F_PROD}
        words = {"kTrT0": 1, "kTrEnd": 1, "kTrNBar": 1, "kTrFirst": 2 * 5,
                 "kTrCWait": 2, "kTrPWait": 2, "kTrAttn": 2, "kTrProd": 4 * 5}
        size, bars, no_work = fp.TRACE_STRIDE, fm.F_BARS, fp.NO_WORK
        needed, sums_want = fp.frame_barriers(full.predictor), fp.TRACE_SUMS
    else:
        struct, args = "StepArgs", ft._StepArgs
        read = {"kTrT0": fm.T_T0, "kTrEnd": fm.T_END, "kTrNBar": fm.T_NBAR,
                "kTrFirst": fm.T_FIRST, "kTrCWait": fm.T_CWAIT,
                "kTrPWait": fm.T_PWAIT, "kTrAttn": fm.T_ATTN,
                "kTrProd": fm.T_PROD}
        words = {"kTrT0": 1, "kTrEnd": 1, "kTrNBar": 1, "kTrFirst": 2 * 5,
                 "kTrCWait": 2, "kTrPWait": 2, "kTrAttn": 6, "kTrProd": 4 * 5}
        size, bars, no_work = ft.TRACE_STRIDE, fm.T_BARS, ft.NO_WORK
        needed, sums_want = ft.step_barriers(full.talker), 40
    assert const.pop("kTrStride") == size
    assert const.pop("kTrBars") == bars >= needed
    sums = const.pop("kTrSums")
    assert sums == sums_want and read["kTrProd"] + 4 * 5 <= \
        read["kTrFirst"] + sums
    barriers = bars
    enum = src[src.index("enum { kNoWork"):]
    modes = dict(re.findall(r"\b(k[A-Z]\w+) = (\d+)",
                            enum[:enum.index("}")]))
    assert modes == {"kNoWork": str(no_work)}
    assert fm.MODES == {"": 0, "nowork": no_work}
    # every trace guard tests kTrace first (-DKERNEL_TRACE builds only)
    assert "a.trace != nullptr" not in src.replace(
        "kTrace && a.trace != nullptr", "")
    assert _c_fields(src, struct) == [f[0] for f in args._fields_]
    assert args._fields_[-1][0] == "trace" or kernel == "talker_step"
    assert const == read
    # each constant's words: after the barriers' stamps, apart, in the buffer
    spans = sorted((const[k], const[k] + n) for k, n in words.items())
    assert 2 * barriers <= spans[0][0] and spans[-1][1] <= size
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
