"""The talker step kernel's CPU-side parts (`ops/fused_talker.py`,
`csrc/talker_step.cu`): the routing rule between the step kernel and the
chain, the kernel's work plan, its weight ring's chunk sequence and
shared-memory sizing, its packed weight layout, the attention split plan
and a plain emulation of the split attention's merge order, and the step
through the route on the CPU against the JAX package's `talker_step_fused`
(its Pallas kernel in interpret mode, as `tests/test_fused_talker.py` runs
it) over consecutive steps with per-row slots and left pad.

The kernel itself runs on the card only (`tests/test_torch_kernels.py`,
marker `cuda`). Tolerances: hidden and logits rtol/atol 1e-4, the cache
slots written atol 1e-5 (f32, sums in another order than the Pallas
kernel's); greedy argmax equal.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core.config import TalkerConfig
from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import fused_talker as jfused_talker
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch import convert
from qwen3_tts_tpu_torch.core import config as tconfig
from qwen3_tts_tpu_torch.ops import flash_decode
from qwen3_tts_tpu_torch.ops import fused_predictor as fp
from qwen3_tts_tpu_torch.ops import fused_talker as ft
from qwen3_tts_tpu_torch.ops import quant

FULL = tconfig.EngineConfig().talker
TINY = tconfig.tiny_engine_config().talker
CONFIGS = {"full": FULL, "tiny": TINY}
# the small int4-capable talker of chip_smoke.py (widths in 256-row groups)
SMALL = dataclasses.replace(TINY, hidden=256, n_q_heads=2, n_kv_heads=2,
                            head_dim=128, ffn_dim=256,
                            mrope_sections=(32, 16, 16, 0))
CONFIGS4 = {"full": FULL, "tiny": TINY, "small": SMALL}
H100_SMEM = 232448          # opt-in shared memory per block (H100)
KINDS = ("dense", "int8", "int4")


def ft_source(name):
    return os.path.join(os.path.dirname(ft.__file__), os.pardir, "csrc",
                        name)


def _meta_params(cfg, kind):
    """Talker params of `cfg` on the meta device (shapes and kinds, no
    data), as quant.quantize_decoder_params lays them out."""
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [1, 2, 8, 9, 16, 17, 24, 32, 33])
def test_route(kind, B, monkeypatch):
    """Each weight kind takes the step kernel at B <= its ROUTE_MAX_B
    (measured on the card, at most the kernel's cap MAX_B = 32, the TPU
    kernel's) and the chain above it; talker_step_fused takes that
    route."""
    assert ft.MAX_B == 32 and ft.WIDE_B == 16
    assert ft.ROUTE_MAX_B == {"dense": 32, "int8": 24, "int4": 8}
    assert max(ft.ROUTE_MAX_B.values()) <= ft.MAX_B
    params = _meta_params(FULL, kind)
    want = ft.KERNEL if B <= ft.ROUTE_MAX_B[kind] else ft.CHAIN
    assert ft.talker_route(params, B) == want
    taken = []
    monkeypatch.setattr(ft, "talker_step_kernel",
                        lambda *a: taken.append(ft.KERNEL))
    monkeypatch.setattr(ft, "_step", lambda *a: taken.append(ft.CHAIN))
    ft.talker_step_fused(params, FULL, torch.zeros(B, 1), None, None, None,
                         None, None, None)
    assert taken == [want]


def test_route_mixed_kinds():
    """Dense and int8 mix on the kernel route; int4 mixed with another
    kind goes to the chain, which refuses it as the TPU kernel does."""
    params = _meta_params(FULL, "dense")
    mixed = dict(params, head=_meta_params(FULL, "int8")["head"])
    assert ft.talker_route(mixed, 1) == ft.KERNEL
    one4 = dict(params, head=_meta_params(FULL, "int4")["head"])
    assert ft.talker_route(one4, 1) == ft.CHAIN
    # the main path's B = 1 and generate_batch's 2, for every kind
    assert min(ft.ROUTE_MAX_B.values()) >= 2


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("nb", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 2, 16, 17, 24, 32])
def test_work_plan_covers_each_column_once(config, nb, B):
    """Every output column of every stage goes to exactly one block, in
    contiguous ranges in block order; the attention units (row, kv head,
    split) once each; the residual's columns once."""
    cfg = CONFIGS[config]
    T = 4096
    plan = ft.step_plan(cfg, B, nb, T)
    shapes = ft.stage_shapes(cfg)
    S = ft.step_splits(B, cfg.n_kv_heads, T, nb)
    for stage, ranges in plan.items():
        assert len(ranges) == nb
        if stage == "attention":
            total = B * cfg.n_kv_heads * S
        elif stage == "residual":
            total = cfg.hidden
        else:
            total = shapes[stage][1] // ft.UNIT
            assert shapes[stage][1] % ft.UNIT == 0
        owner = np.full(total, -1)
        for blk, (lo, hi) in enumerate(ranges):
            assert 0 <= lo <= hi <= total
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = blk
        assert (owner >= 0).all(), stage
        assert (np.diff(owner) >= 0).all()
    assert set(plan) == set(ft._STAGES) | {"attention", "residual"}
    assert ft.row_pass(B, 2) == {1: 1, 2: 2}.get(B, 4 if B <= 4 else 8)
    assert ft.row_pass(B, 4) == {1: 1, 2: 2}.get(B, 4)


RING_CASES = {"dense": ("dense",) * 5, "int8": ("int8",) * 5,
              "int4": ("int4",) * 5,
              "mixed": ("int8", "dense", "int8", "dense", "int8")}


@pytest.mark.parametrize("config", sorted(CONFIGS4))
@pytest.mark.parametrize("kind", sorted(RING_CASES))
@pytest.mark.parametrize("B", [1, 2, 5, 16, 17, 32])
def test_ring_chunks_cover_each_weight_row_once(config, kind, B):
    """The producer's and the consumers' chunk sequence of a block, bf16
    and f32, dense, int8, int4 and mixed weights: per stage and row pass,
    every packed row of every unit the block owns in exactly one chunk, in
    the consumers' order (stage, row pass, batch, rows), each chunk's
    copies within a ring buffer, whole 16-byte copies, int4 chunks in whole
    pairs of groups with their multipliers."""
    cfg = dataclasses.replace(CONFIGS4[config], n_layers=2)
    kinds = RING_CASES[kind]
    if "int4" in kinds and config == "tiny":
        return                          # int4 needs widths of 256 rows
    for t_bytes in (2, 4):
        _check_chunks(cfg, B, 132, kinds, t_bytes)


def _check_chunks(cfg, B, nb, kinds, t_bytes):
    seen = {}
    order = [(l, st) for l in range(cfg.n_layers) for st in ft._STAGES[:4]] \
        + [(0, "head")]
    for blk in (0, 57, nb - 1):
        last = None
        for st, l, rc, ul, nub, r0, rn in ft.chunk_sequence(
                cfg, B, nb, blk, kinds, t_bytes):
            kind = kinds[ft._STAGES.index(st)]
            int4 = kind == "int4"
            wb = ft.row_bytes(kind, t_bytes)
            assert nub * rn * wb <= ft.CHUNK and (rn * wb) % 16 == 0
            if int4:
                # whole pairs of groups: each unit's multipliers are whole
                # 16-byte copies, all of them within the buffer's 64th
                assert rn % (2 * ft.GROUP4_ROWS) == 0
                assert r0 % (2 * ft.GROUP4_ROWS) == 0
                assert nub * (rn // ft.GROUP4_ROWS) * 8 <= ft.CHUNK // 64
            pos = (order.index((l, st)), rc, ul, r0)
            assert last is None or pos > last
            last = pos
            for u in range(ul, ul + nub):
                key = (blk, st, l, rc, u)
                seen.setdefault(key, []).append((r0, rn))
    for (blk, st, l, rc, u), parts in seen.items():
        K = ft.stage_shapes(cfg)[st][0]
        Kp = K // 2 if kinds[ft._STAGES.index(st)] == "int4" else K
        rows = sorted(parts)
        assert rows[0][0] == 0
        assert all(a + n == b for (a, n), (b, _) in zip(rows, rows[1:]))
        assert rows[-1][0] + rows[-1][1] == Kp
    # each block's units of each stage, each row pass
    mt = ft.row_pass(B, t_bytes, "int4" in kinds)
    for blk in (0, 57, nb - 1):
        for st, (_, N) in ft.stage_shapes(cfg).items():
            lo, hi = fp.split_units(N // ft.UNIT, nb)[blk]
            for l in range(cfg.n_layers if st != "head" else 1):
                for rc in range(-(-B // mt)):
                    got = {u for (b2, s2, l2, r2, u) in seen
                           if (b2, s2, l2, r2) == (blk, st, l, rc)}
                    assert got == set(range(lo, hi))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 17, 24, 32])
def test_shared_memory_plan_fits_a_block(kind, B):
    """The ring is one size for every B and dtype: at the full width in
    bf16 and in f32 the fixed part (staged x rows, scratch) and RING
    buffers of CHUNK bytes fit the H100's opt-in shared memory per block,
    for every weight kind and row pass, and a chunk holds at least two rows
    (int4: two groups) of every batch of every stage."""
    int4 = kind == "int4"
    for t_bytes in (2, 4):
        smem = ft.step_smem(FULL, B, t_bytes, H100_SMEM, int4)
        fixed = ft.step_smem_fixed(FULL, B, t_bytes, int4)
        assert smem == fixed + ft.ring_bytes() <= H100_SMEM
        assert ft.ring_bytes() == ft.RING * (ft.CHUNK + ft.CHUNK // 64)
        assert ft.RING >= 2 and ft.CHUNK % 16 == 0
        wb = ft.row_bytes(kind, t_bytes)
        nub = ft.units_a_batch(ft.row_pass(B, t_bytes, int4))
        for K, _ in ft.stage_shapes(FULL).values():
            Kp = K // 2 if int4 else K
            rows = ft.chunk_rows(ft.CHUNK, nub, wb, Kp, int4)
            assert rows >= (2 * ft.GROUP4_ROWS if int4 else 2)
        if int4:
            assert ft.row_pass(B, t_bytes, True) <= ft.MAX_MT4


def test_shared_memory_plan_raises_without_room():
    """A block whose opt-in shared memory cannot hold the fixed part and
    the ring is refused, not given a shallower ring."""
    need = ft.step_smem_fixed(FULL, 16, 2) + ft.ring_bytes()
    assert ft.step_smem(FULL, 16, 2, need) == need
    with pytest.raises(ValueError, match="ring"):
        ft.step_smem(FULL, 16, 2, need - 1)


@pytest.mark.parametrize("config", sorted(CONFIGS4))
@pytest.mark.parametrize("nb", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 2, 16, 32])
@pytest.mark.parametrize("T", [256, 4096])
def test_head_counters_and_attention_units_cover_once(config, nb, B, T):
    """The deal that replaces the grid barrier between qkv and attention:
    each block's arrivals on the head counters count each of its qkv units
    once, on its kv head's group, so each group's counter gains exactly
    group_units a layer; the attention units (kv head, row, split) are each
    dealt once, j-major; at the full width each head's attention units sit
    on blocks within one block of those that hold its qkv columns."""
    cfg = CONFIGS4[config]
    nk = cfg.n_kv_heads
    ug = ft.group_units(cfg)
    assert ug * nk == ft.stage_shapes(cfg)["qkv"][1] // ft.UNIT
    totals = [0] * nk
    qkv_blocks = {j: set() for j in range(nk)}
    for blk in range(nb):
        for j, n in ft.head_arrivals(cfg, nb, blk).items():
            assert 0 < n <= ug
            totals[j] += n
            qkv_blocks[j].add(blk)
    assert totals == [ug] * nk
    S = ft.step_splits(B, nk, T, nb)
    plan = ft.step_plan(cfg, B, nb, T)["attention"]
    seen = []
    attn_blocks = {j: set() for j in range(nk)}
    for blk, (lo, hi) in enumerate(plan):
        for u in range(lo, hi):
            j, b, s = ft.attention_unit(u, B, S)
            seen.append((j, b, s))
            attn_blocks[j].add(blk)
    assert seen == [(j, b, s) for j in range(nk) for b in range(B)
                    for s in range(S)]
    if config == "full" and nb >= 114:
        for j in range(nk):
            lo, hi = min(qkv_blocks[j]), max(qkv_blocks[j])
            assert all(lo - 1 <= blk <= hi + 1 for blk in attn_blocks[j])


def test_barrier_count_matches_kernel():
    """The host's count of grid barriers a step is the kernel's (parsed
    from csrc/talker_step.cu): four a layer, 112 at the full depth, where
    the parent design had five."""
    src = open(ft_source("talker_step.cu")).read()
    body = re.search(r"constexpr int step_barriers\(int L\) \{ return "
                     r"(\d+) \* L; \}", src)
    assert body is not None
    for cfg in (FULL, TINY):
        assert ft.step_barriers(cfg) == int(body.group(1)) * cfg.n_layers
    assert ft.step_barriers(FULL) == 112


def test_args_and_trace_words_match_kernel():
    """_StepArgs is csrc/talker_step.cu's StepArgs field for field; the
    ring's constants, the trace's words and the int4 row cap agree between
    the kernel, the host and tools/frame_measure.py."""
    from qwen3_tts_tpu_torch.tools import frame_measure as fm
    src = open(ft_source("talker_step.cu")).read()
    struct = src[src.index("struct StepArgs {"):]
    struct = struct[:struct.index("};")]
    names = []
    for line in struct.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        decl = decl.rstrip(";")
        for part in decl.split(","):
            name = part.strip().split()[-1].lstrip("*")
            names.append(name.split("[")[0])
    assert names == [f for f, _ in ft._StepArgs._fields_]

    def const(name):
        m = re.search(rf"\b{name} = (\d+)", src)
        return int(m.group(1))
    assert int(re.search(r"#define STEP_RING (\d+)", src).group(1)) \
        == ft.RING
    assert int(re.search(r"#define STEP_CHUNK (\d+)", src).group(1)) \
        == ft.CHUNK
    assert const("kTrStride") == ft.TRACE_STRIDE == fm.T_STRIDE
    assert (const("kTrT0"), const("kTrEnd"), const("kTrNBar"),
            const("kTrFirst"), const("kTrCWait"), const("kTrPWait"),
            const("kTrAttn"), const("kTrProd")) == (
        fm.T_T0, fm.T_END, fm.T_NBAR, fm.T_FIRST, fm.T_CWAIT, fm.T_PWAIT,
        fm.T_ATTN, fm.T_PROD)
    assert const("kTrBars") == fm.T_BARS >= ft.step_barriers(FULL)
    assert 2 * fm.T_BARS <= fm.T_T0
    assert const("kSMaxMT4") == ft.MAX_MT4
    assert const("kSMaxB") == ft.MAX_B


@pytest.mark.parametrize("kind", KINDS)
def test_packed_weights_round_trip(kind):
    """The kernel's copies of a quantized stacked weight: values (dense,
    int8 q, int4 q4) packed [L, N / 8, Kp, 8], unit u's rows contiguous,
    unpacking exactly; int4's multipliers are read in their own layout."""
    g = torch.Generator().manual_seed(3)
    w = 0.02 * torch.randn(2, 512, 64, generator=g)
    if kind == "dense":
        vals = w.to(torch.bfloat16)
    else:
        q = quant.quantize_decoder_params(
            {"layers": {n: w for n in quant.DECODER_MATMULS},
             "final_norm": torch.ones(512), "head": w[0]}, kind=kind)
        vals = q["layers"]["wqkv"]["q4" if kind == "int4" else "q"]
    p = fp.pack_units(vals)
    Kp, N = vals.shape[-2:]
    assert p.shape == (2, N // ft.UNIT, Kp, ft.UNIT) and p.is_contiguous()
    assert torch.equal(fp.unpack_units(p), vals)
    assert torch.equal(p[1, 3], vals[1, :, 24:32])
    # a unit's rows at the kernel's offset: layer * N * Kp + u * Kp * 8
    flat = p.reshape(-1)
    off = 1 * N * Kp + 3 * Kp * ft.UNIT
    assert torch.equal(flat[off:off + Kp * ft.UNIT].reshape(Kp, ft.UNIT),
                       vals[1, :, 24:32])


@pytest.mark.parametrize("kind", KINDS)
def test_gate_up_interleave_round_trips(kind):
    """The kernel's gate/up copies: each 8-column unit holds features 4f..
    4f+3 of the gate, then the same features of the up projection, for the
    values, the scales and the int4 multipliers alike (a permutation of
    the columns), and the packed values unpack to the interleaved
    weight."""
    g = torch.Generator().manual_seed(5)
    w = 0.02 * torch.randn(2, 256, 2 * 64, generator=g)
    q = w.to(torch.bfloat16) if kind == "dense" else quant.quantize_decoder_params(
        {"layers": {n: w for n in quant.DECODER_MATMULS},
         "final_norm": torch.ones(256), "head": w[0]}, kind=kind)["layers"]["w_gu"]
    parts = {"values": q} if kind == "dense" else dict(q)
    for name, t in parts.items():
        il = ft.interleave_gu(t)
        F = t.shape[-1] // 2
        assert torch.equal(il[..., 8:12], t[..., 4:8])          # gate 4..7
        assert torch.equal(il[..., 12:16], t[..., F + 4:F + 8])  # up 4..7
        perm = torch.arange(2 * F).reshape(2, F // 4, 4).transpose(0, 1)
        assert torch.equal(il, t[..., perm.reshape(-1)]), name
    vals = parts.get("values", parts.get("q", parts.get("q4")))
    part = "q4" if kind == "int4" else "values"
    packed = ft.kernel_copy(vals, "gu", part)
    want = ft.interleave_gu(vals)
    if kind == "int4":
        want = ft.pair_int4(want)
    assert torch.equal(fp.unpack_units(packed), want)
    assert ft.kernel_copy(vals, "gu", part) is packed             # kept
    assert ft.kernel_copy(vals, "wo") is vals


@pytest.mark.parametrize("kind", KINDS)
def test_qkv_grouping_round_trips(kind):
    """The kernel's qkv copies: columns grouped by kv head (q heads j g ..
    j g + g - 1, k_j, v_j contiguous), a permutation of the columns applied
    alike to the values, the scales and the int4 multipliers; the packed
    values unpack to the grouped weight."""
    cfg = dataclasses.replace(SMALL, n_q_heads=4, n_kv_heads=2, head_dim=64,
                              mrope_sections=(16, 8, 8, 0))
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    g = nq // nk
    N = (nq + 2 * nk) * hd
    gen = torch.Generator().manual_seed(9)
    w = 0.02 * torch.randn(2, cfg.hidden, N, generator=gen)
    t = torch.arange(N).expand(3, N)
    got = ft.group_qkv(t, nq, nk, hd)[0].tolist()
    for j in range(nk):
        grp = got[j * (g + 2) * hd:(j + 1) * (g + 2) * hd]
        assert grp[:g * hd] == list(range(j * g * hd, (j + 1) * g * hd))
        assert grp[g * hd:(g + 1) * hd] == list(range((nq + j) * hd,
                                                      (nq + j + 1) * hd))
        assert grp[(g + 1) * hd:] == list(range((nq + nk + j) * hd,
                                                (nq + nk + j + 1) * hd))
    assert sorted(got) == list(range(N))
    parts = {"values": w.to(torch.bfloat16)} if kind == "dense" else dict(
        quant.quantize_decoder_params(
            {"layers": {n: w for n in quant.DECODER_MATMULS},
             "final_norm": torch.ones(cfg.hidden), "head": w[0]},
            kind=kind)["layers"]["wqkv"])
    for name, v in parts.items():
        part = {"q": "values"}.get(name, name)
        c = ft.kernel_copy(v, "qkv", part, cfg)
        want = ft.group_qkv(v, nq, nk, hd)
        if name == "q4":
            want = ft.pair_int4(want)
        if part in ("values", "q4", "m8"):
            c = fp.unpack_units(c)
        assert torch.equal(c, want), name


def test_int4_pairs_round_trip():
    """pair_int4: packed row r holds weight row 2 r in its low nibble and
    2 r + 1 in its high one, the biased nibbles unchanged (ops/quant.py's
    order holds rows r and r + K / 2)."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(512, 24, generator=gen)
    q = quant.quantize_int4(w)
    nib = quant.unpack4(q["q4"]).to(torch.int32) + 8           # [K, N]
    pr = ft.pair_int4(q["q4"]).to(torch.int32) & 0xFF
    assert pr.shape == q["q4"].shape
    assert torch.equal(pr & 0xF, nib[0::2])
    assert torch.equal(pr >> 4, nib[1::2])


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int4_group_order_matches_panel_matmul4(M, x_dtype):
    """The kernel's int4 sum (each 128-row group's dot with the nibbles
    less 8, times the group's multiplier once, in f32), rendered in plain
    PyTorch, agrees with panel_matmul4_plain (the fused kernels' order:
    biased nibbles, the bias folded out through the row sum) and with JAX's
    qmatmul4 (dequantised weights, one f32 product) in f32 to the order of
    the sums: rtol 2e-6, atol 2e-6 of the output's largest value."""
    rng = np.random.default_rng(M)
    K, N = 1024, 48
    w = torch.from_numpy(0.05 * rng.standard_normal((K, N)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(
        np.float32)).to(x_dtype)
    q = quant.quantize_int4(w)
    got = ft.int4_group_order_plain(x, q["q4"], q["m8"])
    want = quant.panel_matmul4_plain(x, q["q4"], q["m8"])
    big = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=2e-6 * big)
    jw = {k: jnp.asarray(v.numpy()) for k, v in q.items()}
    jy = jquant.qmatmul4(jnp.asarray(x.float().numpy()), jw)
    np.testing.assert_allclose((got * q["scale"]).numpy(), np.asarray(jy),
                               rtol=2e-6,
                               atol=2e-6 * big * float(q["scale"].max()))


@pytest.mark.parametrize("B", [1, 2, 16, 17, 32])
@pytest.mark.parametrize("T", [256, 1024, 4096])
@pytest.mark.parametrize("nb", [132, 7])
def test_attention_splits_cover_live_ranges_once(B, T, nb):
    """S from B, nk, the grid and the capacity only; split s of each row's
    live range [valid_from, min(kv_len, T)) as the kernel takes it: the S
    splits tile the range in order, each slot once, ragged valid_from and
    empty ranges included."""
    nk = FULL.n_kv_heads
    S = ft.step_splits(B, nk, T, nb)
    assert 1 <= S <= ft.MAX_SPLITS and S & (S - 1) == 0
    assert B * nk * S <= max(nb, B * nk) and S * ft.MIN_SPLIT_SLOTS <= T \
        or S == 1
    rng = np.random.default_rng(B * T + nb)
    for _ in range(8):
        vf = rng.integers(0, T // 2, B)
        kv = vf + rng.integers(0, T, B)           # past T: clipped to T
        for b in range(B):
            lo, hi = int(vf[b]), min(int(kv[b]), T)
            slots = []
            for s in range(S):
                s0, s1 = ft.split_range(lo, hi, S, s)
                assert s0 <= s1
                slots += list(range(s0, s1))
            assert slots == list(range(lo, max(lo, hi)))
    assert ft.split_range(5, 3, 4, 0) == (5, 5)   # valid_from past kv_len


@pytest.mark.parametrize("S", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_order_equals_decode_attention_plain(S, dtype):
    """The kernel's split attention, emulated in plain PyTorch (S online
    softmax states merged in split order, the current token last), equals
    decode_attention_plain: ragged left pad, an empty live range, a range
    shorter than S, a range past the cache's end."""
    rng = np.random.default_rng(S)
    L, B, nq, nk, T, hd = 2, 4, 4, 2, 64, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    q, kn, vn = t(B, nq, hd), t(B, nk, hd), t(B, nk, hd)
    kc, vc = t(L, B, nk, T, hd), t(L, B, nk, T, hd)
    kv_len = torch.tensor([40, 0, 5, 70], dtype=torch.int32)
    vfrom = torch.tensor([3, 0, 2, 10], dtype=torch.int32)
    got = ft.split_attention_plain(q, kc, vc, kn, vn, 1, kv_len, vfrom, S)
    want = flash_decode.decode_attention_plain(q, kc, vc, kn, vn, 1, kv_len,
                                               vfrom)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- JAX
TC = TalkerConfig(hidden=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
                  head_dim=16, ffn_dim=128, vocab=2176, max_seq=512,
                  mrope_sections=(4, 2, 2, 0), dtype="float32")
# int4 needs widths in whole packed groups (multiples of 256)
TC4 = dataclasses.replace(TC, hidden=256, n_q_heads=2, n_kv_heads=2,
                          head_dim=128, ffn_dim=256,
                          mrope_sections=(32, 16, 16, 0))
STEP_CASES = {"tiny f32 dense": (TC, "dense"), "tiny f32 int8": (TC, "int8"),
              "small f32 int4": (TC4, "int4")}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax_kernel_over_steps(case):
    """Three consecutive steps through the route (on the CPU: the kernel's
    plain version) against JAX's talker_step_fused in interpret mode, each
    side carrying its own cache: B = 2 with left pad [0, 3] and per-row
    slots (row 1 one token behind), the same numpy feedback each step."""
    cfg, kind = STEP_CASES[case]
    tp = _steps_against_jax(cfg, kind, 2, 3)
    assert ft.talker_route(tp, 2) == ft.KERNEL


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("B", [17, 32])
def test_wide_step_matches_jax_kernel(case, B):
    """The step kernel's rows past 16 (its cap is the TPU kernel's 32):
    two consecutive steps of the kernel's wrapper (on the CPU: its plain
    version, after the kernel's own checks) against JAX's
    talker_step_fused in interpret mode, odd rows left-padded by 3 and one
    token behind; tolerances as above."""
    cfg, kind = STEP_CASES[case]
    _steps_against_jax(cfg, kind, B, 2, ft.talker_step_kernel)


def _steps_against_jax(cfg, kind, B, steps, step_fn=None):
    """`steps` consecutive steps of `step_fn` (default the route,
    talker_step_fused) against JAX's talker_step_fused in interpret mode
    at batch B, each side carrying its own cache: rows 1, 3, ... with left
    pad 3 and one token behind, the same numpy feedback each step.
    Returns the port's params."""
    step_fn = step_fn or ft.talker_step_fused
    S = 6
    rng = np.random.default_rng(7)
    ks = jax.random.split(jax.random.key(1), 2)
    jp = jdecoder.init_decoder(ks[0], cfg)
    if kind != "dense":
        jp = jquant.quantize_decoder_params(jp, kind=kind)
    tp = convert.decoder_from_numpy(jax.tree.map(np.asarray, jp))
    odd = (np.arange(B) % 2).astype(np.int32)
    pad = 3 * odd
    x = (0.1 * rng.standard_normal((B, S, cfg.hidden))).astype(np.float32)
    pos = jnp.maximum(jnp.arange(S)[None] - jnp.asarray(pad)[:, None], 0)
    _, _, jc = jdecoder.forward(jp, cfg, jnp.asarray(x), pos,
                                jdecoder.init_kv_cache(cfg, B), jnp.int32(0),
                                kv_valid_from=jnp.asarray(pad))
    jk, jv = jc["k"], jc["v"]
    tk = torch.from_numpy(np.array(jk))
    tv = torch.from_numpy(np.array(jv))
    slot = S - odd                       # odd rows one token behind
    launches = ft.talker_step_kernel.launches
    for step in range(steps):
        fb = (0.1 * rng.standard_normal((B, cfg.hidden))).astype(np.float32)
        jh, jl, jk, jv = jfused_talker.talker_step_fused(
            jp, cfg, jnp.asarray(fb), jnp.asarray(slot - pad),
            jnp.asarray(slot), jnp.asarray(slot), jnp.asarray(pad), jk, jv,
            interpret=True)
        th, tl, tk, tv = step_fn(
            tp, cfg, torch.from_numpy(fb), torch.from_numpy(slot - pad),
            torch.from_numpy(slot), torch.from_numpy(slot),
            torch.from_numpy(pad), tk, tv)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        for b in range(B):
            for t_all, j_all in ((tk, jk), (tv, jv)):
                np.testing.assert_allclose(
                    t_all[:, b, :, slot[b]].numpy(),
                    np.asarray(j_all)[:, b, :, slot[b]], rtol=0, atol=1e-5)
        slot = slot + 1
    assert ft.talker_step_kernel.launches == launches   # CPU: plain only
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                               atol=1e-5)
    return tp


def test_kernel_refuses_what_it_does_not_take():
    """The step kernel's checks run on every device: B past MAX_B, a
    cache in another dtype and a head width it cannot split raise on the
    CPU as on the card."""
    g = torch.Generator().manual_seed(0)
    from qwen3_tts_tpu_torch.models import decoder
    tp = decoder.init_decoder(g, TINY)
    cache = decoder.init_kv_cache(TINY, 2, length=64)
    x = torch.zeros(2, TINY.hidden)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="B in"):
        big = torch.zeros(ft.MAX_B + 1, TINY.hidden)
        c = decoder.init_kv_cache(TINY, ft.MAX_B + 1, length=64)
        ft.talker_step_kernel(tp, TINY, big, 0, 0, 0, 0, c["k"], c["v"])
    with pytest.raises(ValueError, match="k_cache"):
        ft.talker_step_kernel(tp, TINY, x, i32, i32, i32, i32,
                              cache["k"].double(), cache["v"])
    odd = dataclasses.replace(TINY, head_dim=12, mrope_sections=(3, 2, 1, 0))
    with pytest.raises(ValueError, match="head_dim"):
        ft.talker_step_kernel(tp, odd, x, i32, i32, i32, i32, cache["k"],
                              cache["v"])
