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
CONFIGS = {"full": FULL, "tiny": TINY}
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


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 16, 17])
def test_route(config, kind, B, monkeypatch):
    """Dense or int8 weights at B <= 16 go to the frame kernel; int4
    weights or B > 16 to the chain, and frame_codes_fused takes that
    route."""
    cfg = CONFIGS[config]
    params = _meta_params(cfg, kind)
    want = fp.CHAIN if kind == "int4" or B > fp.MAX_B else fp.KERNEL
    assert fp.frame_route(params, B) == want
    taken = []
    monkeypatch.setattr(fp, "predictor_frame_kernel",
                        lambda *a: taken.append(fp.KERNEL))
    monkeypatch.setattr(fp, "_frame", lambda *a: taken.append(fp.CHAIN))
    fp.frame_codes_fused(params, cfg, None, 0, None,
                         torch.zeros(B, dtype=torch.int32))
    assert taken == [want]


def test_route_mixed_dense_int8_is_kernel_and_int4_anywhere_is_chain():
    params = _meta_params(TINY, "dense")
    mixed = dict(params, head=_meta_params(TINY, "int8")["head"])
    assert fp.frame_route(mixed, 4) == fp.KERNEL
    one4 = dict(params, head=_meta_params(TINY, "int4")["head"])
    assert fp.frame_route(one4, 1) == fp.CHAIN


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("nb", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 2, 16])
def test_work_plan_covers_each_column_once(config, nb, B):
    """Every output column of every stage goes to exactly one block, in
    contiguous ranges in block order; stage 2's units are whole (row, kv
    head) pairs, each once; the residual's columns once."""
    cfg = CONFIGS[config]
    plan = fp.frame_plan(cfg, B, nb)
    shapes = fp.stage_shapes(cfg)
    for stage, ranges in plan.items():
        assert len(ranges) == nb
        if stage == "attention":
            total = B * cfg.n_kv_heads
        elif stage == "residual":
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
        if stage not in ("attention", "residual"):
            cols = np.repeat(owner, fp.UNIT)
            assert cols.shape == (shapes[stage][1],)
    # stage 2: a unit is one row's kv head with its whole q group
    for lo, hi in plan["attention"]:
        for u in range(lo, hi):
            b, j = divmod(u, cfg.n_kv_heads)
            assert 0 <= b < B and 0 <= j < cfg.n_kv_heads
    assert fp.row_chunk(B) == {1: 1, 2: 2}.get(B, 4)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["dense", "int8"])
@pytest.mark.parametrize("B", [1, 2, 16])
def test_shared_memory_plan_fits_a_block(config, kind, B):
    """The two weight buffers and the fixed part fit the H100's opt-in
    shared memory per block; at the full bf16 and int8 widths every stage's
    whole block slice fits its buffer at one block per SM (132 SMs)."""
    cfg = CONFIGS[config]
    t_bytes = 4 if cfg.dtype == "float32" else 2
    w_bytes = {st: 1 if kind == "int8" else t_bytes for st in fp._STAGES}
    fixed = fp.frame_smem_fixed(cfg, B, t_bytes)
    buf = fp.frame_buffer_bytes(cfg, fp.frame_plan(cfg, B, 132), w_bytes,
                                fixed, H100_SMEM)
    assert buf % 16 == 0 and fixed + 2 * buf <= H100_SMEM
    for st, (K, N) in fp.stage_shapes(cfg).items():
        most = max(hi - lo for lo, hi in fp.split_units(N // fp.UNIT, 132))
        if most:
            assert buf >= most * fp.UNIT * K * w_bytes[st]
    if config == "full" and kind == "dense":
        # the largest slice: gate/up, 6 units of 1024 bf16 rows (96 KiB)
        assert buf == 6 * fp.UNIT * 1024 * 2


def test_shared_memory_plan_caps_f32_full_width():
    """f32 weights at the full width do not fit whole: the buffers take
    what the block leaves, and the slice's first rows are staged."""
    cfg = dataclasses.replace(FULL, dtype="float32")
    fixed = fp.frame_smem_fixed(cfg, 1, 4)
    buf = fp.frame_buffer_bytes(cfg, fp.frame_plan(cfg, 1, 132),
                                {st: 4 for st in fp._STAGES}, fixed,
                                H100_SMEM)
    assert fixed + 2 * buf <= H100_SMEM
    assert buf < 6 * fp.UNIT * 1024 * 4


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
    lg[2, [3, 600]] = float("nan")              # first NaN wins
    lg[2, 4] = 1e30
    lg[3] = float("-inf")                       # all -inf: index 0
    lg[4, 2047] = 50.0
    return lg


@pytest.mark.parametrize("nb", [132, 114, 7, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_partials_reduce_to_torch_argmax(nb, seed):
    """Per-block (max, index) partials, reduced in any order, give
    torch.argmax: the lowest index on ties, NaN first."""
    lg = _crafted_logits(seed)
    want = torch.argmax(lg, dim=-1)
    assert want[:4].tolist() == [7, 15, 3, 0]
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


def _frame_inputs(kind, B, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    jp = jdecoder.init_decoder(k1, PC)
    if kind != "dense":
        jp = jquant.quantize_decoder_params(jp, kind=kind)
    ja = jtables.random_assets(k2, text_vocab=64, codec_rows=2176,
                               dim=64, proj_dim=PC.hidden)
    ta = convert.assets_from_numpy(
        np.asarray(ja.text_table), np.asarray(ja.codec_tables),
        np.asarray(ja.proj_weight), np.asarray(ja.proj_bias))
    tp = convert.decoder_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    h1024 = rng.standard_normal((B, PC.hidden)).astype(np.float32)
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
    buffer."""
    from qwen3_tts_tpu_torch.ops import fused_talker as ft
    from qwen3_tts_tpu_torch.tools import frame_measure as fm

    src = (pathlib.Path(fp.__file__).parent.parent / "csrc"
           / f"{kernel}.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"\b(kTr\w+) = (\d+)", src)}
    full = tconfig.EngineConfig()
    if kernel == "predictor_frame":
        struct, args = "FrameArgs", fp._FrameArgs
        read = {"kTrT0": fm.T0, "kTrProd": fm.PHASES, "kTrNorm": fm.NORM,
                "kTrWait": fm.WAIT}
        words = {"kTrT0": 1, "kTrProd": 4 * 5, "kTrNorm": 5, "kTrWait": 2}
        L = full.predictor.n_layers
        barriers = 16 * 5 * L + 15
    else:
        struct, args = "StepArgs", ft._StepArgs
        read = {"kTrT0": fm.T_T0, "kTrEnd": fm.T_END, "kTrWait": fm.T_WAIT,
                "kTrPWait": fm.T_PWAIT, "kTrAttn": fm.T_ATTN,
                "kTrProd": fm.T_PROD}
        words = {"kTrT0": 1, "kTrEnd": 1, "kTrWait": 2, "kTrPWait": 2,
                 "kTrAttn": 6, "kTrProd": 8 * 5}
        barriers = 5 * full.talker.n_layers
    # every trace guard tests kTrace first (-DKERNEL_TRACE builds only)
    assert "a.trace != nullptr" not in src.replace(
        "kTrace && a.trace != nullptr", "")
    assert _c_fields(src, struct) == [f[0] for f in args._fields_]
    assert args._fields_[-1][0] == "trace" or kernel == "talker_step"
    assert const == read
    # each constant's words: after the barriers' stamps, apart, in the buffer
    spans = sorted((const[k], const[k] + n) for k, n in words.items())
    assert 2 * barriers <= spans[0][0] and spans[-1][1] <= fm.TRACE_WORDS
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
