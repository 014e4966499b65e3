"""The rms norm as the prologue of gemv B / B8 / B4 (`gemv(..., norm=)`), on
the CPU, where each wrapper runs its plain version.

  * The plain fused-norm product of each weight kind (dense f32 and bf16,
    int8, int4), at M = 1, 2, 8, every epilogue and a column slice, equals
    `rms_norm_plain` followed by the plain product bit for bit, through the
    plain function and through the wrapper.
  * It agrees with the JAX package on the same numpy inputs:
    `qwen3_tts_tpu/models/decoder.rms_norm` (rounded once to the model
    dtype, as `rms2` rounds), then the product (dense: x @ w; int8 / int4:
    the TPU kernels' `stream_matmul` math, x @ q or `panel_matmul4`, times
    the column scale). Tolerances: f32 atol 1e-5 (reduction order); bf16
    one bf16 ulp of the output's largest magnitude (2^-7 relative: the
    normed x rounds to bf16 from two f32 computations of the same value,
    which may straddle a rounding boundary).
  * A recording op set shows where the norms run: `layer_pass` launches no
    standalone rms_norm, a talker step launches one (the final norm, whose
    output is the step's hidden), a predictor frame none.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels.py and chip_smoke.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch.core.config import tiny_engine_config
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.ops import chain, fused_predictor, fused_talker
from qwen3_tts_tpu_torch.ops import elementwise as el
from qwen3_tts_tpu_torch.ops import gemv, quant, rope

EPS = 1e-6
EPILOGUES = [gemv.EPI_STORE_DT, gemv.EPI_F32, gemv.EPI_F32_ROUND_DT,
             gemv.EPI_ADD_F32]
# (weight kind, model dtype); int4 needs K in whole packed groups (256)
KINDS = [("dense", torch.float32), ("dense", torch.bfloat16),
         ("int8", torch.bfloat16), ("int4", torch.bfloat16),
         ("int4", torch.float32)]
K, N, COL0, NC = 512, 4 * 64, 2 * 64, 64          # a head-like slice


def _inputs(M, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((M, K))).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    w[:128, 5] = 0.0                       # an all-zero int4 k-group
    ln = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    ln = torch.from_numpy(ln).to(dt).float().numpy()     # exact in dt
    res = rng.standard_normal((M, NC)).astype(np.float32)
    return x, w, ln, res


def _weights(kind, w, dt):
    tw = torch.from_numpy(w)
    if kind == "dense":
        return (tw.to(dt),)
    if kind == "int8":
        q = quant.quantize(tw)
        return q["q"], q["scale"]
    q = quant.quantize_int4(tw)
    return q["q4"], q["m8"], q["scale"]


FNS = {"dense": (gemv.gemv, gemv.gemv_plain),
       "int8": (gemv.gemv_int8, gemv.gemv_int8_plain),
       "int4": (gemv.gemv_int4, gemv.gemv_int4_plain)}


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_fused_norm_plain_equals_norm_then_product(kind, dt, M, epilogue):
    x, w, ln, res = _inputs(M, dt, seed=M)
    tx, tln = torch.from_numpy(x), torch.from_numpy(ln).to(dt)
    wargs = _weights(kind, w, dt)
    fn, plain = FNS[kind]

    def out():
        return torch.from_numpy(res.copy()) \
            if epilogue == gemv.EPI_ADD_F32 else None

    kw = dict(col0=COL0, n=NC, epilogue=epilogue)
    want = plain(el.rms_norm_plain(tx, tln, EPS, dt), *wargs, out=out(),
                 **kw)
    for f in (plain, fn):          # the wrapper takes the plain version here
        got = f(tx, *wargs, norm=(tln, EPS), dt=dt, out=out(), **kw)
        assert got.dtype == want.dtype and got.shape == (M, NC)
        assert torch.equal(got, want)


def _jax_ref(kind, x, w, ln, dt, epilogue, res):
    """decoder.rms_norm (f32 math), one rounding to dt, then the TPU
    kernels' product for the weight kind, then the epilogue."""
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    xn = jdecoder.rms_norm(jnp.asarray(x), jnp.asarray(ln), EPS).astype(jdt)
    xf = xn.astype(jnp.float32)
    cols = slice(COL0, COL0 + NC)
    wj = jnp.asarray(w)
    if kind == "dense":
        acc = xf @ wj.astype(jdt).astype(jnp.float32)[:, cols]
    elif kind == "int8":
        q = jquant.quantize(wj)
        acc = (xf @ q["q"][:, cols].astype(jnp.float32)) * q["scale"][cols]
    else:
        q = jquant.quantize_int4(wj)
        acc = jquant.panel_matmul4(xn, q["q4"][:, cols], q["m8"][:, cols],
                                   jnp.float32) * q["scale"][cols]
    if epilogue == gemv.EPI_ADD_F32:
        return np.asarray(acc) + res
    if epilogue in (gemv.EPI_STORE_DT, gemv.EPI_F32_ROUND_DT):
        acc = acc.astype(jdt).astype(jnp.float32)
    return np.asarray(acc)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_fused_norm_plain_matches_jax(kind, dt, M, epilogue):
    x, w, ln, res = _inputs(M, dt, seed=10 + M)
    fn, _ = FNS[kind]
    out = torch.from_numpy(res.copy()) \
        if epilogue == gemv.EPI_ADD_F32 else None
    got = fn(torch.from_numpy(x), *_weights(kind, w, dt), col0=COL0, n=NC,
             epilogue=epilogue, out=out,
             norm=(torch.from_numpy(ln).to(dt), EPS), dt=dt).float().numpy()
    ref = _jax_ref(kind, x, w, ln, dt, epilogue, res)
    atol = 1e-5 if dt == torch.float32 else 2 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_fused_norm_needs_the_model_dtype():
    x, w, ln, _ = _inputs(1, torch.float32)
    with pytest.raises(ValueError, match="model dtype"):
        gemv.gemv_plain(torch.from_numpy(x), torch.from_numpy(w),
                        norm=(torch.from_numpy(ln), EPS))


class _Recorder:
    """An op set that runs the plain versions and records each call: the
    op's name, and for the products whether the norm was their prologue."""

    def __init__(self):
        self.calls = []

        def wrap(name, fn):
            def call(*a, **kw):
                self.calls.append(name + ("+norm" if kw.get("norm")
                                          is not None else ""))
                return fn(*a, **kw)
            return call
        self.ops = SimpleNamespace(**{n: wrap(n, f) for n, f in
                                      vars(chain.PLAIN).items()})

    def count(self, name):
        return sum(c == name for c in self.calls)


def _tiny_step_inputs(tc, B=2):
    g = torch.Generator().manual_seed(0)
    params = tdecoder.init_decoder(g, tc)
    cache = tdecoder.init_kv_cache(tc, B, length=64)
    x = 0.1 * torch.randn(B, tc.hidden, generator=g)
    pos = torch.full((B,), 5, dtype=torch.int32)
    pad = torch.zeros(B, dtype=torch.int32)
    return params, x, pos, pad, cache


def test_layer_pass_runs_no_standalone_rms_norm():
    tc = tiny_engine_config().talker
    params, x, pos, pad, cache = _tiny_step_inputs(tc)
    rec = _Recorder()
    rec.ops.rms_norm = None             # a standalone norm would raise
    nq, nk, hd = tc.n_q_heads, tc.n_kv_heads, tc.head_dim
    B = x.shape[0]
    cos, sin = rope.rope_angles(rope.mrope_positions(pos[:, None]),
                                tc.mrope_sections, hd, tc.rope_theta)
    chain.layer_pass(rec.ops, params["layers"], 0, tc, x.clone(),
                     cos[:, 0].contiguous(), sin[:, 0].contiguous(),
                     cache["k"], cache["v"], torch.empty(B, nq, hd),
                     torch.empty(B, nk, hd), torch.empty(B, nk, hd), pos,
                     pad)
    assert rec.count("gemv+norm") == 2       # qkv (ln1), gate/up (ln2)
    assert rec.count("gemv") == 2            # wo, down


def test_talker_step_runs_the_final_norm_alone():
    tc = tiny_engine_config().talker
    params, x, pos, pad, cache = _tiny_step_inputs(tc)
    rec = _Recorder()
    h, logits, _, _ = fused_talker._step(rec.ops, params, tc, x, pos, 5,
                                         pos, pad, cache["k"], cache["v"])
    assert rec.count("rms_norm") == 1
    assert rec.count("gemv+norm") == 2 * tc.n_layers
    # the recorder passes the plain versions through unchanged
    ref, _, _, _ = fused_talker.talker_step_fused_plain(
        params, tc, x, pos, 5, pos, pad, *(
            t.clone() for t in _tiny_step_inputs(tc)[4].values()))
    assert torch.equal(h, ref)


def test_predictor_frame_runs_no_standalone_norm():
    from qwen3_tts_tpu_torch.assets import tables
    cfg = tiny_engine_config()
    pc = cfg.predictor
    g = torch.Generator().manual_seed(1)
    params = tdecoder.init_decoder(g, pc)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176,
                                  dim=cfg.talker.hidden, proj_dim=pc.hidden)
    ptab, rows = fused_predictor.make_ptab(assets, pc)
    h = torch.randn(2, pc.hidden, generator=g)
    code0 = torch.tensor([5, 3000])
    rec = _Recorder()
    codes = fused_predictor._frame(rec.ops, params, pc, ptab, rows, h, code0)
    assert rec.count("rms_norm") == 0
    nb = codes.shape[1]
    # ln1 + ln2 of every layer in each of the 16 passes, and the final norm
    # of the 15 head slices
    assert rec.count("gemv+norm") == nb * 2 * pc.n_layers + nb - 1
    assert torch.equal(codes, fused_predictor.frame_codes_fused_plain(
        params, pc, ptab, rows, h, code0))
