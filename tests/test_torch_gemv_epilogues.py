"""The qk epilogue and the silu prologue of gemv B / B8 / B4 (`gemv(...,
qk=, kv=)`, `gemv(..., act="silu")`), on the CPU, where each wrapper runs
its plain version.

  * The plain fused products equal the chain they replace, bit for bit,
    through the plain function and through the wrapper: the qk epilogue is
    the normed product (`norm=`, stored in the model dtype) followed by
    `qk_norm_rope_plain`, and its KV store writes f32(k), f32(v) into slot
    p of a [L, B, nk, T, hd] f32 cache, leaving every other slot
    bit-unchanged; the silu prologue is `silu_mul_plain` followed by the
    plain product. Dense f32 and bf16, int8, int4; M = 1, 2, 8; hd 16, 64,
    128.
  * They agree with the JAX package on the same numpy inputs: the TPU
    kernels' `rms3` + `rope` (`qwen3_tts_tpu/ops/fused_predictor.py:137-151`:
    f32 norm math rounded once, RoPE in the model dtype) after the
    `rms2`-normed product, and g / (1 + exp(-g)) * u rounded once before
    the product. Tolerances: f32 atol 1e-5 (reduction order); bf16 one bf16
    ulp of the output's largest magnitude (2^-7 relative: roundings of two
    f32 computations of one value may straddle a boundary, and the TPU
    kernels' RoPE rounds its two products in bf16 where the port rounds
    once).
  * A recording op set shows the routing: `layer_pass` runs five ops; a
    predictor frame does no copy into its cache (the qkv launch's KV store
    fills slot p before the pass's attention); a talker step still writes
    its cache after the step.
  * The wrappers refuse what the kernels do not take (ValueError), on every
    device, before the CPU branch.

The kernels are held against these plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import ctypes
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch.assets import tables
from qwen3_tts_tpu_torch.core.config import tiny_engine_config
from qwen3_tts_tpu_torch.kernels import build
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.ops import chain, fused_predictor, fused_talker
from qwen3_tts_tpu_torch.ops import elementwise as el
from qwen3_tts_tpu_torch.ops import gemv, quant, rope

EPS = 1e-6
NQ, NK = 4, 2
K = 256                       # one packed int4 group pair
# (weight kind, model dtype)
KINDS = [("dense", torch.float32), ("dense", torch.bfloat16),
         ("int8", torch.bfloat16), ("int4", torch.bfloat16),
         ("int4", torch.float32)]
FNS = {"dense": (gemv.gemv, gemv.gemv_plain),
       "int8": (gemv.gemv_int8, gemv.gemv_int8_plain),
       "int4": (gemv.gemv_int4, gemv.gemv_int4_plain)}
L_C, T_C, SLOT = 3, 6, 4      # the KV store's cache: layers, slots, slot p


def _weights(kind, w, dt):
    tw = torch.from_numpy(w)
    if kind == "dense":
        return (tw.to(dt),)
    if kind == "int8":
        q = quant.quantize(tw)
        return q["q"], q["scale"]
    q = quant.quantize_int4(tw)
    return q["q4"], q["m8"], q["scale"]


def _exact(a, dt):
    """numpy f32 values exactly representable in dt."""
    return torch.from_numpy(a).to(dt).float().numpy()


def _qk_inputs(M, hd, dt, seed):
    rng = np.random.default_rng(seed)
    N = (NQ + 2 * NK) * hd
    x = (2.0 * rng.standard_normal((M, K))).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    ln = _exact((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32), dt)
    qn = _exact((1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32), dt)
    kn = _exact((1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32), dt)
    pos = rng.integers(0, 300, size=M).astype(np.int32)
    cos, sin = rope.rope_angles(
        rope.mrope_positions(torch.from_numpy(pos)[:, None]),
        (hd // 4, hd // 8, hd // 8, 0), hd, 1e6)
    return (x, w, ln, qn, kn, cos[:, 0].contiguous().numpy(),
            sin[:, 0].contiguous().numpy())


def _qk_args(qn, kn, cos, sin, dt):
    return (torch.from_numpy(qn).to(dt), torch.from_numpy(kn).to(dt),
            torch.from_numpy(cos), torch.from_numpy(sin), NQ, NK, EPS)


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_qk_epilogue_plain_equals_product_then_qk_norm_rope(kind, dt, M, hd,
                                                            kv):
    x, w, ln, qn, kn, cos, sin = _qk_inputs(M, hd, dt, seed=M + hd)
    tx, tln = torch.from_numpy(x), torch.from_numpy(ln).to(dt)
    wargs = _weights(kind, w, dt)
    qk = _qk_args(qn, kn, cos, sin, dt)
    fn, plain = FNS[kind]
    y = plain(tx, *wargs, norm=(tln, EPS), dt=dt)
    assert y.dtype == dt
    want = el.qk_norm_rope_plain(y, *qk)
    g = torch.Generator().manual_seed(hd)
    cache0 = torch.randn(2, L_C, M, NK, T_C, hd, generator=g)
    for f in (plain, fn):          # the wrapper takes the plain version here
        cache = cache0.clone()
        views = (cache[0, 1, :, :, SLOT], cache[1, 1, :, :, SLOT]) \
            if kv else None
        out = tuple(torch.full(t.shape, float("nan"), dtype=dt)
                    for t in want)
        got = f(tx, *wargs, norm=(tln, EPS), qk=qk, out=out, kv=views,
                dt=dt)
        assert all(a is b for a, b in zip(got, out))
        for a, b in zip(got, want):
            assert a.dtype == dt and torch.equal(a, b)
        if kv:
            assert torch.equal(cache[:, 1, :, :, SLOT],
                               torch.stack(want[1:]).float())
            cache[:, 1, :, :, SLOT] = cache0[:, 1, :, :, SLOT]
        assert torch.equal(cache, cache0)     # every other slot untouched


def _jax_product(kind, xn, w, dt):
    """The TPU kernels' product of the normed x (in dt) for the weight
    kind, f32: x @ w, x @ q times the scale, or `panel_matmul4`."""
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    xn = xn.astype(jdt)
    wj = jnp.asarray(w)
    if kind == "dense":
        return xn.astype(jnp.float32) @ wj.astype(jdt).astype(jnp.float32)
    if kind == "int8":
        q = jquant.quantize(wj)
        return (xn.astype(jnp.float32) @ q["q"].astype(jnp.float32)) \
            * q["scale"]
    q = jquant.quantize_int4(wj)
    return jquant.panel_matmul4(xn, q["q4"], q["m8"], jnp.float32) \
        * q["scale"]


def _jax_qk(kind, x, w, ln, qn, kn, cos, sin, dt, hd):
    """rms2 -> the product -> T -> rms3 and rope on q and k, as written in
    qwen3_tts_tpu/ops/fused_predictor.py:130-151."""
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    xn = jdecoder.rms_norm(jnp.asarray(x), jnp.asarray(ln), EPS)
    qkv = _jax_product(kind, xn, w, dt).astype(jdt)
    M = x.shape[0]
    half = hd // 2

    def rms3(h, w_row):
        hf = h.astype(jnp.float32)
        var = jnp.mean(hf * hf, axis=-1, keepdims=True)
        return (hf * jax.lax.rsqrt(var + EPS) * w_row[None]).astype(jdt)

    def rope3(h):
        rot = jnp.concatenate([-h[..., half:], h[..., :half]], axis=-1)
        c = jnp.asarray(cos)[:, None].astype(jdt)
        s = jnp.asarray(sin)[:, None].astype(jdt)
        return h * c + rot * s

    q3 = qkv[:, :NQ * hd].reshape(M, NQ, hd)
    k3 = qkv[:, NQ * hd:(NQ + NK) * hd].reshape(M, NK, hd)
    v3 = qkv[:, (NQ + NK) * hd:].reshape(M, NK, hd)
    return (rope3(rms3(q3, jnp.asarray(qn))),
            rope3(rms3(k3, jnp.asarray(kn))), v3)


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_qk_epilogue_plain_matches_jax(kind, dt, M, hd):
    x, w, ln, qn, kn, cos, sin = _qk_inputs(M, hd, dt, seed=20 + M + hd)
    fn, _ = FNS[kind]
    got = fn(torch.from_numpy(x), *_weights(kind, w, dt),
             norm=(torch.from_numpy(ln).to(dt), EPS),
             qk=_qk_args(qn, kn, cos, sin, dt), dt=dt)
    for part, ref in zip(got, _jax_qk(kind, x, w, ln, qn, kn, cos, sin, dt,
                                      hd)):
        ref = np.asarray(ref.astype(jnp.float32))
        atol = 1e-5 if dt == torch.float32 else 2 ** -7 * np.abs(ref).max()
        np.testing.assert_allclose(part.float().numpy(), ref, rtol=0,
                                   atol=atol)


def _silu_inputs(M, N, seed):
    rng = np.random.default_rng(seed)
    gu = (2.0 * rng.standard_normal((M, 2 * K))).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return gu, w, res


SILU_EPILOGUES = [gemv.EPI_ADD_F32, gemv.EPI_STORE_DT]


@pytest.mark.parametrize("epilogue", SILU_EPILOGUES)
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_silu_prologue_plain_equals_silu_mul_then_product(kind, dt, M,
                                                          epilogue):
    gu, w, res = _silu_inputs(M, 64, seed=30 + M)
    tgu = torch.from_numpy(gu)
    wargs = _weights(kind, w, dt)
    fn, plain = FNS[kind]

    def out():
        return torch.from_numpy(res.copy()) \
            if epilogue == gemv.EPI_ADD_F32 else None

    want = plain(el.silu_mul_plain(tgu, dt), *wargs, epilogue=epilogue,
                 out=out())
    for f in (plain, fn):
        got = f(tgu, *wargs, epilogue=epilogue, out=out(), act="silu", dt=dt)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("kind,dt", KINDS)
def test_silu_prologue_plain_matches_jax(kind, dt, M):
    gu, w, res = _silu_inputs(M, 64, seed=40 + M)
    fn, _ = FNS[kind]
    got = fn(torch.from_numpy(gu), *_weights(kind, w, dt),
             epilogue=gemv.EPI_ADD_F32, out=torch.from_numpy(res.copy()),
             act="silu", dt=dt).numpy()
    g, u = jnp.asarray(gu[:, :K]), jnp.asarray(gu[:, K:])
    ref = np.asarray(_jax_product(kind, g / (1.0 + jnp.exp(-g)) * u, w,
                                  dt)) + res
    atol = 1e-5 if dt == torch.float32 else 2 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# ------------------------------------------------------- argmax epilogue
def _jax_argmax_row(lg):
    """JAX's `argmax_row` (qwen3_tts_tpu/ops/fused_predictor.py:465-469)
    of numpy logits [B, CV]: min(where(lg >= max, iota, CV))."""
    lg = jnp.asarray(lg)
    m = jnp.max(lg, axis=-1, keepdims=True)
    iota = jax.lax.broadcasted_iota(jnp.int32, lg.shape, 1)
    return np.asarray(jnp.min(jnp.where(lg >= m, iota, lg.shape[1]), axis=-1))


def _argmax_inputs(kind, dt, seed=2):
    """x [5, K] (row 3 holds an inf: its normed row, so its logits, are
    NaN), a head of two ARGMAX_CV-wide slices whose second slice has two
    tied pairs of boosted columns (u at 7 and 9, -u at 200 and 201, so a
    row's code is mostly 7 or 200), ptab [16, 40, K] in dt, 30 real rows
    (code 200 and the NaN row's CV select the bias row)."""
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((K, 2 * ARGMAX_CV))).astype(np.float32)
    u = (1.2 * rng.standard_normal(K)).astype(np.float32)
    for c, sign in ((7, 1), (9, 1), (200, -1), (201, -1)):
        w[:, ARGMAX_CV + c] = sign * u
    x = (2.0 * rng.standard_normal((5, K))).astype(np.float32)
    x[3, 0] = np.inf
    ln = _exact((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32), dt)
    ptab = torch.from_numpy(rng.standard_normal((16, 40, K)).astype(
        np.float32)).to(dt)
    return (torch.from_numpy(x), _weights(kind, w, dt),
            (torch.from_numpy(ln).to(dt), EPS), ptab, 30)


@pytest.mark.parametrize("kind,dt", KINDS)
def test_argmax_epilogue_plain_equals_product_then_argmax_gather(kind, dt):
    """The head slice with `argmax=`, through the plain function and the
    wrapper's CPU branch, with x_out a buffer of its own or x itself:
    the logits stored into `out` equal the plain product's, and codes and
    the gathered rows equal `argmax_gather_plain` on them, bit for bit;
    the codes are JAX's `argmax_row` of those logits (ties to the lowest
    index, CV for the NaN row), and the gathered rows ptab[q][sel]."""
    x, wargs, norm, ptab, rows = _argmax_inputs(kind, dt)
    fn, plain = FNS[kind]
    M, q = x.shape[0], 2
    kw = dict(col0=ARGMAX_CV, n=ARGMAX_CV, epilogue=gemv.EPI_F32_ROUND_DT,
              norm=norm, dt=dt)
    logits = plain(x, *wargs, **kw)
    codes_r = torch.zeros(M, 16, dtype=torch.int32)
    xo_r = torch.empty(M, K)
    el.argmax_gather_plain(logits, codes_r, q, ptab, rows, xo_r)
    want = _jax_argmax_row(logits.numpy())
    assert codes_r[:, q].tolist() == want.tolist()
    assert want[3] == ARGMAX_CV and {7, 200} & set(want.tolist())
    assert not {9, 201} & set(want.tolist())
    sel = np.where(want < rows, want, ptab.shape[1] - 1)
    assert torch.equal(xo_r, ptab[q][torch.from_numpy(sel)].float())
    for f in (fn, plain):
        for alias in (False, True):
            xi = x.clone()
            xo = xi if alias else torch.empty(M, K)
            codes = torch.zeros(M, 16, dtype=torch.int32)
            lg = torch.empty(M, ARGMAX_CV)
            f(xi, *wargs, out=lg, argmax=(codes, q, ptab, rows, xo), **kw)
            torch.testing.assert_close(lg, logits, rtol=0, atol=0,
                                       equal_nan=True)
            assert torch.equal(codes, codes_r) and torch.equal(xo, xo_r)
    # the last slice gathers nothing
    codes = torch.zeros(M, 16, dtype=torch.int32)
    assert fn(x, *wargs, argmax=(codes, 15, ptab, rows, None), **kw) is None
    assert torch.equal(codes[:, 15], codes_r[:, q])


# ------------------------------------------------------------------ refusals
def _refusal_case(kind, case):
    """Arguments of one refused call on CPU tensors (model dtype f32)."""
    hd = {"hd256": 256, "hd48": 48}.get(case, 16)
    N = (NQ + 2 * NK) * hd + (16 if case == "width" else 0)
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    wargs = _weights(kind, w, torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, K)).astype(np.float32))
    ln = torch.ones(K)
    cos = torch.ones(2, hd, dtype=torch.float64 if case == "cos" else
                     torch.float32)
    kw = dict(norm=(ln, EPS), dt=torch.float32,
              qk=(torch.ones(hd), torch.ones(hd), cos, torch.ones(2, hd),
                  NQ, NK, EPS))
    if case == "col0":
        kw.update(col0=8, n=N - 8)
    elif case == "epilogue":
        kw.update(epilogue=gemv.EPI_F32)
    elif case == "no_norm":
        kw.pop("norm")
    elif case == "out":
        kw.update(out=(torch.empty(2, NQ, hd), torch.empty(2, NK, hd),
                       torch.empty(2, NK, hd, dtype=torch.bfloat16)))
    elif case == "kv_dtype":
        kw.update(kv=(torch.empty(2, NK, hd, dtype=torch.bfloat16),
                      torch.empty(2, NK, hd, dtype=torch.bfloat16)))
    elif case == "kv_without_qk":
        kw.pop("qk")
        kw.update(kv=(torch.empty(2, NK, hd), torch.empty(2, NK, hd)))
    elif case == "silu_with_norm":
        kw.pop("qk")
        kw.update(act="silu", x=torch.zeros(2, 2 * K))
    elif case == "act":
        kw.pop("qk")
        kw.pop("norm")
        kw.update(act="gelu")
    x = kw.pop("x", x)
    return x, wargs, kw


REFUSALS = ["hd256", "hd48", "cos", "col0", "epilogue", "no_norm", "width",
            "out", "kv_dtype", "kv_without_qk", "silu_with_norm", "act"]


@pytest.mark.parametrize("case", REFUSALS)
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_wrappers_refuse_what_the_kernels_do_not_take(kind, case):
    x, wargs, kw = _refusal_case(kind, case)
    fn, _ = FNS[kind]
    with pytest.raises(ValueError):
        fn(x, *wargs, **kw)


ARGMAX_CV = 256               # the argmax cases' code vocabulary


def _argmax_refusal(kind, case):
    """Arguments of one refused argmax epilogue on CPU tensors (model dtype
    f32): a head of two ARGMAX_CV-wide slices, the second one taken."""
    M, R = 2, 40
    N = 2 * ARGMAX_CV
    rng = np.random.default_rng(1)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    wargs = _weights(kind, w, torch.float32)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    codes = torch.zeros(M, 16, dtype=torch.int32)
    ptab = torch.zeros(16, R, K)
    am = [codes, 3, ptab, R - 1, torch.empty(M, K)]
    kw = dict(col0=ARGMAX_CV, n=ARGMAX_CV, epilogue=gemv.EPI_F32_ROUND_DT,
              norm=(torch.ones(K), EPS), dt=torch.float32)
    if case == "epilogue":
        kw.update(epilogue=gemv.EPI_F32)
    elif case == "pow2":
        kw.update(n=ARGMAX_CV - 8)
    elif case == "no_norm":
        kw.pop("norm")
    elif case == "with_qk":
        kw.update(qk=(torch.ones(16), torch.ones(16), torch.ones(M, 16),
                      torch.ones(M, 16), 1, 1, EPS))
    elif case == "codes_rows":
        am[0] = torch.zeros(M + 1, 16, dtype=torch.int32)
    elif case == "codes_dtype":
        am[0] = torch.zeros(M, 16, dtype=torch.int64)
    elif case == "q":
        am[1] = 16
    elif case == "ptab_dtype":
        am[2] = ptab.bfloat16()
    elif case == "ptab_rows":
        am[3] = R + 1
    elif case == "x_out_shape":
        am[4] = torch.empty(M, K + 8)
    elif case == "x_out_dtype":
        am[4] = torch.empty(M, K, dtype=torch.bfloat16)
    elif case == "logits_out":
        kw.update(out=torch.empty(M, ARGMAX_CV + 8))
    return x, wargs, dict(kw, argmax=tuple(am))


ARGMAX_REFUSALS = ["epilogue", "pow2", "no_norm", "with_qk", "codes_rows",
                   "codes_dtype", "q", "ptab_dtype", "ptab_rows",
                   "x_out_shape", "x_out_dtype", "logits_out"]


@pytest.mark.parametrize("case", ARGMAX_REFUSALS)
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_wrappers_refuse_an_argmax_the_kernels_do_not_take(kind, case):
    """`_check_fusion` refuses the argmax epilogue with another epilogue,
    without the norm, with the qk epilogue, over a non-power-of-two
    width, and with codes, ptab, x_out or logits of the wrong shape or
    type, on every device; the well-formed call passes."""
    x, wargs, kw = _argmax_refusal(kind, case)
    fn, _ = FNS[kind]
    with pytest.raises(ValueError):
        fn(x, *wargs, **kw)
    x, wargs, kw = _argmax_refusal(kind, "none")
    fn(x, *wargs, **kw)


# ------------------------------------------------------------------ routing
class _Recorder:
    """An op set that runs the plain versions and records each call: the
    op's name, and for the products their fusions (+norm, +silu, +qk,
    +kv)."""

    def __init__(self, drop_kv=False):
        self.calls = []
        self.caches = []

        def wrap(name, fn):
            def call(*a, **kw):
                if drop_kv:
                    kw.pop("kv", None)
                tags = "".join(f"+{t}" for t, on in (
                    ("norm", kw.get("norm") is not None),
                    ("silu", kw.get("act") == "silu"),
                    ("qk", kw.get("qk") is not None),
                    ("kv", kw.get("kv") is not None)) if on)
                self.calls.append(name + tags)
                if name == "decode_attention":
                    self.caches.append((a[1].clone(), a[6]))
                return fn(*a, **kw)
            return call
        self.ops = SimpleNamespace(**{n: wrap(n, f) for n, f in
                                      vars(chain.PLAIN).items()})

    def count(self, name):
        return sum(c == name for c in self.calls)


def _talker_inputs(B=2):
    tc = tiny_engine_config().talker
    g = torch.Generator().manual_seed(0)
    params = tdecoder.init_decoder(g, tc)
    cache = tdecoder.init_kv_cache(tc, B, length=64)
    x = 0.1 * torch.randn(B, tc.hidden, generator=g)
    pos = torch.full((B,), 5, dtype=torch.int32)
    pad = torch.zeros(B, dtype=torch.int32)
    return tc, params, x, pos, pad, cache


def test_layer_pass_runs_five_ops():
    tc, params, x, pos, pad, cache = _talker_inputs()
    rec = _Recorder()
    nq, nk, hd = tc.n_q_heads, tc.n_kv_heads, tc.head_dim
    B = x.shape[0]
    cos, sin = rope.rope_angles(rope.mrope_positions(pos[:, None]),
                                tc.mrope_sections, hd, tc.rope_theta)
    chain.layer_pass(rec.ops, params["layers"], 0, tc, x.clone(),
                     cos[:, 0].contiguous(), sin[:, 0].contiguous(),
                     cache["k"], cache["v"], torch.empty(B, nq, hd),
                     torch.empty(B, nk, hd), torch.empty(B, nk, hd), pos,
                     pad)
    assert rec.calls == ["gemv+norm+qk", "decode_attention", "gemv",
                         "gemv+norm", "gemv+silu"]


def _predictor_inputs():
    cfg = tiny_engine_config()
    pc = cfg.predictor
    g = torch.Generator().manual_seed(1)
    params = tdecoder.init_decoder(g, pc)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176,
                                  dim=cfg.talker.hidden, proj_dim=pc.hidden)
    ptab, rows = fused_predictor.make_ptab(assets, pc)
    h = torch.randn(2, pc.hidden, generator=g)
    return pc, params, ptab, rows, h, torch.tensor([5, 3000])


def test_predictor_frame_stores_kv_in_the_qkv_launch():
    pc, params, ptab, rows, h, code0 = _predictor_inputs()
    rec = _Recorder()
    codes = fused_predictor._frame(rec.ops, params, pc, ptab, rows, h, code0)
    nb, L = codes.shape[1], pc.n_layers
    assert rec.count("gemv+norm+qk+kv") == nb * L
    assert rec.count("gemv+silu") == nb * L
    assert torch.equal(codes, fused_predictor.frame_codes_fused_plain(
        params, pc, ptab, rows, h, code0))
    # at each pass's attention of layer l, slot p already holds the pass's
    # k (stored by the qkv launch) and the later slots are still empty
    for i, (k_cache, kv_len) in enumerate(rec.caches):
        p, l = i // L, i % L
        assert int(kv_len[0]) == p
        assert k_cache[l, :, :, p].abs().sum() > 0
        assert k_cache[l, :, :, p + 1:].abs().sum() == 0


def test_predictor_frame_does_no_copy_into_its_cache():
    """With the KV store dropped from the qkv launches, nothing writes the
    frame cache: every attention of the frame sees it empty."""
    pc, params, ptab, rows, h, code0 = _predictor_inputs()
    rec = _Recorder(drop_kv=True)
    fused_predictor._frame(rec.ops, params, pc, ptab, rows, h, code0)
    assert len(rec.caches) == 16 * pc.n_layers
    assert all(k.abs().sum() == 0 for k, _ in rec.caches)


def test_talker_step_writes_its_cache_after_the_step():
    tc, params, x, pos, pad, cache = _talker_inputs()
    rec = _Recorder()
    k0 = cache["k"].clone()
    _, _, k_cache, _ = fused_talker._step(rec.ops, params, tc, x, pos, 5,
                                          pos, pad, cache["k"], cache["v"])
    assert rec.count("gemv+norm+qk") == tc.n_layers    # no KV store
    assert rec.count("gemv+norm+qk+kv") == 0
    # every attention saw the pre-step cache; the step wrote slot 5 after
    assert all(torch.equal(k, k0) for k, _ in rec.caches)
    assert k_cache[:, :, :, 5].abs().sum() > 0
    k_cache[:, :, :, 5] = k0[:, :, :, 5]
    assert torch.equal(k_cache, k0)


# ------------------------------------------------------ launch codes, ABI
def test_launch_codes_counters_and_qk_args():
    """The codes and C arguments a CUDA launch would get, and the counters
    it would bump (`_Launch`, on CPU tensors: nothing is launched)."""
    hd, M = 16, 2
    x, w, ln, qn, kn, cos, sin = _qk_inputs(M, hd, torch.float32, seed=0)
    qk = _qk_args(qn, kn, cos, sin, torch.float32)
    out = tuple(torch.empty(M, n, hd) for n in (NQ, NK, NK))
    cache = torch.zeros(2, L_C, M, NK, T_C, hd)
    views = (cache[0, 1, :, :, SLOT], cache[1, 1, :, :, SLOT])
    fn = SimpleNamespace(**{c: 0 for c in gemv.COUNTERS})
    lq = gemv._Launch((torch.from_numpy(ln), EPS), None, qk, views,
                      gemv.EPI_STORE_DT, out)
    assert (lq.pro, lq.epilogue) == (gemv.PRO_NORM, gemv.EPI_QK)
    a = lq.args
    assert (a.nq, a.nk, a.hd, a.kc, a.vc) == (
        NQ, NK, hd, views[0].data_ptr(), views[1].data_ptr())
    assert (a.kc_sb, a.kc_sh) == (NK * T_C * hd, T_C * hd) \
        == views[0].stride()[:2]
    assert lq.qk_ptr() == ctypes.addressof(a)
    lq.count(fn)
    ls = gemv._Launch(None, "silu", None, None, gemv.EPI_ADD_F32, None)
    assert (ls.pro, ls.epilogue, ls.qk_ptr()) == (gemv.PRO_SILU,
                                                  gemv.EPI_ADD_F32, None)
    ls.count(fn)
    codes = torch.zeros(M, 16, dtype=torch.int32)
    ptab = torch.zeros(16, 40, K)
    x_out = torch.empty(M, K)
    ws = torch.zeros(gemv.MAX_M + gemv.MAX_M // 2, dtype=torch.int64)
    la = gemv._Launch((torch.from_numpy(ln), EPS), None, None, None,
                      gemv.EPI_F32_ROUND_DT, None,
                      (codes, 3, ptab, 33, x_out), ws)
    assert (la.pro, la.epilogue, la.qk_ptr()) == (gemv.PRO_NORM,
                                                  gemv.EPI_ARGMAX, None)
    a = la.am
    assert (a.codes, a.ptab, a.x_out, a.keys, a.tickets) == (
        codes.data_ptr(), ptab[3].data_ptr(), x_out.data_ptr(),
        ws.data_ptr(), ws.data_ptr() + 8 * gemv.MAX_M)
    assert (a.ncodes, a.q, a.rows0, a.R, a.H) == (16, 3, 33, 40, K)
    assert la.am_ptr() == ctypes.addressof(a) and lq.am_ptr() is None
    la.count(fn)
    assert vars(fn) == {"launches": 3, "norm_launches": 2,
                        "silu_launches": 1, "qk_launches": 1,
                        "kv_launches": 1, "argmax_launches": 1}


def test_qk_args_match_the_c_struct():
    """ops/gemv.py _QkArgs lists csrc/gemv.cuh QkArgs's fields in order,
    with the C sizes (9 pointers, 4 long longs, 3 ints, a float)."""
    text = open(build.CSRC_DIR + "/gemv.cuh").read()
    body = text[text.index("struct QkArgs {"):].split("};")[0]
    names = re.findall(r"(\w+)\s*[,;]", body)
    assert names == [f for f, _ in gemv._QkArgs._fields_]
    assert ctypes.sizeof(gemv._QkArgs) == 9 * 8 + 4 * 8 + 3 * 4 + 4


def test_argmax_args_match_the_c_struct():
    """ops/gemv.py _ArgmaxArgs lists csrc/gemv.cuh ArgmaxArgs's fields in
    order, with the C sizes (5 pointers, 5 ints)."""
    text = open(build.CSRC_DIR + "/gemv.cuh").read()
    body = text[text.index("struct ArgmaxArgs {"):].split("};")[0]
    names = re.findall(r"(\w+)\s*[,;]", body)
    assert names == [f for f, _ in gemv._ArgmaxArgs._fields_]
    assert ctypes.sizeof(gemv._ArgmaxArgs) == 5 * 8 + 5 * 4 + 4   # padded


def test_launch_counts_name_the_fused_pieces():
    chain.reset_launch_counts()
    counts = chain.launch_counts()
    fused = {"rms_norm_gemv", "qk_rope_gemv", "silu_gemv", "kv_store_gemv",
             "argmax_gather_gemv"}
    assert fused <= set(counts)
    assert not {"qk_norm_rope", "silu_mul", "argmax_gather"} & set(counts)
    assert all(v == 0 for v in counts.values())
