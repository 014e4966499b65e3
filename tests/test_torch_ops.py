"""The port's ops against the JAX package's on the CPU: RoPE, dense GQA
attention, rms norm, linear, and the plain versions of the decode-attention,
gemv and elementwise kernels. Inputs are made with numpy from a seed and
handed to both packages. f32 throughout; tolerance atol 1e-5 (reduction
order differs between the two frameworks).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import decoder as jdecoder
from qwen3_tts_tpu.ops import attention as jattention
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops import rope as jrope
from qwen3_tts_tpu_torch.models import decoder as tdecoder
from qwen3_tts_tpu_torch.ops import attention as tattention
from qwen3_tts_tpu_torch.ops import elementwise as el
from qwen3_tts_tpu_torch.ops import flash_decode, gemv, quant, rope

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("sections,hd", [((4, 2, 2, 0), 16),
                                         ((8, 0, 0, 0), 16),
                                         ((24, 20, 20, 0), 128)])
def test_rope_matches_jax(sections, hd):
    rng = _rng(1)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    tc, ts = rope.rope_angles(rope.mrope_positions(torch.from_numpy(pos)),
                              sections, hd, 1e6)
    jc, js = jrope.rope_angles(jrope.mrope_positions(jnp.asarray(pos)),
                               sections, hd, 1e6)
    _close(tc, jc)
    _close(ts, js)
    _close(rope.apply_rope(torch.from_numpy(x), tc, ts),
           jrope.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("S", [1, 4])
def test_gqa_attention_matches_jax(S):
    rng = _rng(2)
    B, nq, nk, T, hd = 2, 4, 2, 16, 8
    q = rng.standard_normal((B, S, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, nk, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, nk, T, hd)).astype(np.float32)
    q_start = np.asarray([5, 9], np.int32)
    kv_len = q_start + S
    vfrom = np.asarray([0, 3], np.int32)
    t = tattention.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(q_start),
                                 torch.from_numpy(kv_len),
                                 torch.from_numpy(vfrom))
    j = jattention.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(q_start),
                                 jnp.asarray(kv_len), jnp.asarray(vfrom))
    _close(t, j)


def test_rms_norm_and_plain_kernel_match_jax():
    rng = _rng(3)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    j = jdecoder.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(tdecoder.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           j)
    _close(el.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                       torch.float32), j)


def test_linear_dense_and_quantized_raises():
    """Dense `linear` matches JAX; a weight dict that is neither int8
    (q, scale) nor int4 (q4, m8, scale) raises. The quantized kinds are
    held against JAX in tests/test_torch_quant.py."""
    rng = _rng(4)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    _close(quant.linear(torch.from_numpy(x), torch.from_numpy(w)),
           jquant.linear(jnp.asarray(x), jnp.asarray(w)))
    with pytest.raises(ValueError, match="q4/m8/scale"):
        quant.linear(torch.from_numpy(x),
                     {"q": torch.zeros(32, 24, dtype=torch.int8)})


@pytest.mark.parametrize("kv_len,vfrom,T", [
    ((7, 12), (0, 4), 16),          # left-padded second row
    ((0, 0), (0, 0), 16),           # empty cache: only the current token
    ((90, 70), (3, 40), 100),       # several 32-slot tiles, ragged tail
], ids=["valid_from", "kv_len0", "multi_tile"])
def test_decode_attention_plain_matches_dense_jax(kv_len, vfrom, T):
    rng = _rng(5)
    L, B, nq, nk, hd = 3, 2, 4, 2, 16
    layer = 1
    q = rng.standard_normal((B, nq, hd)).astype(np.float32)
    kc = rng.standard_normal((L, B, nk, T, hd)).astype(np.float32)
    vc = rng.standard_normal((L, B, nk, T, hd)).astype(np.float32)
    kn = rng.standard_normal((B, nk, hd)).astype(np.float32)
    vn = rng.standard_normal((B, nk, hd)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    vfrom = np.asarray(vfrom, np.int32)
    # JAX dense reference: write the token at its slot, then attend with
    # the slot as the query position
    kj, vj = kc[layer].copy(), vc[layer].copy()
    for b in range(B):
        kj[b, :, kv_len[b]] = kn[b]
        vj[b, :, kv_len[b]] = vn[b]
    ref = jattention.gqa_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kj), jnp.asarray(vj),
        jnp.asarray(kv_len), jnp.asarray(kv_len + 1),
        jnp.asarray(vfrom))[:, 0]
    args = [torch.from_numpy(a) for a in (q, kc, vc, kn, vn)]
    lens = (torch.from_numpy(kv_len), torch.from_numpy(vfrom))
    _close(flash_decode.decode_attention_plain(*args, layer, *lens), ref)
    # the wrapper takes the plain version for CPU tensors
    _close(flash_decode.decode_attention_stacked(*args, layer, *lens), ref)


@pytest.mark.parametrize("epilogue", [gemv.EPI_STORE_DT, gemv.EPI_F32,
                                      gemv.EPI_F32_ROUND_DT,
                                      gemv.EPI_ADD_F32])
def test_gemv_plain_matches_matmul(epilogue):
    rng = _rng(6)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 4 * 32)).astype(np.float32)
    col0, n = 2 * 32, 32                 # a head slice at a column offset
    ref = x @ w[:, col0:col0 + n]
    res = rng.standard_normal((3, n)).astype(np.float32)
    out = torch.from_numpy(res.copy()) \
        if epilogue == gemv.EPI_ADD_F32 else None
    got = gemv.gemv(torch.from_numpy(x), torch.from_numpy(w), col0=col0,
                    n=n, epilogue=epilogue, out=out)
    want = ref + res if epilogue == gemv.EPI_ADD_F32 else ref
    _close(got, want, atol=1e-4)


def test_gemv_plain_rounds_through_bf16():
    rng = _rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    acc = xb.float() @ wb.float()
    got = gemv.gemv_plain(xb, wb, epilogue=gemv.EPI_F32_ROUND_DT)
    assert got.dtype == torch.float32
    assert torch.equal(got, acc.bfloat16().float())
    assert gemv.gemv_plain(xb, wb).dtype == torch.bfloat16


def test_silu_mul_plain_matches_jax_formula():
    rng = _rng(8)
    gu = rng.standard_normal((3, 2 * 48)).astype(np.float32)
    g, u = jnp.asarray(gu[:, :48]), jnp.asarray(gu[:, 48:])
    _close(el.silu_mul_plain(torch.from_numpy(gu), torch.float32),
           g / (1.0 + jnp.exp(-g)) * u)


def test_qk_norm_rope_plain_matches_jax():
    rng = _rng(9)
    B, nq, nk, hd = 2, 4, 2, 16
    qkv = rng.standard_normal((B, (nq + 2 * nk) * hd)).astype(np.float32)
    qn = rng.standard_normal(hd).astype(np.float32)
    kn = rng.standard_normal(hd).astype(np.float32)
    pos = np.asarray([3, 11], np.int32)
    jc, js = jrope.rope_angles(jrope.mrope_positions(jnp.asarray(pos)[:, None]),
                               (4, 2, 2, 0), hd, 1e6)
    heads = jnp.asarray(qkv).reshape(B, 1, nq + 2 * nk, hd)
    jq = jrope.apply_rope(jdecoder.rms_norm(heads[:, :, :nq],
                                            jnp.asarray(qn), 1e-6), jc, js)
    jk = jrope.apply_rope(jdecoder.rms_norm(heads[:, :, nq:nq + nk],
                                            jnp.asarray(kn), 1e-6), jc, js)
    q, k, v = el.qk_norm_rope_plain(
        torch.from_numpy(qkv), torch.from_numpy(qn), torch.from_numpy(kn),
        torch.from_numpy(np.array(jc[:, 0])),
        torch.from_numpy(np.array(js[:, 0])), nq, nk, 1e-6)
    _close(q, jq[:, 0])
    _close(k, jk[:, 0])
    _close(v, heads[:, 0, nq + nk:], atol=0)


def _jax_argmax_row(lg):
    """The greedy code of JAX's predictor kernel (`argmax_row`,
    qwen3_tts_tpu/ops/fused_predictor.py:465-469) of numpy logits [B, CV]:
    min(where(lg >= max, iota, CV))."""
    lg = jnp.asarray(lg)
    m = jnp.max(lg, axis=-1, keepdims=True)
    iota = jax.lax.broadcasted_iota(jnp.int32, lg.shape, 1)
    return np.asarray(jnp.min(jnp.where(lg >= m, iota, lg.shape[1]), axis=-1))


def test_argmax_gather_plain_ties_and_bias_row():
    """JAX's `argmax_row` order, NaN included: the lowest index on ties,
    code CV for a row holding a NaN (JAX: max NaN, no element >= it), and
    the gathered row ptab[q][sel(code)] with the bias row past the real
    rows."""
    B, CV, R, H = 6, 2048, 10, 8
    logits = torch.from_numpy(_rng(4).integers(-3, 3, (B, CV)).astype(
        np.float32))
    logits[0, [5, 9]] = 4.0              # tie: the lowest index wins
    logits[1, 7] = 4.0
    logits[2, 2047] = 5.0                # past the real rows: bias row
    logits[3, [1, 3]] = 6.0              # a tie, and a NaN in the row
    logits[3, 900] = float("nan")
    logits[4] = float("-inf")            # all -inf: index 0
    logits[5, 2047] = float("nan")       # a NaN at the last column
    ptab = torch.arange(2 * R * H, dtype=torch.float32).reshape(2, R, H)
    codes = torch.zeros(B, 16, dtype=torch.int32)
    x = torch.empty(B, H)
    el.argmax_gather_plain(logits, codes, 1, ptab, R - 1, x)
    want = _jax_argmax_row(logits.numpy())
    assert want.tolist() == [5, 7, 2047, CV, 0, CV]
    assert codes[:, 1].tolist() == want.tolist()
    sel = np.where(want < R - 1, want, R - 1)
    assert torch.equal(x, ptab[1][torch.from_numpy(sel)])
