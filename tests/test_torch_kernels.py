"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card (marker `cuda`; every test skips where there is no card).

This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_kernels.py -q

Tolerances: f32 rtol/atol 1e-4 (the kernels sum in another order than
PyTorch); bf16 outputs within one bf16 ulp (relative 2^-7 of the row max).
Codes and gathered rows: exact.
"""

import pytest
import torch

from qwen3_tts_tpu_torch.core.config import tiny_engine_config
from qwen3_tts_tpu_torch.ops import elementwise as el
from qwen3_tts_tpu_torch.ops import flash_decode, fused_predictor
from qwen3_tts_tpu_torch.ops import fused_talker
from qwen3_tts_tpu_torch.ops import gemv as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run there only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(shape, generator=g, device=g.device)).to(dtype)


def _close(a, b, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-4, atol=1e-4)
    else:
        err = (a.float() - b.float()).abs().max()
        assert err <= 2 ** -7 * b.float().abs().max(), float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,col0,n", [(1, 2048, 4096, 0, None),
                                          (3, 1024, 3072, 0, None),
                                          (1, 1024, 8192, 2048, 2048),
                                          (9, 128, 264, 8, 256)])
def test_gemv(dev, dtype, M, K, N, col0, n):
    g = torch.Generator(device=dev).manual_seed(0)
    x, w = _randn(g, M, K, dtype=dtype), _randn(g, K, N, dtype=dtype,
                                                 scale=0.02)
    for epi in (G.EPI_STORE_DT, G.EPI_F32, G.EPI_F32_ROUND_DT):
        _close(G.gemv(x, w, col0=col0, n=n, epilogue=epi),
               G.gemv_plain(x, w, col0=col0, n=n, epilogue=epi), dtype)
    res = _randn(g, M, n or N)
    _close(G.gemv(x, w, col0=col0, n=n, epilogue=G.EPI_ADD_F32,
                  out=res.clone()),
           G.gemv_plain(x, w, col0=col0, n=n, epilogue=G.EPI_ADD_F32,
                        out=res.clone()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,T,lens,vfrom", [
    (16, 8, 1024, (0, 1), (0, 0)), (16, 8, 600, (599, 37), (3, 20)),
    (8, 8, 32, (15, 2), (0, 0)), (4, 2, 100, (64, 33), (31, 32))])
def test_decode_attention(dev, dtype, nq, nk, T, lens, vfrom):
    g = torch.Generator(device=dev).manual_seed(1)
    hd = 128 if nq >= 8 else 16
    B = len(lens)
    q = _randn(g, B, nq, hd, dtype=dtype)
    kc, vc = (_randn(g, 2, B, nk, T, hd, dtype=dtype) for _ in range(2))
    kn, vn = (_randn(g, B, nk, hd, dtype=dtype) for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    vfrom = torch.tensor(vfrom, dtype=torch.int32, device=dev)
    _close(flash_decode.decode_attention_stacked(q, kc, vc, kn, vn, 1, lens,
                                                 vfrom),
           flash_decode.decode_attention_plain(q, kc, vc, kn, vn, 1, lens,
                                               vfrom), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elementwise(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x, w = _randn(g, 2, 2048), _randn(g, 2048, dtype=dtype)
    _close(el.rms_norm(x, w, 1e-6, dtype), el.rms_norm_plain(x, w, 1e-6,
                                                              dtype), dtype)
    qkv = _randn(g, 2, 32 * 128, dtype=dtype)
    qn, kn = _randn(g, 128, dtype=dtype), _randn(g, 128, dtype=dtype)
    cos, sin = _randn(g, 2, 128), _randn(g, 2, 128)
    for a, b in zip(el.qk_norm_rope(qkv, qn, kn, cos, sin, 16, 8, 1e-6),
                    el.qk_norm_rope_plain(qkv, qn, kn, cos, sin, 16, 8,
                                          1e-6)):
        _close(a, b, dtype)
    gu = _randn(g, 2, 2 * 6144)
    _close(el.silu_mul(gu, dtype), el.silu_mul_plain(gu, dtype), dtype)


def test_argmax_gather_exact(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ptab = _randn(g, 16, 3584, 1024, dtype=torch.bfloat16)
    logits = _randn(g, 3, 2048)
    logits[0, [100, 900]] = 50.0
    logits[1, 2047] = 60.0
    out = []
    for fn in (el.argmax_gather, el.argmax_gather_plain):
        codes = torch.zeros(3, 16, dtype=torch.int32, device=dev)
        xo = torch.zeros(3, 1024, device=dev)
        fn(logits, codes, 4, ptab, 2000, xo)
        out.append((codes, xo))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][0][:2, 4].tolist() == [100, 2047]


def test_fused_steps_match_plain_tiny_f32(dev):
    """The talker step and the predictor frame, chained kernels against the
    chained plain versions, on the tiny f32 config."""
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.models import decoder

    cfg = tiny_engine_config()
    tc, pc = cfg.talker, cfg.predictor
    g = torch.Generator(device=dev).manual_seed(4)
    tp = decoder.init_decoder(g, tc, device=dev)
    pp = decoder.init_decoder(g, pc, device=dev)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176,
                                  dim=tc.hidden, proj_dim=pc.hidden,
                                  device=dev)
    cache = decoder.init_kv_cache(tc, 2, length=256, device=dev)
    cache["k"].copy_(_randn(g, *cache["k"].shape))
    cache["v"].copy_(_randn(g, *cache["v"].shape))
    x = _randn(g, 2, tc.hidden)
    slot = torch.tensor([40, 40], dtype=torch.int32, device=dev)
    pad = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    a = fused_talker.talker_step_fused(tp, tc, x, slot - pad, 40, slot, pad,
                                       cache["k"].clone(), cache["v"].clone())
    b = fused_talker.talker_step_fused_plain(tp, tc, x, slot - pad, 40, slot,
                                             pad, cache["k"].clone(),
                                             cache["v"].clone())
    for u, v in zip(a, b):
        _close(u, v, torch.float32)
    ptab, rows = fused_predictor.make_ptab(assets, pc)
    h = _randn(g, 3, pc.hidden)
    code0 = torch.tensor([5, 3000, -2], device=dev)
    assert torch.equal(
        fused_predictor.frame_codes_fused(pp, pc, ptab, rows, h, code0),
        fused_predictor.frame_codes_fused_plain(pp, pc, ptab, rows, h, code0))
