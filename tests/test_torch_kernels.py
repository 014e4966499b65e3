"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card (marker `cuda`; every test skips where there is no card).

This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_kernels.py -q

Tolerances: f32 rtol/atol 1e-4 (the kernels sum in another order than
PyTorch); bf16 outputs within one bf16 ulp (relative 2^-7 of the row max).
Codes and gathered rows: exact (the head slice's argmax epilogue against
`argmax_gather_plain` on the launch's own logits, and against the plain
head slice where the logits decide). Kernel A (qmatmul) outputs f32 from
bf16 inputs, exact products: f32 tolerances for both x dtypes. The eight
capability probes (`csrc/probes.cu`; int8_panel through kernel A): exact
(rot bit for bit, its NaN included), except the int8 panel's f32 sums
(max |d| <= 1e-5 of the output's largest magnitude: exact products,
another order of the sums).
"""

import dataclasses

import pytest
import torch

from qwen3_tts_tpu_torch.core.config import tiny_engine_config
from qwen3_tts_tpu_torch.ops import elementwise as el
from qwen3_tts_tpu_torch.ops import flash_decode, fused_predictor
from qwen3_tts_tpu_torch.ops import fused_talker
from qwen3_tts_tpu_torch.ops import gemv as G
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.tools import mosaic_probe

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
                                          (9, 128, 264, 8, 256),
                                          (1, 1024, 6144, 0, None),
                                          (2, 3072, 1024, 0, None),
                                          (2, 1024, 32768, 30720, 2048),
                                          (32, 6144, 2048, 0, None)])
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
@pytest.mark.parametrize("M,K,N,col0,n", [(1, 2048, 4096, 0, None),
                                          (3, 1024, 3072, 0, None),
                                          (8, 1024, 8192, 2048, 2048),
                                          (32, 6144, 2048, 0, None),
                                          (9, 256, 264, 8, 256),
                                          (1, 1024, 6144, 0, None),
                                          (2, 3072, 1024, 0, None),
                                          (1, 1024, 1024, 0, None)])
def test_gemv_quantized(dev, dtype, M, K, N, col0, n):
    """B8 and B4 against their plain versions, every epilogue."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = _randn(g, M, K, dtype=dtype)
    w = _randn(g, K, N, scale=0.02)
    q8, q4 = quant.quantize(w), quant.quantize_int4(w)
    calls = [(G.gemv_int8, G.gemv_int8_plain, (q8["q"], q8["scale"])),
             (G.gemv_int4, G.gemv_int4_plain,
              (q4["q4"], q4["m8"], q4["scale"]))]
    for fn, plain, wargs in calls:
        for epi in (G.EPI_STORE_DT, G.EPI_F32, G.EPI_F32_ROUND_DT):
            _close(fn(x, *wargs, col0=col0, n=n, epilogue=epi),
                   plain(x, *wargs, col0=col0, n=n, epilogue=epi), dtype)
        res = _randn(g, M, n or N)
        _close(fn(x, *wargs, col0=col0, n=n, epilogue=G.EPI_ADD_F32,
                  out=res.clone()),
               plain(x, *wargs, col0=col0, n=n, epilogue=G.EPI_ADD_F32,
                     out=res.clone()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,col0,n", [(1, 2048, 4096, 0, None),
                                          (2, 2048, 12288, 0, None),
                                          (1, 1024, 3072, 0, None),
                                          (8, 1024, 32768, 30720, 2048),
                                          (3, 512, 264, 8, 256),
                                          (32, 2048, 2176, 0, None)])
def test_gemv_fused_norm(dev, dtype, M, K, N, col0, n):
    """B, B8 and B4 with the rms norm as their prologue (x the f32
    residual) against rms_norm_plain + the plain product, every epilogue."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = _randn(g, M, K, scale=3.0)
    ln = (1.0 + 0.1 * _randn(g, K)).to(dtype)
    w = _randn(g, K, N, scale=0.02)
    q8, q4 = quant.quantize(w), quant.quantize_int4(w)
    calls = [(G.gemv, G.gemv_plain, (w.to(dtype),)),
             (G.gemv_int8, G.gemv_int8_plain, (q8["q"], q8["scale"])),
             (G.gemv_int4, G.gemv_int4_plain,
              (q4["q4"], q4["m8"], q4["scale"]))]
    res = _randn(g, M, n or N)
    for fn, plain, wargs in calls:
        for epi in (G.EPI_STORE_DT, G.EPI_F32, G.EPI_F32_ROUND_DT,
                    G.EPI_ADD_F32):
            kw = dict(col0=col0, n=n, epilogue=epi, norm=(ln, 1e-6),
                      dt=dtype)
            out = (lambda: res.clone()) if epi == G.EPI_ADD_F32 \
                else (lambda: None)
            _close(fn(x, *wargs, out=out(), **kw),
                   plain(x, *wargs, out=out(), **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 37, 64, 128, 192, 1088])
@pytest.mark.parametrize("K,N", [(2048, 4096), (2048, 2048), (2048, 12288),
                                 (6144, 2048), (2048, 2176), (256, 384)])
def test_qmatmul(dev, dtype, M, K, N):
    """Kernel A against its plain version at the talker's prefill shapes:
    ragged M is zero-filled by TMA and never stored, K is split across a
    cluster where the output tiles are few; a repeat gives the same bits
    (the cluster sums its ranks in rank order)."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, M, K, dtype=dtype)
    qw = quant.quantize(_randn(g, K, N, scale=0.02))
    got = quant.qmatmul_kernel(x, qw["q"], qw["scale"])
    _close(got, quant.qmatmul_kernel_plain(x, qw["q"], qw["scale"]),
           torch.float32)
    assert torch.equal(got, quant.qmatmul_kernel(x, qw["q"], qw["scale"]))


@pytest.mark.parametrize("M", [1, 64, 300])
def test_qmatmul_column_view(dev, M):
    """Kernel A on a column view of a wider int8 weight (row stride > N),
    as a slice of a head: the TMA map reads the view's N columns only."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _randn(g, M, 2048, dtype=torch.bfloat16)
    qw = quant.quantize(_randn(g, 2048, 4096, scale=0.02))
    q, sc = qw["q"][:, 1024:1024 + 2176], qw["scale"][1024:1024 + 2176]
    assert q.stride(0) == 4096
    _close(quant.qmatmul_kernel(x, q, sc),
           quant.qmatmul_kernel_plain(x, q, sc), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 2, 16, 32, 64])
@pytest.mark.parametrize("K,N", [(1024, 4096), (1024, 1024), (1024, 6144),
                                 (3072, 1024), (1024, 2048)])
def test_qmatmul_predictor_shapes(dev, dtype, M, K, N):
    """Kernel A at the int8 predictor's products (`models/predictor.py`):
    qkv, wo, gate/up and down, and a head slice (a 2048-column view of the
    32768-column head, as `decoder.head_logits` takes it), at M = B (a
    single-token step), 2B (the prefill) and 16B (a Jacobi pass)."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = _randn(g, M, K, dtype=dtype)
    if N == 2048:
        qw = quant.quantize(_randn(g, K, 16 * N, scale=0.02))
        q, sc = qw["q"][:, 5 * N:6 * N], qw["scale"][5 * N:6 * N]
    else:
        qw = quant.quantize(_randn(g, K, N, scale=0.02))
        q, sc = qw["q"], qw["scale"]
    got = quant.qmatmul_kernel(x, q, sc)
    _close(got, quant.qmatmul_kernel_plain(x, q, sc), torch.float32)
    assert torch.equal(got, quant.qmatmul_kernel(x, q, sc))


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_predictor_frame_codes_and_jacobi_f32_equal_cpu(dev, kind):
    """`models/predictor.py` on the card, f32 at MID_PREDICTOR's widths
    (multiples of 128, so int8 weights take kernel A; decode attention in
    frame_codes's steps): frame_codes and frame_codes_jacobi with zero,
    oracle and adversarial drafts equal each other and the CPU's codes."""
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.models import decoder, predictor

    cfg = dataclasses.replace(tiny_engine_config().predictor,
                              **dict(MID_PREDICTOR, dtype="float32"))
    g = torch.Generator().manual_seed(12)
    p = decoder.init_decoder(g, cfg, scale=0.5)
    if kind == "int8":
        p = quant.quantize_decoder_params(p, kind="int8")
    a = tables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                             proj_dim=cfg.hidden)
    h = torch.randn(3, cfg.hidden, generator=g)
    c0 = torch.randint(0, 2048, (3,), generator=g)
    want = predictor.frame_codes(p, cfg, a, h, c0)

    def to(t):
        return {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(dev)

    pd = to(p)
    ad = tables.Assets(*(getattr(a, f.name).to(dev)
                         for f in dataclasses.fields(a)))
    hd, cd = h.to(dev), c0.to(dev)
    a_launches = quant.qmatmul_kernel.launches
    d_launches = flash_decode.decode_attention_stacked.launches
    got = predictor.frame_codes(pd, cfg, ad, hd, cd)
    assert torch.equal(got.cpu(), want)
    assert flash_decode.decode_attention_stacked.launches > d_launches
    if kind == "int8":
        assert quant.qmatmul_kernel.launches > a_launches
    for draft in (None, want[:, 1:], (want[:, 1:] + 7) % 2048):
        jac = predictor.frame_codes_jacobi(
            pd, cfg, ad, hd, cd, None if draft is None else draft.to(dev))
        assert torch.equal(jac.cpu(), want)
    assert predictor.frame_codes_jacobi.passes <= 15


@pytest.mark.parametrize("case", ["k_not_128", "n_not_128", "ldq_odd",
                                  "q_misaligned", "scale_f16"])
def test_qmatmul_refuses(dev, case):
    """No fallback: a CUDA tensor kernel A cannot take raises."""
    g = torch.Generator(device=dev).manual_seed(8)
    K, N = (192 if case == "k_not_128" else 256,
            192 if case == "n_not_128" else 256)
    x = _randn(g, 4, K, dtype=torch.bfloat16)
    qw = quant.quantize(_randn(g, K, N + 16, scale=0.02))
    q, sc = qw["q"][:, :N], qw["scale"][:N].contiguous()
    if case == "ldq_odd":
        q = quant.quantize(_randn(g, K, N + 1))["q"][:, :N]
    if case == "q_misaligned":
        q = qw["q"][:, 8:8 + N]
    if case == "scale_f16":
        sc = sc.half()
    with pytest.raises((ValueError, TypeError)):
        quant.qmatmul_kernel(x, q, sc)


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


@pytest.mark.parametrize("nq,nk,T,lens,vfrom,qdt,cdt", [
    # the predictor's mix: bf16 q over an f32 cache, <= 15 live slots
    (8, 8, 32, (15, 8), (0, 0), torch.bfloat16, torch.float32),
    (8, 8, 32, (0, 1), (0, 0), torch.bfloat16, torch.float32),
    # the stream path's 4096-slot cache with a short live range
    (16, 8, 4096, (96, 100), (0, 37), torch.bfloat16, torch.bfloat16),
    (16, 8, 4096, (5, 64), (3, 64), torch.bfloat16, torch.bfloat16),
    (16, 8, 4096, (100, 1), (0, 0), torch.float32, torch.bfloat16)])
def test_decode_attention_mixed_dtypes_and_stream_cache(dev, nq, nk, T, lens,
                                                        vfrom, qdt, cdt):
    g = torch.Generator(device=dev).manual_seed(8)
    B = len(lens)
    q = _randn(g, B, nq, 128, dtype=qdt)
    kc, vc = (_randn(g, 2, B, nk, T, 128, dtype=cdt) for _ in range(2))
    kn, vn = (_randn(g, B, nk, 128, dtype=qdt) for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    vfrom = torch.tensor(vfrom, dtype=torch.int32, device=dev)
    _close(flash_decode.decode_attention_stacked(q, kc, vc, kn, vn, 0, lens,
                                                 vfrom),
           flash_decode.decode_attention_plain(q, kc, vc, kn, vn, 0, lens,
                                               vfrom), qdt)


def _bit_identical(fn):
    """fn() twice and in a CUDA graph replayed twice: equal bits."""
    a, b = fn().clone(), fn().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    return all(torch.equal(a, t) for t in (b, *replays))


def test_cluster_kernels_repeat_and_graph_replay_bit_identical(dev):
    """B, B8, B4 (with and without the norm prologue, with the silu prologue
    and the qk epilogue) and decode attention sum in a fixed order: the same
    call twice and two replays of a captured call give the same bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = _randn(g, 2, 2048, dtype=torch.bfloat16)
    w = _randn(g, 2048, 4096, dtype=torch.bfloat16, scale=0.02)
    q8 = quant.quantize(_randn(g, 1024, 3072, scale=0.02))
    x8 = _randn(g, 1, 1024, dtype=torch.bfloat16)
    res = _randn(g, 2, 4096)
    q = _randn(g, 1, 16, 128, dtype=torch.bfloat16)
    kc, vc = (_randn(g, 2, 1, 8, 4096, 128, dtype=torch.bfloat16)
              for _ in range(2))
    kn, vn = (_randn(g, 1, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([97], dtype=torch.int32, device=dev)
    vfrom = torch.tensor([2], dtype=torch.int32, device=dev)
    q4 = quant.quantize_int4(_randn(g, 6144, 2048, scale=0.02))
    x4 = _randn(g, 2, 6144, dtype=torch.bfloat16)
    res4 = _randn(g, 2, 2048)
    xr, ln = _randn(g, 1, 2048), _randn(g, 2048, dtype=torch.bfloat16)
    nb = dict(norm=(ln, 1e-6), dt=torch.bfloat16)
    q4h = quant.quantize_int4(_randn(g, 2048, 1024, scale=0.02))
    calls = [lambda: G.gemv(x, w, epilogue=G.EPI_F32),
             lambda: G.gemv(x, w, epilogue=G.EPI_ADD_F32, out=res.clone()),
             lambda: G.gemv(xr, w, epilogue=G.EPI_F32, **nb),
             lambda: G.gemv_int8(x8, q8["q"], q8["scale"]),
             lambda: G.gemv_int4(x4, q4["q4"], q4["m8"], q4["scale"],
                                 epilogue=G.EPI_ADD_F32, out=res4.clone()),
             lambda: G.gemv_int4(xr, q4h["q4"], q4h["m8"], q4h["scale"],
                                 **nb),
             lambda: flash_decode.decode_attention_stacked(
                 q, kc, vc, kn, vn, 1, lens, vfrom)]
    gu = _randn(g, 2, 2 * 6144)
    qkx, qkln, qk, cache, qkk = _qk_case(g, torch.bfloat16, 1, 1024, 8, 8,
                                         128, True)
    views = (cache[0, 1, :, :, 3], cache[1, 1, :, :, 3])

    def qk_call(fn, wargs):
        def call():
            q, k, v = fn(qkx, *wargs, norm=(qkln, 1e-6), qk=qk, kv=views,
                         dt=torch.bfloat16)
            return torch.cat([q.flatten().float(), k.flatten().float(),
                              v.flatten().float(), cache.flatten()])
        return call
    calls += [lambda: G.gemv_int4(gu, q4["q4"], q4["m8"], q4["scale"],
                                  epilogue=G.EPI_ADD_F32, out=res4.clone(),
                                  act="silu", dt=torch.bfloat16)]
    calls += [qk_call(fn, wargs) for fn, _, wargs in qkk]
    for i, fn in enumerate(calls):
        assert _bit_identical(fn), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elementwise(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x, w = _randn(g, 2, 2048), _randn(g, 2048, dtype=dtype)
    _close(el.rms_norm(x, w, 1e-6, dtype), el.rms_norm_plain(x, w, 1e-6,
                                                              dtype), dtype)


def _qk_case(g, dtype, M, K, nq, nk, hd, kv):
    """Inputs of a qkv product with the qk epilogue: the f32 residual, ln1,
    the three weight kinds, the qk tuple, and (with `kv`) a [2, M, nk, 6,
    hd] f32 cache whose slot 3 of layer 1 is the KV store's target."""
    N = (nq + 2 * nk) * hd
    x = _randn(g, M, K, scale=3.0)
    ln = (1.0 + 0.1 * _randn(g, K)).to(dtype)
    w = _randn(g, K, N, scale=0.02)
    q8, q4 = quant.quantize(w), quant.quantize_int4(w)
    qk = ((1.0 + 0.1 * _randn(g, hd)).to(dtype),
          (1.0 + 0.1 * _randn(g, hd)).to(dtype), _randn(g, M, hd),
          _randn(g, M, hd), nq, nk, 1e-6)
    cache = _randn(g, 2, 2, M, nk, 6, hd) if kv else None
    kinds = [(G.gemv, G.gemv_plain, (w.to(dtype),)),
             (G.gemv_int8, G.gemv_int8_plain, (q8["q"], q8["scale"])),
             (G.gemv_int4, G.gemv_int4_plain,
              (q4["q4"], q4["m8"], q4["scale"]))]
    return x, ln, qk, cache, kinds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,nq,nk,hd,kv", [(1, 2048, 16, 8, 128, False),
                                             (2, 1024, 8, 8, 128, True),
                                             (8, 2048, 16, 8, 128, True),
                                             (3, 512, 4, 2, 64, True),
                                             (2, 256, 4, 2, 16, True)])
def test_gemv_qk_epilogue(dev, dtype, M, K, nq, nk, hd, kv):
    """B, B8 and B4 with the norm prologue and the qk epilogue (QK-norm,
    RoPE, the q/k/v split and the KV store into a strided f32 cache view)
    against the plain fused product; the cache's other slots unchanged."""
    g = torch.Generator(device=dev).manual_seed(12)
    x, ln, qk, cache, kinds = _qk_case(g, dtype, M, K, nq, nk, hd, kv)
    for fn, plain, wargs in kinds:
        outs = []
        for f in (fn, plain):
            c = cache.clone() if kv else None
            views = (c[0, 1, :, :, 3], c[1, 1, :, :, 3]) if kv else None
            q, k, v = f(x, *wargs, norm=(ln, 1e-6), qk=qk, kv=views,
                        dt=dtype)
            outs.append((q, k, v, c))
        (q, k, v, c), (qp, kp, vp, cp) = outs
        for a, b in ((q, qp), (k, kp), (v, vp)):
            _close(a, b, dtype)
        if kv:
            assert torch.equal(c[:, 1, :, :, 3], torch.stack([k, v]).float())
            c[:, 1, :, :, 3] = cp[:, 1, :, :, 3]
            assert torch.equal(c, cp)      # every other slot untouched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 6144, 2048), (2, 3072, 1024),
                                   (8, 6144, 2048), (3, 256, 264)])
def test_gemv_silu_prologue(dev, dtype, M, K, N):
    """B, B8 and B4 with silu*up as their prologue (x the f32 gate/up
    product [M, 2K]) against silu_mul_plain + the plain product."""
    g = torch.Generator(device=dev).manual_seed(13)
    gu = _randn(g, M, 2 * K)
    w = _randn(g, K, N, scale=0.02)
    q8, q4 = quant.quantize(w), quant.quantize_int4(w)
    res = _randn(g, M, N)
    for fn, plain, wargs in ((G.gemv, G.gemv_plain, (w.to(dtype),)),
                             (G.gemv_int8, G.gemv_int8_plain,
                              (q8["q"], q8["scale"])),
                             (G.gemv_int4, G.gemv_int4_plain,
                              (q4["q4"], q4["m8"], q4["scale"]))):
        kw = dict(epilogue=G.EPI_ADD_F32, act="silu", dt=dtype)
        _close(fn(gu, *wargs, out=res.clone(), **kw),
               plain(gu, *wargs, out=res.clone(), **kw), dtype)


def _head_case(dev, kind, B, seed):
    """The predictor's head slice at full width: slice 1 (1024 x 2048) of a
    two-slice head, bf16, the final norm as prologue. Slice 1 holds two
    tied pairs of columns, u at 300 and 700 and -u at 1500 and 1800; x
    row b leans on u (b % 3 == 0), on -u (b % 3 == 1) or on neither (the
    argmax among 2048 random bf16 logits, ties included), and row 1 holds
    an inf (its normed row, so its logits, are NaN: code CV). ptab [16,
    3584, 1024] bf16 with 1024 real rows: codes 1500 and CV select the
    bias row. Returns (kernel, plain, x, weight arguments, norm, ptab,
    real rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    H, CV = 1024, 2048
    w = _randn(g, H, 2 * CV, scale=0.02)
    u = _randn(g, H, scale=0.3)
    for c, sign in ((300, 1), (700, 1), (1500, -1), (1800, -1)):
        w[:, CV + c] = sign * u
    lean = torch.tensor([(1.0, -1.0, 0.0)[b % 3] for b in range(B)],
                        device=dev)
    x = _randn(g, B, H) + 2.0 * lean[:, None] * u / u.norm() * H ** 0.5
    if B > 1:
        x[1, 0] = float("inf")
    norm = ((1.0 + 0.1 * _randn(g, H)).bfloat16(), 1e-6)
    ptab = _randn(g, 16, 3584, H, dtype=torch.bfloat16)
    if kind == "dense":
        fns, wargs = (G.gemv, G.gemv_plain), (w.bfloat16(),)
    elif kind == "int8":
        q8 = quant.quantize(w)
        fns, wargs = (G.gemv_int8, G.gemv_int8_plain), (q8["q"], q8["scale"])
    else:
        q4 = quant.quantize_int4(w)
        fns, wargs = ((G.gemv_int4, G.gemv_int4_plain),
                      (q4["q4"], q4["m8"], q4["scale"]))
    return fns + (x, wargs, norm, ptab, 1024)


@pytest.mark.parametrize("q", [1, 15])
@pytest.mark.parametrize("B", [1, 10, 17, 32])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_argmax_gather_exact(dev, kind, B, q):
    """The argmax epilogue of the head slice (`argmax=`, one launch) on
    `_head_case`: codes and the gathered rows (q = 1; none at q = 15)
    equal `argmax_gather_plain` on the launch's own logits exactly, and
    the plain head slice's exactly where its logits decide (the rows that
    lean on a tied pair, and the NaN row); the logits are the plain
    product's within one bf16 ulp; a launch without `out` gives the same
    codes and rows."""
    fn, plain, x, wargs, norm, ptab, rows = _head_case(dev, kind, B, 40 + B)
    CV = 2048
    kw = dict(col0=CV, n=CV, epilogue=G.EPI_F32_ROUND_DT, norm=norm,
              dt=torch.bfloat16)

    def run(f, out):
        codes = torch.zeros(B, 16, dtype=torch.int32, device=dev)
        xo = None if q == 15 else torch.zeros(B, 1024, device=dev)
        f(x, *wargs, out=out, argmax=(codes, q, ptab, rows, xo), **kw)
        return codes, xo

    lg = torch.empty(B, CV, device=dev)
    codes, xo = run(fn, lg)
    codes_p, xo_p = run(lambda *a, out, argmax, **k: el.argmax_gather_plain(
        lg, *argmax), None)
    assert torch.equal(codes, codes_p)
    assert xo is None or torch.equal(xo, xo_p)
    codes_n, xo_n = run(fn, None)
    assert torch.equal(codes_n, codes)
    assert xo is None or torch.equal(xo_n, xo)
    ref = plain(x, *wargs, **kw)
    fin = torch.isfinite(ref).all(-1)
    assert torch.isnan(lg[~fin]).all() and torch.isnan(ref[~fin]).all()
    _close(lg[fin], ref[fin], torch.bfloat16)
    codes_r, xo_r = run(plain, None)
    want = {0: 300, 1: 1500}
    for b in range(B):
        w_b = CV if b == 1 and B > 1 else want.get(b % 3)
        if w_b is not None:
            assert int(codes[b, q]) == int(codes_r[b, q]) == w_b, b
            if xo is not None:
                assert torch.equal(xo[b], xo_r[b])


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_argmax_epilogue_tickets_reset_across_graph_replays(dev, kind):
    """Two argmax launches (q = 3 with the gather into x itself, then q = 4
    without) captured in one CUDA graph and replayed twice, the codes
    zeroed and x renewed before each replay: each replay gives the eager
    launches' codes and rows, so every launch left its tickets and keys
    zero for the next."""
    B, CV = 10, 2048
    fn, _, x, wargs, norm, ptab, rows = _head_case(dev, kind, B, 7)
    kw = dict(col0=CV, n=CV, epilogue=G.EPI_F32_ROUND_DT, norm=norm,
              dt=torch.bfloat16)
    x0 = x.clone()
    codes = torch.zeros(B, 16, dtype=torch.int32, device=dev)

    def launches():
        fn(x, *wargs, argmax=(codes, 3, ptab, rows, x), **kw)
        fn(x, *wargs, argmax=(codes, 4, ptab, rows, None), **kw)

    launches()
    want_codes, want_x = codes.clone(), x.clone()
    x.copy_(x0)
    codes.zero_()
    # the capture stream's workspace is made (and zeroed) by a launch on
    # it before the capture, so no replay starts with a captured memset
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        launches()
    for _ in range(2):
        x.copy_(x0)
        codes.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(codes, want_codes)
        assert torch.equal(x, want_x)


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


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_talker_step_matches_plain(dev, kind):
    """The fused talker step on int8 / int4 weights (B8 / B4 in the
    chain) against the chained plain versions, f32, on an int4-capable
    width."""
    import dataclasses
    from qwen3_tts_tpu_torch.models import decoder

    tc = dataclasses.replace(tiny_engine_config().talker, hidden=256,
                             n_q_heads=2, n_kv_heads=2, head_dim=128,
                             ffn_dim=256, mrope_sections=(32, 16, 16, 0))
    g = torch.Generator(device=dev).manual_seed(7)
    tp = quant.quantize_decoder_params(
        decoder.init_decoder(g, tc, device=dev), kind=kind)
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


@pytest.mark.parametrize("name", [p.name for p in mosaic_probe.PROBES])
def test_probe_kernel_matches_plain(dev, name):
    """Each probe kernel against its plain version at the TPU probe's
    shapes, and the TPU probe's own check; then on the non-constant inputs
    of `varied_inputs` (hbm_scratch on an arange and normal draws, fori_dma
    at 1-5 and 9 steps, the int8 panel on a second seed at three row
    strides, argmax on NaN rows, ties and -0 / +0 with rows off 16 bytes
    and cols % 4 != 0, rot with +-0 / +-inf / NaN at d = 2-256, onehot
    at 1-33 rows, vocab 1-1000, d 1-260 on tables with +-inf, NaN or -0,
    codes outside the table, unaligned tables)."""
    probe = next(p for p in mosaic_probe.PROBES if p.name == name)
    args = mosaic_probe.probe_inputs(dev)[name]
    got = probe.kernel(*args)
    torch.cuda.synchronize()
    ok, err = mosaic_probe.agree(probe, got, probe.plain(*args))
    assert ok, err
    probe.check(got, *args)
    for pname, label, args in mosaic_probe.varied_inputs(dev, seed=4):
        if pname == name:
            ok, err = mosaic_probe.agree(probe, probe.kernel(*args),
                                         probe.plain(*args))
            assert ok, (label, err)


@pytest.mark.parametrize("name", ["hbm_scratch", "fori_dma", "dyn_sublane",
                                  "int8_panel"])
def test_probe_bulk_copy_refuses_misaligned_data(dev, name):
    """The bulk copies read 16-byte aligned addresses: a view 4 bytes off
    is refused before any launch."""
    probe = next(p for p in mosaic_probe.PROBES if p.name == name)
    args = list(mosaic_probe.probe_inputs(dev)[name])
    x = args[0]
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    off = 4 // x.element_size()
    args[0] = flat[off:off + x.numel()].view(x.shape).copy_(x)
    before = probe.kernel.launches
    with pytest.raises(ValueError, match="aligned"):
        probe.kernel(*args)
    assert probe.kernel.launches == before


def test_probe_kernels_edge_indices(dev):
    """Out-of-table codes give zero rows; a table with an inf or a NaN
    gives the one-hot product's NaN columns, equal as values (NaN = NaN,
    -0 = +0), on each of `onehot_edges` (one table with three, one of each
    ONEHOT_KINDS kind); device-held indices outside the range are taken
    as lax.dynamic_slice takes them, on normal draws (a row or slice read
    from the wrong place shows); dyn_col_dma at row counts that leave the
    last slice of 4 rows (csrc/probes.cu's COL_ROWS) partial, whole or the
    only one, on a wide and a narrow w."""
    tab = torch.randn(256, 128, device=dev)
    codes = torch.tensor([[3], [-1], [256], [255], [1000], [0], [-7], [4]],
                         dtype=torch.int32, device=dev).expand(8, 128)
    codes = codes.contiguous()
    assert torch.equal(mosaic_probe.onehot(codes, tab),
                       mosaic_probe.onehot_plain(codes, tab))
    onehot = next(p for p in mosaic_probe.PROBES if p.name == "onehot")
    edges = dict(mosaic_probe.onehot_edges(dev, seed=13))
    for label, (c, t) in edges.items():
        ok, err = mosaic_probe.agree(onehot, mosaic_probe.onehot(c, t),
                                     mosaic_probe.onehot_plain(c, t))
        assert ok, (label, err)
    got = mosaic_probe.onehot(*edges["inf / NaN / -inf table"]).cpu()
    assert got[0, [5, 7]].isnan().all() and got[0, 9] == float("-inf")
    assert got[1, 5] == float("inf") and got[2, [5, 7, 9]].isnan().all()
    c = torch.randn(32, 128, device=dev)
    for pos in (-40, -3, 0, 7, 31, 40):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        assert torch.equal(mosaic_probe.dyn_sublane(c, p),
                           mosaic_probe.dyn_sublane_plain(c, p)), pos
    w = torch.randn(128, 2048, device=dev)
    for q in (-9, -1, 0, 3, 5):
        qt = torch.tensor([q], dtype=torch.int32, device=dev)
        assert torch.equal(mosaic_probe.dyn_col_dma(qt, w),
                           mosaic_probe.dyn_col_dma_plain(qt, w)), q
    for rows in (1, 7, 4, 100, 128, 256):
        for cols in (2048, 260):
            w = torch.randn(rows, cols, device=dev)
            for q in (-9, 0, 3, 5):
                qt = torch.tensor([q], dtype=torch.int32, device=dev)
                assert torch.equal(mosaic_probe.dyn_col_dma(qt, w),
                                   mosaic_probe.dyn_col_dma_plain(qt, w)), (
                    rows, cols, q)


def test_probe_rot_and_argmax_past_one_grid(dev):
    """rot past 65535 groups of rows (the grid's y limit, so the kernel's
    groups loop), bit for bit; argmax over 70000 rows of 130 columns (a
    CTA a row, scalar loads)."""
    x = torch.randn(65535 * 256 + 1001, 2, device=dev)
    assert torch.equal(mosaic_probe.rot(x).view(torch.int32),
                       mosaic_probe.rot_plain(x).view(torch.int32))
    x = torch.randn(70000, 130, device=dev)
    assert torch.equal(mosaic_probe.argmax(x), mosaic_probe.argmax_plain(x))


# ------------------------------------------------- the predictor frame kernel
# a mid size between the tiny config and the full one: bf16, GQA (2 q heads
# per kv head), four layers
MID_PREDICTOR = dict(hidden=256, n_layers=4, n_q_heads=4, n_kv_heads=2,
                     head_dim=64, ffn_dim=512, max_seq=32,
                     mrope_sections=(32, 0, 0, 0), dtype="bfloat16")


def _frame_case(dev, cfg, kind, B, seed, peak=False):
    """Seeded predictor weights (dense, int8 or int4), ptab, h1024 and
    code_0 on the card. `peak` boosts 4 columns of each head slice 24x, so the argmax
    races a few well-separated candidates (chip_smoke.py peak_head)."""
    from qwen3_tts_tpu_torch.assets import tables
    from qwen3_tts_tpu_torch.core import protocol
    from qwen3_tts_tpu_torch.models import decoder

    g = torch.Generator(device=dev).manual_seed(seed)
    pp = decoder.init_decoder(g, cfg, device=dev)
    if peak:
        head = pp["head"].float()
        for q in range(protocol.NUM_CODEBOOKS):
            cols = q * protocol.CODE_VOCAB + torch.randperm(
                protocol.CODE_VOCAB, generator=g, device=dev)[:4]
            head[:, cols] *= 24.0
        pp["head"] = head.to(pp["head"].dtype)
    if kind != "dense":
        pp = quant.quantize_decoder_params(pp, kind=kind)
    assets = tables.random_assets(g, text_vocab=64, codec_rows=2176, dim=64,
                                  proj_dim=cfg.hidden, device=dev)
    ptab, rows = fused_predictor.make_ptab(assets, cfg)
    h = _randn(g, B, cfg.hidden)
    code0 = torch.randint(-3, 2300, (B,), generator=g, device=dev)
    return pp, ptab, rows, h, code0


@pytest.mark.parametrize("B", [1, 2, 3, 16])
def test_predictor_frame_tiny_f32_codes_equal_plain(dev, B):
    """The frame kernel at the tiny f32 config: codes equal to the plain
    version on the card and on the CPU; the routed entry launches it once
    a frame where frame_route takes it (B <= 10 dense), and the kernel
    itself takes every B <= MAX_B. With a NaN head column the kernel gives
    JAX's order (code CV, then the bias row), equal to plain."""
    cfg = tiny_engine_config().predictor
    pp, ptab, rows, h, code0 = _frame_case(dev, cfg, "dense", B, 21 + B)
    routed = fused_predictor.frame_route(pp, B) == fused_predictor.KERNEL
    assert routed == (B <= fused_predictor.ROUTE_MAX_B["dense"])
    before = fused_predictor.predictor_frame_kernel.launches
    got = fused_predictor.frame_codes_fused(pp, cfg, ptab, rows, h, code0)
    assert fused_predictor.predictor_frame_kernel.launches == before + routed
    if not routed:
        got = fused_predictor.predictor_frame_kernel(pp, cfg, ptab, rows, h,
                                                     code0)
        assert fused_predictor.predictor_frame_kernel.launches == before + 1
    want = fused_predictor.frame_codes_fused_plain(pp, cfg, ptab, rows, h,
                                                   code0)
    assert torch.equal(got, want)
    cpu = fused_predictor.frame_codes_fused_plain(
        {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
             else v.cpu()) for k, v in pp.items()},
        cfg, ptab.cpu(), rows, h.cpu(), code0.cpu())
    assert torch.equal(got.cpu(), cpu)
    # a NaN head column (slice 13, column 100): every row's code 14 is CV
    # (JAX's argmax_row), pass 15 takes the bias row; exact against plain
    CV = 2048
    head = pp["head"].clone()
    head[:, 13 * CV + 100] = float("nan")
    pn = dict(pp, head=head)
    got = fused_predictor.predictor_frame_kernel(pn, cfg, ptab, rows, h,
                                                 code0)
    want = fused_predictor.frame_codes_fused_plain(pn, cfg, ptab, rows, h,
                                                   code0)
    assert (got[:, 14] == CV).all() and (got[:, 15] != CV).all()
    assert torch.equal(got, want)
    cpu = fused_predictor.frame_codes_fused_plain(
        {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
             else v.cpu()) for k, v in pn.items()},
        cfg, ptab.cpu(), rows, h.cpu(), code0.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("B", [1, 2, 3, 16])
def test_predictor_frame_int4_small_f32_codes_equal_plain(dev, B):
    """All five weights int4 at the small int4-capable f32 width (hidden
    256, 2/2 heads of 128, ffn 256): the frame kernel's codes equal to the
    plain version on the card and on the CPU; frame_codes_fused launches
    it once where frame_route takes it."""
    import dataclasses
    cfg = dataclasses.replace(tiny_engine_config().predictor, hidden=256,
                              n_q_heads=2, n_kv_heads=2, head_dim=128,
                              ffn_dim=256, mrope_sections=(64, 0, 0, 0))
    pp, ptab, rows, h, code0 = _frame_case(dev, cfg, "int4", B, 81 + B)
    routed = fused_predictor.frame_route(pp, B) == fused_predictor.KERNEL
    assert routed == (B <= fused_predictor.ROUTE_MAX_B["int4"])
    before = fused_predictor.predictor_frame_kernel.launches_int4
    got = fused_predictor.predictor_frame_kernel(pp, cfg, ptab, rows, h,
                                                 code0)
    assert fused_predictor.predictor_frame_kernel.launches_int4 == before + 1
    want = fused_predictor.frame_codes_fused_plain(pp, cfg, ptab, rows, h,
                                                   code0)
    assert torch.equal(got, want)
    cpu = fused_predictor.frame_codes_fused_plain(
        {k: ({n: ({m: u.cpu() for m, u in t.items()} if isinstance(t, dict)
                  else t.cpu()) for n, t in v.items()}
             if isinstance(v, dict) else v.cpu()) for k, v in pp.items()},
        cfg, ptab.cpu(), rows, h.cpu(), code0.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 2, 16])
def test_predictor_frame_mid_bf16_agrees_with_plain(dev, kind, B):
    """A mid size in bf16, dense, int8 and int4 weights, peaked heads: codes
    agree with the plain version in >= 95% of places (bf16 sums in another
    order may flip a near tie, which then changes the frame's later
    inputs); code_0 column exact."""
    import dataclasses
    cfg = dataclasses.replace(tiny_engine_config().predictor,
                              **MID_PREDICTOR)
    pp, ptab, rows, h, code0 = _frame_case(dev, cfg, kind, B, 31 + B,
                                           peak=True)
    got = fused_predictor.predictor_frame_kernel(pp, cfg, ptab, rows, h,
                                                 code0)
    want = fused_predictor.frame_codes_fused_plain(pp, cfg, ptab, rows, h,
                                                   code0)
    assert torch.equal(got[:, 0], want[:, 0])
    assert float((got == want).float().mean()) >= 0.95


def test_predictor_frame_repeats_bit_identical(dev):
    """No K split, no atomics: the same frame twice gives the same codes,
    at the tiny f32 config and at the mid size in bf16 and int8, B = 3."""
    import dataclasses
    tiny = tiny_engine_config().predictor
    mid = dataclasses.replace(tiny, **MID_PREDICTOR)
    for cfg, kind in ((tiny, "dense"), (mid, "dense"), (mid, "int8"),
                      (mid, "int4")):
        pp, ptab, rows, h, code0 = _frame_case(dev, cfg, kind, 3, 41)
        a, b = (fused_predictor.predictor_frame_kernel(
            pp, cfg, ptab, rows, h, code0) for _ in range(2))
        assert torch.equal(a, b)


def _step_case(dev, kind, B, dtype, seed, T=256):
    """A small int4-capable talker (hidden 256, 2/2 heads of 128, ffn 256,
    2 layers) in `dtype` with `kind` weights, x, and a random cache with
    ragged live ranges; the step writes at slot kv_len."""
    import dataclasses
    from qwen3_tts_tpu_torch.models import decoder

    tc = dataclasses.replace(tiny_engine_config().talker, hidden=256,
                             n_q_heads=2, n_kv_heads=2, head_dim=128,
                             ffn_dim=256, mrope_sections=(32, 16, 16, 0),
                             dtype="float32" if dtype == torch.float32
                             else "bfloat16")
    g = torch.Generator(device=dev).manual_seed(seed)
    tp = decoder.init_decoder(g, tc, device=dev)
    if kind != "dense":
        tp = quant.quantize_decoder_params(tp, kind=kind)
    cache = decoder.init_kv_cache(tc, B, length=T, device=dev)
    for c in cache.values():
        c.copy_(_randn(g, *c.shape))
    x = _randn(g, B, tc.hidden, dtype=dtype, scale=0.1)
    pad = torch.arange(B, dtype=torch.int32, device=dev) * 5
    slot = pad + 60 + 3 * torch.arange(B, dtype=torch.int32, device=dev)
    return tc, tp, x, slot - pad, slot, slot, pad, cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 2, 5, 16, 17, 32])
def test_talker_step_kernel_matches_plain(dev, dtype, kind, B):
    """The step kernel against talker_step_fused_plain: hidden, logits and
    the cache slot written (f32 rtol/atol 1e-4; bf16 max |d| <= 8e-3 of the
    largest magnitude, chip_smoke.py's bound); every other slot unchanged;
    one launch a step through talker_step_fused where the route takes the
    kernel, else through the kernel's wrapper; B up to the kernel's cap,
    32 (a 512-slot cache past 16 rows, whose slots reach 308)."""
    tc, tp, x, pos, slot, kv_len, vf, cache = _step_case(
        dev, kind, B, dtype, 50 + B, T=256 if B <= 16 else 512)
    before = fused_talker.talker_step_kernel.launches
    wide = fused_talker.talker_step_kernel.launches_wide
    kk, kv = cache["k"].clone(), cache["v"].clone()
    step = fused_talker.talker_step_fused \
        if fused_talker.talker_route(tp, B) == fused_talker.KERNEL \
        else fused_talker.talker_step_kernel
    a = step(tp, tc, x, pos, slot, kv_len, vf, kk, kv)
    assert fused_talker.talker_step_kernel.launches == before + 1
    assert fused_talker.talker_step_kernel.launches_wide == wide + (B > 16)
    b = fused_talker.talker_step_fused_plain(tp, tc, x, pos, slot, kv_len,
                                             vf, cache["k"].clone(),
                                             cache["v"].clone())
    rows = torch.arange(B, device=dev)
    sl = slot.long()
    for u, v in zip(a[:2] + tuple(t[:, rows, :, sl] for t in a[2:]),
                    b[:2] + tuple(t[:, rows, :, sl] for t in b[2:])):
        if dtype == torch.float32:
            torch.testing.assert_close(u.float(), v.float(), rtol=1e-4,
                                       atol=1e-4)
        else:
            err = (u.float() - v.float()).abs().max()
            assert err <= 8e-3 * v.float().abs().max(), float(err)
    for got, orig in ((kk, cache["k"]), (kv, cache["v"])):
        got[:, rows, :, sl] = orig[:, rows, :, sl]
        assert torch.equal(got, orig)


def test_talker_step_repeats_and_graph_replay_bit_identical(dev):
    """No K split, no atomics on data: the same step twice, and two
    replays of a CUDA graph of it, give the same bits (bf16, int8 and
    int4, B = 2)."""
    for kind in ("dense", "int8", "int4"):
        tc, tp, x, pos, slot, kv_len, vf, cache = _step_case(
            dev, kind, 2, torch.bfloat16, 61)

        def step():
            h, lg, _, _ = fused_talker.talker_step_kernel(
                tp, tc, x, pos, slot, kv_len, vf, cache["k"], cache["v"])
            return torch.cat([h.float().flatten(), lg.flatten()])
        first, second = step().clone(), step().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(out.clone())
        assert all(torch.equal(first, t) for t in (second, *replays)), kind
