"""The port's multi-device layer (`qwen3_tts_tpu_torch/parallel/`) against
the JAX package's (`qwen3_tts_tpu/parallel/`) on the CPU.

The layouts (interleaves, per-rank shards) are pure functions checked in
this process. One spawned world of 8 gloo processes (this file run as a
script, `--rank`) runs the port's (2, 4) and (8, 1) meshes on JAX's
weights and writes its results to files; the tests that read them hold
them against JAX's runs on the 8-device virtual CPU mesh
(`tests/conftest.py`), at JAX's own tolerance (`tests/test_parallel.py`).
"""

import argparse
import dataclasses
import datetime
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from qwen3_tts_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qwen3_tts_tpu_torch.parallel import run as trun  # noqa: E402
from qwen3_tts_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from qwen3_tts_tpu_torch.tools import multihost_smoke as launcher  # noqa: E402

WORLD = 8
SPAWN_TIMEOUT_S = 120
RTOL, ATOL = 2e-3, 2e-4          # JAX's own (tests/test_parallel.py)
SP_SEQ = 64


# ------------------------------------------------------------ layouts
@pytest.mark.parametrize("nq,nk,hd,m", [
    (8, 4, 16, 4), (8, 4, 16, 2), (4, 4, 16, 4), (16, 8, 128, 2),
    (16, 8, 128, 4), (16, 8, 128, 8), (8, 8, 128, 2), (8, 8, 128, 8),
    (8, 4, 16, 1)])
def test_interleave_perm_matches_jax(nq, nk, hd, m):
    from qwen3_tts_tpu.parallel import sharding as jsharding
    np.testing.assert_array_equal(tsharding.interleave_perm(nq, nk, hd, m),
                                  jsharding.interleave_perm(nq, nk, hd, m))


def test_interleave_wqkv_matches_jax_and_refuses_quantized():
    from qwen3_tts_tpu.parallel import sharding as jsharding
    cfg = trun.parallel_test_config().talker
    w = np.random.default_rng(0).standard_normal(
        (2, cfg.hidden, (cfg.n_q_heads + 2 * cfg.n_kv_heads) * cfg.head_dim)
    ).astype(np.float32)
    got = tsharding.interleave_wqkv(torch.from_numpy(w), cfg, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsharding.interleave_wqkv(w, cfg, 4)))
    with pytest.raises(AssertionError):
        tsharding.interleave_wqkv({"q": torch.from_numpy(w)}, cfg, 4)
    with pytest.raises(AssertionError):
        tsharding.interleave_gate_up({"q": torch.from_numpy(w)}, cfg, 4)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_interleaves_are_bijections_with_device_blocks(m):
    nq, nk, hd, F = 8, 4, 16, 128
    perm = tsharding.interleave_perm(nq, nk, hd, m)
    assert sorted(perm.tolist()) == list(range((nq + 2 * nk) * hd))
    blk = len(perm) // m
    for d in range(m):
        a, b = d * nq // m, d * nk // m
        want = np.concatenate([
            np.arange(a * hd, (a + nq // m) * hd),
            nq * hd + np.arange(b * hd, (b + nk // m) * hd),
            (nq + nk) * hd + np.arange(b * hd, (b + nk // m) * hd)])
        np.testing.assert_array_equal(perm[d * blk:(d + 1) * blk], want)
    gu = tsharding.gate_up_perm(F, m)
    assert sorted(gu.tolist()) == list(range(2 * F))
    f = F // m
    for d in range(m):
        block = gu[2 * f * d: 2 * f * (d + 1)]
        np.testing.assert_array_equal(block[:f], np.arange(d * f, (d + 1) * f))
        np.testing.assert_array_equal(block[f:],
                                      F + np.arange(d * f, (d + 1) * f))


def _decoder_tree(cfg):
    from qwen3_tts_tpu_torch.models import decoder
    return decoder.init_decoder(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("data,model", [(1, 1), (2, 4), (8, 1), (1, 2),
                                        (4, 2)])
def test_shard_shapes_and_reassembly(data, model):
    cfg = trun.parallel_test_config().talker
    tree = _decoder_tree(cfg)
    specs = tsharding.decoder_param_specs()
    shape = {"data": data, "model": model}
    L, H, F = cfg.n_layers, cfg.hidden, cfg.ffn_dim
    nqkv = (cfg.n_q_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    want = {"wqkv": (L, H, nqkv // model),
            "wo": (L, cfg.n_q_heads * cfg.head_dim // model, H),
            "w_gu": (L, H, 2 * F // model), "w_down": (L, F // model, H),
            "ln1": (L, H)}
    blocks = {}
    for d in range(data):
        for r in range(model):
            coords = {"data": d, "model": r}
            lw = {k: tmesh.local_slice(v, specs["layers"][k], shape, coords)
                  for k, v in tree["layers"].items()}
            for k, s in want.items():
                assert tuple(lw[k].shape) == s, (k, lw[k].shape, s)
            head = tmesh.local_slice(tree["head"], specs["head"], shape,
                                     coords)
            assert tuple(head.shape) == (H, cfg.vocab // model)
            if d == 0:
                blocks[r] = (lw, head)
    # the model ranks' blocks put back together give the whole tensor
    for k, dim in (("wqkv", 2), ("wo", 1), ("w_gu", 2), ("w_down", 1)):
        whole = torch.cat([blocks[r][0][k] for r in range(model)], dim=dim)
        assert torch.equal(whole, tree["layers"][k])
    assert torch.equal(torch.cat([blocks[r][1] for r in range(model)], 1),
                       tree["head"])
    # the decode cache and the batch
    cache = torch.zeros(L, 8, cfg.n_kv_heads, 16, cfg.head_dim)
    spec = tsharding.kv_cache_specs()["k"]
    got = tmesh.local_slice(cache, spec, shape, {"data": 0, "model": 0})
    assert tuple(got.shape) == (L, 8 // data, cfg.n_kv_heads // model, 16,
                                cfg.head_dim)
    x = torch.zeros(8, 5, H)
    assert tmesh.local_slice(x, tsharding.batch_spec(), shape,
                             {"data": 0, "model": 0}).shape[0] == 8 // data


def test_shard_specs_of_quantized_weights():
    from qwen3_tts_tpu_torch.ops import quant
    w = torch.randn(2, 256, 512)
    q8 = quant._quantize_stack(w, quant.quantize)
    shape, coords = {"data": 1, "model": 2}, {"data": 0, "model": 1}
    col, row = tmesh.P(None, None, "model"), tmesh.P(None, "model", None)
    specs = tmesh._quantized_specs(q8, col)
    assert specs["scale"] == tmesh.P(None, "model")
    got = {k: tmesh.local_slice(v, specs[k], shape, coords)
           for k, v in q8.items()}
    assert torch.equal(got["q"], q8["q"][..., 256:])
    assert torch.equal(got["scale"], q8["scale"][..., 256:])
    specs = tmesh._quantized_specs(q8, row)
    assert specs["scale"] == tmesh.P(None, None)
    q4 = quant._quantize_stack(w, quant.quantize_int4)
    assert tmesh._quantized_specs(q4, col)["m8"] == col
    with pytest.raises(ValueError, match="int4"):
        tmesh._quantized_specs(q4, row)
    with pytest.raises(ValueError, match="split"):
        tmesh.local_slice(torch.zeros(3, 5), tmesh.P(None, "model"), shape,
                          coords)


# ------------------------------------------------- the tp_interleave repair
def _jax_decoder_case(cfg, S, seed):
    import jax
    import jax.numpy as jnp
    from qwen3_tts_tpu.models import decoder as jdec
    params = jdec.init_decoder(jax.random.key(seed), cfg)
    x = 0.1 * jax.random.normal(jax.random.key(seed + 1),
                                (2, S, cfg.hidden))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (2, S))
    return params, x, pos


def _interleaved(params_np, cfg, m):
    from qwen3_tts_tpu.parallel import sharding as jsharding
    lw = dict(params_np["layers"])
    lw["wqkv"] = np.asarray(jsharding.interleave_wqkv(lw["wqkv"], cfg, m))
    return dict(params_np, layers=lw)


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def test_forward_with_tp_interleave_matches_jax():
    """The port's decoder.forward splits an interleaved wqkv block by block
    when cfg.tp_interleave > 1, as JAX's does: prefill then a decode step,
    hidden, logits and cache."""
    import jax.numpy as jnp
    from qwen3_tts_tpu.models import decoder as jdec
    from qwen3_tts_tpu_torch import convert
    from qwen3_tts_tpu_torch.models import decoder as tdec

    cfg = dataclasses.replace(trun.parallel_test_config().talker,
                              tp_interleave=4)
    params, x, pos = _jax_decoder_case(cfg, 6, 3)
    pint = _interleaved(_np_tree(params), cfg, 4)
    tparams = convert.decoder_from_numpy(pint)
    jcache = jdec.init_kv_cache(cfg, 2)
    tcache = tdec.init_kv_cache(cfg, 2)
    jh, jl, jcache = jdec.forward(pint, cfg, x, pos, jcache, jnp.int32(0))
    th, tl, tcache = tdec.forward(tparams, cfg, torch.from_numpy(
        np.array(x)), torch.from_numpy(np.array(pos)), tcache, 0)
    x1 = 0.1 * np.ones((2, 1, cfg.hidden), np.float32)
    p1 = np.full((2, 1), 6, np.int32)
    jh1, jl1, jcache = jdec.forward(pint, cfg, jnp.asarray(x1),
                                    jnp.asarray(p1), jcache, jnp.int32(6))
    th1, tl1, tcache = tdec.forward(tparams, cfg, torch.from_numpy(x1),
                                    torch.from_numpy(p1), tcache, 6)
    for got, want in ((th, jh), (tl, jl), (th1, jh1), (tl1, jl1),
                      (tcache["k"], jcache["k"]), (tcache["v"], jcache["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_interleaved_forward_equals_flat_forward():
    """The interleaved layout with its tp_interleave computes what the flat
    layout computes (the head order is unchanged)."""
    from qwen3_tts_tpu_torch.models import decoder as tdec
    cfg = trun.parallel_test_config().talker
    flat = _decoder_tree(cfg)
    inter = dict(flat, layers=dict(flat["layers"], wqkv=tsharding.
                                   interleave_wqkv(flat["layers"]["wqkv"],
                                                   cfg, 4)))
    cfg4 = dataclasses.replace(cfg, tp_interleave=4)
    x = 0.1 * torch.randn(2, 5, cfg.hidden, generator=torch.Generator()
                          .manual_seed(1))
    pos = torch.arange(5)[None].expand(2, 5)
    a = tdec.forward(flat, cfg, x, pos, tdec.init_kv_cache(cfg, 2), 0)
    b = tdec.forward(inter, cfg4, x, pos, tdec.init_kv_cache(cfg4, 2), 0)
    for u, v in ((a[0], b[0]), (a[1], b[1]), (a[2]["k"], b[2]["k"])):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6)


# --------------------------------------------------- the spawned world
def _start_ranks(n, args):
    """`n` ranks of this file as a script (the port's launcher: rank 0
    first, the others once it listens)."""
    env = {"OMP_NUM_THREADS": "1", "XLA_FLAGS": ""}
    return launcher.start_ranks(
        lambda r, port: [sys.executable, os.path.abspath(__file__), "--rank",
                         str(r), "--world", str(n), "--port", str(port)]
        + args, n, n, env)


def _jax_models_np(mesh, cfg, seed):
    """JAX's build_sharded_models, gathered to numpy, wqkv back in the flat
    layout (the port interleaves it itself)."""
    from qwen3_tts_tpu.parallel import run as jrun
    from qwen3_tts_tpu.parallel import sharding as jsharding
    models, voc = jrun.build_sharded_models(mesh, cfg, seed=seed)
    out = {}
    for name, part in (("talker", cfg.talker), ("predictor", cfg.predictor)):
        tree = _np_tree(models[name])
        m = jrun.tp_interleave_factor(mesh, part)
        if m > 1:
            perm = jsharding.interleave_perm(part.n_q_heads, part.n_kv_heads,
                                             part.head_dim, m)
            lw = dict(tree["layers"])
            lw["wqkv"] = lw["wqkv"][..., np.argsort(perm)]
            tree = dict(tree, layers=lw)
        out[name] = tree
    a = models["assets"]
    out["assets"] = {k: np.asarray(getattr(a, k)) for k in (
        "text_table", "codec_tables", "proj_weight", "proj_bias")}
    return models, voc, out, _np_tree(voc)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's weights and inputs to a pickle, the 8-rank world spawned on
    them, JAX's own runs meanwhile; returns (JAX results, each rank's)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from qwen3_tts_tpu.models import decoder as jdec
    from qwen3_tts_tpu.parallel import mesh as jmesh
    from qwen3_tts_tpu.parallel import run as jrun
    from qwen3_tts_tpu.parallel import sharding as jsharding
    from qwen3_tts_tpu.tts import generate as jgen

    tmp = tmp_path_factory.mktemp("torch_parallel")
    cfg = jrun.parallel_test_config(max_steps=3)
    m24 = jmesh.make_mesh(2, 4)
    models, voc, models_np, voc_np = _jax_models_np(m24, cfg, 0)
    prompt = 0.1 * jax.random.normal(jax.random.key(1), (2, 5,
                                                         cfg.talker.hidden))
    tc = dataclasses.replace(cfg.talker, max_seq=128)
    sp_params = jdec.init_decoder(jax.random.key(0), tc)
    sp_x = 0.1 * jax.random.normal(jax.random.key(1),
                                   (1, SP_SEQ, tc.hidden))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"models": models_np, "voc": voc_np,
                     "prompt": np.asarray(prompt),
                     "sp_params": _np_tree(sp_params),
                     "sp_x": np.asarray(sp_x)}, f)

    t0 = time.time()
    procs, logs = _start_ranks(WORLD, ["--dir", str(tmp)])

    # JAX meanwhile: the (2, 4) program, its codes, the unsharded prefill
    wav, n_frames = jrun.sharded_generate_step(
        m24, cfg, models, voc, batch=2, prompt_len=5, max_steps=3, seed=0)
    tcfg = jrun.tp_config(m24, cfg)
    ds = NamedSharding(m24, jsharding.batch_spec())
    with jax.set_mesh(m24):
        codes, n2 = jgen.generate_codes(
            models, tcfg.talker, tcfg.predictor, jax.device_put(prompt, ds),
            jax.device_put(jnp.zeros((2,), jnp.int32), ds),
            jax.random.key(0), 0.0, 0, 1.0, 3)
    pos = jnp.arange(SP_SEQ, dtype=jnp.int32)[None]
    ref_h, _, ref_cache = jdec.forward(
        sp_params, tc, sp_x, pos, jdec.init_kv_cache(tc, 1), jnp.int32(0))
    jres = {"wav": np.asarray(wav), "n_frames": np.asarray(n_frames),
            "codes": np.asarray(codes), "n_frames_codes": np.asarray(n2),
            "sp_h": np.asarray(ref_h), "sp_k": np.asarray(ref_cache["k"]),
            "sp_v": np.asarray(ref_cache["v"]), "L": cfg.talker.n_layers}

    rcs, outs = launcher.finish_ranks(
        procs, logs, max(1.0, SPAWN_TIMEOUT_S - (time.time() - t0)))
    assert rcs == [0] * WORLD, "\n".join(outs)[-6000:]
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return jres, ranks


def test_sharded_generation_matches_jax(world):
    """(2, 4): the port's sharded_generate_step on JAX's weights and prompt
    gives JAX's greedy codes and n_frames exactly, its wav within JAX's
    own tolerance."""
    jres, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["codes"].numpy(), jres["codes"])
        np.testing.assert_array_equal(r["n_frames"].numpy(),
                                      jres["n_frames"])
        np.testing.assert_array_equal(r["n_frames_codes"].numpy(),
                                      jres["n_frames_codes"])
        assert np.isfinite(r["wav"].numpy()).all()
        np.testing.assert_allclose(r["wav"].numpy(), jres["wav"],
                                   rtol=RTOL, atol=ATOL)
    assert int(jres["n_frames"].max()) >= 1


def test_ranks_stay_in_lockstep(world):
    """Every rank of a model group saw the same gathered logits and drew
    the same codes; every rank returns the whole batch."""
    _, ranks = world
    for r in ranks[1:]:
        assert torch.equal(r["codes"], ranks[0]["codes"])
        assert torch.equal(r["wav"], ranks[0]["wav"])
        assert r["frames_run"] == ranks[0]["frames_run"]


def test_mesh_layout(world):
    """Row-major ranks over (data, model), as JAX's reshape; a mesh larger
    than the world is refused."""
    _, ranks = world
    for rank, r in enumerate(ranks):
        assert r["coords24"] == [rank // 4, rank % 4]
        assert r["coords81"] == [rank, 0]
        assert r["group_sizes"] == {"data": 2, "model": 4}
        assert r["too_big"] == "ValueError"
        assert r["local_coords"] == [(rank % 4) // 2, rank % 2]


def test_int8_shards_match_the_single_device_int8_model(world):
    """int8 quantization before the split: the (2, 4) prefill on int8
    shards equals the single-device int8 model's."""
    _, ranks = world
    for r in ranks:
        for got, want in zip(r["int8_tp"], r["int8_single"]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_dp_only_mesh_finite(world):
    _, ranks = world
    for r in ranks:
        wav = r["dp_wav"].numpy()
        assert wav.shape[0] == 8 and np.isfinite(wav).all()
        assert r["dp_n_frames"].shape == (8,)


def test_two_all_reduces_a_layer_on_the_model_group(world):
    """The torch twin of test_interleaved_wqkv_reduces_collectives: a
    decode step makes exactly the two TP all-reduces a layer (after wo and
    after w_down) and nothing else on the model group; with logits one
    more, the vocabulary gather."""
    jres, ranks = world
    L = jres["L"]
    for r in ranks:
        assert r["all_reduce_step"] == [("model", 2 * L)]
        assert r["all_reduce_step_logits"] == [("model", 2 * L + 1)]


def test_sequence_parallel_prefill_matches_jax(world):
    """(8, 1): the port's sequence-split prefill against JAX's unsharded
    decoder.forward, hidden and cache, every rank's products fed S/8
    rows, one K/V gather a layer."""
    jres, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["sp_h"].numpy(), jres["sp_h"],
                                   rtol=RTOL, atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(r[f"sp_{k}"].numpy(), jres[f"sp_{k}"],
                                       rtol=RTOL, atol=ATOL)
        assert r["sp_rows"] == {SP_SEQ // WORLD}
        # a K/V gather a layer, then the hidden states' gather
        assert r["sp_all_reduce"] == [("data", jres["L"] + 1)]


def test_sequence_parallel_composes_with_tp(world):
    """(2, 4): sequence over data and heads over model; each rank's cache
    holds its heads, the model ranks' caches together JAX's."""
    jres, ranks = world
    for d in range(2):
        group = ranks[4 * d: 4 * d + 4]
        for r in group:
            np.testing.assert_allclose(r["sptp_h"].numpy(), jres["sp_h"],
                                       rtol=RTOL, atol=ATOL)
        for k in ("k", "v"):
            whole = torch.cat([r[f"sptp_{k}"] for r in group], dim=2)
            np.testing.assert_allclose(whole.numpy(), jres[f"sp_{k}"],
                                       rtol=RTOL, atol=ATOL)


# --------------------------------------------------- the rank's side
class _Counter:
    """dist.all_reduce counted by group, named by its mesh axis
    ({axis: group})."""

    def __init__(self, dist, groups):
        self.dist, self.calls = dist, []
        self.names = {tuple(dist.get_process_group_ranks(g)): a
                      for a, g in groups.items()}
        self.orig = dist.all_reduce

    def __enter__(self):
        def counted(t, *a, group=None, **kw):
            ranks = tuple(self.dist.get_process_group_ranks(group)) \
                if group is not None else None
            self.calls.append(self.names.get(ranks, "other"))
            return self.orig(t, *a, group=group, **kw)
        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig

    def summary(self):
        return [(n, self.calls.count(n)) for n in sorted(set(self.calls))]


def _rank_main(rank, world_size, port, out_dir):
    import torch.distributed as dist
    from qwen3_tts_tpu_torch import convert
    from qwen3_tts_tpu_torch.models import decoder as tdec
    from qwen3_tts_tpu_torch.parallel import context as tcontext
    from qwen3_tts_tpu_torch.tts import generate as tgen

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=90))
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}
    cfg = trun.parallel_test_config(max_steps=3)

    # (2, 4) on JAX's weights
    mesh = tmesh.make_mesh(2, 4, device_type="cpu")
    res["coords24"] = list(mesh.get_coordinate())
    res["group_sizes"] = {a: dist.get_world_size(mesh.get_group(a))
                          for a in ("data", "model")}
    try:
        tmesh.make_mesh(3, 3, device_type="cpu")
        res["too_big"] = "none"
    except ValueError:
        res["too_big"] = "ValueError"
    a = inp["models"]["assets"]
    models = {"talker": convert.decoder_from_numpy(inp["models"]["talker"]),
              "predictor": convert.decoder_from_numpy(
                  inp["models"]["predictor"]),
              "assets": convert.assets_from_numpy(
                  a["text_table"], a["codec_tables"], a["proj_weight"],
                  a["proj_bias"])}
    voc = convert.vocoder_from_numpy(inp["voc"])
    voc["transformer"] = convert.decoder_from_numpy(inp["voc"]["transformer"])
    local, lvoc = trun.shard_models(mesh, cfg, models, voc)
    prompt = torch.from_numpy(inp["prompt"])
    wav, n_frames = trun.sharded_generate_step(
        mesh, cfg, local, lvoc, batch=2, prompt_len=5, max_steps=3,
        prompt=prompt)
    res["wav"], res["n_frames"] = wav, n_frames
    tcfg = trun.tp_config(mesh, cfg)
    tp = mesh.get_group("model")
    data = mesh.get_group("data")
    d = mesh.get_coordinate()[0]
    steps = []
    orig_body = tgen._frame_body

    def body(*a, **kw):
        steps.append(1)
        return orig_body(*a, **kw)
    tgen._frame_body = body
    codes, n2 = tgen.generate_codes(
        local, tcfg.talker, tcfg.predictor, prompt[d:d + 1],
        torch.zeros(1, dtype=torch.int32), None, 0.0, 0, 1.0, 3, tp=tp)
    tgen._frame_body = orig_body
    res["frames_run"] = len(steps)
    res["codes"] = tmesh.all_gather(codes, data, 0)
    res["n_frames_codes"] = tmesh.all_gather(n2, data, 0)

    # the collectives of one decode step on the model group
    names = {"model": tp, "data": data}
    tc = tcfg.talker
    x1 = 0.1 * torch.ones(1, 1, tc.hidden)
    for key, logits in (("all_reduce_step", False),
                        ("all_reduce_step_logits", True)):
        cache = tdec.init_kv_cache(tc, 1, length=16, tp=tp)
        with _Counter(dist, names) as c:
            tdec.forward(local["talker"], tc, x1, torch.full((1, 1), 7),
                         cache, 7, with_logits=logits, tp=tp)
        res[key] = c.summary()

    # int8 weights: quantized before the split, so a rank's shards are the
    # single device's int8 model's; the prefill against it
    from qwen3_tts_tpu_torch.ops import quant
    q_local = trun.shard_models(mesh, cfg, models, voc,
                                {"talker": "int8"})[0]["talker"]
    q_full = quant.quantize_decoder_params(models["talker"], kind="int8")
    xq = prompt[:1]
    posq = torch.arange(xq.shape[1])[None]
    res["int8_tp"] = tdec.forward(q_local, tc, xq, posq, tdec.init_kv_cache(
        tc, 1, length=16, tp=tp), 0, tp=tp)[:2]
    res["int8_single"] = tdec.forward(q_full, cfg.talker, xq, posq,
                                      tdec.init_kv_cache(cfg.talker, 1,
                                                         length=16), 0)[:2]

    # sequence-split prefill composed with TP on (2, 4)
    sp_tc = dataclasses.replace(cfg.talker, max_seq=128)
    sp_full = convert.decoder_from_numpy(inp["sp_params"])
    sp_x = torch.from_numpy(inp["sp_x"])
    pos = torch.arange(SP_SEQ)[None]
    tp_tc = dataclasses.replace(sp_tc, tp_interleave=4)
    shard = trun.shard_models(mesh, dataclasses.replace(
        cfg, talker=sp_tc), dict(models, talker=sp_full), voc)[0]["talker"]
    h, _, cache = tcontext.prefill_sequence_sharded(
        mesh, shard, tp_tc, sp_x, pos,
        tdec.init_kv_cache(tp_tc, 1, tp=tp), 0)
    res["sptp_h"], res["sptp_k"], res["sptp_v"] = h, cache["k"], cache["v"]

    # (8, 1): data-parallel only, then the sequence-split prefill
    m81 = tmesh.make_mesh(8, 1, device_type="cpu")
    res["coords81"] = list(m81.get_coordinate())
    dp_models, dp_voc = trun.build_sharded_models(m81, cfg, seed=1)
    wav, n_frames = trun.sharded_generate_step(
        m81, cfg, dp_models, dp_voc, batch=8, prompt_len=4, max_steps=2,
        seed=1)
    res["dp_wav"], res["dp_n_frames"] = wav, n_frames
    rows = set()
    orig_linear = tdec.linear

    def linear(x, w):
        rows.add(x.shape[-2])
        return orig_linear(x, w)
    tdec.linear = linear
    with _Counter(dist, {"data": m81.get_group("data")}) as c:
        h, _, cache = tcontext.prefill_sequence_sharded(
            m81, sp_full, sp_tc, sp_x, pos, tdec.init_kv_cache(sp_tc, 1), 0)
    tdec.linear = orig_linear
    res["sp_rows"] = rows
    res["sp_all_reduce"] = c.summary()
    res["sp_h"], res["sp_k"], res["sp_v"] = h, cache["k"], cache["v"]

    # a local mesh: hosts of 4 ranks, each (2, 2)
    lm = tmesh.make_local_mesh(model=2, local_world_size=4,
                               device_type="cpu")
    res["local_coords"] = list(lm.get_coordinate())

    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.port, a.dir)
