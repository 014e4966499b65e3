"""The port's capability probes (`qwen3_tts_tpu_torch/tools/mosaic_probe.py`)
against the JAX tool (`tools/mosaic_probe.py`) on the CPU.

For each of the eight probes: the JAX probe runs unchanged in interpret
mode (it asserts its own result), and the port's plain version, fed the JAX
probe's own inputs, is compared with the JAX expression of what the probe
expects. Data-moving probes and the argmax are compared exactly (onehot
on non-finite tables as values: NaN equal to NaN, -0 equal to +0, which
is what np.testing.assert_array_equal compares); probe 12
(an f32 sum of exact bf16 x int8 products) within rtol 1e-6 of jnp.dot, with
an absolute floor of 1e-6 of the output's largest magnitude: both sides sum
the same products in another order, and an element near zero has no
relative bound. The kernels themselves are held against these plain
versions on the card (`tests/test_torch_kernels.py`, `chip_smoke.py`).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.tools import mosaic_probe as tprobe
from tools import mosaic_probe as jprobe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_inputs(name):
    """The JAX probe's inputs, built as it builds them."""
    if name == "hbm_scratch":
        return (jnp.ones((64, 128), jnp.float32),)
    if name == "fori_dma":
        return (jnp.arange(4 * 8 * 128, dtype=jnp.float32).reshape(4, 8, 128),)
    if name == "argmax":
        return (jax.random.normal(jax.random.key(0), (8, 2048), jnp.float32),)
    if name == "dyn_sublane":
        return (jnp.arange(32 * 128, dtype=jnp.float32).reshape(32, 128),
                jnp.array([7], jnp.int32))
    if name == "rot":
        return (jax.random.normal(jax.random.key(1), (8, 16, 128),
                                  jnp.float32),)
    if name == "onehot":
        codes = jnp.array([[3], [7], [0], [255], [9], [1], [2], [4]],
                          jnp.int32)
        return (jnp.broadcast_to(codes, (8, 128)),
                jax.random.normal(jax.random.key(2), (256, 128), jnp.float32))
    if name == "dyn_col_dma":
        return (jnp.array([2], jnp.int32),
                jnp.arange(128 * 2048, dtype=jnp.float32).reshape(128, 2048))
    assert name == "int8_panel"
    x = jax.random.normal(jax.random.key(3), (16, 512)).astype(jnp.bfloat16)
    w = jax.random.randint(jax.random.key(4), (512, 512), -127, 127,
                           jnp.int8)
    return x, w


def _jax_expect(name, *a):
    """The JAX expression of the probe's expectation, at the port's output
    shape."""
    if name == "hbm_scratch":
        return a[0] * 2.0
    if name == "fori_dma":
        return a[0].sum(axis=0)
    if name == "argmax":
        idx = jnp.argmax(a[0], axis=-1).astype(jnp.int32)
        return jnp.broadcast_to(idx[:, None], (a[0].shape[0], 128))
    if name == "dyn_sublane":
        return jnp.broadcast_to(a[0][7], (8, 128))
    if name == "rot":
        return jnp.concatenate([-a[0][..., 64:], a[0][..., :64]], axis=-1)
    if name == "onehot":
        return a[1][a[0][:, 0]]
    if name == "dyn_col_dma":
        return a[1][:, 1280:1536]
    return jnp.dot(a[0].astype(jnp.float32), a[1][:, :256].astype(jnp.float32))


def _torch(a):
    a = np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a)


JAX_PROBES = {"hbm_scratch": jprobe.p_hbm_scratch,
              "fori_dma": jprobe.p_fori_dma, "argmax": jprobe.p_argmax,
              "dyn_sublane": jprobe.p_dyn_sublane, "rot": jprobe.p_rot,
              "onehot": jprobe.p_onehot, "dyn_col_dma": jprobe.p_dyn_col_dma,
              "int8_panel": jprobe.p_int8_panel}
NAMES = [p.name for p in tprobe.PROBES]


def test_probe_table_covers_the_jax_tool():
    assert sorted(NAMES) == sorted(JAX_PROBES)
    src = open(os.path.join(REPO, "tools", "mosaic_probe.py")).read()
    lines = src.splitlines()
    for p in tprobe.PROBES:
        assert lines[p.line - 1].startswith(f"def p_{p.name}("), p
        assert "pl.pallas_call(" in lines[p.call - 1], p
        assert p.line < p.call


@pytest.mark.parametrize("name", NAMES)
def test_probe_plain_matches_jax(name, capsys):
    # the JAX probe, unchanged, in interpret mode: it asserts itself
    JAX_PROBES[name]()
    out = capsys.readouterr().out
    assert "[interpret]" in out and ": OK" in out and "FAIL" not in out, out

    jin = _jax_inputs(name)
    tin = [_torch(a) for a in jin]
    if name == "int8_panel":
        tin = [tin[0].bfloat16(), tin[1]]
    probe = next(p for p in tprobe.PROBES if p.name == name)
    got = probe.plain(*tin)
    probe.check(got, *tin)              # the tool's own check passes too
    want = np.asarray(_jax_expect(name, *jin))
    if name == "int8_panel":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(probe.kernel(*tin).numpy(), got.numpy())


def test_onehot_out_of_range_codes_give_zero_rows():
    """One-hot semantics for codes outside [0, 256): the jnp one-hot
    formula gives a zero row, and so does the port."""
    codes = jnp.broadcast_to(jnp.array([[3], [-1], [256], [255], [1000], [0],
                                        [-7], [4]], jnp.int32), (8, 128))
    tab = jax.random.normal(jax.random.key(2), (256, 128), jnp.float32)
    oh = (jnp.arange(256)[None] == codes[:, :1]).astype(jnp.float32)
    want = np.asarray(jnp.dot(oh, tab, preferred_element_type=jnp.float32))
    got = tprobe.onehot_plain(_torch(codes), _torch(tab))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[[1, 2, 4, 6]].any()


def _onehot_rule(codes, tab):
    """The rule csrc/probes.cu's onehot_kernel applies, in numpy: with c =
    codes[r, 0], hit = 0 <= c < vocab and n_j the non-finite entries
    (exponent bits all ones) of column j, out[r, j] is NaN where hit and
    tab[c, j] is NaN, else NaN where n_j - (hit and tab[c, j] non-finite)
    > 0, else tab[c, j] where hit, else 0."""
    c = codes[:, 0].astype(np.int64)
    hit = (c >= 0) & (c < tab.shape[0])
    nonfinite = (tab.view(np.uint32) & 0x7F800000) == 0x7F800000
    row = np.where(hit, c, 0)
    e = np.where(hit[:, None], tab[row], np.float32(0))
    others = nonfinite.sum(0)[None] - (hit[:, None] & nonfinite[row])
    return np.where(np.isnan(e), e, np.where(others > 0, np.float32(np.nan),
                                             e)).astype(np.float32)


# (rows, vocab, d): the probe's shape, and a small table
ONEHOT_SHAPES = [(8, 256, 128), (5, 7, 3)]


@pytest.mark.parametrize("shape", ONEHOT_SHAPES,
                         ids=[f"{r}x{v}x{d}" for r, v, d in ONEHOT_SHAPES])
@pytest.mark.parametrize("kind", tprobe.ONEHOT_KINDS)
def test_onehot_plain_matches_the_tpu_formula_on_non_finite_tables(kind,
                                                                    shape):
    """onehot_plain against the TPU probe's kernel body in jnp
    (one_hot(codes[:, 0]) @ tab) on a seeded normal table with +-inf or a
    NaN of either sign in a chosen row or in another, +inf and -inf in
    one column, -0 entries, or none; codes -1 and vocab in rows 1 and 2.
    NaN equal to NaN and -0 equal to +0; the rule in numpy equals both."""
    rows, vocab, d = shape
    rng = np.random.default_rng(100 * tprobe.ONEHOT_KINDS.index(kind) + vocab)
    codes = tprobe.onehot_codes(rows, 128, vocab, rng)
    tab = tprobe.onehot_table(kind, codes, vocab, d, rng)
    iota = jax.lax.broadcasted_iota(jnp.int32, (rows, vocab), 1)
    oh = (iota == jnp.asarray(codes)[:, 0:1]).astype(jnp.float32)
    want = np.asarray(jnp.dot(oh, jnp.asarray(tab),
                              preferred_element_type=jnp.float32))
    got = tprobe.onehot_plain(torch.from_numpy(codes), torch.from_numpy(tab))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_onehot_rule(codes, tab), want)
    # row 0 chooses the kind's row, rows 1 and 2 (codes -1, vocab) none
    j, col = d // 3, want[:, d // 3]
    if kind in ("finite", "-0"):
        assert not np.isnan(want).any()
        assert not want[1:3].any() and want[0, j] == tab[codes[0, 0], j]
    elif kind.endswith("a chosen row"):
        value = tprobe.ONEHOT_VALUES[kind.split(" in ")[0]]
        same = codes[:, 0] == codes[0, 0]
        assert np.isnan(col[~same]).all() and not same[1:3].any()
        assert (np.isnan(col[same]) if np.isnan(value)
                else col[same] == value).all()
    else:
        assert np.isnan(col).all()
    assert not np.isnan(np.delete(want, j, axis=1)).any()
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tprobe.onehot(torch.from_numpy(codes),
                                     torch.from_numpy(tab)).view(torch.int32),
                       got.view(torch.int32))


ONEHOT_EDGES = tprobe.onehot_edges("cpu", seed=3)


@pytest.mark.parametrize("case", ONEHOT_EDGES,
                         ids=[label for label, _ in ONEHOT_EDGES])
def test_onehot_edges_match_the_tpu_formula(case):
    """The card's onehot edge cases (`onehot_edges`): onehot_plain and the
    rule in numpy against the TPU probe's kernel body in jnp, as values;
    on the table with +inf, NaN and -inf the columns it documents."""
    label, (codes, tab) = case
    iota = jax.lax.broadcasted_iota(jnp.int32, (8, 256), 1)
    oh = (iota == jnp.asarray(codes.numpy())[:, 0:1]).astype(jnp.float32)
    want = np.asarray(jnp.dot(oh, jnp.asarray(tab.numpy()),
                              preferred_element_type=jnp.float32))
    np.testing.assert_array_equal(tprobe.onehot_plain(codes, tab).numpy(),
                                  want)
    np.testing.assert_array_equal(_onehot_rule(codes.numpy(), tab.numpy()),
                                  want)
    if label == "inf / NaN / -inf table":
        assert np.isnan(want[0, [5, 7]]).all() and want[0, 9] == -np.inf
        assert want[1, 5] == np.inf and np.isnan(want[2, [5, 7, 9]]).all()
        assert np.isnan(want[:, 7]).all()
        assert np.isnan(np.delete(want[:, 5], 1)).all()
    elif label == "codes outside the table":
        assert not np.isnan(want).any() and not want[[1, 2, 4, 6]].any()


@pytest.mark.parametrize("pos", [-40, -3, 0, 7, 31, 40])
def test_dyn_sublane_clamps_like_dynamic_slice(pos):
    c = jnp.asarray(np.random.default_rng(pos + 40).standard_normal(
        (32, 128), np.float32))
    want = jax.lax.dynamic_slice_in_dim(c, pos, 1, 0)
    got = tprobe.dyn_sublane_plain(_torch(c),
                                   torch.tensor([pos], dtype=torch.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(np.asarray(want), (8, 128)))


@pytest.mark.parametrize("q", [-9, -1, 0, 3, 5])
@pytest.mark.parametrize("rows,cols", [(128, 2048)] + [
    (r, c) for r in (1, 7, 4, 100, 256) for c in (2048, 260)])
def test_dyn_col_dma_clamps_like_dynamic_slice(q, rows, cols):
    """The clamped column slice at row counts that fill the kernel's
    slices of a few rows (4 by default) partly, wholly or once, on a wide
    and a narrow w (normal draws; the TPU probe's [128, 2048] first)."""
    w = jnp.asarray(np.random.default_rng(rows + cols).standard_normal(
        (rows, cols), np.float32))
    want = jax.lax.dynamic_slice_in_dim(w, q * 512 + 256, 256, 1)
    got = tprobe.dyn_col_dma_plain(torch.tensor([q], dtype=torch.int32),
                                   _torch(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tpu_argmax(x):
    """The TPU probe's kernel body (tools/mosaic_probe.py p_argmax) in
    jnp: max, broadcasted_iota, min(where(x >= m, iota, cols))."""
    m = jnp.max(x, axis=-1, keepdims=True)
    iota = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    return jnp.min(jnp.where(x >= m, iota, x.shape[1]), axis=-1,
                   keepdims=True)


# the index each edge kind gives at `cols` columns (argmax_row's layout);
# "normal" has none fixed
ARGMAX_EXPECT = {"tie": lambda n: n // 7, "all equal": lambda n: 0,
                 "all -inf": lambda n: 0, "+inf twice": lambda n: n // 3,
                 "nan": lambda n: n, "-nan": lambda n: n,
                 "-0 before +0": lambda n: n // 4,
                 "+0 before -0": lambda n: n // 4,
                 "max at 0": lambda n: 0, "max at end": lambda n: n - 1}


@pytest.mark.parametrize("rows", [1, 8, 33])
@pytest.mark.parametrize("cols", [1, 3, 100, 2047, 2048, 4096])
@pytest.mark.parametrize("kind", tprobe.ARGMAX_KINDS)
def test_argmax_plain_matches_the_tpu_formula_on_edge_rows(kind, cols, rows):
    """argmax_plain against the TPU probe's formula in jnp, exactly, on
    rows of each edge kind: ties across warps and 256-column chunks, an
    all-equal and an all -inf row, +inf twice, a NaN of either sign (cols,
    not torch.argmax's index), -0 and +0 as the maximum in either order,
    the maximum first or last."""
    rng = np.random.default_rng(
        1000 * tprobe.ARGMAX_KINDS.index(kind) + cols + rows)
    x = np.stack([tprobe.argmax_row(kind, cols, rng) for _ in range(rows)])
    want = np.asarray(_tpu_argmax(jnp.asarray(x)))
    got = tprobe.argmax_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(want, (rows, 128)))
    if kind in ARGMAX_EXPECT:
        assert (want == ARGMAX_EXPECT[kind](cols)).all(), want[:, 0]
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tprobe.argmax(torch.from_numpy(x)), got)


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [2, 6, 8, 64, 128, 130, 256])
def test_rot_plain_matches_jnp_bit_for_bit(d, ndim):
    """rot_plain against jnp.concatenate([-x[..., h:], x[..., :h]], -1),
    bit for bit, on normal draws with +-0, +-inf and NaN of either sign
    among them (the TPU probe's [8, 16, 128] at d = 128, 3-D)."""
    lead = {1: (), 2: (5,), 3: (8, 16) if d == 128 else (3, 4),
            4: (2, 3, 2)}[ndim]
    x = tprobe.rot_values(lead + (d,), np.random.default_rng(10 * d + ndim))
    h = d // 2
    xj = jnp.asarray(x)
    want = np.asarray(jnp.concatenate([-xj[..., h:], xj[..., :h]], axis=-1))
    for fn in (tprobe.rot_plain, tprobe.rot):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    if x.size >= tprobe.ROT_SPECIALS.size:
        assert np.isnan(x).any() and np.signbit(x[np.isnan(x)]).any()


VARIED = tprobe.varied_inputs("cpu", seed=5)


@pytest.mark.parametrize("case", VARIED, ids=[f"{n}-{l}" for n, l, _ in VARIED])
def test_plain_on_varied_inputs_matches_numpy(case):
    """The plain versions on the non-constant inputs the card checks use,
    against numpy: 2x exactly, the sum in the kernel's order (o = 0;
    o += w[i]) exactly, the clamped row and column slices exactly, the
    argmax as each row's first maximum (cols where it holds a NaN)
    exactly, rotate-half bit for bit, the one-hot product by its rule
    (`_onehot_rule`) as values, and the panel within PANEL_REL_TOL of an
    f64 product (exact products; the sums' order differs)."""
    name, _, args = case
    probe = next(p for p in tprobe.PROBES if p.name == name)
    got = probe.plain(*args)
    a = [t.float().numpy() for t in args]
    if name == "hbm_scratch":
        want = np.float32(2.0) * a[0]
    elif name == "fori_dma":
        want = np.zeros(a[0].shape[1:], np.float32)
        for w in a[0]:
            want = want + w
    elif name == "dyn_sublane":
        p = int(args[1][0])
        p = min(max(p + 32 if p < 0 else p, 0), 31)
        want = np.broadcast_to(a[0][p], (8, 128))
    elif name == "dyn_col_dma":
        c0 = int(args[0][0]) * 512 + 256
        cols = a[1].shape[1]
        c0 = min(max(c0 + cols if c0 < 0 else c0, 0), cols - 256)
        want = a[1][:, c0:c0 + 256]
    elif name == "argmax":
        cols = a[0].shape[1]
        idx = [cols if np.isnan(r).any() else int(np.flatnonzero(
            r == r.max())[0]) for r in a[0]]
        want = np.broadcast_to(np.array(idx, np.int32)[:, None],
                               (len(idx), 128))
    elif name == "rot":
        h = a[0].shape[-1] // 2
        want = np.concatenate([-a[0][..., h:], a[0][..., :h]], -1)
    elif name == "onehot":
        want = _onehot_rule(args[0].numpy(), a[1])
    else:
        assert name == "int8_panel", name
        want = a[0].astype(np.float64) @ a[1][:, :tprobe.PANEL_N].astype(
            np.float64)
    if probe.bitwise:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    elif probe.exact:
        assert got.dtype == (torch.int32 if name == "argmax"
                             else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= tprobe.PANEL_REL_TOL * np.abs(want).max(), err
    # the wrapper takes the plain version for a CPU tensor
    out = probe.kernel(*args)
    if probe.bitwise or probe.values:
        assert torch.equal(out.view(torch.int32), got.view(torch.int32))
    else:
        assert torch.equal(out, got)


def test_varied_inputs_expose_a_misplaced_slice():
    """What a constant tile hides: an output with two CTAs' row slices
    swapped (hbm_scratch, dyn_col_dma; two rows where there is one slice),
    a step dropped or repeated (fori_dma), another row (dyn_sublane) or
    column offset (dyn_col_dma), two column slices swapped (int8_panel),
    torch.argmax's index on a NaN row, a tie's highest index or the
    largest value past a NaN (argmax, beyond one column), the halves
    swapped without the negation (rot, by its bits), or a one-hot row
    loaded blind to the other rows' non-finite entries or from the next
    row of the table (onehot, as values, where the inputs can show it)
    differs from the plain version on every varied input; on the tool's
    ones-tile the swap does not show."""
    ones = tprobe.probe_inputs("cpu")["hbm_scratch"][0]
    want = tprobe.hbm_scratch_plain(ones)
    assert torch.equal(torch.cat([want[8:16], want[:8], want[16:]]), want)
    steps, onehot_shown = [], 0
    for name, label, args in VARIED:
        probe = next(p for p in tprobe.PROBES if p.name == name)
        want = probe.plain(*args)
        if name == "hbm_scratch":
            bad = torch.cat([want[8:16], want[:8], want[16:]])
        elif name == "fori_dma":
            w = args[0]
            steps.append(w.shape[0])
            bad = tprobe.fori_dma_plain(torch.cat([w, w[-1:]]))
            if w.shape[0] > 1:
                dropped = tprobe.fori_dma_plain(w[:-1])
                assert not torch.equal(dropped, want), label
        elif name == "dyn_sublane":
            c, pos = args
            p = int(tprobe.dynamic_start(pos, c.shape[0], 1))
            bad = tprobe.dyn_sublane_plain(c, pos.new_tensor(
                [p + 1 if p < c.shape[0] - 1 else p - 1]))
        elif name == "dyn_col_dma":
            q, w = args
            n = max(1, w.shape[0] // 2)
            if w.shape[0] > 1:
                swapped = torch.cat([want[n:2 * n], want[:n], want[2 * n:]])
                assert not torch.equal(swapped, want), label
            # the slice at a neighbouring column offset
            c0 = int(tprobe.dynamic_start(q.long() * tprobe.COL_MUL
                                          + tprobe.COL_ADD, w.shape[1],
                                          tprobe.COL_WIDTH))
            c1 = c0 - 4 if c0 >= 4 else c0 + 4
            bad = w[:, c1:c1 + tprobe.COL_WIDTH]
        elif name == "argmax":
            x = args[0].numpy()
            cols = x.shape[1]

            def rows_out(idx):
                return torch.tensor(idx, dtype=torch.int32)[:, None].expand(
                    -1, 128)
            if cols > 1:
                # a tie's highest index; a NaN passed over
                last = [cols if np.isnan(r).any() else int(np.flatnonzero(
                    r == r.max())[-1]) for r in x]
                fin = [r[~np.isnan(r)] for r in x]
                past = [int(np.flatnonzero(r == f.max())[0]) if f.size
                        else cols for r, f in zip(x, fin)]
                assert not torch.equal(rows_out(last), want), label
                assert not torch.equal(rows_out(past), want), label
            bad = torch.argmax(args[0], -1).to(torch.int32)[:, None].expand(
                -1, 128)
        elif name == "rot":
            x = args[0]
            h = x.shape[-1] // 2
            bad = torch.cat([x[..., h:], x[..., :h]], -1)
            assert not torch.equal(bad.view(torch.int32),
                                   want.view(torch.int32)), label
            continue
        elif name == "onehot":
            codes, tab = args
            vocab = tab.shape[0]
            c = codes[:, 0].long()
            hit = (c >= 0) & (c < vocab)
            load = torch.where(hit[:, None], tab[c.clamp(0, vocab - 1)],
                               torch.zeros(()))
            unchosen = torch.ones(vocab, dtype=torch.bool)
            unchosen[c[hit]] = False
            # an unchosen row's inf or NaN makes a column of row 0 NaN
            # that the row load fills from the table
            if (~tab[unchosen].isfinite() & ~tab[c[0]].isnan()).any():
                assert not tprobe.agree(probe, load, want)[0], label
                onehot_shown += 1
            if vocab > 1 and want[0].isfinite().any():
                bad = want.clone()
                bad[0] = tab[(c[0] + 1) % vocab]
                assert not tprobe.agree(probe, bad, want)[0], label
            continue
        else:
            bad = torch.cat([want[:, 32:64], want[:, :32], want[:, 64:]], 1)
            w = args[1]
            assert int(w.min()) == -128 and int(w.max()) == 127, label
        assert not torch.equal(bad, want), label
    assert tuple(steps) == tprobe.FORI_STEPS == (1, 2, 3, 4, 5, 9)
    assert onehot_shown >= 14, onehot_shown     # of 45 at seed 5


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_refuses_a_non_cuda_device(name):
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device (here `meta`) is refused, never run through plain."""
    probe = next(p for p in tprobe.PROBES if p.name == name)
    args = [t.to("meta") for t in tprobe.probe_inputs("cpu")[name]]
    before = probe.kernel.launches
    with pytest.raises((ValueError, TypeError)):
        probe.kernel(*args)
    assert probe.kernel.launches == before


def test_tool_cpu_runs_eight_plain_probes():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.tools.mosaic_probe",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    ok = [l for l in r.stdout.splitlines() if l.strip().startswith("[plain]")
          and l.endswith(": OK")]
    assert len(ok) == 8, r.stdout
    assert "FAIL" not in r.stdout and "[kernel]" not in r.stdout


def test_tool_cuda_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprobe.main(["--device", "cuda"]) != 0
    out = capsys.readouterr()
    assert "[plain]" not in out.out and "is_available" in out.err


def test_tool_exits_1_on_a_failed_probe(monkeypatch, capsys):
    """Divergence from the JAX tool, which exits 0 after printing FAIL."""
    bad = tprobe.PROBES[2]
    monkeypatch.setattr(tprobe, "PROBES", tprobe.PROBES[:2] + (
        dataclasses.replace(bad, plain=lambda x: bad.plain(x) + 1),))
    assert tprobe.main(["--device", "cpu"]) == 1
    assert "[plain] " + bad.label + ": FAIL" in capsys.readouterr().out
