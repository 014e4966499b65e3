"""The launch plans of the cluster kernels, and their merge order, on the
CPU (no card needed).

`csrc/gemv.cu` (B, B8, B4) and `csrc/decode_attention.cu` divide their
work with integer arithmetic inside the kernel. The mirrors below repeat
that arithmetic in Python, block by block, and check that it covers every
K row (B4: every packed group, whole) and output column (gemv) and every
live cache slot (attention) exactly once, in order. `split_merge_attention` repeats the attention kernel's
order of operations (per split, per group an online softmax; groups merged
in group order, splits in rank order, each merge in two passes: the max,
then the rescaled sums; the current token last) in f32 and
is held against `decode_attention_plain` (atol 1e-5: the same math, sums in
another order).
"""

import math

import pytest
import torch

from qwen3_tts_tpu_torch.ops import flash_decode
from qwen3_tts_tpu_torch.ops import gemv as G

# (K, N) of every B / B8 product on the main path: the talker's qkv, wo,
# gate/up, down and head, the predictor's, and one predictor head slice
MAIN_PATH = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048),
             (2048, 2176), (1024, 3072), (1024, 1024), (1024, 6144),
             (3072, 1024), (1024, 2048)]


def gemv_blocks(splits, M, K, N):
    """What each block of the B / B8 kernel covers, by the kernel's own
    arithmetic: (K rows, columns, x rows, rank, the slice of the tile's
    (row, column) elements that the rank reduces)."""
    mt_max = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    for by in range(-(-M // mt_max)):
        for bx in range(-(-N // G.TILE_N) * splits):
            tile, rank = divmod(bx, splits)
            m0 = by * mt_max
            mt = min(mt_max, M - m0)
            rows = -(-K // splits)
            kb = min(K, rank * rows)
            ke = min(K, kb + rows)
            c0 = tile * G.TILE_N
            total = mt * G.TILE_N
            per = -(-total // splits)
            red = range(rank * per, min(total, (rank + 1) * per))
            yield (range(kb, ke), range(c0, min(c0 + G.TILE_N, N)),
                   range(m0, m0 + mt), rank, red)


@pytest.mark.parametrize("w_bytes", [2, 1, 4])
@pytest.mark.parametrize("K,N", MAIN_PATH)
def test_gemv_plan_covers_every_row_and_column_once(K, N, w_bytes):
    for M in (1, 2, 3, 8, 32):
        for per_sm in (1, 2, 3):
            splits = G.gemv_splits(M, K, N, w_bytes, sms=132, per_sm=per_sm)
            assert 1 <= splits <= G.MAX_SPLITS
            assert splits & (splits - 1) == 0
            if splits > 1:           # at least 32 KB of weights a block
                assert (-(-K // splits)) * G.TILE_N * w_bytes \
                    >= G.MIN_BLOCK_BYTES
            # per (x row chunk, column tile): its ranks' K ranges, in rank
            # order, are [0, K); the tiles' columns are [0, N) and the
            # chunks' x rows [0, M); each element of a tile is reduced by
            # exactly one rank
            k_of, red_of, cols, xrows = {}, {}, {}, {}
            for ks, cs, ms, rank, red in gemv_blocks(splits, M, K, N):
                key = (ms.start, cs.start)
                k_of.setdefault(key, []).append((rank, list(ks)))
                red_of.setdefault(key, []).extend(red)
                cols[cs.start] = list(cs)
                xrows[ms.start] = list(ms)
            for key, parts in k_of.items():
                ks = [k for _, r in sorted(parts) for k in r]
                assert ks == list(range(K)), (M, per_sm, splits, key)
                assert sorted(red_of[key]) == list(
                    range(len(xrows[key[0]]) * G.TILE_N))
            assert [c for t in sorted(cols) for c in cols[t]] \
                == list(range(N))
            assert [m for c in sorted(xrows) for m in xrows[c]] \
                == list(range(M))


# (K, N) of every B4 product on the main path (the int4 talker's qkv, wo,
# gate/up, down and head; an int4 predictor's), and one of two groups
MAIN_PATH4 = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048),
              (2048, 2176), (1024, 3072), (1024, 1024), (1024, 6144),
              (3072, 1024), (1024, 2048), (512, 264)]
GROUP2 = 2 * G.GROUP4                  # k's of a packed group


def gemv4_blocks(splits, M, K, N):
    """What each block of the B4 kernel covers, by the kernel's own
    arithmetic: (packed groups, columns, x rows, rank)."""
    mt_max = G.row_tile(M, 4)
    ng2 = K // GROUP2
    per = -(-ng2 // splits)
    for by in range(-(-M // mt_max)):
        for bx in range(-(-N // G.TILE_N) * splits):
            tile, rank = divmod(bx, splits)
            m0 = by * mt_max
            gb = min(ng2, rank * per)
            ge = min(ng2, gb + per)
            c0 = tile * G.TILE_N
            yield (range(gb, ge), range(c0, min(c0 + G.TILE_N, N)),
                   range(m0, min(m0 + mt_max, M)), rank)


@pytest.mark.parametrize("K,N", MAIN_PATH4)
def test_gemv4_plan_covers_every_packed_group_once(K, N):
    ng2 = K // GROUP2
    for M in (1, 2, 3, 8, 32):
        for per_sm in (1, 2, 3):
            splits = G.gemv4_splits(M, K, N, sms=132, per_sm=per_sm)
            assert 1 <= splits <= min(G.MAX_SPLITS, ng2)
            assert splits & (splits - 1) == 0
            groups_of, cols, xrows = {}, {}, {}
            for gs, cs, ms, rank in gemv4_blocks(splits, M, K, N):
                groups_of.setdefault((ms.start, cs.start), []).append(
                    (rank, list(gs)))
                cols[cs.start] = list(cs)
                xrows[ms.start] = list(ms)
            for key, parts in groups_of.items():
                # ranks in order take whole groups [0, ng2), each once
                assert [r for r, _ in sorted(parts)] == list(range(splits))
                gs = [grp for _, r in sorted(parts) for grp in r]
                assert gs == list(range(ng2)), (M, per_sm, splits, key)
            assert [c for t in sorted(cols) for c in cols[t]] \
                == list(range(N))
            assert [m for c in sorted(xrows) for m in xrows[c]] \
                == list(range(M))


def test_gemv4_plan_never_splits_past_the_groups():
    # one packed group: never a cluster; two: at most two ranks
    assert G.gemv4_splits(1, GROUP2, 128, sms=132, per_sm=3) == 1
    assert G.gemv4_splits(1, 2 * GROUP2, 128, sms=132, per_sm=3) == 2
    assert G.gemv4_splits(1, 24 * GROUP2, 2048, sms=132, per_sm=3) == 8


def attention_ranges(kv_len, valid_from, T, n_splits):
    """The live slots of each split (cluster rank), by the kernel's
    arithmetic."""
    length = min(kv_len, T)
    lo = max(valid_from, 0)
    live = max(length - lo, 0)
    per = -(-live // n_splits)
    out = []
    for rank in range(n_splits):
        s0 = lo + rank * per
        out.append(range(s0, max(s0, min(s0 + per, length))))
    return out


def group_slots(r, n_groups):
    """The slots of each group of a block: round robin over its range."""
    return [list(range(r.start + gi, r.stop, n_groups))
            for gi in range(n_groups)]


@pytest.mark.parametrize("T", [32, 256, 4096])
@pytest.mark.parametrize("kv_len", [0, 1, 15, 96, 4095])
def test_attention_splits_cover_live_slots_once_in_order(kv_len, T):
    for valid_from in (0, 3, 14, 40):
        for n_splits in sorted({1, 3, 8,
                                flash_decode.attention_splits(1, 8, T, 132)}):
            ranges = attention_ranges(kv_len, valid_from, T, n_splits)
            slots = [j for r in ranges for j in r]
            assert slots == list(range(valid_from, min(kv_len, T)))
            for hd in (16, 128):
                n_groups = 128 // (hd // 8)
                for r in ranges:
                    got = sorted(j for g in group_slots(r, n_groups)
                                 for j in g)
                    assert got == list(r)


def split_merge_attention(q, k_all, v_all, k_new, v_new, layer, kv_len,
                          valid_from, n_splits, hd_lanes=8, threads=128):
    """The kernel's order of operations in f32 (see the module docstring)."""
    B, nq, hd = q.shape
    nk, T = k_all.shape[2], k_all.shape[3]
    g = nq // nk
    n_groups = threads // (hd // hd_lanes)
    neg = -1e30

    def merge(states):
        """Two passes: the max, then l and acc rescaled to it and summed in
        order."""
        mm = max([neg] + [m for m, _, _ in states])
        ll, aa = 0.0, torch.zeros(hd)
        for m, l, acc in states:
            c = math.exp(m - mm)
            ll, aa = ll + l * c, aa + acc * c
        return mm, ll, aa

    out = torch.empty(B, nq, hd)
    for b in range(B):
        for h in range(nk):
            k = k_all[layer, b, h].float()
            v = v_all[layer, b, h].float()
            for r in range(g):
                qr = q[b, h * g + r].float() / math.sqrt(hd)
                blocks = []
                for rng in attention_ranges(int(kv_len[b]),
                                            int(valid_from[b]), T, n_splits):
                    groups = []
                    for slots in group_slots(rng, n_groups):
                        m, l, acc = neg, 0.0, torch.zeros(hd)
                        for j in slots:           # online softmax
                            s = float(qr @ k[j])
                            mn = max(m, s)
                            a, p = math.exp(m - mn), math.exp(s - mn)
                            l = l * a + p
                            acc = acc * a + p * v[j]
                            m = mn
                        groups.append((m, l, acc))
                    blocks.append(merge(groups))            # group order
                m, l, acc = merge(blocks)                   # rank order
                s_new = float(qr @ k_new[b, h].float())
                m_fin = max(m, s_new)
                a, p_new = math.exp(m - m_fin), math.exp(s_new - m_fin)
                out[b, h * g + r] = (acc * a + p_new * v_new[b, h].float()) \
                    / max(l * a + p_new, 1e-30)
    return out


@pytest.mark.parametrize("n_splits", [1, 4, 8])
@pytest.mark.parametrize("lens,vfrom", [
    ((0, 0), (0, 0)),          # no cache slot: the current token alone
    ((5, 3), (5, 7)),          # fully masked prefixes (valid_from >= kv_len)
    ((3, 1), (0, 0)),          # fewer slots than splits: empty splits
    ((40, 17), (10, 2)),       # left padding
    ((64, 40), (0, 39)),       # kv_len past T; one live slot
])
def test_split_merge_matches_plain(lens, vfrom, n_splits):
    gen = torch.Generator().manual_seed(0)
    B, nq, nk, hd, T = 2, 4, 2, 16, 40
    q = torch.randn(B, nq, hd, generator=gen)
    k_all, v_all = (torch.randn(2, B, nk, T, hd, generator=gen)
                    for _ in range(2))
    k_new, v_new = (torch.randn(B, nk, hd, generator=gen) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32)
    valid_from = torch.tensor(vfrom, dtype=torch.int32)
    got = split_merge_attention(q, k_all, v_all, k_new, v_new, 1, kv_len,
                                valid_from, n_splits)
    want = flash_decode.decode_attention_plain(q, k_all, v_all, k_new, v_new,
                                               1, kv_len, valid_from)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
