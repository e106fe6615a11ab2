"""The merge rule of the split top-2 matchers (K1, K4), on the CPU.

On the card, one pair's train axis is split across S blocks
(`_build.train_splits`); each split keeps the lexicographic top-2 by
(distance, column) of its columns, and the splits' answers are merged in
the same order, with the sentinel (1e30, 0) where fewer than two valid rows
exist.  These tests hold that rule to the unsplit plain versions: the plain
version of each split's columns, merged by a lexicographic merge written
here, must give the unsplit plain answer exactly, for every split count the
kernels can pick.  Descriptors have small integer entries, so every
distance is exact in fp32 and ties are common.
"""
import numpy as np
import pytest
import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels.hamming_kernel import (
    MIN_SPLIT_COLS as K4_MIN_COLS, ROWS_PER_BLOCK as K4_ROWS, hamming_top2_plain)
from points_matching_tpu_torch.ops.kernels.matching_kernel import (
    MIN_SPLIT_COLS as K1_MIN_COLS, ROWS_PER_BLOCK as K1_ROWS, l2_top2_plain)

BIG = 1e30
H100_SMS = 132


def _split_ranges(n2, s):
    """The kernels' split s of S: columns [s·N2/S, (s+1)·N2/S)."""
    return [(i * n2 // s, (i + 1) * n2 // s) for i in range(s)]


def _merge(parts):
    """Lexicographic top-2 by (distance, column) of the splits' top-2s,
    sentinels dropped, then (1e30, 0) where fewer than two remain."""
    out_d, out_i = [], []
    for row in range(parts[0][0].shape[0]):
        cand = sorted((float(d[row, k]), int(i[row, k]))
                      for d, i in parts for k in range(2) if float(d[row, k]) < BIG)
        cand = (cand + [(BIG, 0), (BIG, 0)])[:2]
        out_d.append([c[0] for c in cand])
        out_i.append([c[1] for c in cand])
    return (torch.tensor(out_d, dtype=torch.float32),
            torch.tensor(out_i, dtype=torch.int32))


def _split_top2(top2, q, t, mask, s):
    parts = []
    for lo, hi in _split_ranges(t.shape[0], s):
        if hi > lo:                       # an empty split leaves only sentinels
            d, i = top2(q[None], t[None, lo:hi], mask[None, lo:hi])
            parts.append((d[0], i[0] + lo))
    return _merge(parts)


def _descriptors(metric, rng, n1, n2):
    if metric == "l2":
        q = torch.from_numpy(rng.integers(-1, 2, (n1, 64)).astype(np.float32))
        t = torch.from_numpy(rng.integers(-1, 2, (n2, 64)).astype(np.float32))
        return q, t, l2_top2_plain
    words = lambda n: torch.from_numpy(                                    # noqa: E731
        rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    return words(n1), words(n2), hamming_top2_plain


def _case(metric, name):
    rng = np.random.default_rng(["ties", "repeats", "none", "one", "one_last",
                                 "tiny"].index(name))
    n2 = 3 if name == "tiny" else 37
    q, t, top2 = _descriptors(metric, rng, 24, n2)
    if metric == "hamming":                   # few distinct distances: many ties
        t = t & 0x11111111
        q = q & 0x11111111
    mask = torch.from_numpy(rng.random(n2) > 0.15)
    if name == "repeats":                     # equal rows on both sides of split boundaries
        t[20:] = t[:17]
        q[:8] = t[3:11]
    elif name == "none":
        mask[:] = False
    elif name in ("one", "one_last"):
        mask[:] = False
        mask[n2 - 1 if name == "one_last" else 5] = True
    return q, t, mask, top2


@pytest.mark.parametrize("name", ["ties", "repeats", "none", "one", "one_last", "tiny"])
@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_split_top2_merges_to_the_unsplit_answer(metric, name):
    q, t, mask, top2 = _case(metric, name)
    want_d, want_i = top2(q[None], t[None], mask[None])
    if name == "ties":
        assert bool((want_d[0, :, 0] == want_d[0, :, 1]).any())     # the case has ties
    for s in range(1, 9):
        got_d, got_i = _split_top2(top2, q, t, mask, s)
        assert torch.equal(got_d, want_d[0]), (metric, name, s)
        assert torch.equal(got_i, want_i[0]), (metric, name, s)


@pytest.mark.parametrize("rows,min_cols,n,label", [
    (K1_ROWS, K1_MIN_COLS, 512, "K1"), (K4_ROWS, K4_MIN_COLS, 1024, "K4")])
def test_train_splits_fill_the_card_for_one_pair(rows, min_cols, n, label):
    """One pair of the slices' size launches at least one block per SM; 64
    pairs fill the card without a split; a split never has fewer than
    `min_cols` columns."""
    tiles = -(-n // rows)
    s1 = _build.train_splits(1, tiles, n, H100_SMS, min_cols)
    assert tiles * s1 >= H100_SMS, label
    assert min(hi - lo for lo, hi in _split_ranges(n, s1)) >= min_cols
    assert _build.train_splits(64, tiles, n, H100_SMS, min_cols) == 1
    assert _build.train_splits(1, tiles, 3, H100_SMS, min_cols) == 1      # N2 < one split
    assert _build.train_splits(0, tiles, n, H100_SMS, min_cols) == 1
