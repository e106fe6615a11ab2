"""The tile rule of the RANSAC scorer (K2), on the CPU.

On the card, a warp of K2 scores one hypothesis at a time over the pair's
points, which each lane holds in registers; a block holds 2 or 8 warps and
a warp 1, 2, 4, 8 or 16 hypotheses (`_build.ransac_score_tile` picks them from
the hypothesis count and the SM count), and the tile changes no count.
These tests hold the rule: the tile is one the kernel is built for, one
pair spreads over every SM, larger batches never get fewer hypotheses a
warp, and at the H100's 132 SMs the rule picks the tile that was fastest
at each shape of the sweep that set it
(``examples/probe_ransac_score_torch.py --shapes``).
"""
import pytest
import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
    TILES, ransac_score_hypotheses, ransac_score_plain)

H100_SMS = 132
BATCHES = [(0, 512), (1, 1), (1, 33), (1, 128), (1, 256), (1, 512), (2, 512), (4, 256),
           (4, 512), (5, 256), (8, 512), (16, 512), (32, 512), (64, 128), (64, 512),
           (300, 128), (1132, 128), (10**5, 512)]
# the sweep on an H100 (132 SMs): (pairs, hypotheses) → the fastest tile
# (by the slower of two turns) among those the kernel is built for, or, at
# 4 and 8 pairs of 512, a tile within 6 % of it, whose lead moved between
# calls (PERF.md, the K2 sweep)
SWEEP_FASTEST = [((1, 512), (2, 1)), ((1, 256), (2, 1)), ((1, 128), (2, 1)),
                 ((4, 256), (8, 1)), ((2, 512), (8, 1)), ((4, 512), (8, 1)),
                 ((8, 512), (8, 2)), ((16, 512), (8, 4)), ((64, 128), (8, 4)),
                 ((32, 512), (8, 8)), ((64, 512), (8, 16)), ((1132, 128), (8, 16))]


@pytest.mark.parametrize("num_sms", [1, 16, 114, H100_SMS])
def test_tile_is_one_the_kernel_is_built_for(num_sms):
    for pairs, hyps in BATCHES:
        assert _build.ransac_score_tile(pairs, hyps, num_sms) in TILES


def test_one_pair_spreads_over_every_sm():
    """The slices launch one pair of 128 to 512 hypotheses: a warp a
    hypothesis, two warps a block, so the pair's warps reach every SM or
    the hypotheses run out first."""
    for hyps in (128, 256, 512):
        warps, per_warp = _build.ransac_score_tile(1, hyps, H100_SMS)
        assert per_warp == 1
        blocks = -(-hyps // (warps * per_warp))
        assert blocks >= min(H100_SMS, hyps // 2)


@pytest.mark.parametrize("num_sms", [16, 114, H100_SMS])
def test_hypotheses_a_warp_never_fall_as_the_batch_grows(num_sms):
    tiles = [_build.ransac_score_tile(p, h, num_sms) for p, h in
             sorted(BATCHES, key=lambda ph: ph[0] * ph[1])]
    per_warp = [k for _, k in tiles]
    warps = [w for w, _ in tiles]
    assert all(a <= b for a, b in zip(per_warp, per_warp[1:])), tiles
    assert all(a <= b for a, b in zip(warps, warps[1:])), tiles
    assert tiles[-1] == (8, 16)


@pytest.mark.parametrize("batch,fastest", SWEEP_FASTEST)
def test_tile_is_the_fastest_of_the_h100_sweep(batch, fastest):
    assert _build.ransac_score_tile(*batch, H100_SMS) == fastest


@pytest.mark.parametrize("tile", [(4, 1), (2, 3), (8, 32), (1, 1), (2,), [2, 1], 2])
def test_wrapper_rejects_other_tiles(tile):
    F = torch.zeros(1, 2, 3, 3)
    p = torch.zeros(1, 5, 2)
    with pytest.raises(ValueError):
        ransac_score_hypotheses(F, p, p, torch.ones(1, 5, dtype=torch.bool), 1.5, _tile=tile)


def test_cpu_takes_the_plain_version_with_any_tile():
    g = torch.Generator().manual_seed(0)
    F = torch.randn(2, 40, 3, 3, generator=g) * 1e-3
    p1 = torch.rand(2, 300, 2, generator=g) * 640
    p2 = p1 + 2 * torch.randn(2, 300, 2, generator=g)
    mask = torch.rand(2, 300, generator=g) > 0.1
    want = ransac_score_plain(F, p1, p2, mask, 1.5)
    before = ransac_score_hypotheses.launches
    for tile in (None,) + TILES:
        assert torch.equal(ransac_score_hypotheses(F, p1, p2, mask, 1.5, _tile=tile), want)
    assert ransac_score_hypotheses.launches == before      # no kernel on the CPU
