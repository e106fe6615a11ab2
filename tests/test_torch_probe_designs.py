"""The host's rules for the probes' tensor-core kernels, on the CPU.

P1/P2 (``ops/kernels/probe_match.py``) and the bf16 score instances
(``probe_score.py``) are built in two designs, the warp-level ``mma.sync``
kernel (``warp``) and the ``wgmma`` kernel with its mbarrier ring
(``warpgroup``); the wrapper picks one from the launch's size and the SM
count, and splits the loop axis by the design's own rule.  Both designs
give the plain version's results within the same tolerances (the card
tests hold each), so the rules decide speed only.  These tests hold them:
at the H100's 132 SMs each picks the design that was faster at each pair
count of the sweep that set it (PERF.md; ``--parent`` of the two probe
scripts), the split count keeps a warpgroup launch within one wave, and
the fp32 score instance has the warp design only.
"""
import pytest

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import probe_match as pm
from points_matching_tpu_torch.ops.kernels import probe_score as ps

H100_SMS = 132
PAIRS = (1, 2, 4, 8, 16, 32, 64)
# the sweep on an H100 (512 × 512 × 64 a pair; 512 hypotheses × 512
# points a pair): the pair counts where the warpgroup design was faster
MATCH_WARPGROUP = {"gemm_rowmin": {16, 32, 64}, "packed_top2": {8, 16, 32, 64}}
SCORE_WARPGROUP = {"bf16x1": {1, 2, 4, 8, 16, 32}, "bf16x3": {1, 2, 4, 8}}


@pytest.mark.parametrize("kernel", ["gemm_rowmin", "packed_top2"])
def test_match_design_is_the_faster_at_each_swept_shape(kernel):
    for pairs in PAIRS:
        want = "warpgroup" if pairs in MATCH_WARPGROUP[kernel] else "warp"
        assert pm.design(kernel, pairs, 512, H100_SMS) == want, pairs


@pytest.mark.parametrize("products", ["bf16x1", "bf16x3"])
def test_score_design_is_the_faster_at_each_swept_shape(products):
    for pairs in PAIRS:
        want = "warpgroup" if pairs in SCORE_WARPGROUP[products] else "warp"
        assert ps.design(pairs, 512, products, H100_SMS) == want, pairs


@pytest.mark.parametrize("num_sms", [1, 16, 114, H100_SMS])
def test_fp32_score_is_the_warp_design(num_sms):
    for pairs in PAIRS:
        assert ps.design(pairs, 512, "f32", num_sms) == "warp"


@pytest.mark.parametrize("num_sms", [1, 16, 114, H100_SMS])
def test_designs_move_one_way_with_the_batch(num_sms):
    """More pairs never take the match back to the warp design, nor the
    score back to the warpgroup design."""
    for kernel in ("gemm_rowmin", "packed_top2"):
        picks = [pm.design(kernel, p, 512, num_sms) for p in range(1, 200)]
        assert picks == sorted(picks, key=("warp", "warpgroup").index)
    for products in ("bf16x1", "bf16x3"):
        picks = [ps.design(p, 512, products, num_sms) for p in range(1, 200)]
        assert picks == sorted(picks, key=("warpgroup", "warp").index)


@pytest.mark.parametrize("blocks,n_axis,min_per,want", [
    (0, 512, 8, 1), (1, 512, 8, 64), (2, 512, 8, 64), (16, 512, 8, 8), (32, 512, 32, 4),
    (128, 512, 8, 1), (132, 512, 8, 1), (256, 512, 8, 1), (4, 512, 32, 16), (3, 7, 8, 1)])
def test_one_wave_splits(blocks, n_axis, min_per, want):
    assert _build.one_wave_splits(blocks, n_axis, H100_SMS, min_per) == want


@pytest.mark.parametrize("pairs", PAIRS + (3, 100))
def test_warpgroup_launches_fit_one_wave(pairs):
    """A warpgroup launch (one block an SM) never spills into a second
    wave by its splits, and a split keeps its minimum of columns or
    points."""
    for n1, n2 in ((512, 512), (1, 9), (513, 1000)):
        tiles = -(-n1 // pm.ROWS_PER_BLOCK["warpgroup"])
        S = pm.splits("warpgroup", pairs, n1, n2, H100_SMS)
        assert S == 1 or pairs * tiles * S <= H100_SMS
        assert S == 1 or -(-n2 // 8) * 8 // S >= pm.MIN_SPLIT_COLS["warpgroup"]
    S = ps.splits("warpgroup", pairs, 512, 512, H100_SMS)
    assert S == 1 or pairs * 4 * S <= H100_SMS
    assert 512 // S >= ps.MIN_SPLIT_POINTS["warpgroup"]


def test_warp_design_splits_as_before():
    """The warp design keeps its launch: K1's split rule over 128-row
    (P1/P2) and 64-hypothesis (score) tiles."""
    for pairs in PAIRS:
        assert pm.splits("warp", pairs, 512, 512, H100_SMS) == _build.train_splits(
            pairs, 4, 512, H100_SMS, 16)
        assert ps.splits("warp", pairs, 512, 512, H100_SMS) == _build.train_splits(
            pairs, 8, 512, H100_SMS, 64)
