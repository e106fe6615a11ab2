"""The lane-group rule of the 8-point kernel (K3), on the CPU.

On the card, a block of K3 is one warp of 32 / G samples with G lanes each
(`_build.eight_point_group` picks G from the sample count and the SM
count); the lanes share a sample's Hartley roots and AᵀA entries, and G
changes no bit of the result.  These tests hold the rule: G is one of the
built sizes, empty and single-sample batches are handled, one pair's 512
samples spread over more than 4 SMs, a larger batch never gets more lanes
per sample, and at the H100's 132 SMs the rule picks the G that was
fastest at each batch size of the sweep that set it
(``examples/probe_eightpoint_torch.py --groups``).
"""
import pytest
import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
    GROUPS, minimal_eight_point, samples_per_block)

H100_SMS = 132
COUNTS = [0, 1, 2, 7, 32, 33, 511, 512, 513, 4096, 4224, 4225, 8192, 16384, 32768,
          33792, 65536, 10**6]
# the sweep on an H100 (132 SMs): samples → the fastest G, by the slower of
# two turns (PERF.md, the K3 sweep)
SWEEP_FASTEST = [(512, 8), (1024, 8), (1536, 8), (2048, 8), (3072, 8), (4096, 8),
                 (6144, 1), (8192, 1), (12288, 1), (16384, 1), (24576, 1), (32768, 1)]


@pytest.mark.parametrize("num_sms", [1, 16, 114, H100_SMS])
def test_group_is_a_power_of_two_up_to_8(num_sms):
    assert set(GROUPS) <= {1, 2, 4, 8}
    for count in COUNTS:
        assert _build.eight_point_group(count, num_sms) in GROUPS


def test_group_handles_zero_and_one_sample():
    assert _build.eight_point_group(0, H100_SMS) == 8
    assert _build.eight_point_group(1, H100_SMS) == 8
    # the wrapper: no sample gives an empty [0, 3, 3]
    empty = minimal_eight_point(torch.zeros(0, 8, 2), torch.zeros(0, 8, 2))
    assert empty.shape == (0, 3, 3)


def test_one_pair_spreads_over_more_than_four_sms():
    """The slices launch 512 samples (one pair): the old kernel's 4 blocks
    of 128 samples used 4 SMs of 132.  A block is one warp of 32 / G
    samples."""
    g = _build.eight_point_group(512, H100_SMS)
    blocks = -(-512 // samples_per_block(g))
    assert blocks > 4 * 4                       # more than 4 SMs' worth of warps
    assert all(samples_per_block(g) * g == 32 for g in GROUPS)


@pytest.mark.parametrize("num_sms", [16, 114, H100_SMS])
def test_group_is_monotone_in_the_sample_count(num_sms):
    groups = [_build.eight_point_group(c, num_sms) for c in sorted(COUNTS)]
    assert all(a >= b for a, b in zip(groups, groups[1:])), groups
    assert groups[-1] == 1                      # a million samples: one lane each


@pytest.mark.parametrize("count,fastest", SWEEP_FASTEST)
def test_group_is_the_fastest_of_the_h100_sweep(count, fastest):
    assert _build.eight_point_group(count, H100_SMS) == fastest


# 2 and 4 are powers of two the kernel is not built for
@pytest.mark.parametrize("group", [0, 2, 3, 4, 16, 1.5])
def test_wrapper_rejects_other_groups(group):
    sp = torch.zeros(2, 8, 2)
    with pytest.raises(ValueError):
        minimal_eight_point(sp, sp, _group=group)
