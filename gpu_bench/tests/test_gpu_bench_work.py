"""The benchmark's frozen yardstick against the program's own counts at the
cells' shapes: equal today, so that a later change to the program's counts
shows as a difference here and never moves the benchmark's numbers."""
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpu_bench.reference import round_tf32  # noqa: E402
from gpu_bench.work import arith, peaks  # noqa: E402
from points_matching_tpu_torch.ops.kernels import work  # noqa: E402
from points_matching_tpu_torch.utils.profiling import _CHIP_PEAKS  # noqa: E402


def _mix(name):
    with open(os.path.join(ROOT, "gpu_bench", "traffic", name + ".json")) as f:
        return json.load(f)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_sampson_ops_per_cell_is_the_programs():
    assert arith.SAMPSON_OPS_PER_CELL == work.ransac_score_ops_per_cell()


@pytest.mark.parametrize("mix", ["pairs_8k", "pairs_wide"])
def test_l2_top2_and_sampson_gate_at_the_cells_shapes(mix):
    m = _mix(mix)
    P, N, H = m["pairs"], m["keypoints"], m["hypotheses"]
    t_mask = torch.ones(P, N, dtype=torch.bool)
    mine = arith.l2_top2(P, N, N, 64, P * N, 2)
    theirs = work.l2_top2_work(_meta(P, N, 64), _meta(P, N, 64), t_mask, _meta(P, N, 2))
    assert (mine.bytes, mine.ops, mine.unit) == (theirs.bytes, theirs.ops, theirs.unit)
    valid = torch.ones(P, N, dtype=torch.bool)
    valid[:, -7:] = False                      # some rows not matched
    mine = arith.sampson_gate(P, H, N, int(valid.sum()))
    theirs = work.ransac_score_work(_meta(P, H, 3, 3), _meta(P, N, 2), _meta(P, N, 2), valid)
    assert (mine.bytes, mine.ops) == (theirs.bytes, theirs.ops)
    assert theirs.unit == "instr" and mine.unit == "instr"


def test_all_pairs_ops_are_the_sweeps_k1_launches():
    m = _mix("sweep_8k")
    n, k = m["images"], m["keypoints"]
    one = work.l2_top2_work(_meta(1, n * k, 64), _meta(1, k, 64), torch.ones(1, k, dtype=torch.bool))
    assert arith.all_pairs(n, k, 64, n * k).ops == n * one.ops
    assert arith.all_pairs(n, k, 64, n * k).unit == one.unit


def test_peaks_are_the_programs_h100_row():
    mine, theirs = peaks.PEAKS["h100"], _CHIP_PEAKS["h100"]
    assert mine["flops"] == theirs["flops"]
    assert mine["instr_per_s"] == theirs["instr_per_s"]
    assert mine["hbm_bytes_per_s"] == theirs["hbm_gbps"] * 1e9
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3") is peaks.PEAKS["h100"]
    with pytest.raises(ValueError):
        peaks.peaks_for("NVIDIA A100-SXM4-80GB")


def test_bound_takes_the_slower_of_bytes_and_operations():
    p = peaks.PEAKS["h100"]
    w = arith.Work(bytes=3.35e9, ops=67e9, unit="flops")          # 1 ms each
    assert arith.bound_s(w, p) == pytest.approx(1e-3)
    w = arith.Work(bytes=0.0, ops=33.5e9, unit="instr")
    assert arith.bound_s(w, p) == pytest.approx(1e-3)


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    x = torch.randn(4096, dtype=torch.float32) * 1e3
    r = round_tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((r - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -11 * (1 + 1e-6)
    assert torch.equal(round_tf32(r), r)
