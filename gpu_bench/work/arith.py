"""Frozen work arithmetic: the bytes and operations a layer must spend on
given shapes, whatever implements it.

Copied from ``points_matching_tpu_torch/ops/kernels/work.py`` with its
data-dependent constants written out as numbers
(``tests/test_gpu_bench_work.py`` holds them equal to the program's counts
at the cells' shapes as of the copy):

* bytes: each input read once, each output written once;
* operations: in the unit the work is bound by: fp32 FMA flops (an FMA is
  two) for the L2 top-2 and the all-pairs sweep, one instruction per
  unfused fp32 operation for the Sampson gate.
"""
from __future__ import annotations

import dataclasses

# fp32 operations of the Sampson gate a (hypothesis, point) cell: the RANSAC
# scorer's plain version (``ransac_kernel.ransac_score_plain``) counted op by
# op on one cell (``work.ransac_score_ops_per_cell()`` = 37).
SAMPSON_OPS_PER_CELL = 37


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float
    unit: str            # "flops" (fp32 FMA, two a cell) or "instr" (fp32 instructions)


def l2_top2(pairs: int, n_query: int, n_train: int, dim: int, valid_train: int,
            point_dim: int = 0) -> Work:
    """The L2 top-2 of ``pairs`` pairs (the matcher, K1 / K1b): the queries
    and the valid train rows read once, the train mask read, the top-2
    distances and indices written once (with ``point_dim``: the valid rows'
    points read and the matched points written); one FMA per (query, valid
    train row, dimension).  ``valid_train`` counts the valid train rows of
    all pairs together."""
    nbytes = (4 * (pairs * n_query + valid_train) * dim + pairs * n_train
              + 16 * pairs * n_query + 4 * point_dim * (valid_train + pairs * n_query))
    return Work(nbytes, 2 * n_query * valid_train * dim, "flops")


def sampson_gate(pairs: int, hyps: int, n_points: int, valid_points: int) -> Work:
    """Scoring ``hyps`` hypotheses a pair under the Sampson gate (K2): each
    hypothesis read and its count written once, each mask byte and each
    valid point pair read once; ``SAMPSON_OPS_PER_CELL`` over the valid
    cells.  ``valid_points`` counts the valid points of all pairs."""
    nbytes = pairs * hyps * (9 + 1) * 4 + pairs * n_points + valid_points * 2 * 2 * 4
    return Work(nbytes, hyps * valid_points * SAMPSON_OPS_PER_CELL, "instr")


def all_pairs(images: int, keypoints: int, dim: int, valid_rows: int) -> Work:
    """One all-pairs sweep: every image's valid rows against every image's
    valid rows, one FMA per (query row, train row, dimension); the
    descriptors and masks read once and the [N, N] int32 scores written
    once."""
    nbytes = 4 * images * keypoints * dim + images * keypoints + 4 * images * images
    return Work(nbytes, 2 * valid_rows * valid_rows * dim, "flops")


def bound_s(work: Work, peaks: dict) -> float:
    """The least seconds for ``work``: the larger of its bytes over the
    memory rate and its operations over their unit's rate."""
    rate = peaks["flops"] if work.unit == "flops" else peaks["instr_per_s"]
    return max(work.bytes / peaks["hbm_bytes_per_s"], work.ops / rate)
