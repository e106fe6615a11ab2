"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| name | wrapper | replaces (TPU kernel) |
| --- | --- | --- |
| K1  | ``matching_kernel.fused_l2_top2`` | ``ops/pallas/matching_kernel.py:fused_l2_top2`` |
| K1b | ``matching_kernel.fused_l2_top2_points`` | ``ops/pallas/matching_kernel.py:fused_l2_top2_points`` |
| K2  | ``ransac_kernel.ransac_score_hypotheses`` | ``ops/pallas/ransac_kernel.py:ransac_score_hypotheses`` |
| K3  | ``eightpoint_kernel.minimal_eight_point`` | ``ops/pallas/eightpoint_kernel.py:minimal_eight_point`` |
| K4  | ``hamming_kernel.fused_hamming_top2`` | ``ops/pallas/hamming.py:fused_hamming_top2`` |
| P1  | ``probe_match.gemm_rowmin`` | ``benchmarks/probe/match_variants.py:gemm_only`` |
| P2  | ``probe_match.packed_top2`` | ``benchmarks/probe/match_variants.py:packed_top2`` |
| P3, P4 | ``probe_score.score_variant`` | ``benchmarks/probe/score_variants.py:build_fn_stacked``, ``build_fn`` |
| SS  | ``segment_sum.segment_sum`` | none: the semantics of ``ba/sparse.py``'s ``'sorted'`` layout |

K1–K4 and SS are on the package's paths (SS: the sparse BA's and the pose
graph's sums); P1–P4 only on the probes' (the probe scripts
``examples/probe_*_variants_torch.py`` and ``chip_smoke.py``).

Each wrapper launches its kernel for CUDA tensors (or raises), runs the plain
version for CPU tensors, and counts its kernel launches in its ``launches``
attribute.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import minimal_eight_point
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2,
        fused_l2_top2_points,
    )
    from points_matching_tpu_torch.ops.kernels.probe_match import gemm_rowmin, packed_top2
    from points_matching_tpu_torch.ops.kernels.probe_score import score_variant
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses
    from points_matching_tpu_torch.ops.kernels.segment_sum import segment_sum

    return {
        "fused_l2_top2": fused_l2_top2,
        "fused_l2_top2_points": fused_l2_top2_points,
        "ransac_score_hypotheses": ransac_score_hypotheses,
        "minimal_eight_point": minimal_eight_point,
        "fused_hamming_top2": fused_hamming_top2,
        "gemm_rowmin": gemm_rowmin,
        "packed_top2": packed_top2,
        "score_variant": score_variant,
        "segment_sum": segment_sum,
    }


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
