#!/usr/bin/env python3
"""Matching micro-variants on the card: where do the per-pair microseconds
go?  The port of ``benchmarks/probe/match_variants.py``'s ``main()``, at the
same shapes and inputs (64 pairs × 512 × 512 × 64-d unit descriptors, the
train rows the query rows plus 0.1 noise, a pool of 16 such batches from
``RandomState(0)``, ratio 0.85):

  gemm           the bf16 distance matrix (``ops/matching.l2_distance_matrix``:
                 norms + ``torch.matmul``) + row ``amin`` — library calls, a
                 yardstick on no path
  topk           the GEMM + ``torch.topk(k=2)``                 (yardstick)
  argmin2        the GEMM + two argmin passes                    (yardstick)
  full           ``ops/matching.match_descriptors`` in bf16 over the 64
                 pairs in one call (K1, ratio filter, compaction)
  kernel_raw     K1 (``fused_l2_top2``, bf16) alone
  kernel_gemm    P1 (``probe_match.gemm_rowmin``): the tensor-core GEMM
                 with only a row minimum — the GEMM/top-2 split
  kernel_packed  P2 (``probe_match.packed_top2``): the tensor-core GEMM
                 with the packed-key top-2

The TPU probe's ``sweep`` (tile sizes of the Pallas kernel) has no
counterpart: K1's and P1/P2's train splits come from
``_build.train_splits``, and their tiles are fixed in the sources.

    python examples/probe_match_variants_torch.py [variant ...]   (default: all)

Prints the card's name and power limit, then one JSON line per variant:
{variant, pairs_per_sec, us_per_pair, ms_per_step, bound_ms, bound_by,
bound_unit, calls} and, for the kernels, their agreement with the plain
version on the first batch.  A step is one call over a batch of 64 pairs;
its time is a CUDA-graph replay of 64 steps cycling through the pool
(``utils/profiling.cuda_graph_ms``), not the TPU probe's chunked slope.
Bounds are the work of each variant's function (``ops/kernels/work.py``)
against the card's peaks.  Needs one CUDA device.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, NKP, DIM, POOL, RATIO = 64, 512, 64, 16, 0.85
CHUNK = 64
VARIANTS = ("gemm", "topk", "argmin2", "full", "kernel_raw", "kernel_gemm", "kernel_packed")
KERNELS = ("kernel_raw", "kernel_gemm", "kernel_packed")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def make_inputs(dev, pool: int = POOL):
    """The TPU probe's pool: d1 [pool, 64, 512, 64] unit rows, d2 = d1 +
    0.1 noise, renormalised (``RandomState(0)``, in its order), and ‖d2‖²."""
    import torch

    rng = np.random.RandomState(0)
    d1 = rng.randn(pool * BATCH, NKP, DIM).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + 0.1 * rng.randn(*d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    pd1, pd2 = (torch.from_numpy(x.reshape(pool, BATCH, NKP, DIM)).to(dev) for x in (d1, d2))
    return pd1, pd2, (pd2 * pd2).sum(-1)


def steps():
    """variant → (step(a, b, t2, mask), wrapper whose work bounds it)."""
    import torch

    from points_matching_tpu_torch.core.config import MatcherConfig
    from points_matching_tpu_torch.core.types import Descriptors
    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
    from points_matching_tpu_torch.ops.matching import (
        _argmin_top2, l2_distance_matrix, match_descriptors)

    cfg = MatcherConfig(metric="l2", filter="ratio", ratio=RATIO, compute_dtype="bf16")

    def full(a, b, t2, mask):
        return match_descriptors(Descriptors(data=a, mask=mask), Descriptors(data=b, mask=mask),
                                 cfg).mask

    return {
        "gemm": (lambda a, b, t2, mask: l2_distance_matrix(a, b, "bf16").amin(-1), pm.gemm_rowmin),
        "topk": (lambda a, b, t2, mask: torch.topk(l2_distance_matrix(a, b, "bf16"), 2,
                                                   largest=False), pm.packed_top2),
        "argmin2": (lambda a, b, t2, mask: _argmin_top2(l2_distance_matrix(a, b, "bf16")),
                    pm.packed_top2),
        "full": (full, fused_l2_top2),
        "kernel_raw": (lambda a, b, t2, mask: fused_l2_top2(a, b, mask, compute_dtype="bf16"),
                       fused_l2_top2),
        "kernel_gemm": (lambda a, b, t2, mask: pm.gemm_rowmin(a, b), pm.gemm_rowmin),
        "kernel_packed": (lambda a, b, t2, mask: pm.packed_top2(a, b, t2), pm.packed_top2),
    }


def _work_args(wrapper, a, b, t2, mask):
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    if wrapper is pm.gemm_rowmin:
        return a, b
    if wrapper is pm.packed_top2:
        return a, b, t2
    return a, b, mask


def agreement(name: str, a, b, t2, mask) -> dict:
    """A kernel variant against its plain version on one batch: P1's max
    |Δ|; P2's index mismatches off the rows within 2 quanta and max |Δdist|;
    K1's max |Δdist| (bf16 operands, fp32 sums in another order)."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    if name == "kernel_gemm":
        err = float((pm.gemm_rowmin(a, b) - pm.gemm_rowmin_plain(a, b)).abs().max())
        return dict(max_abs_err=err, ok=err <= 1e-5)
    if name == "kernel_packed":
        (kd, ki), (pd, pi) = pm.packed_top2(a, b, t2), pm.packed_top2_plain(a, b, t2)
        near = pm.near_tie_rows(a, b, t2)
        bad = int((ki != pi)[~near].any(-1).sum())
        err = float((kd - pd).abs().max())
        q = pm.quantum(a, t2)
        return dict(max_abs_err=err, quantum=q, near_tie_rows=int(near.sum()),
                    idx_mismatches_off_near_ties=bad, ok=bad == 0 and err <= 2 * q + 1e-5)
    kd, _ = fused_l2_top2(a, b, mask, compute_dtype="bf16")
    err = float((kd - l2_top2_plain(a, b, mask, compute_dtype="bf16")[0]).abs().max())
    return dict(max_abs_err=err, ok=err <= 1e-5)


def run(variants=VARIANTS, dev=None, pool: int = POOL) -> list:
    """Time each variant; return (and print) one dict a variant."""
    import torch

    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks, cuda_graph_ms

    pin_fp32()
    dev = dev or torch.device("cuda")
    pd1, pd2, pt2 = make_inputs(dev, pool)
    mask = torch.ones(BATCH, NKP, dtype=torch.bool, device=dev)
    table, peaks, rows = steps(), chip_peaks("cuda"), []
    for name in variants:
        step, wrapper = table[name]
        slices = itertools.cycle(range(pool))

        def one():
            i = next(slices)
            return step(pd1[i], pd2[i], pt2[i], mask)

        ms = cuda_graph_ms(one, iters=CHUNK)
        b = bound(wrapper.work(*_work_args(wrapper, pd1[0], pd2[0], pt2[0], mask)), peaks)
        row = dict(variant=name, pairs_per_sec=BATCH / (ms / 1e3), us_per_pair=ms * 1e3 / BATCH,
                   ms_per_step=ms, **b,
                   calls="one kernel" if name in KERNELS else
                   "match_descriptors (K1 + filter + compaction)" if name == "full" else
                   "library yardstick: l2_distance_matrix (bf16 matmul, norms) + " +
                   {"gemm": "amin", "topk": "topk", "argmin2": "two argmin passes"}[name])
        if name in KERNELS:
            row.update(agreement(name, pd1[0], pd2[0], pt2[0], mask))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    variants = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {VARIANTS}", file=sys.stderr)
        return 2
    print(card(), flush=True)
    rows = run(variants)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
