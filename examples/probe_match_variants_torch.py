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
    python examples/probe_match_variants_torch.py --ptxas [CSRC_DIR] [--sass] --parent CSRC_DIR

``--ptxas`` compiles ``probe_match.cu`` (from CSRC_DIR, by default the
package's ``csrc/``) with the build's flags and ``-Xptxas -v`` and prints,
for each kernel instance, its registers a thread, spill stores and loads,
stack frame, shared memory and ptxas's notes, with ``--sass`` also its SASS
opcodes by count (``nvcc`` only, no card).
``--parent CSRC_DIR`` builds an earlier tree's ``probe_match.cu`` into a
library of its own and times its P1 and P2 in turns with both designs of
this tree's (parent, warp, warpgroup, warpgroup, warp, parent; CUDA-graph
replays) at 64 down to 1 pairs of the probe's shape (``PARENT_PAIRS``),
beside the design the host picks (``probe_match.design``), the bound and
the launch floor, each run checked against the plain version under the
tolerances below.  Either option alone runs no variant.

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

import argparse
import ctypes
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
PARENT_PAIRS = (64, 32, 16, 8, 4, 2, 1)
TURNS = ("parent", "warp", "warpgroup", "warpgroup", "warp", "parent")
# the earlier tree's tile: query rows a block, train columns a split at least
PARENT_ROWS_PER_BLOCK, PARENT_MIN_SPLIT_COLS = 128, 16


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


def check_probe(name: str, got, a, b, t2) -> dict:
    """A P1 (``kernel_gemm``) or P2 (``kernel_packed``) result against the
    plain version: P1's max |Δ| ≤ 1e-5; P2's index mismatches off the rows
    within 2 quanta (none) and max |Δdist| ≤ 2 quanta + 1e-5."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    if name == "kernel_gemm":
        err = float((got - pm.gemm_rowmin_plain(a, b)).abs().max())
        return dict(max_abs_err=err, ok=err <= 1e-5)
    (kd, ki), (pd, pi) = got, pm.packed_top2_plain(a, b, t2)
    near = pm.near_tie_rows(a, b, t2)
    bad = int((ki != pi)[~near].any(-1).sum())
    err = float((kd - pd).abs().max())
    q = pm.quantum(a, t2)
    return dict(max_abs_err=err, quantum=q, near_tie_rows=int(near.sum()),
                idx_mismatches_off_near_ties=bad, ok=bad == 0 and err <= 2 * q + 1e-5)


def agreement(name: str, a, b, t2, mask) -> dict:
    """A kernel variant against its plain version on one batch: P1 and P2
    as ``check_probe``; K1's max |Δdist| (bf16 operands, fp32 sums in
    another order)."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    if name == "kernel_gemm":
        return check_probe(name, pm.gemm_rowmin(a, b), a, b, t2)
    if name == "kernel_packed":
        return check_probe(name, pm.packed_top2(a, b, t2), a, b, t2)
    kd, _ = fused_l2_top2(a, b, mask, compute_dtype="bf16")
    err = float((kd - l2_top2_plain(a, b, mask, compute_dtype="bf16")[0]).abs().max())
    return dict(max_abs_err=err, ok=err <= 1e-5)


def parent_library(csrc: str, source: str) -> ctypes.CDLL:
    """An earlier tree's ``<csrc>/<source>`` built with the build's flags
    into a library of its own (its C entry points keep their names; ctypes
    keeps the two libraries' symbols apart)."""
    from points_matching_tpu_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "probe", f"libparent_{os.path.splitext(source)[0]}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out,
                           os.path.join(csrc, source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    return ctypes.CDLL(out)


def parent_kernels(csrc: str) -> dict:
    """The earlier tree's P1 and P2 as callables with the wrappers'
    arguments, launched with its own tile and train splits
    (``_build.train_splits`` over ``PARENT_ROWS_PER_BLOCK``-row query tiles,
    at least ``PARENT_MIN_SPLIT_COLS`` columns a split) and scratch."""
    import torch

    from points_matching_tpu_torch.ops.kernels import _build

    def splits(B, N1, N2, device):
        return _build.train_splits(B, -(-N1 // PARENT_ROWS_PER_BLOCK), -(-N2 // 8) * 8,
                                   _build.sm_count(device.index), PARENT_MIN_SPLIT_COLS)

    lib = parent_library(csrc, "probe_match.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pmt_probe_gemm_rowmin.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.pmt_probe_packed_top2.argtypes = [P] * 7 + [I] * 5 + [P]

    def ptr(x):
        return None if x is None else x.data_ptr()

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")

    def gemm_rowmin(q, t):
        (B, N1, D), N2 = q.shape, t.shape[1]
        S = splits(B, N1, N2, q.device)
        out = torch.empty((B, N1, 1), dtype=torch.float32, device=q.device)
        part = torch.empty((B, S, N1), dtype=torch.float32, device=q.device) if S > 1 else None
        check(lib.pmt_probe_gemm_rowmin(q.data_ptr(), t.data_ptr(), out.data_ptr(), ptr(part),
                                        B, N1, N2, D, S,
                                        torch.cuda.current_stream().cuda_stream), "P1")
        return out

    def packed_top2(q, t, t2):
        (B, N1, D), N2 = q.shape, t.shape[1]
        S = splits(B, N1, N2, q.device)
        dist = torch.empty((B, N1, 2), dtype=torch.float32, device=q.device)
        idx = torch.empty((B, N1, 2), dtype=torch.int32, device=q.device)
        part = q2 = None
        if S > 1:
            part = torch.empty((B, S, N1, 2), dtype=torch.int32, device=q.device)
            q2 = torch.empty((B, N1), dtype=torch.float32, device=q.device)
        check(lib.pmt_probe_packed_top2(q.data_ptr(), t.data_ptr(), t2.data_ptr(),
                                        dist.data_ptr(), idx.data_ptr(), ptr(part), ptr(q2),
                                        B, N1, N2, D, S,
                                        torch.cuda.current_stream().cuda_stream), "P2")
        return dist, idx

    return dict(kernel_gemm=gemm_rowmin, kernel_packed=packed_top2)


def launch_floor_ms() -> float:
    """A graph of one-element ``add_`` launches, timed as the kernels are."""
    import torch

    from points_matching_tpu_torch.utils.profiling import cuda_graph_ms

    one = torch.zeros(1, device="cuda")
    return cuda_graph_ms(lambda: one.add_(1))


def in_turns(runs: dict, order=TURNS) -> dict:
    """Each callable of ``runs`` timed (CUDA-graph replays) in the given
    order: who → its times."""
    from points_matching_tpu_torch.utils.profiling import cuda_graph_ms

    times = {who: [] for who in runs}
    for who in order:
        if who in runs:
            times[who].append(cuda_graph_ms(runs[who]))
    return times


def turns_row(times: dict, pick: str, bnd: dict, floor: float) -> dict:
    """The times of a shape: the host's pick (``new_ms``), each design's and
    the earlier tree's, the slower turns' ratios, the share of the bound."""
    slow = {who: max(ts) for who, ts in times.items()}
    return dict(design=pick, new_ms=times[pick], parent_ms=times["parent"],
                **{f"{who}_ms": ts for who, ts in times.items() if who != "parent"},
                new_over_parent=slow[pick] / slow["parent"],
                **{f"{who}_over_parent": slow[who] / slow["parent"]
                   for who in times if who not in ("parent", pick)},
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                share_of_bound=bnd["bound_ms"] / slow[pick], launch_floor_ms=floor)


def parent_turns(csrc: str, dev=None) -> list:
    """This tree's P1 and P2, each design forced, against the earlier
    tree's in turns at ``PARENT_PAIRS`` pairs of the probe's shape (the
    first batch of the pool); one dict a (kernel, pairs), printed as a JSON
    line."""
    import torch

    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks

    pin_fp32()
    dev = dev or torch.device("cuda")
    parent = parent_kernels(csrc)
    pd1, pd2, pt2 = make_inputs(dev, 1)
    floor, peaks, rows = launch_floor_ms(), chip_peaks("cuda"), []
    for nb in PARENT_PAIRS:
        a, b, t2 = pd1[0, :nb], pd2[0, :nb], pt2[0, :nb]
        for name, new in (("kernel_gemm", pm.gemm_rowmin), ("kernel_packed", pm.packed_top2)):
            args = (a, b) if name == "kernel_gemm" else (a, b, t2)
            runs = {"parent": lambda f=parent[name]: f(*args)}
            runs.update({d: (lambda d=d: new(*args, _design=d)) for d in pm.DESIGNS})
            checks = {who: check_probe(name, fn(), a, b, t2) for who, fn in runs.items()}
            pick = pm.design(new.__name__, nb, NKP, _build.sm_count(0))
            row = dict(kernel=name, pairs=nb,
                       **turns_row(in_turns(runs), pick, bound(new.work(*args), peaks), floor),
                       checks=checks, ok=all(c["ok"] for c in checks.values()))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant")
    ap.add_argument("--ptxas", nargs="?", const=os.path.join(
        ROOT, "points_matching_tpu_torch", "csrc"), metavar="CSRC_DIR")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--parent", metavar="CSRC_DIR")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {VARIANTS}", file=sys.stderr)
        return 2
    variants = args.variants or ([] if args.parent or args.ptxas else list(VARIANTS))
    if args.ptxas:
        from probe_eightpoint_torch import ptxas_report

        for row in ptxas_report(args.ptxas, "probe_match.cu", sass=args.sass):
            print("ptxas", json.dumps(row), flush=True)
    if not (args.parent or variants):
        return 0
    print(card(), flush=True)
    rows = (parent_turns(args.parent) if args.parent else []) + (run(variants) if variants else [])
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
