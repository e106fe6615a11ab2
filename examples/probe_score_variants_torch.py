#!/usr/bin/env python3
"""RANSAC scoring variants on the card: the port of
``benchmarks/probe/score_variants.py``'s ``main()``, at its shapes and
inputs (64 pairs × 512 hypotheses × 512 points, τ = 1.5; F unit-norm random,
p1 uniform on [0, 640)², p2 = p1 + N(0, 1), a pool of 16 such batches from
``RandomState(0)`` in its order; every point valid).

The TPU probe's nine variants compute four functions
(``ops/kernels/probe_score.py``); each variant runs the port's kernel for
its function:

  prod, oneop              divide gate, fp32 products      score_variant("divide", "f32")
  nodiv, stacked, ostack   multiply gate, fp32 products    K2, ransac_score_hypotheses
  def_prec                 divide gate, one bf16 pass      score_variant("divide", "bf16x1")
  split3, stack3, ostack3  multiply gate, 3-term bf16 split score_variant("multiply", "bf16x3")

``oneop``'s docstring says "3-pass", but ``make_kernel`` gives it no branch
of its own: it computes what ``prod`` does, and so does it here.  The
``stack*`` and ``ostack*`` layouts (F rows stacked for the MXU) are the same
functions as their unstacked forms; on the card the stacking is the layout
of the tensor-core fragments inside ``csrc/probe_score.cu``.  ``def_prec``
is one bf16 pass at pixel scale (a coordinate near 640 keeps 8 mantissa
bits): its counts are far from fp32's, "timing only" as the TPU probe says.
The ``prod_thN`` variants time the production kernel at a tile: that is
``examples/probe_ransac_score_torch.py --shapes``.

    python examples/probe_score_variants_torch.py [variant ...]
    (default: prod nodiv def_prec stacked stack3 split3, as the TPU probe)
    python examples/probe_score_variants_torch.py --ptxas [CSRC_DIR] [--sass] --parent CSRC_DIR

``--ptxas`` compiles ``probe_score.cu`` (from CSRC_DIR, by default the
package's ``csrc/``) with the build's flags and ``-Xptxas -v`` and prints,
for each kernel instance, its registers a thread, spill stores and loads,
stack frame, shared memory and ptxas's notes, with ``--sass`` also its SASS
opcodes by count (``nvcc`` only, no card).
``--parent CSRC_DIR`` builds an earlier tree's ``probe_score.cu`` into a
library of its own and times each of the three instances in turns with
each design of this tree's (parent, warp, warpgroup, warpgroup, warp,
parent; CUDA-graph replays; the fp32 instance has the warp design only) at
64 down to 1 pairs of the probe's shape, beside the design the host picks
(``probe_score.design``), the bound and the launch floor, each run held to
the plain version (cells beyond the gate 0; the fp32 instance bit for bit).
The earlier tree is launched with its own tile: 64 hypotheses a block and
at least 64 points a split (``PARENT_HYPS_PER_BLOCK``,
``PARENT_MIN_SPLIT_POINTS``).  Either option alone runs no variant.

Prints the card's name and power limit, then one JSON line per variant:
{variant, function, pairs_per_sec, us_per_pair, ms_per_step, max_count_dev,
cells_beyond_gate, bound_ms, bound_by, bound_unit, k2_ms}.  ``max_count_dev``
is the TPU probe's check: the largest count difference from the fp32
Sampson counts (``geometry/fundamental.sampson_distance``) on the first
pair.  ``cells_beyond_gate`` holds the kernel to its own plain version on
the first batch: count differences beyond the cells at the gate
(``probe_score.near_gate_cells``), which must be 0.  A step is one call over
64 pairs, timed as a CUDA-graph replay of 64 steps cycling through the pool;
``k2_ms`` is K2's step on the same inputs, timed the same way.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH, NKP, HYP = 64, 512, 512
POOL, CHUNK = 16, 64
TAU = 1.5
# variant → (gate, products) of probe_score.score_variant; None: K2
FUNCTIONS = {
    "prod": ("divide", "f32"), "oneop": ("divide", "f32"),
    "nodiv": None, "stacked": None, "ostack": None,
    "def_prec": ("divide", "bf16x1"),
    "split3": ("multiply", "bf16x3"), "stack3": ("multiply", "bf16x3"),
    "ostack3": ("multiply", "bf16x3"),
}
DEFAULT = ("prod", "nodiv", "def_prec", "stacked", "stack3", "split3")
PARENT_HYPS_PER_BLOCK, PARENT_MIN_SPLIT_POINTS = 64, 64


def make_inputs(dev, pool: int = POOL):
    """The TPU probe's pool: F [pool, 64, 512, 3, 3], p1, p2 [pool, 64, 512, 2]."""
    import torch

    rng = np.random.RandomState(0)
    F = rng.randn(pool, BATCH, HYP, 3, 3).astype(np.float32)
    F /= np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    p1 = rng.uniform(0, 640, (pool, BATCH, NKP, 2)).astype(np.float32)
    p2 = p1 + rng.randn(pool, BATCH, NKP, 2).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (F, p1, p2))


def scorer(variant: str):
    """The port's call for a variant: (F, p1, p2, mask, τ) → counts."""
    from points_matching_tpu_torch.ops.kernels.probe_score import score_variant
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses

    fn = FUNCTIONS[variant]
    if fn is None:
        return ransac_score_hypotheses, ()
    return score_variant, fn


def run(variants=DEFAULT, dev=None, pool: int = POOL) -> list:
    """Time each variant; return (and print) one dict a variant."""
    import torch

    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.geometry.fundamental import sampson_distance
    from points_matching_tpu_torch.ops.kernels import probe_score as ps
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        ransac_score_hypotheses, ransac_score_plain)
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks, cuda_graph_ms

    pin_fp32()
    dev = dev or torch.device("cuda")
    pF, pp1, pp2 = make_inputs(dev, pool)
    mask = torch.ones(BATCH, NKP, dtype=torch.bool, device=dev)
    # the TPU probe's reference: fp32 Sampson counts of the first pair
    ref = (sampson_distance(pF[0, 0], pp1[0, 0][None], pp2[0, 0][None]) < TAU ** 2).sum(-1)
    first = (pF[0], pp1[0], pp2[0], mask, TAU)

    def _cycle(fn, extra, slices):
        i = next(slices)
        return fn(pF[i], pp1[i], pp2[i], mask, TAU, *extra)

    def timed(fn, extra):
        slices = itertools.cycle(range(pool))
        return cuda_graph_ms(lambda: _cycle(fn, extra, slices), iters=CHUNK)

    k2_ms = timed(ransac_score_hypotheses, ())
    peaks, rows = chip_peaks("cuda"), []
    for name in variants:
        if name.startswith("prod_th"):
            print(json.dumps(dict(variant=name, see="examples/probe_ransac_score_torch.py "
                                                    "--shapes (K2 at every tile)")), flush=True)
            continue
        fn, extra = scorer(name)
        got = fn(*first, *extra)
        if FUNCTIONS[name] is None:
            want, near = ransac_score_plain(*first), torch.zeros_like(got)
            function = "K2 (multiply gate, fp32 products)"
        else:
            want = ps.score_variant_plain(*first, *extra)
            near = ps.near_gate_cells(*first, products=extra[1])
            function = f"{extra[0]} gate, {extra[1]} products"
        ms = timed(fn, extra)
        b = bound(fn.work(*first, *extra), peaks)
        row = dict(variant=name, function=function, pairs_per_sec=BATCH / (ms / 1e3),
                   us_per_pair=ms * 1e3 / BATCH, ms_per_step=ms,
                   max_count_dev=int((got[0] - ref).abs().max()),
                   cells_beyond_gate=int(((got - want).abs() - near).clamp_min(0).sum()),
                   **b, k2_ms=k2_ms)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def parent_kernel(csrc: str):
    """The earlier tree's score kernel as a callable (F, p1, p2, mask, τ,
    gate, products) → counts, launched with its own tile."""
    import torch

    from probe_match_variants_torch import parent_library
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels import probe_score as ps

    fn = parent_library(csrc, "probe_score.cu").pmt_probe_score
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def score(F, p1, p2, mask, tau, gate, products):
        (B, H), N = F.shape[:2], p1.shape[1]
        S = _build.train_splits(B, -(-H // PARENT_HYPS_PER_BLOCK), N,
                                _build.sm_count(F.device.index), PARENT_MIN_SPLIT_POINTS)
        counts = (torch.zeros if S > 1 else torch.empty)((B, H), dtype=torch.int32,
                                                         device=F.device)
        rc = fn(F.data_ptr(), p1.data_ptr(), p2.data_ptr(), mask.data_ptr(), counts.data_ptr(),
                B, H, N, S, tau ** 2, ps.GATES[gate], ps.PRODUCTS[products],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent pmt_probe_score: CUDA error {rc}")
        return counts

    return score


def parent_turns(csrc: str, dev=None) -> list:
    """This tree's score instances, each design forced, against the earlier
    tree's in turns at ``PARENT_PAIRS`` pairs of the probe's shape (the
    first batch of the pool); one dict an (instance, pairs), printed as a
    JSON line."""
    import torch

    from probe_match_variants_torch import PARENT_PAIRS, in_turns, launch_floor_ms, turns_row
    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels import probe_score as ps
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks

    pin_fp32()
    dev = dev or torch.device("cuda")
    parent = parent_kernel(csrc)
    pF, pp1, pp2 = make_inputs(dev, 1)
    floor, peaks, rows = launch_floor_ms(), chip_peaks("cuda"), []
    for nb in PARENT_PAIRS:
        args = (pF[0, :nb], pp1[0, :nb], pp2[0, :nb],
                torch.ones(nb, NKP, dtype=torch.bool, device=dev), TAU)
        for gate, products in ps.VARIANTS:
            want = ps.score_variant_plain(*args, gate, products)
            near = ps.near_gate_cells(*args[:4], TAU, products=products)
            runs = {"parent": lambda: parent(*args, gate, products)}
            designs = ("warp",) if products == "f32" else ps.DESIGNS
            runs.update({d: (lambda d=d: ps.score_variant(*args, gate, products, _design=d))
                         for d in designs})
            beyond = {}
            for who, fn in runs.items():
                diff = (fn() - want).abs()
                beyond[who] = int((diff if products == "f32" else
                                   (diff - near).clamp_min(0)).sum())
            pick = ps.design(nb, HYP, products, _build.sm_count(0))
            bnd = bound(ps.score_variant.work(*args, gate, products), peaks)
            row = dict(instance=f"{gate}/{products}", pairs=nb,
                       **turns_row(in_turns(runs), pick, bnd, floor), cells_off=beyond,
                       ok=not any(beyond.values()))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    from probe_match_variants_torch import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant")
    ap.add_argument("--ptxas", nargs="?", const=os.path.join(
        ROOT, "points_matching_tpu_torch", "csrc"), metavar="CSRC_DIR")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--parent", metavar="CSRC_DIR")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in FUNCTIONS and not v.startswith("prod_th")]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(FUNCTIONS)} and prod_thN",
              file=sys.stderr)
        return 2
    variants = args.variants or ([] if args.parent or args.ptxas else list(DEFAULT))
    if args.ptxas:
        from probe_eightpoint_torch import ptxas_report

        for row in ptxas_report(args.ptxas, "probe_score.cu", sass=args.sass):
            print("ptxas", json.dumps(row), flush=True)
    if not (args.parent or variants):
        return 0
    print(card(), flush=True)
    ok = all(r["ok"] for r in parent_turns(args.parent)) if args.parent else True
    if variants:
        ok &= all(r["cells_beyond_gate"] == 0 for r in run(variants))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
