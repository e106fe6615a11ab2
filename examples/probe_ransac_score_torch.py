#!/usr/bin/env python3
"""What K2 (the RANSAC hypothesis scorer) costs on the card, by tile.

    python examples/probe_ransac_score_torch.py --ptxas [CSRC_DIR] [--sass]
    python examples/probe_ransac_score_torch.py --shapes [--parent CSRC_DIR]

``--ptxas`` compiles ``ransac_score.cu`` (from CSRC_DIR, by default the
package's ``csrc/``) with the build's flags and ``-Xptxas -v`` into a
temporary cubin and prints, for each kernel, the registers a thread, spill
stores and loads, stack frame and shared memory; with ``--sass`` also its
SASS opcodes by count (``cuobjdump``).  It needs ``nvcc`` only, no card.

``--shapes`` times K2 at the shapes the paths launch it at (`SHAPES`) and
at a sweep of pair counts, with every tile the kernel is built for forced
— (warps a block, hypotheses a warp), ``ransac_kernel.TILES`` — as
CUDA-graph replays, in turns (each variant, then the same backwards), and
checks every variant against ``ransac_score_plain`` bit for bit.  For each
shape it prints the tile ``_build.ransac_score_tile`` picks, the fastest
tile by the slower of its two turns, and each variant's times beside the
bound (``ops/kernels/work.py``); first the card's name and power limit and
the launch floor (a graph of one-element ``add_`` launches, timed the same
way).  With ``--parent CSRC_DIR`` it also builds the one-warp-per-hypothesis
kernel of an earlier tree (whose ``pmt_ransac_score`` takes F, p1, p2,
mask, counts, B, H, N, tau2, stream) and times it in the same turns.
Needs one CUDA device.  The inputs are ``chip_smoke.py``'s: random scenes
with 30 % outliers and 5 masked rows a pair, F from K3 on random minimal
samples, a 1.5-pixel gate.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (pairs, hypotheses, points, who launches it)
SHAPES = (
    (1, 512, 512, "SURF slice, staged (one pair)"),
    (1, 512, 1024, "ORB slice, staged (one pair)"),
    (1, 256, 512, "SLAM demo's RANSAC"),
    (1, 128, 256, "config 4, one pair"),
    (4, 256, 256, "SfM bootstrap (4 candidates)"),
    (64, 128, 256, "config 4 bootstrap, S = 16"),
    (1132, 128, 256, "config 4 bootstrap, S = 283"),
    (64, 512, 512, "bench head (pairs phase)"),
)
# pairs of 512 × 512 for the tile rule's crossovers
SWEEP_PAIRS = (2, 4, 8, 16, 32)


def parent_kernel(csrc: str):
    """The earlier tree's K2 as a callable (F, p1, p2, mask, tau2) → counts,
    from its own build of ``ransac_score.cu``."""
    import ctypes

    import torch

    from points_matching_tpu_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "probe", "libparent_ransac_score.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out,
                           os.path.join(csrc, "ransac_score.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    fn = ctypes.CDLL(out).pmt_ransac_score
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(F, p1, p2, mask, tau2):
        B, H, N = F.shape[0], F.shape[1], p1.shape[1]
        counts = torch.empty((B, H), dtype=torch.int32, device=F.device)
        rc = fn(F.data_ptr(), p1.data_ptr(), p2.data_ptr(), mask.data_ptr(),
                counts.data_ptr(), B, H, N, tau2, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent pmt_ransac_score: CUDA error {rc}")
        return counts

    return run


def inputs(B: int, H: int, N: int, seed: int = 0):
    """chip_smoke.py's K2 inputs: B scenes of N correspondences and H
    hypotheses a pair from K3 on random minimal samples."""
    import torch

    from chip_smoke import _scenes
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import minimal_eight_point

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p1, p2, mask = _scenes(B, N, gen, dev)
    pick = torch.rand(B, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    sp1, sp2 = (torch.gather(p[:, None].expand(B, H, N, 2), 2,
                             pick[..., None].expand(B, H, 8, 2)).contiguous()
                for p in (p1, p2))
    return minimal_eight_point(sp1, sp2), p1, p2, mask


def shapes(parent_csrc) -> None:
    import torch

    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        TILES, ransac_score_hypotheses, ransac_score_plain)
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks, cuda_graph_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    pin_fp32()
    dev = torch.device("cuda")
    sms = _build.sm_count(0)
    parent = parent_kernel(parent_csrc) if parent_csrc else None
    one = torch.zeros(1, device=dev)
    print(f"launch_floor_ms {cuda_graph_ms(lambda: one.add_(1)):.5f}")
    cases = list(SHAPES) + [(b, 512, 512, "sweep") for b in SWEEP_PAIRS]
    for B, H, N, who in cases:
        F, p1, p2, mask = inputs(B, H, N)
        args = (F, p1, p2, mask, 1.5)
        want = ransac_score_plain(*args)
        runs = {t: (lambda t=t: ransac_score_hypotheses(*args, _tile=t)) for t in TILES}
        if parent:
            runs["parent"] = lambda: parent(F, p1, p2, mask, 1.5 ** 2)
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} at {B}x{H}x{N} differs from plain: "
                                   f"{int((got - want).abs().max())}")
        order = (["parent"] if parent else []) + list(TILES)
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            times[name].append(cuda_graph_ms(runs[name]))
        best = min(TILES, key=lambda t: max(times[t]))
        rule = _build.ransac_score_tile(B, H, sms)
        b = bound(ransac_score_hypotheses.work(*args), chip_peaks("cuda"))
        print(f"shape {B}x{H}x{N} ({who}): rule tile {rule}, fastest tile {best} "
              f"(by the slower turn); bound {b['bound_ms']:.5f} ms ({b['bound_by']}); "
              f"max count {int(want.max())}/{N}; all equal plain bit for bit")
        for name in order:
            print(f"  {name}: " + " / ".join(f"{t:.5f}" for t in times[name]) + " ms")
        if parent:
            print(f"  rule {rule} against parent (slower turns): {max(times[rule]):.5f} / "
                  f"{max(times['parent']):.5f} ms = {max(times[rule]) / max(times['parent']):.3f}; "
                  f"share of the bound {b['bound_ms'] / max(times[rule]):.3f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ptxas", nargs="?", const=os.path.join(
        ROOT, "points_matching_tpu_torch", "csrc"), metavar="CSRC_DIR")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--parent", metavar="CSRC_DIR")
    args = ap.parse_args()
    if args.ptxas:
        from probe_eightpoint_torch import ptxas_report

        for row in ptxas_report(args.ptxas, "ransac_score.cu", sass=args.sass):
            print("ptxas", row)
    if args.shapes:
        shapes(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
