#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (two-view SURF and ORB, the staged
two-view pipeline, the bench head's 64 pairs in one call, incremental SfM
with loop closure, the pose graph, the dense Schur BA and its
landmark-sharded form, all-pairs scores, the all-pairs ring and the staged
pipeline over several ranks, distributed SLAM, the SLAM demo on sequences
from disk) once on one CUDA GPU, and the probes' tensor-core kernels (P1,
P2, the score variants) through the port's probe scripts.

    python3 chip_smoke.py [--parent TREE]

(``python3 chip_smoke.py --rank-worker JOBS RANK WORLD PORT DIR`` is one
rank of a gloo group of WORLD processes on this card, which the script
starts itself for the phases that run over several ranks: it runs the
comma-separated ``JOBS`` of ``RANK_JOBS`` — ``config4`` (the
``distributed`` phase's world size 2), ``dense_ba`` (``ba_dense``),
``ring`` and ``staged`` (``ranks``) — reads its inputs from
``DIR/inputs.pt`` and writes its results to ``DIR/rank<RANK>.pt``.  The
parent builds the kernels first; a worker only loads them.)  ``--parent
TREE``: an earlier checkout (``git archive`` unpacked into a directory that
``.gitignore`` lists) whose segmented-sum kernel the ``segment_sum`` phase
times in turns with this one.

Phases, in order, one line each and their seconds at the end; any failure
exits non-zero before the result line:

1. device  — ``nvidia-smi`` name and power limit; CUDA present; TF32 off;
             the launch floor (a CUDA graph of one-element ``add_``
             launches, timed as the kernels are), which the one-pair
             kernel times are read against.
2. build   — compile every CUDA kernel of the paths from ``csrc/`` (nvcc,
             sm_90a) and report the seconds.
3. kernels — each kernel against its plain PyTorch version on the card at
             two shapes: batched (64 pairs × 512 × 512 × 64 for K1/K1b,
             64 × 512 hypotheses × 512 points for K2, 64 × 512 samples for
             K3, 64 pairs × 1024 × 1024 × 8 words for K4) and one pair (the
             shape the slices launch): errors, agreement, kernel times
             (CUDA-graph replays, so that the host's enqueue time does not
             hide a short kernel), plain times (CUDA events), and each
             kernel's bound (the least time the card could take for the
             same work).  K1, K1b, K3 and K4 on one pair must equal the
             same pair's rows of the batched launch bit for bit, and K3 and
             K2 must equal their plain versions exactly.  Beside K1 and K1b
             at 64 pairs, the yardstick ``baddbmm`` + ``topk`` (two calls).
4. slices  — a rendered 993×660 pair through ``two_view_pipeline`` twice:
             the SURF slice with the demo's ``--config ransac`` settings
             (512 keypoints, 512 hypotheses, plus ``match_descriptors_points``)
             and the ORB slice, ``orb_default_config()`` (FAST → rotated
             BRIEF → Hamming match → RANSAC F; 1024 keypoints, 512
             hypotheses).  The launch counters are set to 0 just before each
             slice and read just after; every kernel of the slice must have
             launched.  The output must be sane and agree with the same
             pipeline run on the CPU (plain versions) with the same RANSAC
             samples.
   k1sfm   — K1 at the shapes the SfM slices launch it at: a frame against
             the landmark bank (1 × 256 × 8192 × 64) and the bank's
             cross-check (1 × 8192 × 256 × 64), 90 % of the train rows
             masked, and the 32-d sequences (64 × 256 × 256 × 32), each held
             to its plain version as the 512 × 512 cases are; config 4's
             shapes at one pair and at the segment batches of 16 and 283
             (K1 S × 256 × 2,048 × 32 and back, S × 256 × 256 × 32; K3/K2
             at 4·S pairs of 128 hypotheses × 256 points).
   widths  — K1 and K1b at D = 16 and 48 (padded with zero columns to 32
             and 64), 128 (SIFT; its own instance) and 160, 256, 512 (the
             chunked kernel; 160 padded to 192), K4 at W = 4 (padded to 8),
             16 (512-bit; its own instance) and 24, 32 (the chunked
             kernel), 8 pairs each, against their plain versions with the
             built widths' tolerances.
   staged  — ``staged_two_view`` at world size 1 on 4 rendered pairs, SURF
             then ORB: launches, ms, and each pair equal to
             ``two_view_pipeline`` with the same RANSAC samples.
   pairs   — the bench head's step (``bench.py:363 bench_tpu``) over the
             pair axis: ``match_descriptors_points`` → ``ransac_fundamental``
             on 64 pairs × 512 keypoints × 64-d, 30 % outliers, ratio 0.85,
             512 hypotheses, bf16 and f32 matching, in one call each: K1b,
             K3 and K2 launch once a step (64 times in the loop of one-pair
             calls); with the same injected samples the batch equals the
             loop (counts and masks, |ΔF| ≤ 1e-5); inliers ≥ half the
             matches and F finite, unit-norm, rank 2 on every pair; the
             median ms of a step (20 steps) and of the loop (3), pairs/s of
             both, the host's eager launch time beside them.
   probes  — the probes' path: ``examples/probe_match_variants_torch.py``
             and ``probe_score_variants_torch.py`` through every variant at
             their shapes (64 pairs × 512 × 512 × 64-d; 64 × 512 hypotheses
             × 512 points), the launch counters set to 0 just before and
             read just after (``launches_by_path.probe``; P1, P2, the score
             kernel, K1 and K2).  Then P1 (``gemm_rowmin``), P2
             (``packed_top2``) and the score kernel's three instances against
             their plain versions at 64 pairs and at one pair (the kernels
             phase's descriptors, scenes and K3 hypotheses): P1 within 1e-5,
             P2's indices equal off the rows whose competing keys lie within
             2 quanta and dist within 2 quanta + 1e-5, the counts of (divide,
             fp32) equal and those of the bf16 instances off by no more than
             their cells at the gate; kernel and plain times, bounds, and
             the yardsticks ``torch.matmul`` + ``amin`` (P1) and ``baddbmm``
             + ``topk`` (P2) on the same bf16 operands, two calls each.
5. sfm     — BASELINE config 3 without loop closure: 100 rendered 512×384
             frames → Hessian/SURF on the card → ``run_incremental_sfm``
             (128 / 8,192 / 65,536, ``ba_every=4``, ``chunk_size=16``), held
             to tests/test_sequence_100.py's bounds (≥ 95 frames registered,
             > 500 landmarks, ATE < 10 % of the extent); frames/s of three
             runs (one ``synchronize`` at the end of each) beside the host's
             eager launch time (the loop is host-bound), launches per kernel
             and peak memory of the first; host syncs a frame (a run in
             CUDA's sync debug mode); ms per ``register_frame`` and per local
             BA (the loop's steps driven one by one, each synchronized); the
             first 16 frames through the CPU too, held to the same frames
             registered and trajectories within 2 % of the extent.
   sfm32   — the JAX bench's synthetic tracked sequence (64 frames × 256 ×
             32-d; K1 at D = 32): every frame registered, ATE under 10 % of
             the extent, frames/s and ms per frame as above.
             Then loop closure on the natural run's trajectory:
             ``close_loops`` (all-pairs scores on K1 → verification on K1,
             K3, K2 → pose graph), held to tests/test_sequence_100.py's
             bounds (≥ 1 candidate, ≥ 1 verified, ATE after closure < 10 %
             of the extent), its ms, host syncs and launches
             (``launches_by_path.loop``), and the same call on the CPU with
             the same injected RANSAC samples: equal candidates, flags and
             inlier counts, corrected poses within 1e-3.
   segment_sum — the segmented-sum kernel (the sparse BA's and the pose
             graph's sums, ``ops/kernels/segment_sum.py``) against its plain
             version at its paths' shapes: the ``ba`` phase's camera and
             landmark plans, config 4's full-length batch of 283 windowed
             BAs, the pose graph at P = 4,541 (f64) and the dense pose
             graph's block plan at P = 100 (10,000 rows, f64); equal bit for
             bit to its order in plain PyTorch (``segment_sum_ordered``),
             within the kernel's rounding bound of the plain version in
             float64, two launches equal bit for bit, a batch equal
             to each problem alone bit for bit; kernel ms (graph replays)
             beside the plain version's, the bound and its share,
             ``torch.index_add`` (atomics) and ``index_put_(accumulate=True)``
             under deterministic algorithms, ptxas's registers; with
             ``--parent``, the earlier tree's kernel in turns and its
             wrapper's host enqueue.
   ba      — ``bundle_adjust_sparse`` at the JAX bench's BA shape (64 cameras
             × 16,384 landmarks × 131,072 observations) under ``obs_layout``
             'auto', 'scatter', 'auto' (one path): the cost must fall; ms per
             LM iteration of each and peak memory; the three runs must end
             at the same bits.
   pose_graph — ``make_odometry_chain`` (laps of a circuit, noise 0.01, a
             loop edge at every revisit, every 500 poses) + ``optimize_pose_graph`` at P = 100 (dense; also on the
             CPU, poses within 1e-4) and P = 4,541 (KITTI 00's length, PCG
             of 1,000 steps; the default 100 steps reported beside it): cost
             and mean translation error must fall; ms per GN iteration, host
             syncs, peak memory; a second run equal bit for bit.
   ba_dense — the dense Schur BA (``ba/lm.bundle_adjust``, BASELINE config
             2's two-view BA and the engine of bench.py's ``ba`` section) at
             the bench's 32 cameras × 2,048 landmarks (``BA_DENSE``), a
             perturbed start: Cholesky and PCG (50 steps), chunks of 25 LM
             iterations at rtol 0 three times — the cost falls and stays
             finite, the runs equal in every bit; ms per LM iteration, peak
             memory, aten ops and host reads an iteration, the flop bound
             (``work.dense_ba_iteration_work``) and its share; held to the
             CPU with tests/test_torch_ba.py's bounds (first two steps 1e-3,
             20 iterations 10 % / 1 %; after 1, 2 and 20 iterations, here
             and at 6 × 64, cost, X, t within 4× the card's own move under
             a 1e-7 / 1e-6 move of its landmarks).
             ``distributed_bundle_adjust`` at
             world size 1 over NCCL equal to it bit for bit, at 2 and 4 as
             rank workers over gloo within tests/test_torch_parallel.py's
             bounds (1 iteration cost 1e-4, X 1e-3; 5: 10 %).
   all_pairs — BASELINE config 1's sweep (bench.py ``bench_all_pairs``:
             1,024 × 256 × 64-d, ratio 0.8) through ``all_pairs_scores`` (the
             ring with ``mesh=None``: one step) on K1: seconds a sweep and
             pairs/s beside the FMA bound, peak memory; 8 query frames × all
             1,024 against the plain version (differences only at f32
             near-ties of the ratio); a planted near-duplicate pair (7, 900)
             must be each other's best.
   ranks   — paths over several ranks, as rank workers on this card over
             gloo (seconds of processes sharing one card): the all-pairs
             ring at 2 and 4 ranks of a data mesh, its [1,024, 1,024] scores
             equal to the ``mesh=None`` sweep bit for bit, the planted pair
             found, K1's launches a rank, the bytes a ``ring_shift`` moves;
             the staged two-view at one rank a stage (4 ranks), SURF and
             ORB on the ``staged`` phase's pairs and samples, every wire
             field equal to world size 1 bit for bit, each stage's kernels
             launched on its own rank only, ms a microbatch and the bubble
             share.
   distributed — BASELINE config 4 on its stand-in (272 of KITTI 00's 4,541
             frames: 16 segments of 20, overlap 4, 3,000 landmarks, 256 ×
             32-d features, seed 5) through ``run_distributed_slam``: at
             world size 1 over NCCL (the 16 segments as one batch: K1 1 + 3
             a frame step, K3 = K2 = 1), then as two processes on this card
             over gloo, held to the reference test's gates, the same
             registrations and trajectories within 1 % of the extent;
             GPU against CPU on the 16-frame, 2-segment sequence; the first
             4 segments as one batch against two loops of one-segment
             builds (same registrations, camera gap within the loops' own
             spread); then config 4 at KITTI 00's length (4,541 frames, 283
             segments in one batch, 44,000 landmarks) at world size 1 over
             NCCL: every segment frame registered, > 95 % of cameras
             valid, global BA cost not above its start, the same launches,
             ATE printed, seconds by stage, peak memory.  The world-size-1
             stand-in and the full length each run twice: the two runs
             must be equal in every bit (RMS gap printed).
   slam    — ``examples/slam_demo_torch.py``'s path (``pipelines/slam.py``:
             decode from disk → Hessian/SURF, 512 features → SfM → loop
             closure → ATE → checkpoint) on rendered sequences written to
             disk: a KITTI-format tree at KITTI 00's camera size (200 frames,
             1241 × 376; ``SLAM_KITTI``) with loop closure and a checkpoint
             restored onto the card bit for bit; ``--distributed`` on it at
             world size 1 (16 segments of 16, overlap 4, one batch: K1 1 + 3
             a frame step, K3 = K2 = 1) under config 4's gates; a
             TUM-format tree of config 3's shape (100 frames, 640 × 480);
             each held to tests/test_sequence_100.py's gates.  K1 at the
             demo's shapes (512 × 32,768-row bank × 64) and K3/K2 at its
             RANSAC's (256 × 512) against their plain versions; ``roofline``,
             ``trace`` and ``checked`` on the card; GPU against CPU on the KITTI
             tree's first 16 frames.
6. result  — one JSON line of the SfM, pose-graph, all-pairs, staged,
             pairs, distributed and slam numbers, one of the probes' rows,
             one of per-kernel numbers (launches by path: surf, orb, sfm,
             loop, all_pairs, staged, pairs, distributed, slam, probe, ba,
             ba_dense, pose_graph, ranks — the ranks' launches summed over
             the workers; the segmented sum must have launched on sfm, loop,
             distributed, slam, ba and pose_graph), then
             the last line
             ``{"ok": true, "device": {...}}``.

Bounds are each kernel's work count on the inputs it was given
(``ops/kernels/work.py``: bytes read and written once, operations in the
kernel's unit, masked train rows of K1 and K4 and masked points of K2 not
counted) against the card's published peaks (``utils/profiling.chip_peaks``,
NVIDIA H100 SXM data sheet: 3.35 TB/s of device memory and 67 TFLOP/s fp32, an FMA counted
as two flops, so 33.5 T fp32 instructions/s).  Kernels built with
``--fmad=false`` (K2, K3) execute one instruction per multiply or add.
Population counts (K4) retire at 16 per clock per SM against 128 fp32 lanes
(the CUDA programming guide's throughput table for compute capability 9.0):
33.5e12 × 16/128 per second.  ``utils/profiling.roofline`` reads the same
counts.

Imports nothing of JAX.  Writes no files besides the kernel build, the
``slam`` phase's sequences and checkpoint, and the rank workers' inputs and
results, under temporary directories.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _bound_of(kernel, *args, **kwargs) -> dict:
    """A kernel's bound on these inputs: its work count
    (``ops/kernels/work.py``) against the card's peaks."""
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks

    return bound(kernel.work(*args, **kwargs), chip_peaks("cuda"))


def _scenes(B: int, N: int, gen, dev, outlier_frac: float = 0.3, noise: float = 0.5):
    """B random two-view scenes of N correspondences (pixels, 640×480, f=500):
    points in the first camera's frustum, a small rotation + baseline for the
    second, Gaussian pixel noise, and a fraction of outlier rows."""
    import torch

    def rnd(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    X = torch.stack([rnd(B, N) * 4 - 2, rnd(B, N) * 3 - 1.5, rnd(B, N) * 6 + 4], -1)
    a = (rnd(B) - 0.5) * 0.2
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    R = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                     torch.stack([-s, z, c], -1)], -2)
    t = torch.stack([0.3 + 0.2 * rnd(B), 0.05 * rnd(B), 0.05 * rnd(B)], -1)
    X2 = X @ R.transpose(-1, -2) + t[:, None]

    def project(P):
        return P[..., :2] / P[..., 2:] * 500.0 + torch.tensor([320.0, 240.0], device=dev)

    noise_t = lambda: noise * torch.randn(B, N, 2, generator=gen, device=dev)  # noqa: E731
    p1 = project(X) + noise_t()
    p2 = project(X2) + noise_t()
    n_out = int(outlier_frac * N)
    p2[:, :n_out] = torch.stack([rnd(B, n_out) * 640, rnd(B, n_out) * 480], -1)
    mask = torch.ones(B, N, dtype=torch.bool, device=dev)
    mask[:, -5:] = False
    return p1.contiguous(), p2.contiguous(), mask


def _binary_descriptors(B: int, N: int, W: int, gen, dev):
    """Random packed descriptors with what matching meets in use: exact
    duplicates of train rows, near-duplicates (3 flipped bits on average),
    train rows repeated (tied best and runner-up), ~5 % invalid train rows."""
    import torch

    from points_matching_tpu_torch.ops.descriptors import pack_bits

    bits = W * 32
    t = pack_bits(torch.rand(B, N, bits, generator=gen, device=dev) < 0.5)
    q = pack_bits(torch.rand(B, N, bits, generator=gen, device=dev) < 0.5)
    t[:, N - N // 16:] = t[:, :N // 16]                          # repeated train rows
    src = torch.rand(B, N, generator=gen, device=dev).argsort(-1)[:, :N // 2]
    picked = torch.gather(t, 1, src[..., None].expand(-1, -1, W))
    flips = pack_bits(torch.rand(B, N // 4, bits, generator=gen, device=dev) < 3 / bits)
    q[:, :N // 4] = picked[:, :N // 4]                           # exact duplicates
    q[:, N // 4:N // 2] = picked[:, N // 4:] ^ flips              # near-duplicates
    t_mask = torch.rand(B, N, generator=gen, device=dev) > 0.05
    return q.contiguous(), t.contiguous(), t_mask


def _check_estimate(tag: str, res, n_kp: int, min_matches: int) -> tuple:
    """Sanity of one slice's output: keypoint counts, matches, inliers ≥
    half the matches, F finite / unit-norm / rank 2, output shapes."""
    import torch

    n_kp1, n_kp2 = int(res.kps1.mask.sum()), int(res.kps2.mask.sum())
    n_m = int(res.matches.mask.sum())
    n_in = int(res.estimate.num_inliers)
    F = res.estimate.F.double().cpu()
    sv = torch.linalg.svdvals(F)
    print(f"slice {tag}: keypoints {n_kp1}/{n_kp2}, matches {n_m}, inliers {n_in}, "
          f"residual {float(res.estimate.residual_mean):.4g}, |F| {float(F.norm()):.6f}, "
          f"s3/s1 {float(sv[2] / sv[0]):.3g}")
    _check(n_kp1 >= n_kp and n_kp2 >= n_kp, f"{tag}: keypoints below {n_kp}")
    _check(n_m >= min_matches, f"{tag}: fewer than {min_matches} matches")
    _check(bool(torch.isfinite(F).all()) and abs(float(F.norm()) - 1.0) < 1e-4,
           f"{tag}: F not finite / not unit norm")
    _check(float(sv[2]) < 1e-4 * float(sv[0]), f"{tag}: F not rank 2")
    _check(2 * n_in >= n_m, f"{tag}: inliers below half the matches")
    cap = res.kps1.capacity
    _check(res.p1.shape == (cap, 2) and res.epilines2.shape == (cap, 3)
           and bool(torch.isfinite(res.epilines2).all()), f"{tag}: bad output shapes")
    return n_kp1, n_m, n_in


def _gpu_vs_cpu(tag: str, im1, im2, cfg, res, dev) -> None:
    """The same pair through the CPU (plain versions) with the same RANSAC
    samples: equal keypoint counts, matches within 2 % (≥ 2), inliers
    within 5 % (≥ 2), |⟨F_gpu, F_cpu⟩| ≥ 0.99."""
    import torch

    from points_matching_tpu_torch.geometry.ransac import sample_minimal_points
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    samples = sample_minimal_points(torch.Generator(device=dev).manual_seed(1),
                                    res.matches.mask, cfg.ransac.num_hypotheses, 8,
                                    (res.p1, res.p2))
    gpu = two_view_pipeline(im1, im2, None, cfg, samples=samples)
    cpu = two_view_pipeline(im1.cpu(), im2.cpu(), None, cfg,
                            samples=tuple(s.cpu() for s in samples))
    cos = abs(float((gpu.estimate.F.cpu() * cpu.estimate.F).sum()))
    g = (int(gpu.kps1.mask.sum()), int(gpu.matches.mask.sum()),
         int(gpu.estimate.num_inliers))
    c = (int(cpu.kps1.mask.sum()), int(cpu.matches.mask.sum()),
         int(cpu.estimate.num_inliers))
    print(f"slice {tag}: GPU vs CPU (kp1, matches, inliers) {g} vs {c}, "
          f"|<F_gpu, F_cpu>| {cos:.6f}")
    _check(g[0] == c[0] and abs(g[1] - c[1]) <= max(2, c[1] // 50)
           and abs(g[2] - c[2]) <= max(2, c[2] // 20) and cos >= 0.99,
           f"GPU and CPU runs of the {tag} slice disagree")


def _time_pipeline(tag: str, im1, im2, cfg, dev) -> float:
    import torch

    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    torch.cuda.synchronize()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(i), cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    print(f"slice {tag}: two_view_pipeline 993x660 {cfg.detector.max_keypoints} kp "
          f"{cfg.ransac.num_hypotheses} hyp: {med:.3f} ms/pair (median of 5; runs {times})")
    return med


def _k1_case(tag: str, nb: int, n1: int, n2: int, d: int, masked: float, gen, dev,
             measure) -> dict:
    """K1 f32 at one shape against its plain version: the same checks as the
    512 × 512 cases (max |Δdist| ≤ 1e-5, no 1-NN index mismatch off
    near-ties), times, and the bound from the train rows that are valid (a
    masked row needs no distance)."""
    import torch

    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    q = torch.randn(nb, n1, d, generator=gen, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    t = torch.randn(nb, n2, d, generator=gen, device=dev)
    t = t / t.norm(dim=-1, keepdim=True)
    t_mask = torch.rand(nb, n2, generator=gen, device=dev) >= masked
    kd, ki = fused_l2_top2(q, t, t_mask)
    pd, pi = l2_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    idx_bad = int(((ki[..., 0] != pi[..., 0]) & ~tie).sum())
    valid = int(t_mask.sum())
    print(f"kernel K1 f32 {tag} {nb}x{n1}x{n2}x{d} ({valid} valid train rows): "
          f"max|dist err| {err:.3g} (tol 1e-05), 1-NN index mismatches off near-ties "
          f"{idx_bad}")
    _check(err <= 1e-5 and idx_bad == 0, f"K1 {tag} disagrees with plain")
    bound = _bound_of(fused_l2_top2, q, t, t_mask)
    ms, pms = measure(f"K1 f32 {tag}", fused_l2_top2, l2_top2_plain, (q, t, t_mask), bound)
    lib_ms = _library_top2_ms(q, t, t_mask, "f32")
    print(f"kernel K1 f32 {tag}: yardstick baddbmm + topk {lib_ms:.5f} ms (two calls)")
    return dict(shape=[nb, n1, n2, d], masked_train_rows=nb * n2 - valid, max_abs_err=err,
                ms=ms, plain_ms=pms, **bound, library_ms=lib_ms,
                library_calls="two calls: torch.baddbmm + topk")


def _ransac_case(tag: str, H: int, N: int, gen, dev, measure, min_best=None, P: int = 1
                 ) -> dict:
    """K3 then K2 on P pairs (one by default) at H hypotheses over N
    correspondences, against their plain versions with the same checks as
    the 64-pair case (K3 every F bit-equal, K2 every count equal), times and
    bounds.  The best hypothesis must hold more than ``min_best`` (N / 2 by
    default) inliers, so that the comparison is not of empty counts."""
    import torch

    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        ransac_score_hypotheses, ransac_score_plain)

    p1, p2, pmask = _scenes(P, N, gen, dev)
    pick = torch.rand(P, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    sp1, sp2 = (torch.gather(p[:, None].expand(P, H, N, 2), 2,
                             pick[..., None].expand(P, H, 8, 2)).contiguous()
                for p in (p1, p2))
    kF = minimal_eight_point(sp1, sp2)
    pF = minimal_eight_point_plain(sp1, sp2)
    torch.cuda.synchronize()
    k3_ok = bool(torch.isfinite(kF).all()) and torch.equal(kF, pF)
    k3_bound = _bound_of(minimal_eight_point, sp1, sp2)
    print(f"kernel K3 {tag} {P}x{H}: max|F err| {float((kF - pF).abs().max()):.3g} (tol 0), "
          f"lanes per sample G = {minimal_eight_point.last_group}")
    _check(k3_ok, f"K3 {tag} disagrees with plain")
    group = minimal_eight_point.last_group
    k3_ms, k3_pms = measure(f"K3 {tag} {P}x{H}", minimal_eight_point, minimal_eight_point_plain,
                            (sp1, sp2), k3_bound, plain_iters=3)
    args = (kF, p1, p2, pmask, 1.5)
    kc = ransac_score_hypotheses(*args)
    tile = ransac_score_hypotheses.last_tile
    pc = ransac_score_plain(*args)
    torch.cuda.synchronize()
    cdiff = int((kc - pc).abs().max())
    k2_bound = _bound_of(ransac_score_hypotheses, *args)
    print(f"kernel K2 {tag} {P}x{H}x{N}: max|count diff| {cdiff} (tol 0), "
          f"max count {int(kc.max())}/{N}, tile (warps, hypotheses a warp) {tile}")
    _check(cdiff == 0 and int(kc.max()) > (N // 2 if min_best is None else min_best),
           f"K2 {tag} disagrees with plain")
    k2_ms, k2_pms = measure(f"K2 {tag} {P}x{H}x{N}", ransac_score_hypotheses,
                            ransac_score_plain, args, k2_bound)
    return dict(K3=dict(shape=[P, H], max_abs_err=0.0, ms=k3_ms, plain_ms=k3_pms, **k3_bound,
                        library_ms=None, group=group),
                K2=dict(shape=[P, H, N], max_abs_err=float(cdiff), ms=k2_ms, plain_ms=k2_pms,
                        **k2_bound, library_ms=None, tile=tile))


def _rendered_frames(dev, num_frames: int):
    """BASELINE config 3's sequence (tests/test_sequence_100.py): frames at
    512 × 384 from ``data/render.render_sequence`` (900 landmarks, an
    out-and-back trajectory of step 0.25), through the Hessian (threshold
    100, 256 keypoints) + SURF frontend on the card."""
    import torch

    from points_matching_tpu_torch.core.config import DescriptorConfig, DetectorConfig
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.detect import detect_keypoints

    step = 0.25
    imgs, gt_pos, _, (fx, fy, cx, cy) = render_sequence(
        num_frames=num_frames, num_landmarks=900, image_size=(512, 384), seed=0,
        loop=True, step=step, x_span=(-6.0, 6.0 + step * (num_frames // 2 - 1)))
    dcfg = DetectorConfig(kind="hessian", threshold=100.0, max_keypoints=256)
    xcfg = DescriptorConfig(kind="surf")
    frames = []
    for im in imgs:
        g = torch.from_numpy(np.ascontiguousarray(im)).to(dev)
        kp = detect_keypoints(g, dcfg)
        d = extract_descriptors(g, kp, xcfg)
        frames.append((kp.xy.contiguous(), d.data.contiguous(), kp.mask & d.mask))
    K = CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32, device=dev)
                           for v in (fx, fy, cx, cy)))
    return frames, K, torch.from_numpy(gt_pos.astype(np.float32)), step * (num_frames // 2 - 1)


def _sfm_config(max_landmarks: int, max_observations: int):
    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)

    return SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=128, max_landmarks=max_landmarks, max_observations=max_observations,
        pnp_min_inliers=12)


def _ate(res, gt, n: int) -> float:
    from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error

    mask = res.state.cam_mask[:n].cpu()
    return float(absolute_trajectory_error(res.trajectory[:n].cpu(), gt[:n], mask).rmse)


def _dispatch_us(dev, n: int = 2000) -> float:
    """The host's time per eager launch (µs): ``n`` one-element ``add_``
    calls enqueued back to back, one ``synchronize`` at the end.  The SfM
    loop is host-bound, so its frames/s follow this number."""
    import torch

    one = torch.zeros(1, device=dev)
    one.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _count_ops(fn) -> int:
    """The aten ops ``fn`` dispatches (each one eager launch or view on
    the host): what a host-bound path's time follows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def _count_syncs(fn):
    """(fn(), the host-device synchronizations it made) — each one the
    CUDA sync debug mode reports as a warning (``.item()``, ``bool()``,
    copies to the host, ...)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _slice_sfm(dev, K_mod) -> dict:
    """BASELINE config 3 without loop closure: 100 rendered frames → the
    frontend → ``run_incremental_sfm`` (128 cameras / 8,192 landmarks /
    65,536 observations, ``ba_every=4``, ``chunk_size=16``), held to
    tests/test_sequence_100.py's bounds; then the first 16 frames through
    the port on the CPU, against the same 16 on the card."""
    import torch

    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm
    from points_matching_tpu_torch.utils.evaluation import umeyama_alignment

    n = 100
    t0 = time.perf_counter()
    frames, K, gt, extent = _rendered_frames(dev, n)
    torch.cuda.synchronize()
    t_front = time.perf_counter() - t0
    n_feat = [int(f[2].sum()) for f in frames]
    print(f"slice sfm: {n} frames 512x384 rendered + Hessian/SURF on the card in "
          f"{t_front:.2f} s; features per frame min {min(n_feat)} / median "
          f"{int(np.median(n_feat))}")
    _check(min(n_feat) >= 96, "sfm: a frame with fewer than 96 features")
    cfg = _sfm_config(8192, 65536)

    def run(fr):
        return run_incremental_sfm(fr, K.to(fr[0][0].device), cfg, seed=0, ba_every=4,
                                   chunk_size=16)

    run(frames[:6])                              # warm-up (allocator, library)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # three timed runs (host clock, one synchronize at the end of each), the
    # host's eager launch time just before each; the first run's launches
    # and peak memory are the path's
    fps, disp, trajs = [], [], []
    for rep in range(3):
        disp.append(_dispatch_us(dev))
        K_mod.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(frames)
        torch.cuda.synchronize()
        fps.append(n / (time.perf_counter() - t0))
        trajs.append(out.trajectory)
        if rep == 0:
            res, launches = out, K_mod.launch_counts()
            peak = torch.cuda.max_memory_allocated()
    runs_equal = all(torch.equal(t_, trajs[0]) for t_ in trajs[1:])
    n_reg = sum(res.registered)
    n_lms = int(res.state.num_lms)
    ate = _ate(res, gt, n)
    print(f"slice sfm: registered {n_reg}/{n}, landmarks {n_lms}, observations "
          f"{int(res.state.num_obs)}, ATE {ate:.4f} (bound {0.1 * extent:.4f} = 10 % of "
          f"the extent {extent}); frames/s of three runs "
          + ", ".join(f"{f:.2f}" for f in fps) + " (host clock, one synchronize at the "
          "end of each); host eager launch before each "
          + ", ".join(f"{d:.2f}" for d in disp) + f" us; the three trajectories equal bit "
          f"for bit {runs_equal}")
    _check(n_reg >= n - 5, f"sfm: registered {n_reg}/{n}")
    _check(n_lms > 500, f"sfm: {n_lms} landmarks")
    _check(ate < 0.1 * extent, f"sfm: ATE {ate} over the bound")
    per_reg = {k: v / n_reg for k, v in launches.items()}
    print(f"slice sfm: launches on the path {launches}; per registered frame "
          + json.dumps({k: round(v, 3) for k, v in per_reg.items()}))
    for k in ("fused_l2_top2", "minimal_eight_point", "ransac_score_hypotheses"):
        _check(launches[k] > 0, f"sfm: {k} never launched")
    # K1: three launches a frame after the bootstrap's one
    _check(launches["fused_l2_top2"] >= 1 + 3 * (n - 2), "sfm: K1 not launched every frame")
    # the rest of config 3: loop closure on the natural run's trajectory
    loop = _loop_closure(dev, K_mod, res, frames, K, cfg, gt, extent)

    res_s, syncs = _count_syncs(lambda: run(frames))
    print(f"slice sfm: host syncs {syncs} in the run ({syncs / n:.2f} a frame; registered "
          f"{sum(res_s.registered)}/{n}); peak device memory {peak / 2**20:.1f} MiB")
    disp.append(_dispatch_us(dev))
    frame_ms, ba_ms = _step_times(frames, K, cfg)
    print(f"slice sfm: register_frame {float(np.median(frame_ms)):.3f} ms median of "
          f"{len(frame_ms)} registered frames after the bootstrap; local BA {len(ba_ms)} "
          f"calls, median {float(np.median(ba_ms)):.3f} ms, total {sum(ba_ms):.1f} ms "
          f"(each step synchronized; host eager launch before {disp[-1]:.2f} us)")

    # GPU against CPU on the first 16 frames (the card's features, on the CPU)
    m = 16
    gpu = run(frames[:m])
    cpu = run([tuple(x.cpu() for x in f) for f in frames[:m]])
    ext_m = 0.25 * (m - 1)
    tg, tc = gpu.trajectory[:m].cpu(), cpu.trajectory[:m]
    s, R, t = umeyama_alignment(tg, tc)
    diff = float(((s * tg @ R.T + t - tc).norm(dim=-1) ** 2).mean().sqrt())
    ate_g, ate_c = _ate(gpu, gt, m), _ate(cpu, gt, m)
    print(f"slice sfm: GPU vs CPU on {m} frames: registered {gpu.registered} vs "
          f"{cpu.registered}; ATE {ate_g:.4f} vs {ate_c:.4f} (bound {0.1 * ext_m:.4f}); "
          f"aligned trajectory difference {diff:.4f} (bound {0.02 * ext_m:.4f} = 2 % of "
          f"{ext_m})")
    _check(gpu.registered == cpu.registered, "sfm: GPU and CPU registered other frames")
    _check(ate_g < 0.1 * ext_m and ate_c < 0.1 * ext_m, "sfm: 16-frame ATE over the bound")
    _check(diff < 0.02 * ext_m, "sfm: GPU and CPU trajectories differ")
    return dict(launches=launches, loop=loop, registered=n_reg, landmarks=n_lms, ate=ate,
                frame_ms=float(np.median(frame_ms)), frames_per_s=float(np.median(fps)),
                frames_per_s_runs=fps, runs_equal=runs_equal, dispatch_us=disp, ba_ms=ba_ms,
                syncs_per_frame=syncs / n, peak_bytes=peak, gpu_vs_cpu_diff=diff)


def _step_times(frames, K, cfg):
    """Per-step times of the SfM loop on the host clock, each step
    synchronized: ``register_frame`` for each registered frame after the
    bootstrap, and each local BA (``ba_every=4``), in the order of
    ``run_incremental_sfm`` (the slices' frames/s come from its run, which
    synchronizes only where it reads the device).  Returns (frame ms, local
    BA ms)."""
    import torch

    from points_matching_tpu_torch.pipelines.sfm import (
        bootstrap_two_view, init_sfm_state, local_bundle_adjust, register_frame)

    dev = frames[0][0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_sfm_state(cfg, *frames[0][1].shape, device=dev)
    state, _ = bootstrap_two_view(state, *frames[0], *frames[1], K, gen, cfg)
    frame_ms, ba_ms = [], []
    for i, f in enumerate(frames[2:], 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, st = register_frame(state, *f, K, gen, cfg)
        torch.cuda.synchronize()
        if not bool(st.registered):
            continue
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 4 == 0:
            t0 = time.perf_counter()
            state, _ = local_bundle_adjust(state, K, cfg, cfg.local_ba_window)
            torch.cuda.synchronize()
            ba_ms.append((time.perf_counter() - t0) * 1e3)
    return frame_ms, ba_ms


def _slice_sfm32(dev, K_mod) -> dict:
    """The JAX bench's ``sfm`` section on the card: 64 frames × 256
    features × 32-d (kernel K1 at D = 32), 128 / 4,096 / 32,768."""
    import torch

    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm

    n = 64
    frames, K, gt = make_tracked_sequence(n, device=dev, num_landmarks=600,
                                          x_range=(-6.0, 10.0), yaw_step=0.01, t_step=0.12)
    extent = 0.12 * (n - 1)
    cfg = _sfm_config(4096, 32768)
    run_incremental_sfm(frames[:6], K, cfg, seed=0)               # warm-up
    torch.cuda.synchronize()
    disp = _dispatch_us(dev)
    K_mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_incremental_sfm(frames, K, cfg, seed=0, ba_every=4, chunk_size=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K_mod.launch_counts()
    n_reg = sum(res.registered)
    ate = _ate(res, gt, n)
    frame_ms, _ = _step_times(frames, K, cfg)
    print(f"slice sfm32: registered {n_reg}/{n}, landmarks {int(res.state.num_lms)}, "
          f"ATE {ate:.4f} (bound {0.1 * extent:.4f} = 10 % of the extent {extent:.2f}); "
          f"{n / wall:.2f} frames/s, register_frame {float(np.median(frame_ms)):.3f} ms "
          f"median (synchronized); host eager launch {disp:.2f} us; launches {launches}")
    _check(n_reg == n, f"sfm32: registered {n_reg}/{n}")
    _check(ate < 0.1 * extent, f"sfm32: ATE {ate} over the bound")
    _check(launches["fused_l2_top2"] >= 3 * (n - 2), "sfm32: K1 (D = 32) not launched")
    return dict(registered=n_reg, ate=ate, frame_ms=float(np.median(frame_ms)),
                frames_per_s=n / wall, dispatch_us=disp, launches=launches)


def _ba_sparse(dev, K_mod) -> dict:
    """``bundle_adjust_sparse`` at the JAX bench's BA shape (bench.py:
    ``bench_ba_sparse``): 64 cameras × 16,384 landmarks × 131,072
    observations from ``make_sparse_ba_problem(seed=1)``, 10 LM iterations
    (rtol 0) of 25 PCG steps, under ``obs_layout`` ``'auto'``,
    ``'scatter'``, ``'auto'`` — every layout runs the plans and the
    segmented-sum kernel, as the reference's two layouts give the same
    bits — with ms per LM iteration for each.  The three runs must end at
    the same bits; the first one's launches are the path's."""
    import torch

    from points_matching_tpu_torch.ba.sparse import (
        bundle_adjust_sparse, make_sparse_ba_state)
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem

    prob = make_sparse_ba_problem(seed=1, num_cameras=64, num_landmarks=16384,
                                  obs_per_landmark=8, device=dev)
    K = CameraIntrinsics.from_matrix(prob["K"])
    state = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"], prob["lm_idx"],
                                 prob["uv"], prob["obs_mask"])
    bundle_adjust_sparse(state, K, BAConfig(max_iterations=1, rtol=0.0,      # warm-up
                                            pcg_iterations=25))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    runs = []
    for layout in ("auto", "scatter", "auto"):
        cfg = BAConfig(max_iterations=10, rtol=0.0, pcg_iterations=25, obs_layout=layout)
        torch.cuda.reset_peak_memory_stats()
        K_mod.reset_launch_counts()
        t0 = time.perf_counter()
        out, st = bundle_adjust_sparse(state, K, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs.append(dict(layout=layout, out=out, st=st, ms=ms,
                         peak=torch.cuda.max_memory_allocated(),
                         launches=K_mod.launch_counts()))
    n_obs = int(state.obs_mask.sum())
    first = runs[0]
    st = first["st"]
    it = int(st.iterations)
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    ms_it = [r["ms"] / int(r["st"].iterations) for r in runs]
    print(f"ba sparse: 64 cams x 16384 lm x {state.num_observations} obs ({n_obs} valid): "
          f"cost {c0:.6g} -> {c1:.6g} in {it} LM iterations, "
          + " / ".join(f"{m:.3f} ({r['layout']})" for m, r in zip(ms_it, runs))
          + f" ms/iteration (host clock, synchronized); peak device memory "
          f"{first['peak'] / 2**20:.1f} MiB ({(first['peak'] - base) / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before the call); segmented-sum launches "
          f"{first['launches']['segment_sum']}")
    _check(c1 < c0 and math.isfinite(c1), "ba sparse: cost did not go down")
    same = all(torch.equal(first["st"].final_cost, r["st"].final_cost)
               and torch.equal(first["out"].X, r["out"].X)
               and torch.equal(first["out"].poses.t, r["out"].poses.t) for r in runs[1:])
    print(f"ba sparse: the 'auto', 'scatter' and 'auto' runs equal bit for bit (cost, X, t): "
          f"{same}")
    _check(same, "ba sparse: two runs differ")
    _check(all(r["launches"]["segment_sum"] > 0 for r in runs),
           "ba sparse: the segmented sum never launched")
    return dict(initial_cost=c0, final_cost=c1, iterations=it, ms_per_iteration=ms_it,
                layouts=[r["layout"] for r in runs], peak_bytes=first["peak"],
                base_bytes=base, runs_equal=same, launches=first["launches"])


def _seg_library_ms(values, keys, n: int) -> dict:
    """The two yardsticks beside the segmented sum, one PyTorch call each on
    the same values and the unsorted row of each entry (masked entries on a
    dump row n): ``torch.index_add`` (float atomics; CUDA-graph replays,
    as the kernel) and ``index_put_(accumulate=True)`` under
    ``torch.use_deterministic_algorithms(True)`` (its sort-based
    deterministic version; CUDA events around back-to-back calls, as the
    plain versions are timed).  Timed here, used nowhere in the port."""
    import torch

    from points_matching_tpu_torch.utils.profiling import cuda_event_ms, cuda_graph_ms

    zeros = torch.zeros((n + 1, *values.shape[1:]), dtype=values.dtype, device=values.device)
    index_add = cuda_graph_ms(lambda: torch.index_add(zeros, 0, keys, values))
    acc = zeros.clone()
    torch.use_deterministic_algorithms(True)
    try:
        index_put = cuda_event_ms(lambda: acc.index_put_((keys,), values, accumulate=True))
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(index_add_ms=index_add, index_put_deterministic_ms=index_put)


def _host_us(fn, n: int = 500) -> float:
    """The host's µs to enqueue one call of ``fn`` (``n`` calls back to back,
    no wait; for calls the card finishes faster than the host enqueues)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _seg_registers(csrc: str) -> dict:
    """ptxas's registers a thread for each kernel of ``csrc/segment_sum.cu``
    (the build's flags and ``-Xptxas -v``), keyed by (dtype, W) and then by
    kernel: ``{("float64", 36): {"segment_sum_kernel": 40}, ...}``."""
    import re

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    from probe_eightpoint_torch import ptxas_report

    regs = {}
    for row in ptxas_report(csrc, "segment_sum.cu"):
        m = re.search(r"\d+(segment_[a-z_]+_kernel)I([fd])Li(\d+)E", row["kernel"])
        if m and "registers" in row:
            key = ("float64" if m.group(2) == "d" else "float32", int(m.group(3)))
            regs.setdefault(key, {})[m.group(1)] = row["registers"]
    return regs


def _parent_segment_sum(tree: str):
    """An earlier tree's ``ops/kernels/segment_sum.py`` run against its own
    ``csrc/segment_sum.cu``, built alone with this build's flags into
    ``build/parent_segment_sum/``: the module, with its ``_build`` swapped
    for one that loads that library (C entry: values, perm, offsets, pieces,
    piece_rows, out, part, n, W, max_pieces, f64, stream)."""
    import ctypes
    import importlib.util
    import types

    from points_matching_tpu_torch.ops.kernels import _build

    csrc = os.path.join(tree, "points_matching_tpu_torch", "csrc")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "parent_segment_sum", "libparent_segment_sum.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out,
                           os.path.join(csrc, "segment_sum.cu")], capture_output=True, text=True)
    _check(proc.returncode == 0, f"the parent's segment_sum.cu did not build:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.pmt_segment_sum.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pmt_segment_sum.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "parent_segment_sum", os.path.join(tree, "points_matching_tpu_torch", "ops", "kernels",
                                           "segment_sum.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def check(_lib, rc, name):
        _check(rc == 0, f"parent {name}: CUDA error {rc}")

    mod._build = types.SimpleNamespace(library=lambda: lib, check=check)
    return mod, _seg_registers(csrc)


def _segment_sum(dev, parent_tree=None) -> dict:
    """The segmented-sum kernel against its plain version at the shapes of
    its paths: the ``ba sparse`` phase's camera and landmark plans (64 ×
    16,384 × 131,072; W = 36, 6 and 9, 3), config 4's full-length batch of
    283 windowed BAs (20 cameras, 2,048 landmarks, 8,192 observations a
    segment, 60 % valid; the [S·C] rows at W = 36 and the [S·L] rows at W =
    9), the pose graph at P = 4,541 (the ``pose graph`` phase's circuit;
    endpoints [ei; ej], f64 at W = 6 and 36) and the dense pose graph's
    block plan at P = 100 (P² = 10,000 (row, column) blocks, mostly empty,
    f64 at W = 36, as ``close_loops`` runs it).  Each equal bit for bit to
    its order in plain PyTorch (``segment_sum.segment_sum_ordered``), within
    the kernel's rounding bound (``segment_sum.rounding_bound``) of the
    plain version in float64 (``max_abs_err`` is that gap), two launches
    equal bit for bit, and a batch equal to each problem alone bit for bit
    (config 4: each of the 283 segments; the others: two copies side by
    side); kernel ms (CUDA-graph replays) beside the plain version's, the
    bound and its share, the two library calls and the factor against
    ``index_add``, and ptxas's registers of the instance.  With
    ``parent_tree`` (an earlier checkout, ``--parent``) also that tree's
    kernel on the same values, timed in turns with this one (this,
    parent, parent, this; each the mean of its two turns) and its
    registers.  At the pose graph's W = 6 also the host's µs to enqueue a
    call, against ``torch.zeros`` + ``index_add_`` (the sums before the
    plans) and the parent's wrapper."""
    import torch

    from points_matching_tpu_torch.ba.pose_graph import _block_plan, make_odometry_chain
    from points_matching_tpu_torch.ba.sparse import make_sparse_ba_state, sparse_plans
    from points_matching_tpu_torch.core.types import flat_rows
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss
    from points_matching_tpu_torch.utils.profiling import cuda_event_ms, cuda_graph_ms

    here = os.path.dirname(os.path.abspath(__file__))
    regs = _seg_registers(os.path.join(here, "points_matching_tpu_torch", "csrc"))
    print(f"segment sum: ptxas registers a thread {regs}")
    parent, parent_regs = _parent_segment_sum(parent_tree) if parent_tree else (None, {})
    if parent is None:
        print("segment sum: no --parent tree given; the earlier design is not measured")
    else:
        print(f"segment sum: the parent's kernels ({parent_tree}), ptxas registers {parent_regs}")
    gen = torch.Generator(device=dev).manual_seed(14)
    prob = make_sparse_ba_problem(seed=1, num_cameras=64, num_landmarks=16384,
                                  obs_per_landmark=8, device=dev)
    ba = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"], prob["lm_idx"],
                              prob["uv"], prob["obs_mask"])
    S, C, L, O = 283, SEG4, 2048, 8192
    c4_cam = torch.randint(0, C, (S, O), generator=gen, device=dev)
    c4_lm = torch.randint(0, L, (S, O), generator=gen, device=dev)
    c4_mask = torch.rand(S, O, generator=gen, device=dev) < 0.6
    P = 4541
    g = make_odometry_chain(_circuit_poses(P, 500, dev), torch.Generator(device=dev).manual_seed(P),
                            loop_edges=tuple((i, i + 500) for i in range(0, P - 500, 500)))
    ends = torch.cat([g.edges_i, g.edges_j]).long()
    # the dense solve's block plan, as the pose graph phase's P = 100 graph gives it
    P1 = 100
    g1 = make_odometry_chain(_circuit_poses(P1, P1 - 1, dev),
                             torch.Generator(device=dev).manual_seed(P1), odom_noise=0.01,
                             loop_edges=((0, P1 - 1),), loop_weight=20.0)
    ei, ej = g1.edges_i.long(), g1.edges_j.long()
    blocks = torch.cat([ei * P1 + ei, ej * P1 + ej, ei * P1 + ej, ej * P1 + ei])
    # (tag, index [S', R'] of S' problems, rows a problem, mask, widths, dtype)
    cases = [("ba sparse cameras", ba.cam_idx.long()[None], 64, ba.obs_mask[None], (36, 6),
              torch.float32),
             ("ba sparse landmarks", ba.lm_idx.long()[None], 16384, ba.obs_mask[None], (9, 3),
              torch.float32),
             ("config4 cameras", c4_cam, C, c4_mask, (36,), torch.float32),
             ("config4 landmarks", c4_lm, L, c4_mask, (9,), torch.float32),
             ("pose graph P=4541", ends[None], P, torch.ones_like(ends[None], dtype=torch.bool),
              (6, 36), torch.float64),
             ("pose graph dense P=100", blocks[None], P1 * P1,
              torch.ones_like(blocks[None], dtype=torch.bool), (36,), torch.float64)]
    # the BA's plans come from sparse_plans, the dense one from the pose graph's _block_plan
    cp, lp = sparse_plans(ba)
    own = {"ba sparse cameras": cp, "ba sparse landmarks": lp,
           "pose graph dense P=100": _block_plan(g1)}
    out = []
    for tag, index, n, mask, widths, dtype in cases:
        B, R = index.shape
        plan = ss.build_plan(flat_rows(index, n), B * n, mask)
        keys = torch.where(mask, flat_rows(index, n), B * n).reshape(-1)
        if tag in own:
            _check(all(torch.equal(a, b) for a, b in zip(own[tag][:4], plan[:4])),
                   f"segment sum {tag}: the path's own plan differs")
        pplan = parent.build_plan(flat_rows(index, n), B * n, mask) if parent else None
        # the batch of the check: config 4's own 283, else two copies side by side
        bidx, bmask = (index, mask) if B > 1 else (index.expand(2, -1), mask.expand(2, -1))
        bplan = plan if B > 1 else ss.build_plan(flat_rows(bidx, n), 2 * n, bmask)
        for W in widths:
            values = torch.randn(B * R, W, generator=gen, device=dev, dtype=dtype)
            got = ss.segment_sum(values, plan)
            ref = ss.segment_sum_plain(values.double(), plan)
            again = ss.segment_sum(values, plan)
            tol = ss.rounding_bound(values, plan)
            bvalues = values if B > 1 else torch.randn(2 * R, W, generator=gen, device=dev,
                                                       dtype=dtype)
            bgot = got if B > 1 else ss.segment_sum(bvalues, bplan)
            torch.cuda.synchronize()
            ordered = torch.equal(got, ss.segment_sum_ordered(values, plan))
            err = float((got.double() - ref).abs().max())
            within = bool(((got.double() - ref).abs() <= tol).all())
            twice = torch.equal(got, again)
            alone = all(torch.equal(bgot[s * n:(s + 1) * n], ss.segment_sum(
                bvalues[s * R:(s + 1) * R], ss.build_plan(bidx[s], n, bmask[s])))
                for s in range(bidx.shape[0]))
            bound = _bound_of(ss.segment_sum, values, plan)
            turns = {"this": [], "parent": []}
            for who in ("this", "parent", "parent", "this"):
                if who == "this":
                    turns[who].append(cuda_graph_ms(lambda: ss.segment_sum(values, plan)))
                elif parent:
                    turns[who].append(cuda_graph_ms(lambda: parent.segment_sum(values, pplan)))
            ms = sum(turns["this"]) / 2
            parent_ms = sum(turns["parent"]) / 2 if parent else None
            pms = cuda_event_ms(lambda: ss.segment_sum_plain(values, plan))
            lib = _seg_library_ms(values, keys, B * n)
            valid = int(plan.offsets[-1])
            key = (str(dtype)[6:], W)
            reg = regs.get(key, {}).get("segment_sum_kernel")
            preg = parent_regs.get(key)
            was = (f"; the parent's design {parent_ms:.5f} ms ({parent_ms / ms:.2f}x this one), "
                   f"registers {preg}" if parent else "")
            print(f"segment sum {tag} {B} x {n} rows x {R} entries ({valid} valid), W = {W} "
                  f"{str(dtype)[6:]}: equal to segment_sum_ordered {ordered}, max |kernel - "
                  f"plain| {err:.3g} (within the rounding bound {within}), two launches equal "
                  f"{twice}, a batch of {bidx.shape[0]} equal to each problem alone {alone}; "
                  f"{ms:.5f} ms (turns {turns['this'][0]:.5f}, {turns['this'][1]:.5f}) vs plain "
                  f"{pms:.5f} ms, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; "
                  f"{bound['bound_ms'] / ms:.1%} of it), index_add {lib['index_add_ms']:.5f} ms "
                  f"(this one {ms / lib['index_add_ms']:.2f}x), deterministic index_put_ "
                  f"{lib['index_put_deterministic_ms']:.5f} ms; {reg} registers{was}")
            _check(ordered and within and twice and alone, f"segment sum {tag} W = {W}: disagrees")
            out.append(dict(case=tag, problems=B, rows=n, entries=R, valid=valid, width=W,
                            dtype=str(dtype)[6:], max_abs_err=err, equal_to_ordered=ordered,
                            ms=ms, ms_turns=turns["this"], plain_ms=pms, **bound,
                            bound_share=bound["bound_ms"] / ms, library_ms=lib["index_add_ms"],
                            vs_index_add=ms / lib["index_add_ms"],
                            library_deterministic_ms=lib["index_put_deterministic_ms"],
                            registers=reg, parent_ms=parent_ms, parent_ms_turns=turns["parent"],
                            parent_registers=preg))
            if tag.startswith("pose graph P") and W == 6:
                host = _host_us(lambda: ss.segment_sum(values, plan))
                scatter = _host_us(lambda: torch.zeros(
                    (B * n, W), dtype=dtype, device=dev).index_add_(0, ends, values))
                phost = _host_us(lambda: parent.segment_sum(values, pplan)) if parent else None
                print(f"segment sum {tag} W = {W}: the host's enqueue {host:.2f} us a call "
                      f"against {scatter:.2f} us for torch.zeros + index_add_"
                      + (f" and {phost:.2f} us for the parent's wrapper" if parent else ""))
                out[-1].update(host_us=host, host_us_zeros_index_add=scatter,
                               host_us_parent=phost)
    return dict(cases=out)


def _near_tie_cells(got, ref, qd, qm, td, tm, ratio: float) -> int:
    """Cells of two score matrices that differ by more than their rows at an
    f32 near-tie of the ratio test (|best − r²·second| ≤ 1e-5·second, in
    float64): 0 when every difference is rounding at a near-tie."""
    import torch

    bad = 0
    for i, j in (got != ref).nonzero().tolist():
        dist = torch.cdist(qd[i].double(), td[j].double()) ** 2
        dist = torch.where(tm[j][None], dist, torch.full_like(dist, 1e30))
        two = dist.topk(2, largest=False).values
        ties = qm[i] & ((two[:, 0] - ratio ** 2 * two[:, 1]).abs() <= 1e-5 * two[:, 1])
        bad += int(abs(int(got[i, j]) - int(ref[i, j])) > int(ties.sum()))
    return bad


def _widths(dev, measure) -> dict:
    """K1 / K1b at widths the kernel is not built for (D = 16, 48: zero
    columns up to 32 and 64), at its instance D = 128 (SIFT) and on its
    chunked path above 128 (D = 160, padded to 192; 256; 512), and K4 at
    W = 4 (zero words up to 8), its instance W = 16 (512-bit) and its
    chunked path (W = 24, 32), each against its plain version on the card:
    the same tolerances as at the built widths (K1 distances 1e-5, no 1-NN
    mismatch off near-ties; K4 exact).  Times at 8 pairs; bounds from the
    unpadded width."""
    import torch

    from points_matching_tpu_torch.ops.kernels.hamming_kernel import (
        fused_hamming_top2, hamming_top2_plain)
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain, l2_top2_points_plain)

    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"K1": {}, "K4": {}}
    B, N = 8, 512
    for d in (16, 48, 128, 160, 256, 512):
        q = torch.randn(B, N, d, generator=gen, device=dev)
        q = q / q.norm(dim=-1, keepdim=True)
        t = torch.randn(B, N, d, generator=gen, device=dev)
        t = t / t.norm(dim=-1, keepdim=True)
        t_mask = torch.rand(B, N, generator=gen, device=dev) > 0.05
        pts = torch.rand(B, N, 2, generator=gen, device=dev) * 900
        kd, ki, kp = fused_l2_top2_points(q, t, t_mask, pts)
        kd1, ki1 = fused_l2_top2(q, t, t_mask)
        pd, pi, pp = l2_top2_points_plain(q, t, t_mask, pts)
        torch.cuda.synchronize()
        err = float(max((kd - pd).abs().max(), (kd1 - pd).abs().max()))
        tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
        idx_bad = int(((ki[..., 0] != pi[..., 0]) & ~tie).sum())
        pts_ok = bool(torch.equal(kp, torch.gather(pts, 1, ki[..., :1].long().expand(-1, -1, 2))))
        same = bool(torch.equal(ki, ki1) and torch.equal(kd, kd1))
        print(f"widths K1/K1b D = {d} ({B}x{N}x{N}): max|dist err| {err:.3g} (tol 1e-05), "
              f"1-NN index mismatches off near-ties {idx_bad}, K1b pts exact {pts_ok}, "
              f"K1 == K1b {same}")
        _check(err <= 1e-5 and idx_bad == 0 and pts_ok and same, f"K1 at D = {d} disagrees")
        bound = _bound_of(fused_l2_top2, q, t, t_mask)
        ms, pms = measure(f"K1 f32 D = {d} x{B}", fused_l2_top2, l2_top2_plain,
                          (q, t, t_mask), bound)
        out["K1"][f"D{d}"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bound,
                                  library_ms=None)
    HB, HN = 8, 1024
    for w in (4, 16, 24, 32):
        hq, ht, hmask = _binary_descriptors(HB, HN, w, gen, dev)
        kd, ki = fused_hamming_top2(hq, ht, hmask)
        pd, pi = hamming_top2_plain(hq, ht, hmask)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        exact = bool(torch.equal(ki, pi))
        print(f"widths K4 W = {w} ({HB}x{HN}x{HN}): max|dist err| {err:.3g} (tol 0), "
              f"both index columns equal {exact}")
        _check(err == 0.0 and exact, f"K4 at W = {w} disagrees")
        bound = _bound_of(fused_hamming_top2, hq, ht, hmask)
        ms, pms = measure(f"K4 W = {w} x{HB}", fused_hamming_top2, hamming_top2_plain,
                          (hq, ht, hmask), bound, plain_iters=3)
        out["K4"][f"W{w}"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bound,
                                  library_ms=None)
    return out


def _circuit_poses(n: int, period: int, dev):
    """n world→camera poses driving a flat circle of radius 50 m, one lap
    every ``period`` poses (the camera yawing with the road): pose i and
    i + ``period`` stand at the same place — the revisits a loop closure
    links."""
    import torch

    from points_matching_tpu_torch.core.types import Pose
    from points_matching_tpu_torch.geometry.se3 import so3_exp

    ang = 2.0 * math.pi * torch.arange(n, dtype=torch.float64) / period
    R = so3_exp(torch.stack([torch.zeros_like(ang), ang, torch.zeros_like(ang)], -1))
    c = torch.stack([50.0 * torch.cos(ang), torch.zeros_like(ang), 50.0 * torch.sin(ang)], -1)
    t = -(R @ c[..., None])[..., 0]
    return Pose(R=R.float().to(dev), t=t.float().to(dev))


def _drifted_start(g):
    """The noisy odometry integrated from pose 0 (float64 on the host), on
    the graph's device: the drifted start a pose graph corrects."""
    import torch

    from points_matching_tpu_torch.core.types import Pose

    P = g.num_poses
    ZR, Zt = g.Z.R[:P - 1].double().cpu(), g.Z.t[:P - 1].double().cpu()
    R, t = [g.poses.R[0].double().cpu()], [g.poses.t[0].double().cpu()]
    for e in range(P - 1):                     # T_{e+1} = Z_e⁻¹ T_e
        Ri = ZR[e].T
        R.append(Ri @ R[-1])
        t.append(Ri @ (t[-1] - Zt[e]))
    dev = g.poses.t.device
    return Pose(R=torch.stack(R).float().to(dev), t=torch.stack(t).float().to(dev))


def _pose_graph(dev, K_mod) -> dict:
    """``make_odometry_chain`` + ``optimize_pose_graph`` on the card: a
    circuit driven lap after lap (``_circuit_poses``), odometry noise 0.01,
    a loop edge at every revisit — every 500 poses (one lap of 99 at P =
    100) — and a start drifted by the noisy odometry; P = 100 (dense;
    BASELINE config 3's length), also solved on the CPU, and P = 4,541 (KITTI
    odometry sequence 00, BASELINE config 4; ``solver="auto"`` takes PCG).
    The cost and the mean translation error against ground truth must
    fall, and a second run (the one that counts host syncs) must end at the
    same bits; the timed runs' launches are the path's."""
    import torch

    from points_matching_tpu_torch.ba.pose_graph import (
        make_odometry_chain, optimize_pose_graph, pose_graph_cost)

    out, launches = {}, None
    # P = 4,541 twice: PCG's default of 100 steps a solve, reported only (it
    # stops early: on this graph the cost fell 10× while the mean error rose,
    # measured on one H100), and 1,000 steps, held (CG needs about the loop spacing in
    # steps on a chain with a loop every 500 poses)
    for P, pcg, held in ((100, 100, True), (4541, 100, False), (4541, 1000, True)):
        period = min(500, P - 1)
        gt = _circuit_poses(P, period, dev)
        loops = tuple((i, i + period) for i in range(0, P - period, period))
        gen = torch.Generator(device=dev).manual_seed(P)
        g = make_odometry_chain(gt, gen, odom_noise=0.01, loop_edges=loops, loop_weight=20.0)
        g0 = g.replace(poses=_drifted_start(g))
        optimize_pose_graph(g0, max_iterations=1, pcg_iterations=pcg)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K_mod.reset_launch_counts()
        t0 = time.perf_counter()
        g1, st = optimize_pose_graph(g0, pcg_iterations=pcg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        counts = K_mod.launch_counts()
        launches = counts if launches is None else {k: launches[k] + v
                                                    for k, v in counts.items()}
        (g2, _), syncs = _count_syncs(lambda: optimize_pose_graph(g0, pcg_iterations=pcg))
        same = torch.equal(g1.poses.R, g2.poses.R) and torch.equal(g1.poses.t, g2.poses.t)
        it = int(st.iterations)

        def err(p):
            return float((p.t - gt.t).norm(dim=-1).mean())

        c0, c1 = float(st.initial_cost), float(st.final_cost)
        e0, e1 = err(g0.poses), err(g1.poses)
        solver = "dense" if P <= 384 else f"pcg {pcg} steps"
        print(f"pose graph P = {P} ({g.num_edges} edges, {len(loops)} loops, {solver}): cost "
              f"{c0:.6g} -> {c1:.6g} in {it} GN iterations, {ms / it:.3f} ms/iteration (host "
              f"clock, synchronized), mean translation error {e0:.4f} -> {e1:.4f}; host syncs "
              f"{syncs}; peak device memory {peak / 2**20:.1f} MiB; segmented-sum launches "
              f"{counts['segment_sum']}; a second run equal bit for bit {same}"
              + ("" if held else " (reported, not held)"))
        _check(same, f"pose graph P = {P}: two runs differ")
        _check(c1 < c0 and math.isfinite(c1), f"pose graph P = {P}: cost did not fall")
        _check(e1 < e0 or not held, f"pose graph P = {P}: the error did not fall")
        entry = dict(poses=P, edges=g.num_edges, solver=solver, held=held, iterations=it,
                     initial_cost=c0, final_cost=c1, err_before=e0, err_after=e1,
                     ms_per_iteration=ms / it, host_syncs=syncs, peak_bytes=peak,
                     runs_equal=same)
        if P == 100:
            cpu, cst = optimize_pose_graph(g0.to("cpu"))
            dR = float((cpu.poses.R - g1.poses.R.cpu()).abs().max())
            dt = float((cpu.poses.t - g1.poses.t.cpu()).abs().max())
            c_cpu = float(pose_graph_cost(cpu))
            print(f"pose graph P = {P}: GPU vs CPU max |dR| {dR:.3g}, |dt| {dt:.3g} (tol "
                  f"1e-04); iterations {it} vs {int(cst.iterations)}; cost {c1:.6g} vs {c_cpu:.6g}")
            _check(max(dR, dt) <= 1e-4, "pose graph: GPU and CPU poses differ")
            entry.update(gpu_vs_cpu_dR=dR, gpu_vs_cpu_dt=dt)
        out[f"P{P}" if P == 100 else f"P{P}_pcg{pcg}"] = entry
    return dict(out, launches=launches)


# BASELINE config 1 (bench.py ``bench_all_pairs``): 1,024 images × 256
# keypoints × 64-d, ratio 0.8; frame 7 planted as frame 900 plus noise
ALL_PAIRS = dict(n=1024, k=256, d=64, ratio=0.8, twin=900)


def _all_pairs_inputs(dev):
    """Config 1's descriptors (``RandomState(3)``, L2-normalised, frame 7 a
    noisy copy of frame ``twin``) and masks (every row valid) on ``dev``;
    the same bits in every process."""
    import torch

    n, k, d, twin = (ALL_PAIRS[x] for x in ("n", "k", "d", "twin"))
    rng = np.random.RandomState(3)
    base = rng.randn(n, k, d).astype(np.float32)
    base[7] = base[twin] + 0.01 * rng.randn(k, d).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    return (torch.from_numpy(base).to(dev),
            torch.ones(n, k, dtype=torch.bool, device=dev))


def _planted_pair(scores) -> tuple:
    """(best partner of frame 7, of frame ``twin``, their scores, the median
    off-diagonal score) from [N, N] scores."""
    twin = ALL_PAIRS["twin"]
    off = scores.clone()
    off.fill_diagonal_(-1)
    best7, best_twin = int(off[7].argmax()), int(off[twin].argmax())
    return (best7, best_twin, int(off[7, best7]),
            float(off[off >= 0].float().median()))


def _all_pairs(dev, K_mod) -> dict:
    """BASELINE config 1's all-pairs sweep at its published width
    (bench.py ``bench_all_pairs``): 1,024 images × 256 keypoints × 64-d, every
    row valid, descriptors from ``RandomState(3)``, L2-normalised; ratio 0.8;
    frame 7 planted as frame 900 plus noise 0.01.  The full N² sweep through
    ``all_pairs_scores`` on the card (the ring with ``mesh=None``, one step;
    kernel K1); a block of 8 query frames ×
    all 1,024 against the plain version; the planted pair must be each
    other's best partner."""
    import torch

    from points_matching_tpu_torch.parallel.all_pairs import (
        all_pairs_scores, pair_scores_plain)
    from points_matching_tpu_torch.utils.profiling import chip_peaks

    n, k, d, ratio, twin = (ALL_PAIRS[x] for x in ("n", "k", "d", "ratio", "twin"))
    desc, mask = _all_pairs_inputs(dev)
    all_pairs_scores(desc[:16], mask[:16], ratio)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    K_mod.reset_launch_counts()
    t0 = time.perf_counter()
    scores = all_pairs_scores(desc, mask, ratio)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = K_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    bound_s = 2 * n * n * k * k * d / chip_peaks("cuda")["flops"]   # one FMA a cell
    print(f"all pairs: {n} x {k} x {d} ({n * n} ordered pairs): {sec:.4f} s a sweep, "
          f"{n * n / sec:.4g} pairs/s (host clock, one synchronize); FMA bound {bound_s:.4f} s "
          f"= {n * n / bound_s:.4g} pairs/s; K1 launches {launches['fused_l2_top2']}; peak "
          f"device memory {peak / 2**20:.1f} MiB ({(peak - base_bytes) / 2**20:.1f} MiB above "
          f"the inputs)")
    _check(launches["fused_l2_top2"] > 0, "all pairs: K1 never launched")
    ref = pair_scores_plain(desc[:8], mask[:8], desc, mask, ratio)
    torch.cuda.synchronize()
    n_diff = int((scores[:8] != ref).sum())
    bad = _near_tie_cells(scores[:8], ref, desc[:8], mask[:8], desc, mask, ratio)
    print(f"all pairs: block of 8 x {n} against the plain version: {n_diff} cells differ, "
          f"{bad} not explained by f32 near-ties of the ratio test")
    _check(bad == 0, "all pairs: K1 counts disagree with the plain version")
    best7, best_twin, score7, median = _planted_pair(scores)
    print(f"all pairs: planted pair 7 <-> {twin}: best partner of 7 is {best7} (score "
          f"{score7}), of {twin} is {best_twin}; median off-diagonal score {median:.1f}")
    _check(best7 == twin and best_twin == 7, "all pairs: the planted pair was not found")
    return dict(shape=[n, k, d], seconds=sec, pairs_per_s=n * n / sec, bound_s=bound_s,
                bound_by="operations", launches=launches["fused_l2_top2"], peak_bytes=peak,
                block_cells_differing=n_diff)


def _loop_closure(dev, K_mod, res, frames, K, cfg, gt, extent) -> dict:
    """``close_loops`` on the 100-frame out-and-back run (the reference's
    tests/test_sequence_100.py bounds: ≥ 1 candidate, ≥ 1 verified, ATE of
    the corrected trajectory < 10 % of the extent); then the same call on
    the CPU from the same inputs, with the same RANSAC samples (drawn on the
    card from the card's matches) injected into both."""
    import torch

    from points_matching_tpu_torch.core.types import Descriptors, Pose
    from points_matching_tpu_torch.geometry.ransac import sample_index_sets
    from points_matching_tpu_torch.ops.matching import match_descriptors
    from points_matching_tpu_torch.pipelines.loop_closure import close_loops
    from points_matching_tpu_torch.pipelines.sfm import camera_centers
    from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error

    n = len(frames)
    st = res.state
    num_cams = int(st.num_cams)

    def run(poses, fr, k_, samples=None):
        return close_loops(poses, num_cams, fr, k_, cfg, seed=0, f_samples=samples)

    run(st.poses, frames, K)                                     # warm-up
    torch.cuda.synchronize()
    K_mod.reset_launch_counts()
    t0 = time.perf_counter()
    corrected, cands = run(st.poses, frames, K)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = K_mod.launch_counts()
    _, syncs = _count_syncs(lambda: run(st.poses, frames, K))
    mask = st.cam_mask[:n].cpu()
    traj = camera_centers(corrected, st.cam_mask)[:n].cpu()
    ate_before = float(absolute_trajectory_error(res.trajectory[:n].cpu(), gt[:n], mask).rmse)
    ate = float(absolute_trajectory_error(traj, gt[:n], mask).rmse)
    n_ver = sum(c.verified for c in cands)
    print(f"slice sfm: loop candidates {len(cands)}, verified {n_ver}: "
          + ", ".join(f"({c.i}, {c.j}, score {c.score}, verified {c.verified}, inliers "
                      f"{c.num_inliers})" for c in cands))
    print(f"slice sfm: close_loops {ms:.3f} ms (one synchronize at the end), host syncs "
          f"{syncs}; ATE {ate_before:.4f} -> {ate:.4f} after closure (bound {0.1 * extent:.4f}); "
          f"launches on the loop path {launches}")
    _check(len(cands) >= 1 and n_ver >= 1, "loop closure: no verified candidate")
    _check(ate < 0.1 * extent, f"loop closure: ATE {ate} over the bound")
    for name in ("fused_l2_top2", "minimal_eight_point", "ransac_score_hypotheses"):
        _check(launches[name] > 0, f"loop closure: {name} never launched")

    # GPU against CPU with the same samples
    H = cfg.two_view.ransac.num_hypotheses
    gen = torch.Generator(device=dev).manual_seed(1)
    samples = []
    for c in cands:
        (xi, di, mi), (xj, dj, mj) = frames[c.i], frames[c.j]
        m = match_descriptors(Descriptors(data=dj, mask=mj), Descriptors(data=di, mask=mi),
                              cfg.two_view.matcher)
        idx = sample_index_sets(gen, m.mask, H, 8).long()
        nk = xj.shape[0]
        pj = xj[m.query_idx.long().clamp(0, nk - 1)]
        pi = xi[m.train_idx.long().clamp(0, nk - 1)]
        samples.append((pj[idx], pi[idx]))
    gpu, gc = run(st.poses, frames, K, samples)
    cpu, cc = run(Pose(R=st.poses.R.cpu(), t=st.poses.t.cpu()),
                  [tuple(x.cpu() for x in f) for f in frames], K.to("cpu"),
                  [tuple(x.cpu() for x in s_) for s_ in samples])
    key = lambda cs: [(c.i, c.j, c.score, c.verified, c.num_inliers) for c in cs]  # noqa: E731
    dR = float((gpu.R.cpu() - cpu.R).abs().max())
    dt = float((gpu.t.cpu() - cpu.t).abs().max())
    print(f"slice sfm: close_loops GPU vs CPU (same samples): candidates (i, j, score, "
          f"verified, inliers) {key(gc)} vs {key(cc)}; corrected poses max |dR| {dR:.3g}, "
          f"|dt| {dt:.3g} (tol 1e-03)")
    _check(key(gc) == key(cc), "loop closure: GPU and CPU candidates differ")
    _check(max(dR, dt) <= 1e-3, "loop closure: GPU and CPU corrected poses differ")
    return dict(candidates=key(cands), close_loops_ms=ms, host_syncs=syncs,
                ate_before=ate_before, ate_after=ate, launches=launches,
                gpu_vs_cpu_dR=dR, gpu_vs_cpu_dt=dt)


def _staged_inputs(dev):
    """The staged phases' 4 rendered 993×660 pairs (frames i, i + 1 of a
    5-frame sequence) and their seeds: (img1, img2, seeds) on ``dev``."""
    import torch

    from points_matching_tpu_torch.data.render import render_sequence

    imgs, *_ = render_sequence(num_frames=5, num_landmarks=500, image_size=(993, 660), seed=0)
    im = torch.stack([torch.from_numpy(np.ascontiguousarray(i)) for i in imgs]).to(dev)
    return im[:4].contiguous(), im[1:].contiguous(), torch.arange(4)


def _staged_samples(w, cfg, dev):
    """RANSAC minimal sets for each pair of a staged wire ``w``, drawn from
    one seeded generator: (sp1, sp2), each [4, H, 8, 2]."""
    import torch

    from points_matching_tpu_torch.geometry.ransac import sample_minimal_points

    H = cfg.ransac.num_hypotheses
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = [sample_minimal_points(gen, w["mmask"][i] != 0, H, 8, (w["p1"][i], w["p2"][i]))
          for i in range(w["mmask"].shape[0])]
    return torch.stack([x[0] for x in sp]), torch.stack([x[1] for x in sp])


STAGED_CONFIGS = (("surf", "ransac", ("fused_l2_top2", "minimal_eight_point",
                                      "ransac_score_hypotheses")),
                  ("orb", "orb", ("fused_hamming_top2", "minimal_eight_point",
                                  "ransac_score_hypotheses")))


def _staged(dev, K_mod) -> dict:
    """``staged_two_view`` at world size 1 (its four stages composed on the
    card) on 4 rendered 993×660 pairs (frames i, i + 1 of a 5-frame
    sequence), SURF (the demo's ``--config ransac``) and then ORB
    (``orb_default_config()``): its launches (``launches_by_path.staged``)
    and ms a microbatch of 4; then the same pairs with the same injected
    RANSAC samples through the staged path and through
    ``two_view_pipeline`` pair by pair: equal keypoints, matches and
    inliers, F within 1e-5."""
    import torch

    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.pipelines.staged_two_view import staged_two_view
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    img1, img2, seeds = _staged_inputs(dev)
    out, launches = {}, {}
    for tag, cfg_name, kernels in STAGED_CONFIGS:
        cfg = named_config(cfg_name)
        staged_two_view(img1, img2, seeds, cfg)                          # warm-up
        torch.cuda.synchronize()
        K_mod.reset_launch_counts()
        t0 = time.perf_counter()
        w = staged_two_view(img1, img2, seeds, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[tag] = K_mod.launch_counts()
        _check(all(launches[tag][k] > 0 for k in kernels),
               f"staged {tag}: a kernel of the path never launched")
        sp1, sp2 = _staged_samples(w, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ws = staged_two_view(img1, img2, seeds, cfg, samples=(sp1, sp2))
        torch.cuda.synchronize()
        ms_samples = (time.perf_counter() - t0) * 1e3
        rows, dF = [], 0.0
        for i in range(4):
            res = two_view_pipeline(img1[i], img2[i], None, cfg, samples=(sp1[i], sp2[i]))
            same = (torch.equal(ws["xy1"][i], res.kps1.xy)
                    and torch.equal(ws["xy2"][i], res.kps2.xy)
                    and torch.equal(ws["kmask1"][i] != 0, res.kps1.mask)
                    and torch.equal(ws["kmask2"][i] != 0, res.kps2.mask)
                    and torch.equal(ws["mmask"][i] != 0, res.matches.mask)
                    and torch.equal(ws["p1"][i], res.p1) and torch.equal(ws["p2"][i], res.p2)
                    and int(ws["num_inliers"][i]) == int(res.estimate.num_inliers))
            dF = max(dF, float((ws["F"][i] - res.estimate.F).abs().max()))
            rows.append((int(res.kps1.mask.sum()), int(res.matches.mask.sum()),
                         int(res.estimate.num_inliers)))
            _check(same, f"staged {tag}: pair {i} differs from two_view_pipeline")
            _check(2 * rows[-1][2] >= rows[-1][1] and rows[-1][1] >= 8,
                   f"staged {tag}: pair {i} has too few inliers")
        print(f"staged {tag}: 4 pairs 993x660 through 4 stages (world size 1) {ms:.3f} ms "
              f"(host clock, synchronized; {ms / 4:.3f} ms a pair); launches {launches[tag]}; "
              f"with the same samples == two_view_pipeline per pair (kp1, matches, inliers) "
              f"{rows}, max |dF| {dF:.3g} (tol 1e-05)")
        _check(dF <= 1e-5, f"staged {tag}: F differs from two_view_pipeline")
        out[tag] = dict(ms_per_batch=ms, ms_per_batch_samples=ms_samples, pairs=4,
                        per_pair=rows, max_dF=dF)
        # the ``ranks`` phase's reference: this run with the injected samples
        out.setdefault("ws1", {})[tag] = dict(samples=(sp1, sp2), wire=ws, ms=ms_samples)
    out["launches"] = {k: launches["surf"][k] + launches["orb"][k] for k in launches["surf"]}
    return out


# The bench head's step (bench.py:363 bench_tpu, BASELINE's headline cell):
# 64 pairs × 512 keypoints × 64-d SURF-class descriptors, 30 % outliers,
# ratio 0.85, query-order matches, 512 hypotheses and 2 refits
PAIRS_B, PAIRS_N, PAIRS_D, PAIRS_H = 64, 512, 64, 512
PAIRS_STEPS, PAIRS_LOOPS = 20, 3


def _pairs(dev, K_mod) -> dict:
    """The bench head's step over the pair axis: ``match_descriptors_points``
    on [64, 512, 64] → ``ransac_fundamental`` on [64, 512, 2], for bf16 and
    f32 matching (the bench's workload: train rows are permuted noisy copies
    of the query rows, the points ``_scenes``' with 30 % outliers).  Launches
    of one batched step (each kernel once: K1b, K3, K2) and of the loop of
    64 one-pair calls (64 each); with the same injected samples the batched
    step equals the loop (matches and points exactly, inlier counts and
    masks equal, |ΔF| ≤ 1e-5); gates on every pair (inliers ≥ half the
    matches, F finite, unit-norm, rank 2); the aten ops a step dispatches
    at 64 pairs and at one; the median ms of a step over
    ``PAIRS_STEPS`` steps and of the loop over ``PAIRS_LOOPS`` (CUDA events
    around each, one ``synchronize`` at the end, own draws), pairs/s of both
    beside the host's eager launch time."""
    import torch

    from points_matching_tpu_torch.core.config import MatcherConfig, RansacConfig
    from points_matching_tpu_torch.core.types import Descriptors
    from points_matching_tpu_torch.geometry.ransac import ransac_fundamental, sample_minimal_points
    from points_matching_tpu_torch.ops.matching import match_descriptors_points

    B, N, D, H = PAIRS_B, PAIRS_N, PAIRS_D, PAIRS_H
    gen = torch.Generator(device=dev).manual_seed(9)
    p1, p2_query, _ = _scenes(B, N, gen, dev)
    q = torch.randn(B, N, D, generator=gen, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    # train row j holds query perm[j]'s descriptor (noisy) and point
    perm = torch.rand(B, N, generator=gen, device=dev).argsort(-1)
    t = q.gather(1, perm[..., None].expand(B, N, D))
    t = t + 0.1 * torch.randn(B, N, D, generator=gen, device=dev)
    t = (t / t.norm(dim=-1, keepdim=True)).contiguous()
    p2 = p2_query.gather(1, perm[..., None].expand(B, N, 2)).contiguous()
    ones = torch.ones(B, N, dtype=torch.bool, device=dev)
    rcfg = RansacConfig(num_hypotheses=H)
    kernels = ("fused_l2_top2_points", "minimal_eight_point", "ransac_score_hypotheses")

    def step(mcfg, i, generator, samples=None):
        """Pairs ``i`` (a slice: the batch; an int: one pair) through the head."""
        m, q2 = match_descriptors_points(Descriptors(q[i], ones[i]), Descriptors(t[i], ones[i]),
                                         p2[i], mcfg)
        return m, q2, ransac_fundamental(generator, p1[i], q2, m.mask, rcfg, samples=samples)

    def loop(mcfg, generator, samples=None):
        return [step(mcfg, i, generator, None if samples is None else
                     (samples[0][i], samples[1][i])) for i in range(B)]

    def event_ms(fn, reps):
        """Median ms of ``fn`` over ``reps`` calls: CUDA events around each,
        one synchronize at the end."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        ev[0].record()
        for k in range(reps):
            fn()
            ev[k + 1].record()
        torch.cuda.synchronize()
        return float(np.median([ev[k].elapsed_time(ev[k + 1]) for k in range(reps)]))

    out, launches = {}, {}
    for dtype in ("bf16", "f32"):
        mcfg = MatcherConfig(metric="l2", filter="ratio", ratio=0.85, compute_dtype=dtype,
                             compact=False)
        draws = torch.Generator(device=dev).manual_seed(0)
        step(mcfg, slice(None), draws)                                   # warm-up
        loop(mcfg, draws)
        torch.cuda.synchronize()
        K_mod.reset_launch_counts()
        m, q2, _ = step(mcfg, slice(None), draws)
        torch.cuda.synchronize()
        launches[dtype] = K_mod.launch_counts()
        K_mod.reset_launch_counts()
        loop(mcfg, draws)
        torch.cuda.synchronize()
        loop_launches = K_mod.launch_counts()
        print(f"pairs {dtype}: launches of one batched step {launches[dtype]}; "
              f"of the {B}-call loop {loop_launches}")
        _check(all(launches[dtype][k] == 1 for k in kernels)
               and sum(launches[dtype].values()) == 3,
               f"pairs {dtype}: the batched step did not launch K1b, K3, K2 once each")
        _check(all(loop_launches[k] == B for k in kernels),
               f"pairs {dtype}: the loop did not launch each kernel {B} times")

        # the same injected samples through both: the batch equals the loop
        samples = sample_minimal_points(torch.Generator(device=dev).manual_seed(1), m.mask,
                                        H, 8, (p1, q2))
        mb, q2b, eb = step(mcfg, slice(None), None, samples)
        per = loop(mcfg, None, samples)
        same_m = all(torch.equal(mb.mask[i], per[i][0].mask)
                     and torch.equal(mb.train_idx[i], per[i][0].train_idx)
                     and torch.equal(q2b[i], per[i][1]) for i in range(B))
        same_inl = all(torch.equal(eb.inlier_mask[i], per[i][2].inlier_mask)
                       and int(eb.num_inliers[i]) == int(per[i][2].num_inliers)
                       for i in range(B))
        dF = max(float((eb.F[i] - per[i][2].F).abs().max()) for i in range(B))
        n_m = mb.mask.sum(-1).cpu()
        n_in = eb.num_inliers.cpu()
        F = eb.F.double().cpu()
        sv = torch.linalg.svdvals(F)
        norm_err = float((F.flatten(1).norm(dim=-1) - 1.0).abs().max())
        rank = float((sv[:, 2] / sv[:, 0]).max())
        print(f"pairs {dtype}: batch == {B} one-pair calls with the same samples: matches "
              f"{same_m}, inlier masks and counts {same_inl}, max |dF| {dF:.3g} (tol 1e-05); "
              f"matches {int(n_m.min())}-{int(n_m.max())}, inliers {int(n_in.min())}-"
              f"{int(n_in.max())} (min inliers/matches {float((n_in / n_m).min()):.4f}), "
              f"max ||F|-1| {norm_err:.3g}, max s3/s1 {rank:.3g}")
        _check(same_m and same_inl and dF <= 1e-5,
               f"pairs {dtype}: the batched step differs from the one-pair calls")
        _check(bool(torch.isfinite(F).all()) and norm_err < 1e-4 and rank < 1e-4,
               f"pairs {dtype}: an F is not finite, unit-norm and rank 2")
        _check(bool((2 * n_in >= n_m).all()) and int(n_m.min()) >= 8,
               f"pairs {dtype}: a pair has inliers below half its matches")

        ops = {n: _count_ops(lambda: step(mcfg, i, draws)) for n, i in ((B, slice(None)),
                                                                        (1, 0))}
        print(f"pairs {dtype}: aten ops dispatched by a step of {B} pairs {ops[B]}, "
              f"of one pair {ops[1]}")
        ms = event_ms(lambda: step(mcfg, slice(None), draws), PAIRS_STEPS)
        loop_ms = event_ms(lambda: loop(mcfg, draws), PAIRS_LOOPS)
        disp = _dispatch_us(dev)
        print(f"pairs {dtype}: {B} x {N} kp x {D}-d, {H} hyp: batched step {ms:.3f} ms "
              f"(median of {PAIRS_STEPS}; {B / ms * 1e3:.1f} pairs/s), loop of {B} one-pair "
              f"calls {loop_ms:.3f} ms (median of {PAIRS_LOOPS}; {B / loop_ms * 1e3:.1f} pairs/s), "
              f"{loop_ms / ms:.2f}x; host eager launch {disp:.2f} us")
        out[dtype] = dict(ms_per_step=ms, pairs_per_s=B / ms * 1e3, loop_ms=loop_ms,
                          loop_pairs_per_s=B / loop_ms * 1e3, dispatch_us=disp,
                          loop_launches={k: loop_launches[k] for k in kernels},
                          aten_ops_step=ops[B], aten_ops_one_pair=ops[1],
                          min_inlier_share=float((n_in / n_m).min()), max_dF=dF)
    out["shape"] = [B, N, D, H]
    out["launches"] = {k: launches["bf16"][k] + launches["f32"][k] for k in launches["bf16"]}
    return out


# BASELINE config 4's stand-in: tests/test_distributed_slam.py's
# test_distributed_slam_config4_scale (272 frames, 16 segments of 20 with an
# overlap of 4, 3,000 landmarks, 256 features of 32-d, seed 5)
CONFIG4 = dict(num_frames=272, num_landmarks=3000, n_feat=256, seed=5, corridor=True)
SEG4, OVERLAP4 = 20, 4
# BASELINE config 4 at KITTI 00's length (4,541 frames: 283 segments of 20,
# 4,532 frames used), at the stand-in's landmark density (3,000 landmarks
# over 0.3 · 272 + 12 units of corridor), in one batch at world size 1.  The
# camera stays on the corridor's axis (``on_axis``): the stand-in's path
# leaves the landmarks' depth band after ~500 frames (from frame 522 on,
# 1,688 of the 4,541 frames saw fewer than 100 landmarks, most none)
CONFIG4_FULL = dict(num_frames=4541, num_landmarks=44000, n_feat=256, seed=5, corridor=True,
                    on_axis=True)
# the segment batches whose kernel shapes k1sfm times: the stand-in's 16
# segments and the full length's 283
SEG4_BATCHES = (16, 283)
# the batch against the loop of one-segment builds on the stand-in's first
# segments: each segment's camera centres, RMS, the largest over the
# segments
BATCH_VS_LOOP_SEGMENTS = 4
# The batch against the loop: the BAs' sums go through the segmented-sum
# kernel (a fixed order, no atomics), so two loops give the same bits
# (loop-loop 0 on an NVIDIA H100, 700 W, chip_smoke.py); the batch
# still differs from a loop in the last bits of its batched reductions
# (batched matrix products and sums block otherwise), which the windowed
# BAs' accept/reject decisions carry to the cameras: batch-loop 0.0155 RMS
# (0.0285 under float atomics).  The batch may differ from a loop
# by this much more than the two loops differ from each other.
BATCH_VS_LOOP_TOL = 0.041
# Config 4 at world sizes 1 and 2 against each other.  Two runs of one world
# size give the same bits (the ``_same_run`` check).  World size 2 shards the
# global BA's observations and completes each sum over the ranks, another
# order than one process, so the two differ from the first bits on and the
# Sim(3) chain carries that along the corridor: RMS aligned gap 0.0494 and
# ATEs 0.8129 / 0.8142 on an NVIDIA H100, 700 W (chip_smoke.py); under
# float atomics (examples/probe_config4_torch.py) any two runs were up
# to 0.460 apart and 11 ATEs spread over 0.8214-0.8542.  The bounds stay at
# about twice those older readings: the RMS gap (the ATE's own measure) as a
# fraction of the extent, and the ATEs' difference.
RUN_GAP_TOL = 0.012
ATE_GAP_TOL = 0.08


def _dslam_config(segment_len: int, max_landmarks: int = 1024, max_observations: int = 4096):
    """tests/test_distributed_slam.py's ``_small_config``."""
    from points_matching_tpu_torch.core.config import (
        BAConfig, MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)

    return SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=128, inlier_threshold=2.0)),
        ba=BAConfig(max_iterations=6), max_cameras=segment_len, max_landmarks=max_landmarks,
        max_observations=max_observations, local_ba_window=segment_len)


def _config4_run(dev, mesh, seq=CONFIG4, data=None):
    """Config 4 through ``run_distributed_slam`` on ``dev`` on the sequence
    ``seq`` (the stand-in by default), or on ``data`` (that sequence already
    made): (result, ground-truth centres, seconds on the host clock)."""
    import torch

    from points_matching_tpu_torch.data.synthetic import make_stacked_sequence
    from points_matching_tpu_torch.pipelines.distributed_slam import run_distributed_slam

    kps, desc, mask, K, gt = data or make_stacked_sequence(device=dev, **seq)
    cfg = _dslam_config(SEG4, 2048, 8192)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_distributed_slam(kps, desc, mask, K, cfg, mesh=mesh, segment_len=SEG4,
                               overlap=OVERLAP4, seed=0)
    torch.cuda.synchronize()
    return res, gt, time.perf_counter() - t0


def _segment_launches(tag: str, launches: dict, segment_len: int) -> None:
    """A segment batch's launches: K1 once for the bootstrap's match and
    three times a frame step, K3 and K2 once (the bootstrap), whatever the
    number of segments."""
    want = dict(fused_l2_top2=1 + 3 * (segment_len - 2), minimal_eight_point=1,
                ransac_score_hypotheses=1)
    got = {k: launches[k] for k in want}
    print(f"{tag}: launches {got} (expected {want})")
    _check(got == want, f"{tag}: launches {got}, expected {want}")


def _aligned_gap(a, b, rms: bool = False) -> float:
    """Largest distance between two trajectories after a Sim(3) alignment
    (their root mean square with ``rms``, as the ATE is)."""
    import torch

    from points_matching_tpu_torch.utils.evaluation import umeyama_alignment

    a, b = (torch.as_tensor(np.asarray(x), dtype=torch.float64) for x in (a, b))
    s, R, t = umeyama_alignment(a, b)
    d = (s * a @ R.T + t - b).norm(dim=-1)
    return float(d.square().mean().sqrt() if rms else d.max())


def _same_run(tag: str, a, b) -> dict:
    """Two runs of config 4 with the same inputs: the RMS aligned gap of
    their trajectories, and whether they are equal in every bit (the
    trajectory, the valid cameras, the registrations and the global BA's
    final cost); fails unless they are."""
    same = (np.array_equal(a.trajectory, b.trajectory)
            and np.array_equal(a.cam_valid, b.cam_valid)
            and np.array_equal(a.registered_per_segment, b.registered_per_segment)
            and float(a.ba_stats.final_cost) == float(b.ba_stats.final_cost))
    gap = _aligned_gap(a.trajectory, b.trajectory, rms=True)
    print(f"{tag} run twice: aligned trajectory gap RMS {gap:.6g}, equal in every bit {same}")
    _check(same, f"{tag}: two runs of the same inputs differ")
    return dict(gap_rms=gap, equal=same)


def _config4_gates(tag: str, traj, cam_valid, regs, initial_cost, final_cost, gt,
                   segments: int = 16, gate_ate: bool = True) -> dict:
    """The reference test's gates: ``segments`` segments, every frame
    registered, ≥ 256 frames, > 95 % of cameras valid, ATE < 10 % of the
    extent (printed only without ``gate_ate``), BA cost not above its
    start."""
    import torch

    from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error

    traj, valid, regs = np.asarray(traj), np.asarray(cam_valid), np.asarray(regs)
    n = len(traj)
    gt_used = gt[:n]
    extent = float(np.linalg.norm(gt_used.max(0) - gt_used.min(0)))
    ate = float(absolute_trajectory_error(torch.from_numpy(traj).float(),
                                          torch.from_numpy(gt_used).float(),
                                          torch.from_numpy(valid)).rmse)
    print(f"distributed {tag}: segments {regs.shape[0]}, frames registered "
          f"{int(regs.sum())}/{regs.size}, cameras {n} ({valid.mean():.4f} valid), ATE "
          f"{ate:.4f} ({ate / extent:.4%} of the extent {extent:.2f}; "
          f"{'bound' if gate_ate else 'not gated, against'} 10 %), global BA "
          f"cost {initial_cost:.6g} -> {final_cost:.6g}")
    _check(regs.shape[0] == segments and regs.all(),
           f"distributed {tag}: a frame did not register")
    _check(n >= 256 and valid.mean() > 0.95, f"distributed {tag}: too few valid cameras")
    _check(not gate_ate or ate < 0.10 * extent,
           f"distributed {tag}: ATE {ate} over 10 % of {extent}")
    _check(final_cost <= initial_cost, f"distributed {tag}: the global BA raised the cost")
    return dict(frames=n, valid_share=float(valid.mean()), ate=ate, extent=extent,
                initial_cost=initial_cost, final_cost=final_cost)


def _config4_rank(dev, K_mod, rank: int, world: int, inputs) -> dict:
    """Rank job ``config4``: config 4's stand-in on a ``world`` × 1 data ×
    model mesh."""
    from points_matching_tpu_torch.parallel.mesh import make_mesh

    res, _, sec = _config4_run(dev, make_mesh((world, 1), ("data", "model")))
    st = res.ba_stats
    return dict(seconds=sec, trajectory=res.trajectory.tolist(),
                cam_valid=res.cam_valid.tolist(), regs=res.registered_per_segment.tolist(),
                initial_cost=float(st.initial_cost), final_cost=float(st.final_cost),
                iterations=int(st.iterations), stage_seconds=res.stage_seconds)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


RANK_DEADLINE_S = 600


def _rank_worker(jobs: str, rank: int, world: int, port: int, out_dir: str) -> int:
    """One rank of a gloo group of ``world`` processes on this card (NCCL
    takes one rank a GPU), running the comma-separated ``jobs`` of
    ``RANK_JOBS`` in order; writes ``{job: result}`` to
    ``out_dir/rank<rank>.pt``.  The kernel library is already built (the
    parent builds it before it starts the ranks): this only loads it."""
    import torch
    import torch.distributed as dist

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.ops import kernels as K_mod
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed

    dev = resolve_device("cuda")
    pin_fp32()
    _check(os.path.exists(_build.library_path()), "rank worker: the kernel library is not built")
    path = os.path.join(out_dir, "inputs.pt")
    inputs = torch.load(path) if os.path.exists(path) else None
    initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank, timeout=60)
    out = {job: RANK_JOBS[job](dev, K_mod, rank, world, inputs) for job in jobs.split(",")}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _spawn_ranks(jobs: str, world: int, inputs=None) -> tuple:
    """``world`` rank workers (``python3 chip_smoke.py --rank-worker JOBS
    RANK WORLD PORT DIR``) on this card, one gloo group; ``inputs`` (CPU
    tensors) reach them through ``DIR/inputs.pt``.  Joined with a deadline
    (``RANK_DEADLINE_S``); when one exits non-zero or the deadline passes,
    the rest are killed and the run fails.  Returns (each rank's results in
    rank order, seconds with the processes' start)."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        if inputs is not None:
            torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker",
                                   jobs, str(r), str(world), str(port), tmp])
                 for r in range(world)]
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.perf_counter() - t0 > RANK_DEADLINE_S):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        rcs = [p.returncode for p in procs]
        _check(rcs == [0] * world, f"ranks {jobs} at world size {world}: workers exited {rcs}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)], wall


def _config4_ws2() -> tuple:
    """Config 4 at world size 2: two rank workers on this card; (rank 0's
    result, seconds with the processes' start)."""
    results, wall = _spawn_ranks("config4", 2)
    return results[0]["config4"], wall


def _distributed(dev, K_mod) -> dict:
    """BASELINE config 4 on its stand-in (``CONFIG4``: 272 of KITTI 00's
    4,541 frames) through ``run_distributed_slam``: at world size 1 over
    NCCL (a 1 × 1 data × model mesh; its launches are the phase's main
    path's), then at world size 2 as two processes on this card over gloo
    (rank job ``config4``), each held to the reference test's gates; world size
    2 must register the same frames as 1, give the same trajectory within
    ``RUN_GAP_TOL`` of the extent (RMS after alignment) and an ATE within
    ``ATE_GAP_TOL``.  Then GPU against CPU on tests/test_distributed_slam.py's
    16-frame sequence (2 segments of 10): the same frames registered and
    aligned trajectories within 1 % of the extent.  Then the batch against
    the loop (``_batch_vs_loop``) and the full length (``_config4_full``)."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.data.synthetic import make_stacked_sequence
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from points_matching_tpu_torch.pipelines.distributed_slam import run_distributed_slam

    out = {}
    initialize_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                           rank=0, timeout=60, force=True)
    _check(dist.get_backend() == "nccl", "world size 1 is not on NCCL")
    mesh = make_mesh((1, 1), ("data", "model"))
    K_mod.reset_launch_counts()
    res1, gt, sec1 = _config4_run(dev, mesh)
    launches = K_mod.launch_counts()
    again, _, _ = _config4_run(dev, mesh)
    dist.destroy_process_group()
    st = res1.ba_stats
    g1 = _config4_gates("ws1 (NCCL)", res1.trajectory, res1.cam_valid,
                        res1.registered_per_segment, float(st.initial_cost),
                        float(st.final_cost), gt)
    its1 = int(st.iterations)
    stage = res1.stage_seconds
    print(f"distributed ws1: {sec1:.3f} s, {CONFIG4['num_frames'] / sec1:.3f} frames/s (host "
          f"clock, synchronized); submaps {stage['submaps']:.3f} s, merge {stage['merge']:.3f} "
          f"s, global BA {stage['global_ba']:.3f} s in {its1} LM iterations "
          f"({stage['global_ba'] / its1 * 1e3:.3f} ms an iteration); launches {launches}")
    _segment_launches("distributed ws1 (16 segments, one batch)", launches, SEG4)
    rerun = _same_run("distributed ws1", res1, again)
    out.update(ws1=dict(g1, seconds=sec1, frames_per_s=CONFIG4["num_frames"] / sec1,
                        lm_iterations=its1, stage_seconds=stage,
                        ba_ms_per_iteration=stage["global_ba"] / its1 * 1e3, rerun=rerun),
               launches=launches)

    # world size 2: two processes on this card, one gloo group
    ws2, wall2 = _config4_ws2()
    g2 = _config4_gates("ws2 (2 processes, gloo)", ws2["trajectory"], ws2["cam_valid"],
                        ws2["regs"], ws2["initial_cost"], ws2["final_cost"], gt)
    gap12 = _aligned_gap(ws2["trajectory"], res1.trajectory, rms=True)
    gap12_max = _aligned_gap(ws2["trajectory"], res1.trajectory)
    tol = RUN_GAP_TOL * g1["extent"]
    print(f"distributed ws2: {ws2['seconds']:.3f} s in the run, "
          f"{CONFIG4['num_frames'] / ws2['seconds']:.3f} "
          f"frames/s ({wall2:.3f} s with the processes' start); submaps "
          f"{ws2['stage_seconds']['submaps']:.3f} s, global BA "
          f"{ws2['stage_seconds']['global_ba']:.3f} s in {ws2['iterations']} LM iterations; "
          f"against ws1: same frames registered "
          f"{np.array_equal(np.asarray(ws2['regs']), res1.registered_per_segment)}, aligned "
          f"trajectory gap RMS {gap12:.4g} (bound {tol:.4g} = {RUN_GAP_TOL:.1%} of the extent), "
          f"largest {gap12_max:.4g}; ATE {g2['ate']:.4f} vs {g1['ate']:.4f} (bound on the "
          f"difference {ATE_GAP_TOL})")
    _check(np.array_equal(np.asarray(ws2["regs"]), res1.registered_per_segment),
           "distributed: world sizes 1 and 2 registered other frames")
    _check(gap12 < tol, "distributed: world sizes 1 and 2 trajectories differ")
    _check(abs(g2["ate"] - g1["ate"]) < ATE_GAP_TOL,
           "distributed: world sizes 1 and 2 ATEs differ")
    out["ws2"] = dict(g2, seconds=ws2["seconds"], seconds_with_start=wall2,
                      frames_per_s=CONFIG4["num_frames"] / ws2["seconds"],
                      stage_seconds=ws2["stage_seconds"], lm_iterations=ws2["iterations"],
                      gap_to_ws1_rms=gap12, gap_to_ws1_max=gap12_max)

    # GPU against CPU on the 16-frame sequence
    kps, desc, mask, K, gt16 = make_stacked_sequence(device=dev)
    cfg = _dslam_config(10)
    t0 = time.perf_counter()
    gpu = run_distributed_slam(kps, desc, mask, K, cfg, segment_len=10, overlap=4)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_distributed_slam(kps.cpu(), desc.cpu(), mask.cpu(), K.to("cpu"), cfg,
                               segment_len=10, overlap=4)
    t_cpu = time.perf_counter() - t0
    ext16 = float(np.linalg.norm(gt16.max(0) - gt16.min(0)))
    gap = _aligned_gap(gpu.trajectory, cpu.trajectory)
    print(f"distributed GPU vs CPU on 16 frames (2 segments of 10): registered "
          f"{int(gpu.registered_per_segment.sum())} vs {int(cpu.registered_per_segment.sum())} "
          f"of 20, aligned trajectory gap {gap:.4g} (bound {0.01 * ext16:.4g} = 1 % of the "
          f"extent {ext16:.2f}); {t_gpu:.3f} s on the card, {t_cpu:.3f} s on the CPU")
    _check(np.array_equal(gpu.registered_per_segment, cpu.registered_per_segment)
           and gpu.registered_per_segment.all(), "distributed: GPU and CPU registered other frames")
    _check(gap < 0.01 * ext16, "distributed: GPU and CPU trajectories differ")
    out["gpu_vs_cpu"] = dict(gap=gap, extent=ext16, seconds_gpu=t_gpu, seconds_cpu=t_cpu)
    out["batch_vs_loop"] = _batch_vs_loop(dev)
    out["full"] = _config4_full(dev, K_mod)
    return out


def _segment_centres(state, s: int):
    """Segment s's camera centres (its registered slots) of a state with a
    segment axis, or of a one-segment state with ``s`` None."""
    R, t, n = ((state.poses.R, state.poses.t, state.num_cams) if s is None else
               (state.poses.R[s], state.poses.t[s], state.num_cams[s]))
    n = int(n)
    return -(R[:n].transpose(-1, -2) @ t[:n, :, None])[..., 0].double().cpu()


def _batch_vs_loop(dev) -> dict:
    """The stand-in's first ``BATCH_VS_LOOP_SEGMENTS`` segments built as
    one batch (``build_submaps``) and twice as a loop of one-segment builds
    (``build_submap``, each segment's own generator): the same frames
    registered, and the batch's cameras no farther from a loop's than the
    two loops' from each other (0: the same bits), plus
    ``BATCH_VS_LOOP_TOL`` (a batch's reductions block otherwise)."""
    import torch

    from points_matching_tpu_torch.data.synthetic import make_stacked_sequence
    from points_matching_tpu_torch.pipelines.distributed_slam import (
        build_submap, build_submaps, segment_frames, segment_seed)

    kps, desc, mask, K, _ = make_stacked_sequence(device=dev, **CONFIG4)
    n = BATCH_VS_LOOP_SEGMENTS
    sk, sd, sm, _ = segment_frames(kps, desc, mask, SEG4, OVERLAP4)
    sk, sd, sm = sk[:n], sd[:n], sm[:n]
    cfg = _dslam_config(SEG4, 2048, 8192)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, regs = build_submaps(sk, sd, sm, K, 0, cfg)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    loops, t_loop = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs = [build_submap(sk[s], sd[s], sm[s], K,
                             torch.Generator(device=dev).manual_seed(segment_seed(0, s)), cfg)
                for s in range(n)]
        torch.cuda.synchronize()
        t_loop.append(time.perf_counter() - t0)
        loops.append(runs)

    def gap(ca, cb):
        return max(float((a - b).norm(dim=-1).square().mean().sqrt()) for a, b in zip(ca, cb))

    cb = [_segment_centres(batch, s) for s in range(n)]
    cl = [[_segment_centres(st, None) for st, _ in runs] for runs in loops]
    same_regs = all(torch.equal(rg.cpu(), regs[s].cpu()) for runs in loops
                    for s, (_, rg) in enumerate(runs))
    same_cams = all(len(a) == len(b) for c in cl for a, b in zip(c, cb))
    gap_ll = gap(cl[0], cl[1]) if same_cams else math.inf
    gap_bl = max(gap(cb, cl[0]), gap(cb, cl[1])) if same_cams else math.inf
    print(f"distributed batch vs loop ({n} segments of {SEG4}): registered "
          f"{int(regs.sum())}/{regs.numel()}, the same frames as both loops {same_regs}; "
          f"camera gap (largest segment RMS) batch-loop {gap_bl:.4g}, loop-loop {gap_ll:.4g} "
          f"(bound {gap_ll:.4g} + {BATCH_VS_LOOP_TOL}); {t_batch:.3f} s as a batch, "
          f"{t_loop[0]:.3f} / {t_loop[1]:.3f} s as loops")
    _check(same_regs and bool(regs.all()), "distributed: the batch registered other frames")
    _check(gap_bl <= gap_ll + BATCH_VS_LOOP_TOL,
           "distributed: the batch's cameras differ from the loops' beyond their own spread")
    return dict(segments=n, gap_batch_loop=gap_bl, gap_loop_loop=gap_ll,
                seconds_batch=t_batch, seconds_loops=t_loop)


def _config4_full(dev, K_mod) -> dict:
    """Config 4 at KITTI 00's length (``CONFIG4_FULL``) at world size 1
    over NCCL: 283 segments built as one batch, gated as the stand-in is
    but for the ATE (printed against 10 % of the extent: no run has chained
    283 Sim(3) alignments before), one K1 launch for the bootstrap and three
    a frame step, K3 = K2 = 1; its seconds by stage, frames/s, peak device
    memory and the global BA's ms an LM iteration.  Run twice on the same
    sequence (made once): the two must be equal in every bit."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.data.synthetic import make_stacked_sequence
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                           rank=0, timeout=60, force=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = make_stacked_sequence(device=dev, **CONFIG4_FULL)
    t_seq = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K_mod.reset_launch_counts()
    res, gt, sec = _config4_run(dev, mesh, data=data)
    launches = K_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    again, _, sec2 = _config4_run(dev, mesh, data=data)
    dist.destroy_process_group()
    del data
    st, stage = res.ba_stats, res.stage_seconds
    regs = res.registered_per_segment
    frames = regs.shape[0] * (SEG4 - OVERLAP4) + OVERLAP4
    g = _config4_gates(f"full length ({regs.shape[0]} segments, one batch)", res.trajectory,
                       res.cam_valid, regs, float(st.initial_cost), float(st.final_cost), gt,
                       segments=(CONFIG4_FULL["num_frames"] - OVERLAP4) // (SEG4 - OVERLAP4),
                       gate_ate=False)
    its = int(st.iterations)
    print(f"distributed full length: {frames} of {CONFIG4_FULL['num_frames']} frames in "
          f"{sec:.3f} s, {frames / sec:.3f} frames/s (host clock, synchronized); submaps "
          f"{stage['submaps']:.3f} s, merge {stage['merge']:.3f} s, global BA "
          f"{stage['global_ba']:.3f} s in {its} LM iterations "
          f"({stage['global_ba'] / its * 1e3:.3f} ms an iteration); peak device memory "
          f"{peak / 2**30:.3f} GiB")
    _segment_launches("distributed full length", launches, SEG4)
    print(f"distributed full length: the sequence made in {t_seq:.3f} s, once for both runs; "
          f"the second run {sec2:.3f} s")
    rerun = _same_run("distributed full length", res, again)
    torch.cuda.empty_cache()
    return dict(g, frames_used=frames, seconds=sec, frames_per_s=frames / sec, rerun=rerun,
                stage_seconds=stage, lm_iterations=its,
                ba_ms_per_iteration=stage["global_ba"] / its * 1e3,
                peak_memory_bytes=peak, launches=launches)


# The slam phase: examples/slam_demo_torch.py's path (pipelines/slam.run_slam_demo)
# on sequences written to disk.  KITTI 00's camera size (1241 × 376) for the
# JAX demo's own KITTI example (200 frames), BASELINE config 3's TUM shape
# (100 frames, 640 × 480); an out-and-back path of step 0.25 for a revisit.
# The renders are fitted to the demo's config, which is not changed.  On an
# NVIDIA H100 (700 W): a yaw of 0.01 a frame over 200 frames turns the camera
# 57° away from the landmark cloud at the far end, and 39 of the 200 frames
# did not register; at 0.005 (the 100-frame sequences' 28° at the far end)
# all 200 did with 2,500 or 3,500 landmarks, 199 with 5,000; more landmarks
# overdraw each other (7,000: 13 registered at a yaw of 0.01).
SLAM_KITTI = dict(num_frames=200, image_size=(1241, 376), num_landmarks=2500,
                  yaw_step=0.005)
SLAM_TUM = dict(num_frames=100, image_size=(640, 480), num_landmarks=1500, yaw_step=0.01)
SLAM_STEP = 0.25
SLAM_FEATURES = 512
SLAM_SEG, SLAM_OVERLAP = 16, 4
# GPU against CPU on the first 16 frames of the KITTI tree, each run with its
# own frontend and its own device's RANSAC draws: the RMS distance between the
# two trajectories, each Sim(3)-aligned to the ground truth, as a fraction of
# its extent.  The card's reading (NVIDIA H100, 700 W) was 1.45 % (0.0545 of
# 3.75; ATEs 0.42 % and 1.29 %); the bound is about twice that.
SLAM_GPU_CPU_TOL = 0.03


def _render_tree(root: str, fmt: str, num_frames: int, image_size, num_landmarks: int,
                 yaw_step: float):
    """A rendered sequence written as a KITTI or TUM tree; the renderer's K."""
    from points_matching_tpu_torch.data.render import (
        render_sequence, write_kitti_format, write_tum_format)

    imgs, pos, quats, K = render_sequence(
        num_frames=num_frames, num_landmarks=num_landmarks, image_size=image_size, seed=0,
        loop=True, step=SLAM_STEP, yaw_step=yaw_step,
        x_span=(-6.0, 6.0 + SLAM_STEP * (num_frames // 2 - 1)))
    if fmt == "kitti":
        write_kitti_format(root, imgs, pos, quats, K)
    else:
        write_tum_format(root, imgs, pos, quats)
    return K


def _slam_gates(tag: str, nums: dict, n: int) -> None:
    """tests/test_sequence_100.py's gates: ≥ 95 % of the frames registered,
    ATE < 10 % of the extent before and after loop closure, ≥ 1 loop
    verified."""
    ext = nums["extent"]
    print(f"slam {tag}: {n} frames {nums['image_size'][0]}x{nums['image_size'][1]}, decode "
          f"{nums['decode_s']:.3f} s ({nums['decoder']}), frontend "
          f"{nums['frontend_ms_per_frame']:.3f} ms a frame (features min "
          f"{nums['features_min']}, median {nums['features_median']:.0f}); SfM "
          f"{nums['sfm_s']:.3f} s, {nums['sfm_frames_per_s']:.3f} frames/s (host clock, one "
          f"synchronize at the end); registered {nums['registered']}/{n}, landmarks "
          f"{nums['landmarks']}, observations {nums['observations']}; loops "
          f"{nums['loops_verified']}/{nums['loop_candidates']} verified in "
          f"{nums['close_loops_s']:.3f} s; ATE {nums['ate_before_closure']:.4f} before closure, "
          f"{nums['ate']:.4f} after ({nums['ate_before_closure'] / ext:.3%} / "
          f"{nums['ate'] / ext:.3%} of the extent {ext:.3f}; bound 10 %); peak device memory "
          f"{nums.get('peak_bytes', 0) / 2**20:.1f} MiB")
    _check(nums["registered"] >= 0.95 * n, f"slam {tag}: registered {nums['registered']}/{n}")
    _check(nums["ate_before_closure"] < 0.1 * ext, f"slam {tag}: ATE before closure over 10 %")
    _check(nums["ate"] < 0.1 * ext, f"slam {tag}: ATE after closure over 10 %")
    _check(nums["loops_verified"] >= 1, f"slam {tag}: no loop verified")


def _slam_utilities(dev, two_view_pair, k1_args, k1_entry) -> dict:
    """The utilities on the card: ``roofline`` of K1 at 64 pairs against
    the kernel table's row (the same work count and bound; a fraction
    within 10 % of the table's, two timings of the same graph), a
    ``trace`` around one two-view pair (its stage names and the kernels'
    names among the events), and ``checked(two_view_pipeline)``: clean on
    the rendered pair with the unchecked run's F, a NaN in one pixel
    flagged, and its cost over the unchecked run."""
    import tempfile

    import torch

    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline
    from points_matching_tpu_torch.utils.profiling import roofline, trace
    from points_matching_tpu_torch.utils.sanitize import checked

    out = {}
    rep = roofline(fused_l2_top2, *k1_args, timing="graph")
    table_fraction = k1_entry["bound_ms"] / k1_entry["ms"]
    print(f"slam utilities: roofline(K1, 64 pairs): {rep}; the table: bound "
          f"{k1_entry['bound_ms']:.4f} ms, {table_fraction:.1%} of the roofline")
    _check(abs(rep.bound_s * 1e3 - k1_entry["bound_ms"]) <= 1e-12 * k1_entry["bound_ms"],
           "roofline's K1 bound differs from the kernel table's")
    _check(abs(rep.fraction_of_roofline / table_fraction - 1) < 0.1,
           "roofline's K1 fraction differs from the kernel table's")
    out["roofline_k1"] = dict(wall_ms=rep.wall_s * 1e3, bound_ms=rep.bound_s * 1e3,
                              fraction=rep.fraction_of_roofline, table_fraction=table_fraction)

    im1, im2 = two_view_pair
    cfg = named_config("ransac")

    def pair(a, b):
        return two_view_pipeline(a, b, torch.Generator(device=dev).manual_seed(0), cfg)

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            pair(im1, im2)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    stages = sorted(n for n in names if n.startswith("two_view."))
    kernels = sorted(n for n in names if any(k in n for k in (
        "l2_top2_kernel", "eight_point_kernel", "ransac_score_kernel")))
    print(f"slam utilities: trace of one two-view pair: {len(events)} events; stages "
          f"{stages}; our kernels {kernels}")
    _check(set(stages) >= {"two_view.detect", "two_view.describe", "two_view.match",
                           "two_view.ransac"}, "trace: a stage is missing")
    for k in ("l2_top2_kernel", "eight_point_kernel", "ransac_score_kernel"):
        _check(any(k in n for n in kernels), f"trace: no {k} event")
    out["trace"] = dict(events=len(events), stages=stages, kernels=kernels)

    F_ref = pair(im1, im2).estimate.F
    times = {}
    for tag, fn in (("unchecked", pair), ("checked", checked(pair))):
        fn(im1, im2)                                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(im1, im2)
        if tag == "checked":
            res, err = res
            msg = err.get()                                   # the one read of the checks
        torch.cuda.synchronize()
        times[tag] = (time.perf_counter() - t0) * 1e3
    bad = im1.clone()
    bad[300, 400] = float("nan")
    _, err_nan = checked(pair)(bad, im2)
    nan_msg = err_nan.get()
    print(f"slam utilities: checked(two_view_pipeline): {msg!r} on the rendered pair, F "
          f"equal to the unchecked run's {torch.equal(res.estimate.F, F_ref)}; "
          f"{times['checked']:.3f} ms vs {times['unchecked']:.3f} ms unchecked "
          f"({times['checked'] / times['unchecked']:.2f}x); a NaN in one pixel: {nan_msg!r}")
    _check(msg is None and torch.equal(res.estimate.F, F_ref), "checked: the clean pair flagged")
    _check(nan_msg is not None and nan_msg.startswith("nan"), "checked: the NaN was missed")
    out["checked"] = dict(ms=times["checked"], unchecked_ms=times["unchecked"],
                          nan_message=nan_msg)
    return out


def _slam(dev, K_mod, measure, two_view_pair, k1_args, k1_entry) -> dict:
    """``examples/slam_demo_torch.py``'s path on sequences from disk: a
    rendered KITTI-format tree (``SLAM_KITTI``) with loop closure and a
    checkpoint, then ``--distributed`` on it (16 segments of 16, overlap 4,
    world size 1), a TUM-format tree (``SLAM_TUM``), K1 at the demo's
    shapes and K3/K2 at its RANSAC's against their plain versions, the
    utilities on the card, and GPU against CPU on the KITTI tree's first 16
    frames."""
    import tempfile

    import torch

    from points_matching_tpu_torch.data.datasets import load_kitti_sequence, load_tum_sequence
    from points_matching_tpu_torch.pipelines.slam import run_slam_demo
    from points_matching_tpu_torch.utils.checkpoint import CheckpointManager
    from points_matching_tpu_torch.utils.evaluation import umeyama_alignment

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- KITTI format, KITTI 00's camera size, loop closure, checkpoint --
        n = SLAM_KITTI["num_frames"]
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        _render_tree(root, "kitti", **SLAM_KITTI)
        t_write = time.perf_counter() - t0
        seq = load_kitti_sequence(root, "00", max_frames=n, device=dev)
        ckpt = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        K_mod.reset_launch_counts()
        run = run_slam_demo(seq, device=dev, features=SLAM_FEATURES, loop_closure=True,
                            checkpoint_dir=ckpt, verbose=False)
        torch.cuda.synchronize()
        launches = K_mod.launch_counts()
        nums = run.numbers
        print(f"slam kitti: rendered and written in {t_write:.3f} s; launches {launches}")
        _slam_gates("kitti", nums, n)
        for k in ("fused_l2_top2", "minimal_eight_point", "ransac_score_hypotheses"):
            _check(launches[k] > 0, f"slam: {k} never launched")
        state = run.result.state
        with CheckpointManager(ckpt) as mgr:
            got = mgr.restore(template=state)
        leaves = [(getattr(got, f.name), getattr(state, f.name))
                  for f in dataclasses.fields(state) if f.name != "poses"]
        leaves += [(got.poses.R, state.poses.R), (got.poses.t, state.poses.t)]
        same = all(a.device == b.device and torch.equal(a, b) for a, b in leaves)
        print(f"slam kitti: checkpoint step {mgr.latest_step()} restored onto {got.X.device} "
              f"equal to the saved state bit for bit: {same} ({len(leaves)} tensors)")
        _check(same, "slam: the restored checkpoint differs from the state")
        out["kitti"] = dict(nums, write_s=t_write)
        bank = state.X.shape[0]
        valid = int(state.num_lms)

        # -- K1 at the demo's shapes (512 features, D = 64, the bank of
        # 64 × 512 rows as full as at the run's end), K3/K2 at its RANSAC's
        gen = torch.Generator(device=dev).manual_seed(11)
        f = SLAM_FEATURES
        masked = 1.0 - valid / bank
        out["K1"] = [
            _k1_case("slam frame->bank", 1, f, bank, 64, masked, gen, dev, measure),
            _k1_case("slam bank->frame", 1, bank, f, 64, 0.0, gen, dev, measure),
            _k1_case("slam frame->frame", 1, f, f, 64, 0.0, gen, dev, measure),
        ]
        # 256 draws over 512 correspondences: the best held 235 inliers on the
        # card (NVIDIA H100), under the N / 2 of the 128-draw cases
        out["ransac"] = _ransac_case("slam", 256, f, gen, dev, measure, min_best=f // 4)

        # -- --distributed on the same tree, world size 1 ---------------------
        K_mod.reset_launch_counts()
        drun = run_slam_demo(seq, device=dev, features=SLAM_FEATURES, distributed=True,
                             segment_len=SLAM_SEG, overlap=SLAM_OVERLAP, verbose=False)
        torch.cuda.synchronize()
        dlaunches = K_mod.launch_counts()
        d = drun.numbers
        regs = drun.result.registered_per_segment
        print(f"slam distributed: {d['segments']} segments of {SLAM_SEG} (overlap "
              f"{SLAM_OVERLAP}), mesh {d['mesh']}: {d['distributed_s']:.3f} s, "
              f"{d['distributed_frames_per_s']:.3f} frames/s; registered {d['registered']}/"
              f"{d['registered_slots']}, cameras {d['cameras_valid']}/{d['cameras']} valid; ATE "
              f"{d['ate']:.4f} ({d['ate'] / d['extent']:.3%} of the extent {d['extent']:.3f}); "
              f"global BA cost {d['ba_initial_cost']:.6g} -> {d['ba_final_cost']:.6g}; launches "
              f"{dlaunches}")
        _segment_launches("slam distributed (16 segments, one batch)", dlaunches, SLAM_SEG)
        _check(d["segments"] == 16 and regs.all(), "slam distributed: a frame did not register")
        _check(d["cameras_valid"] > 0.95 * d["cameras"], "slam distributed: too few cameras valid")
        _check(d["ate"] < 0.1 * d["extent"], "slam distributed: ATE over 10 % of the extent")
        _check(d["ba_final_cost"] <= d["ba_initial_cost"],
               "slam distributed: the global BA raised the cost")
        out["distributed"] = dict(d, launches=dlaunches)

        # -- GPU against CPU on the first 16 frames ---------------------------
        m = 16
        runs = {}
        for tag, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
            seq16 = load_kitti_sequence(root, "00", max_frames=m, device=device)
            t0 = time.perf_counter()
            runs[tag] = run_slam_demo(seq16, device=device, features=SLAM_FEATURES,
                                      verbose=False)
            runs[tag].numbers["seconds"] = time.perf_counter() - t0
        g, c = runs["gpu"], runs["cpu"]
        gt16 = torch.as_tensor(seq16.gt_positions, dtype=torch.float64)

        def on_gt(traj):
            traj = torch.as_tensor(traj, dtype=torch.float64)
            s, R, t = umeyama_alignment(traj, gt16)
            return s * traj @ R.T + t

        gap = float((on_gt(g.trajectory) - on_gt(c.trajectory)).norm(dim=-1).square()
                    .mean().sqrt())
        ext16 = g.numbers["extent"]
        print(f"slam GPU vs CPU on {m} frames: registered {g.result.registered} vs "
              f"{c.result.registered}; trajectories aligned to the ground truth "
              f"{gap:.4g} apart, RMS (bound "
              f"{SLAM_GPU_CPU_TOL * ext16:.4g} = {SLAM_GPU_CPU_TOL:.0%} of the extent "
              f"{ext16:.3f}); ATE {g.numbers['ate']:.4f} vs {c.numbers['ate']:.4f}; "
              f"{g.numbers['seconds']:.3f} s on the card, {c.numbers['seconds']:.3f} s on the CPU")
        _check(g.result.registered == c.result.registered,
               "slam: GPU and CPU registered other frames")
        _check(gap < SLAM_GPU_CPU_TOL * ext16, "slam: GPU and CPU trajectories differ")
        out["gpu_vs_cpu"] = dict(gap=gap, extent=ext16, seconds_gpu=g.numbers["seconds"],
                                 seconds_cpu=c.numbers["seconds"])

    with tempfile.TemporaryDirectory() as tmp:
        # -- TUM format, BASELINE config 3's shape ------------------------------
        n = SLAM_TUM["num_frames"]
        root = os.path.join(tmp, "tum")
        t0 = time.perf_counter()
        K = _render_tree(root, "tum", **SLAM_TUM)
        t_write = time.perf_counter() - t0
        # the demo's CLI assumes fr1's K, 15 px off in c_y for this render
        seq = load_tum_sequence(root, max_frames=n, intrinsics=K, device=dev)
        K_mod.reset_launch_counts()
        run = run_slam_demo(seq, device=dev, features=SLAM_FEATURES, loop_closure=True,
                            verbose=False)
        torch.cuda.synchronize()
        tlaunches = K_mod.launch_counts()
        print(f"slam tum: rendered and written in {t_write:.3f} s; launches {tlaunches}")
        _slam_gates("tum", run.numbers, n)
        out["tum"] = dict(run.numbers, write_s=t_write)

    out["utilities"] = _slam_utilities(dev, two_view_pair, k1_args, k1_entry)
    # the kernels' launches of the phase's main path: the KITTI run
    out["launches"] = launches
    return out


def _library_top2_ms(q, t, t_mask, dtype: str) -> float:
    """The yardstick beside a top-2 matcher: two PyTorch calls, ``baddbmm``
    (‖t‖² − 2·q·tᵀ, masked rows at 1e30; bf16 operands and output for
    ``bf16``) and ``topk(2)``, on operands converted beforehand.  It is
    timed here and used nowhere in the port."""
    import torch

    from points_matching_tpu_torch.utils.profiling import cuda_graph_ms

    t2 = torch.where(t_mask, (t * t).sum(-1), torch.full_like(t_mask, 1e30, dtype=q.dtype))
    if dtype == "bf16":
        q, t, t2 = (x.to(torch.bfloat16) for x in (q, t, t2))
    tT = t.transpose(-1, -2).contiguous()
    return cuda_graph_ms(lambda: torch.topk(torch.baddbmm(t2[:, None, :], q, tT, alpha=-2.0), 2,
                                            largest=False))


def _probes(dev, K_mod, q, t, F, p1, p2, pmask, launch_floor) -> dict:
    """The probes' path and kernels.  Path: the port's two probe scripts
    (``examples/probe_match_variants_torch.py``, ``probe_score_variants_torch.py``)
    through every variant at their full shapes, the launch counters set to
    0 just before and read just after (``launches_by_path.probe``).  Then
    each probe kernel, in each of its designs (``warp``: mma.sync;
    ``warpgroup``: wgmma; the host picks one by the launch's size), against
    its plain version at 64 pairs and at one pair — P1 (``gemm_rowmin``)
    within 1e-5; P2 (``packed_top2``) with indices equal off the rows whose
    competing keys lie within 2 quanta and dist within 2 quanta + 1e-5; the
    score instances (divide, fp32) equal bit for bit and (divide, bf16 × 1),
    (multiply, bf16 × 3) off by no more than their cells at the gate — with
    kernel times (CUDA-graph replays) of the host's pick and of each design
    forced, plain times (CUDA events), bounds, the launch floor and the
    library yardsticks: ``torch.matmul`` + ``amin`` on the same bf16
    operands beside P1, ``baddbmm`` + ``topk`` beside P2 (two calls
    each)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import probe_match_variants_torch as match_probe
    import probe_score_variants_torch as score_probe

    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels import probe_score as ps
    from points_matching_tpu_torch.utils.profiling import cuda_event_ms, cuda_graph_ms

    torch.cuda.synchronize()
    K_mod.reset_launch_counts()
    rows = dict(match=match_probe.run(match_probe.VARIANTS, dev),
                score=score_probe.run(tuple(score_probe.FUNCTIONS), dev))
    torch.cuda.synchronize()
    launches = K_mod.launch_counts()
    print(f"probes: launches on the probes' path {launches}")
    _check(all(r.get("ok", True) for r in rows["match"]), "a match probe kernel disagrees")
    _check(all(r["cells_beyond_gate"] == 0 for r in rows["score"]),
           "a score variant differs from its plain version beyond the gate")
    _check(all(launches[k] > 0 for k in ("gemm_rowmin", "packed_top2", "score_variant",
                                         "fused_l2_top2", "ransac_score_hypotheses")),
           "a kernel of the probes' path never launched")

    def timed(tag, kernel, plain, args, **kw):
        ms = cuda_graph_ms(lambda: kernel(*args, **kw))
        pms = cuda_event_ms(lambda: plain(*args, **kw))
        b = _bound_of(kernel, *args, **kw)
        print(f"probes {tag}: {ms:.5f} ms vs plain {pms:.5f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}, {b['bound_unit']}), launch floor {launch_floor:.5f} ms")
        return dict(ms=ms, plain_ms=pms, **b)

    def by_design(tag, kernel, args, designs, **kw):
        """each design's time, forced; the host's pick (read after a
        launch the host chose) beside them"""
        ms = {d: cuda_graph_ms(lambda d=d: kernel(*args, _design=d, **kw)) for d in designs}
        kernel(*args, **kw)
        print(f"probes {tag}: by design " + ", ".join(f"{d} {t:.5f} ms" for d, t in ms.items())
              + f"; the host picks {kernel.last_design}")
        return dict(design=kernel.last_design, ms_by_design=ms)

    def merge(batched, one, err, library, calls):
        (lib, lib1) = library
        return dict(max_abs_err=err, **batched, library_ms=lib, library_calls=calls,
                    ms_one_pair=one["ms"], bound_ms_one_pair=one["bound_ms"],
                    plain_ms_one_pair=one["plain_ms"], library_ms_one_pair=lib1,
                    launch_floor_ms=launch_floor, design_one_pair=one["design"],
                    ms_by_design_one_pair=one["ms_by_design"])

    B = q.shape[0]
    t2 = (t * t).sum(-1)
    out, times, errs, lib = {}, {}, {}, {}
    for nb in (B, 1):
        a, b, c = q[:nb], t[:nb], t2[:nb]
        pmin = pm.gemm_rowmin_plain(a, b)
        pd, pi = pm.packed_top2_plain(a, b, c)
        near = pm.near_tie_rows(a, b, c)
        quantum = pm.quantum(a, c)
        e1 = e2 = 0.0
        # each design, and the host's pick (one of them), against plain
        for design in pm.DESIGNS:
            km = pm.gemm_rowmin(a, b, _design=design)
            kd, ki = pm.packed_top2(a, b, c, _design=design)
            torch.cuda.synchronize()
            d1 = float((km - pmin).abs().max())
            d2 = float((kd - pd).abs().max())
            bad = int((ki != pi)[~near].any(-1).sum())
            print(f"probes P1 x{nb} ({design}): max |err| {d1:.3g} (tol 1e-05); P2 x{nb} "
                  f"({design}): max |dist err| {d2:.3g} (tol 2 quanta + 1e-05 = "
                  f"{2 * quantum + 1e-5:.3g}), index mismatches off the {int(near.sum())} rows "
                  f"within 2 quanta: {bad}")
            _check(d1 <= 1e-5, f"P1 x{nb} ({design}) disagrees with plain")
            _check(d2 <= 2 * quantum + 1e-5 and bad == 0, f"P2 x{nb} ({design}) disagrees with plain")
            e1, e2 = max(e1, d1), max(e2, d2)
        errs[nb] = (e1, e2)
        times[nb] = (dict(timed(f"P1 x{nb}", pm.gemm_rowmin, pm.gemm_rowmin_plain, (a, b)),
                          **by_design(f"P1 x{nb}", pm.gemm_rowmin, (a, b), pm.DESIGNS)),
                     dict(timed(f"P2 x{nb}", pm.packed_top2, pm.packed_top2_plain, (a, b, c)),
                          **by_design(f"P2 x{nb}", pm.packed_top2, (a, b, c), pm.DESIGNS)))
        qb, tbT = a.to(torch.bfloat16), b.to(torch.bfloat16).transpose(-1, -2).contiguous()
        cb = c.to(torch.bfloat16)[:, None, :]
        lib[nb] = (cuda_graph_ms(lambda: torch.matmul(qb, tbT).amin(-1)),
                   cuda_graph_ms(lambda: torch.topk(torch.baddbmm(cb, qb, tbT, alpha=-2.0), 2,
                                                    largest=False)))
        print(f"probes x{nb} yardsticks: matmul + amin {lib[nb][0]:.5f} ms, baddbmm + topk "
              f"{lib[nb][1]:.5f} ms (two calls each, bf16)")
    out["gemm_rowmin"] = merge(times[B][0], times[1][0], max(errs[B][0], errs[1][0]),
                               (lib[B][0], lib[1][0]), "two calls: torch.matmul (bf16) + amin")
    out["packed_top2"] = merge(times[B][1], times[1][1], max(errs[B][1], errs[1][1]),
                               (lib[B][1], lib[1][1]),
                               "two calls: torch.baddbmm (bf16, t2 - 2 q t^T) + topk")

    instances = {}
    for gate, products in ps.VARIANTS:
        tag = f"{gate}/{products}"
        designs = ("warp",) if products == "f32" else ps.DESIGNS
        res, diffs = {}, []
        for nb in (B, 1):
            args = (F[:nb], p1[:nb], p2[:nb], pmask[:nb], 1.5)
            pc = ps.score_variant_plain(*args, gate, products)
            near = ps.near_gate_cells(*args, products=products)
            for design in designs:
                kc = ps.score_variant(*args, gate, products, _design=design)
                torch.cuda.synchronize()
                diff = int((kc - pc).abs().max())
                beyond = int(((kc - pc).abs() - near).clamp_min(0).sum())
                print(f"probes score {tag} x{nb} ({design}): max |count diff| {diff}, beyond "
                      f"the {int(near.sum())} cells at the gate {beyond}, max count "
                      f"{int(kc.max())}")
                if products == "f32":
                    _check(diff == 0, f"score {tag} x{nb} differs from plain")
                _check(beyond == 0, f"score {tag} x{nb} ({design}) differs from plain beyond "
                                    "the gate")
                # one bf16 pass moves pixel coordinates by up to 2 px: its best
                # hypothesis may keep fewer than half the points
                _check(products == "bf16x1" or int(kc.max()) > p1.shape[1] // 2,
                       f"score {tag} x{nb}: no hypothesis keeps half the points")
                diffs.append(diff)
            res[nb] = dict(timed(f"score {tag} x{nb}", ps.score_variant, ps.score_variant_plain,
                                 args, gate=gate, products=products),
                           **by_design(f"score {tag} x{nb}", ps.score_variant, args, designs,
                                       gate=gate, products=products))
        instances[tag] = merge(res[B], res[1], max(diffs), (None, None), None)
    out["score_variant"] = dict(instances["multiply/bf16x3"], instances=instances)
    out["rows"] = rows
    out["launches"] = launches
    return out


# The dense Schur BA at the JAX bench's ``ba`` shape (bench.py:452
# ``bench_ba``: 32 cameras × 2,048 landmarks, chunks of 25 LM iterations at
# rtol 0) from a perturbed start with two gauge cameras (the dense BA
# tests' setup); the landmark-sharded form at world sizes 1 (NCCL) and, as
# processes on this card over gloo, 2 and 4
BA_DENSE = dict(num_cameras=32, num_landmarks=2048, chunk=25, worlds=(2, 4))
# tests/test_torch_ba.py's bands for the 20-iteration result: the Cholesky
# LM masks the gauge after its solve and amplifies rounding
BA_DENSE_BANDS = dict(cholesky=0.1, pcg=1e-2)
# the float32 card-vs-CPU gap (cost, X, t) may be at most this multiple of
# the largest gap the card's own run shows when its landmarks move by 1e-7
# or 1e-6 relative (seeds 9-11: six probes), as
# tests/test_torch_cuda.py::test_dense_ba_gpu_matches_cpu holds it at 6 x 64
BA_DENSE_PROBE = dict(multiple=4, eps=(1e-7, 1e-6), seeds=(9, 10, 11))


def _ba_dense_problem(dev):
    """(state, K) at ``BA_DENSE``'s shape on ``dev``: the dense BA tests'
    perturbed start (``make_perturbed_ba_problem``, seed 1), the same bits
    in every process."""
    from points_matching_tpu_torch.data.synthetic import make_perturbed_ba_problem

    return make_perturbed_ba_problem(1, BA_DENSE["num_cameras"], BA_DENSE["num_landmarks"],
                                     device=dev)


def _ba_dense_config(solver: str, iterations: int, rtol=None, pcg_iterations: int = 50):
    from points_matching_tpu_torch.core.config import BAConfig

    kw = {} if rtol is None else dict(rtol=rtol)
    return BAConfig(max_iterations=iterations, solver=solver,
                    pcg_iterations=pcg_iterations, **kw)


def _ba_dense_probed(tag: str, state, K, cpu_state, cpu_K, cfg) -> dict:
    """``bundle_adjust`` under ``cfg`` on the card against the CPU: the gap
    (cost relative, largest |dX| and |dt|) beside the largest gap the
    card's own run shows when its landmarks move by ``BA_DENSE_PROBE``'s
    relative amounts (six probes), and the failure unless the gap is within
    its multiple of that."""
    import torch

    from points_matching_tpu_torch.ba.lm import bundle_adjust

    def apart(a, b):
        (oa, sa), (ob, sb) = a, b
        return (abs(float(sa.final_cost) / float(sb.final_cost) - 1),
                float((oa.X.cpu() - ob.X.cpu()).abs().max()),
                float((oa.poses.t.cpu() - ob.poses.t.cpu()).abs().max()))

    card = bundle_adjust(state, K, cfg)
    got = apart(card, bundle_adjust(cpu_state, cpu_K, cfg))
    moved = [apart(bundle_adjust(dataclasses.replace(state, X=state.X * (1 + eps * torch.randn(
        state.X.shape, generator=torch.Generator().manual_seed(seed)).to(state.X.device))),
        K, cfg), card) for eps in BA_DENSE_PROBE["eps"] for seed in BA_DENSE_PROBE["seeds"]]
    most = [max(m[k] for m in moved) for k in range(3)]
    ratio = [x / m if m else (0.0 if x == 0 else math.inf) for x, m in zip(got, most)]
    print(f"ba dense {tag} GPU vs CPU, {cfg.max_iterations} LM iteration(s) (float32): "
          f"cost {got[0]:.3g}, max |dX| {got[1]:.3g}, |dt| {got[2]:.3g}; the card against "
          f"itself, largest of {len(moved)} probes (landmarks moved by "
          f"{'/'.join(f'{e:g}' for e in BA_DENSE_PROBE['eps'])} relative): cost {most[0]:.3g}, "
          f"|dX| {most[1]:.3g}, |dt| {most[2]:.3g}; the gap is {ratio[0]:.3g} / {ratio[1]:.3g} "
          f"/ {ratio[2]:.3g} of it (gate {BA_DENSE_PROBE['multiple']})")
    _check(max(ratio) <= BA_DENSE_PROBE["multiple"],
           f"ba dense {tag}: {cfg.max_iterations} iterations on the card lie further from the "
           f"CPU than the card's own amplification of rounding allows")
    return dict(cost_rel=got[0], X=got[1], t=got[2], probe_cost_rel=most[0], probe_X=most[1],
                probe_t=most[2], ratio_to_probe=ratio, probe_moves=moved)


def _ba_result(out, st) -> dict:
    """A dense BA's result on the host: costs, iterations, X and t."""
    return dict(initial_cost=float(st.initial_cost), final_cost=float(st.final_cost),
                iterations=int(st.iterations), X=out.X.cpu(), t=out.poses.t.cpu())


def _dense_ba_rank(dev, K_mod, rank: int, world: int, inputs) -> dict:
    """Rank job ``dense_ba``: ``distributed_bundle_adjust`` on a 1 × ``world``
    data × model mesh (each rank ``L / world`` landmarks), both solvers, 1
    and 5 LM iterations (default rtol), as tests/test_torch_parallel.py
    runs it; the 5-iteration run timed from a barrier (processes sharing
    one card)."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.mesh import make_mesh
    from points_matching_tpu_torch.parallel.sharded_ba import distributed_bundle_adjust

    state, K = _ba_dense_problem(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    out = {}
    for solver in ("cholesky", "pcg"):
        for it in (1, 5):
            dist.barrier()
            t0 = time.perf_counter()
            o, st = distributed_bundle_adjust(state, K, mesh, _ba_dense_config(solver, it))
            torch.cuda.synchronize()
            out[f"{solver}_it{it}"] = dict(_ba_result(o, st),
                                           seconds=time.perf_counter() - t0)
    return out


def _ba_dense(dev, K_mod) -> dict:
    """The dense Schur BA (``ba/lm.bundle_adjust``) at the JAX bench's
    ``ba`` shape (``BA_DENSE``), Cholesky then PCG (50 steps), each a chunk
    of 25 LM iterations at rtol 0 run three times: the cost falls and stays
    finite, the three runs equal in every bit (cost, X, R, t); ms per LM
    iteration (host clock, synchronized), peak device memory, the aten ops
    and host reads of one iteration (a 2-iteration run less a 1-iteration
    one), the bound (``work.dense_ba_iteration_work``, fp32 FMA peak).  Held
    to the CPU with tests/test_torch_ba.py's bounds: the first two LM steps
    within 1e-3 (cost, and the X and t updates against the largest), the
    20-iteration cost within 10 % (Cholesky) / 1 % (PCG); after 1, 2 and
    20 iterations, here and at the card test's 6 × 64, the cost, X and t
    gaps within ``BA_DENSE_PROBE``'s multiple of the largest the card's own
    run shows when its landmarks move by 1e-7 or 1e-6 relative
    (``_ba_dense_probed``).  Then ``distributed_bundle_adjust``: at world
    size 1 over NCCL (a 1 × 1 mesh) equal to ``bundle_adjust`` bit for bit;
    at world sizes 2 and 4 as rank workers on this card over gloo, held to
    the one-process card run with tests/test_torch_parallel.py's bounds (1
    iteration: cost rtol 1e-4, X 1e-3; 5: both costs fall and agree to 10
    %), every rank the same answer.  The path has no hand kernel (cuBLAS
    contractions): its launches are printed, all 0."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.ba.lm import bundle_adjust
    from points_matching_tpu_torch.data.synthetic import make_perturbed_ba_problem
    from points_matching_tpu_torch.ops.kernels import work
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from points_matching_tpu_torch.parallel.sharded_ba import distributed_bundle_adjust
    from points_matching_tpu_torch.utils.profiling import chip_peaks

    C, L, chunk = (BA_DENSE[k] for k in ("num_cameras", "num_landmarks", "chunk"))
    state, K = _ba_dense_problem(dev)
    cpu_state, cpu_K = _ba_dense_problem("cpu")
    peaks = chip_peaks(dev)
    out, path_launches = {}, {}
    for solver in ("cholesky", "pcg"):
        cfg = _ba_dense_config(solver, chunk, rtol=0.0)
        bundle_adjust(state, K, _ba_dense_config(solver, 1, rtol=0.0))          # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K_mod.reset_launch_counts()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            o, st = bundle_adjust(state, K, cfg)
            torch.cuda.synchronize()
            runs.append((o, st, (time.perf_counter() - t0) * 1e3))
        launches = K_mod.launch_counts()
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated()
        o, st, _ = runs[0]
        c0, c1, its = float(st.initial_cost), float(st.final_cost), int(st.iterations)
        ms_it = sorted(r[2] / its for r in runs)
        same = all(torch.equal(st.final_cost, r[1].final_cost) and torch.equal(o.X, r[0].X)
                   and torch.equal(o.poses.R, r[0].poses.R)
                   and torch.equal(o.poses.t, r[0].poses.t) for r in runs[1:])
        _check(o.X.is_cuda and math.isfinite(c1) and c1 < c0 and its == chunk,
               f"ba dense {solver}: the cost did not fall or is not finite")
        _check(same, f"ba dense {solver}: two runs differ")
        _check(not any(launches.values()), f"ba dense {solver}: launched {launches}")
        ops = [_count_ops(lambda n=n: bundle_adjust(state, K, _ba_dense_config(
            solver, n, rtol=0.0))) for n in (1, 2)]
        syncs = [_count_syncs(lambda n=n: bundle_adjust(state, K, _ba_dense_config(
            solver, n, rtol=0.0)))[1] for n in (1, 2)]
        w = work.dense_ba_iteration_work(C, L, solver, cfg.pcg_iterations)
        b = work.bound(w, peaks)
        print(f"ba dense {solver}: {C} cams x {L} lm ({int(state.mask.sum())} valid cells), "
              f"{its} LM iterations at rtol 0: cost {c0:.6g} -> {c1:.6g}; "
              f"{ms_it[1]:.3f} ms an iteration (median of 3; {ms_it[0]:.3f}-{ms_it[2]:.3f}; "
              f"host clock, synchronized); the three runs equal bit for bit {same}; peak "
              f"device memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} held before); an iteration {ops[1] - ops[0]} aten ops, "
              f"{syncs[1] - syncs[0]} host reads; bound {b['bound_ms']:.5f} ms "
              f"({w.ops / 1e6:.1f} MFLOP at {peaks['flops'] / 1e12:g} TFLOP/s fp32 FMA, "
              f"{b['bound_by']}; {b['bound_ms'] / ms_it[1]:.3%} of it reached); "
              f"launches {launches}")
        rec = dict(initial_cost=c0, final_cost=c1, iterations=its, ms_per_iteration=ms_it[1],
                   ms_per_iteration_runs=ms_it, runs_equal=same, peak_bytes=peak,
                   base_bytes=base, aten_ops_per_iteration=ops[1] - ops[0],
                   host_reads_per_iteration=syncs[1] - syncs[0], flops_per_iteration=w.ops,
                   **b, bound_share=b["bound_ms"] / ms_it[1])

        # the card against the CPU: the first two steps, then 20 iterations
        for n in (1, 2):
            g, gs = bundle_adjust(state, K, _ba_dense_config(solver, n, rtol=0.0))
            c, cs = bundle_adjust(cpu_state, cpu_K, _ba_dense_config(solver, n, rtol=0.0))
            dcost = abs(float(gs.final_cost) / float(cs.final_cost) - 1)
            dsteps = []
            for a_, b_, start in ((g.X, c.X, cpu_state.X), (g.poses.t, c.poses.t,
                                                          cpu_state.poses.t)):
                d_cpu = b_ - start
                dsteps.append(float((a_.cpu() - start - d_cpu).abs().max())
                              / float(d_cpu.abs().max()))
            print(f"ba dense {solver} GPU vs CPU, {n} LM iteration(s): cost "
                  f"{float(gs.final_cost):.6g} vs {float(cs.final_cost):.6g} (relative "
                  f"{dcost:.3g}, tol 1e-3); X and t "
                  f"updates apart by {dsteps[0]:.3g} / {dsteps[1]:.3g} of the largest (tol 1e-3)")
            _check(dcost <= 1e-3 and max(dsteps) <= 1e-3 and int(gs.iterations) == n,
                   f"ba dense {solver}: GPU and CPU steps differ at iteration {n}")
            rec[f"gpu_vs_cpu_it{n}"] = dict(cost_rel=dcost, X_step_rel=dsteps[0],
                                            t_step_rel=dsteps[1])
        cfg20 = _ba_dense_config(solver, 20)
        g, gs = bundle_adjust(state, K, cfg20)
        c, cs = bundle_adjust(cpu_state, cpu_K, cfg20)
        dcost = abs(float(gs.final_cost) / float(cs.final_cost) - 1)
        print(f"ba dense {solver} GPU vs CPU, 20 LM iterations: cost {float(gs.final_cost):.6g} "
              f"vs {float(cs.final_cost):.6g} (relative {dcost:.3g}, band "
              f"{BA_DENSE_BANDS[solver]:g})")
        _check(math.isfinite(float(gs.final_cost)) and dcost <= BA_DENSE_BANDS[solver],
               f"ba dense {solver}: 20 iterations on the card and the CPU differ")
        # the gaps against the card's own amplification of rounding, at the
        # bench's shape and at the card test's 6 x 64 (20 PCG steps)
        small = [make_perturbed_ba_problem(0, 6, 64, device=d) for d in (dev, "cpu")]
        rec["gpu_vs_cpu_probed"] = {
            shape: {n: _ba_dense_probed(f"{solver} {shape}", state_, K_, cpu_, cpu_K_,
                                        _ba_dense_config(solver, n, rtol=0.0 if n < 20
                                                         else None, pcg_iterations=pcg))
                    for n in (1, 2, 20)}
            for shape, (state_, K_), (cpu_, cpu_K_), pcg in (
                (f"{C}x{L}", (state, K), (cpu_state, cpu_K), 50),
                ("6x64", small[0], small[1], 20))}
        rec["gpu_vs_cpu_it20"] = dict(cost_rel=dcost)
        out[solver] = rec

    # the landmark-sharded form: world size 1 over NCCL, bit for bit
    initialize_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                           rank=0, timeout=60, force=True)
    _check(dist.get_backend() == "nccl", "ba dense: world size 1 is not on NCCL")
    mesh = make_mesh((1, 1), ("data", "model"))
    for solver in ("cholesky", "pcg"):
        cfg = _ba_dense_config(solver, chunk, rtol=0.0)
        a, sa = bundle_adjust(state, K, cfg)
        # warm-up: NCCL makes its communicator at the group's first collective
        distributed_bundle_adjust(state, K, mesh, _ba_dense_config(solver, 1, rtol=0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b_, sb = distributed_bundle_adjust(state, K, mesh, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / int(sb.iterations)
        same = (torch.equal(sa.final_cost, sb.final_cost) and torch.equal(a.X, b_.X)
                and torch.equal(a.poses.t, b_.poses.t) and torch.equal(a.poses.R, b_.poses.R))
        print(f"ba dense {solver} distributed_bundle_adjust at world size 1 (NCCL, 1 x 1 mesh): "
              f"{ms:.3f} ms an iteration; equal to bundle_adjust bit for bit {same}")
        _check(same, f"ba dense {solver}: world size 1 differs from bundle_adjust")
        out[solver]["ws1_nccl"] = dict(equal=same, ms_per_iteration=ms)
    dist.destroy_process_group()

    # world sizes 2 and 4: processes sharing this card
    single = {f"{solver}_it{it}": _ba_result(*bundle_adjust(state, K, _ba_dense_config(
        solver, it))) for solver in ("cholesky", "pcg") for it in (1, 5)}
    for world in BA_DENSE["worlds"]:
        results, wall = _spawn_ranks("dense_ba", world)
        for solver in ("cholesky", "pcg"):
            rows = {}
            for it in (1, 5):
                key = f"{solver}_it{it}"
                got, want = results[0]["dense_ba"][key], single[key]
                _check(all(torch.equal(r["dense_ba"][key]["X"], got["X"])
                           and r["dense_ba"][key]["final_cost"] == got["final_cost"]
                           for r in results), f"ba dense {key} ws{world}: ranks disagree")
                dcost = abs(got["final_cost"] / want["final_cost"] - 1)
                dX = float((got["X"] - want["X"]).abs().max())
                ok = (got["final_cost"] < got["initial_cost"]
                      and want["final_cost"] < want["initial_cost"]
                      and dcost <= (1e-4 if it == 1 else 0.1) and (it > 1 or dX <= 1e-3))
                secs = max(r["dense_ba"][key]["seconds"] for r in results)
                rows[it] = dict(cost_rel=dcost, X=dX, final_cost=got["final_cost"],
                                seconds=secs, iterations=got["iterations"])
                _check(ok, f"ba dense {key}: world size {world} against one process "
                           f"(cost {dcost:.3g}, |dX| {dX:.3g})")
            ms5 = rows[5]["seconds"] / rows[5]["iterations"] * 1e3
            print(f"ba dense {solver} distributed_bundle_adjust at world size {world} "
                  f"({world} processes sharing this card over gloo): 1 iteration cost "
                  f"{rows[1]['cost_rel']:.3g} from one process (tol 1e-4), |dX| "
                  f"{rows[1]['X']:.3g} (tol 1e-3); 5 iterations cost {rows[5]['cost_rel']:.3g} "
                  f"(tol 0.1) in {rows[5]['seconds']:.3f} s ({ms5:.3f} ms an iteration, "
                  f"processes sharing one card); every rank the same answer; {wall:.1f} s "
                  f"with the processes' start")
            out[solver][f"ws{world}"] = dict(rows, seconds_with_start=wall)
    out["launches"] = path_launches
    return out


def _ring_rank(dev, K_mod, rank: int, world: int, inputs) -> dict:
    """Rank job ``ring``: config 1's sweep through ``all_pairs_scores`` over
    a (``world``,) data mesh; a warm-up sweep of 4 frames a rank, then the
    timed sweep from a barrier, its K1 launches on this rank."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores
    from points_matching_tpu_torch.parallel.mesh import make_mesh

    desc, mask = _all_pairs_inputs(dev)
    mesh = make_mesh((world,), ("data",))
    all_pairs_scores(desc[:4 * world], mask[:4 * world], ALL_PAIRS["ratio"], mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    K_mod.reset_launch_counts()
    t0 = time.perf_counter()
    scores = all_pairs_scores(desc, mask, ALL_PAIRS["ratio"], mesh=mesh)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    q = desc.shape[0] // world
    return dict(scores=scores.cpu(), seconds=sec, launches=K_mod.launch_counts(),
                shift_bytes=q * desc.shape[1] * (desc.shape[2] * desc.element_size() + 1),
                shifts=world - 1)


def _staged_rank(dev, K_mod, rank: int, world: int, inputs) -> dict:
    """Rank job ``staged``: ``staged_two_view`` over a (``world``,) stage
    mesh, a stage a rank, SURF then ORB on the pairs and RANSAC samples in
    ``inputs``; a warm-up run, then the timed run from a barrier, with this
    rank's launches."""
    import torch
    import torch.distributed as dist

    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.parallel.mesh import make_mesh
    from points_matching_tpu_torch.pipelines.staged_two_view import staged_two_view

    mesh = make_mesh((world,), ("stage",))
    img1, img2 = (inputs[k].to(dev) for k in ("img1", "img2"))
    out = {}
    for tag, cfg_name, _ in STAGED_CONFIGS:
        cfg = named_config(cfg_name)
        samples = tuple(x.to(dev) for x in inputs["samples"][tag])
        staged_two_view(img1, img2, inputs["seeds"], cfg, mesh=mesh, samples=samples)
        torch.cuda.synchronize()
        dist.barrier()
        K_mod.reset_launch_counts()
        t0 = time.perf_counter()
        w = staged_two_view(img1, img2, inputs["seeds"], cfg, mesh=mesh, samples=samples)
        torch.cuda.synchronize()
        out[tag] = dict(wire={k: v.cpu() for k, v in w.items()}, launches=K_mod.launch_counts(),
                        ms=(time.perf_counter() - t0) * 1e3)
    return out


# which kernels each stage may launch (detect → describe → match → geometry)
STAGE_KERNELS = dict(surf=((), (), ("fused_l2_top2",),
                           ("minimal_eight_point", "ransac_score_hypotheses")),
                     orb=((), (), ("fused_hamming_top2",),
                          ("minimal_eight_point", "ransac_score_hypotheses")))


def _ranks(dev, K_mod, staged_ws1) -> dict:
    """Paths over several ranks, as processes on this card over gloo (rank
    jobs ``ring`` and ``staged``; their seconds are of processes that share
    one card).  The all-pairs ring (config 1, ``ALL_PAIRS``) over a data
    mesh of 2 and of 4 ranks: the [N, N] scores equal to the ``mesh=None``
    sweep on the card bit for bit (K1's rows do not depend on the rows
    beside them), the planted pair found, seconds a sweep, K1's launches a
    rank and the bytes each ``ring_shift`` moves.  The staged two-view at
    one rank a stage (4 ranks) on the ``staged`` phase's pairs and RANSAC
    samples, SURF and ORB: every field of the wire equal to the world-size-1
    run bit for bit; each stage's kernels launched on its own rank only
    (``STAGE_KERNELS``); ms a microbatch of 4 beside world size 1's, and the
    bubble share (S − 1)/(M + S − 1)."""
    import torch

    from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores

    desc, mask = _all_pairs_inputs(dev)
    ref = all_pairs_scores(desc, mask, ALL_PAIRS["ratio"]).cpu()
    img1, img2, seeds = _staged_inputs(dev)
    inputs = dict(img1=img1.cpu(), img2=img2.cpu(), seeds=seeds,
                  samples={tag: tuple(x.cpu() for x in staged_ws1[tag]["samples"])
                           for tag, _, _ in STAGED_CONFIGS})
    out = dict(ring={}, staged={}, launches={})
    for world in (2, 4):
        results, wall = _spawn_ranks("ring" if world == 2 else "ring,staged", world,
                                     inputs if world == 4 else None)
        ring = [r["ring"] for r in results]
        for r, res in enumerate(ring):
            diff = (res["scores"] != ref).nonzero().tolist()
            _check(not diff, f"ring ws{world} rank {r}: cells {diff[:8]} differ from the "
                             "mesh=None sweep")
        best7, best_twin, _, _ = _planted_pair(ring[0]["scores"])
        _check(best7 == ALL_PAIRS["twin"] and best_twin == 7,
               f"ring ws{world}: the planted pair was not found")
        k1 = [res["launches"]["fused_l2_top2"] for res in ring]
        _check(all(n > 0 for n in k1), f"ring ws{world}: K1 did not launch on every rank")
        sec = max(res["seconds"] for res in ring)
        n = ALL_PAIRS["n"]
        print(f"ranks ring ws{world} ({world} processes sharing this card over gloo): "
              f"{n} x {ALL_PAIRS['k']} x {ALL_PAIRS['d']} scores equal to the mesh=None sweep bit "
              f"for bit on every rank; planted pair 7 <-> {best7}; {sec:.4f} s a sweep "
              f"({n * n / sec:.4g} pairs/s); K1 launches a rank {k1}; "
              f"{ring[0]['shifts']} ring_shifts a rank of {ring[0]['shift_bytes']} bytes each "
              f"(descriptors and mask, through host copies); {wall:.1f} s with the "
              f"processes' start")
        out["ring"][f"ws{world}"] = dict(seconds=sec, pairs_per_s=n * n / sec,
                                         launches_per_rank=k1, shifts=ring[0]["shifts"],
                                         shift_bytes=ring[0]["shift_bytes"],
                                         seconds_with_start=wall)
        for k in K_mod.launch_counts():
            out["launches"][k] = out["launches"].get(k, 0) + sum(
                res["launches"][k] for res in ring)
        if world != 4:
            continue
        for tag, _, _ in STAGED_CONFIGS:
            want = staged_ws1[tag]["wire"]
            staged = [r["staged"][tag] for r in results]
            for r, res in enumerate(staged):
                bad = [k for k in want if not torch.equal(res["wire"][k], want[k].cpu())]
                _check(set(res["wire"]) == set(want) and not bad,
                       f"staged {tag} ws4 rank {r}: fields {bad} differ from world size 1")
                allowed = STAGE_KERNELS[tag][r]
                stray = {k: v for k, v in res["launches"].items() if v and k not in allowed}
                _check(not stray and all(res["launches"][k] > 0 for k in allowed),
                       f"staged {tag} ws4 rank {r}: launches {res['launches']} (stage "
                       f"kernels {allowed})")
            ms = max(res["ms"] for res in staged)
            M, S = want["F"].shape[0], world
            bubble = (S - 1) / (M + S - 1)
            per_rank = [{k: v for k, v in res["launches"].items() if v} for res in staged]
            print(f"ranks staged {tag} ws4 (a stage a rank, 4 processes sharing this card over "
                  f"gloo): every wire field equal to world size 1 bit for bit on every rank; "
                  f"launches by rank {per_rank}; {ms:.3f} ms a microbatch of {M} (world size "
                  f"1 {staged_ws1[tag]['ms']:.3f} ms); bubble share (S-1)/(M+S-1) = "
                  f"{bubble:.4f}")
            out["staged"][tag] = dict(ms_per_batch=ms, ms_ws1=staged_ws1[tag]["ms"],
                                      bubble_share=bubble, launches_by_rank=per_rank)
            for k in K_mod.launch_counts():
                out["launches"][k] += sum(res["launches"][k] for res in staged)
    return out


RANK_JOBS = dict(config4=_config4_rank, dense_ba=_dense_ba_rank, ring=_ring_rank,
                 staged=_staged_rank)


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-worker"]:
        return _rank_worker(sys.argv[2], *map(int, sys.argv[3:6]), sys.argv[6])
    parent_tree = None
    if sys.argv[1:2] == ["--parent"]:
        parent_tree = os.path.abspath(sys.argv[2])

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "points_matching_tpu_torch")):
        print("chip_smoke: the points_matching_tpu_torch package is not beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, here)
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.ops import kernels as K
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels import work
    from points_matching_tpu_torch.utils.profiling import cuda_event_ms, cuda_graph_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = resolve_device("cuda")
    pin_fp32()
    _check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 still on")
    _check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 still on")
    name = torch.cuda.get_device_name(0)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{name} x{torch.cuda.device_count()}; TF32 off")
    one = torch.zeros(1, device=dev)
    launch_floor = cuda_graph_ms(lambda: one.add_(1))
    print(f"device: launch floor {launch_floor:.5f} ms (one-element add_, graph replays)")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    built = _build.last_build
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built['seconds']:.2f} s, cached={built['cached']}) -> "
          f"{os.path.relpath(built['path'])}")

    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import (
        fused_hamming_top2, hamming_top2_plain)
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain, l2_top2_points_plain)
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        ransac_score_hypotheses, ransac_score_plain)

    def measure(tag, kernel, plain, args, bound, plain_iters=20):
        ms = cuda_graph_ms(lambda: kernel(*args))
        pms = cuda_event_ms(lambda: plain(*args), iters=plain_iters,
                       warmup=1 if plain_iters < 20 else 3)
        print(f"kernel {tag}: {ms:.4f} ms vs plain {pms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        return ms, pms

    phase_s, report = {}, {}
    t_phase = time.perf_counter()
    # -- 3. kernels against their plain versions -----------------------------
    # Each kernel runs at two shapes: the batched one (64 pairs, the bench
    # head's) and one pair, which is what the slices launch.  Kernel times
    # are CUDA-graph replays (`cuda_graph_ms`), plain times CUDA events around
    # back-to-back calls (`cuda_event_ms`).  No single PyTorch call computes any
    # of K1-K4 (a fused top-2 over L2 or Hamming distances, a batch of
    # Sampson-gated counts, a batch of rank-2 minimal 8-point solves); K1 and
    # K1b get the two-call yardstick baddbmm + topk, the others a null
    # library_ms.
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, D, H = 64, 512, 64, 512

    def entry(err, batched, one):
        """A kernel's report: errors over both shapes, the batched times and
        bound, and the one-pair ones beside them."""
        (ms, pms, bound), (ms1, pms1, bound1) = batched, one
        return dict(max_abs_err=err, ms=ms, plain_ms=pms, **bound, library_ms=None,
                    ms_one_pair=ms1, bound_ms_one_pair=bound1["bound_ms"],
                    plain_ms_one_pair=pms1, launch_floor_ms=launch_floor)

    q = torch.randn(B, N, D, generator=gen, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    t = torch.randn(B, N, D, generator=gen, device=dev)
    t = t / t.norm(dim=-1, keepdim=True)
    t_mask = torch.rand(B, N, generator=gen, device=dev) > 0.05
    pts = torch.rand(B, N, 2, generator=gen, device=dev) * torch.tensor(
        [993.0, 660.0], device=dev)

    # both dtypes: the kernel and the plain version round the same operands
    # and differ only in fp32 summation order (measured on the card: < 1e-6)
    for dtype, dist_tol in (("f32", 1e-5), ("bf16", 1e-5)):
        outs, times, errs = {}, {}, []
        for nb in (B, 1):
            args = (q[:nb], t[:nb], t_mask[:nb])
            kd, ki = fused_l2_top2(*args, compute_dtype=dtype)
            pd, pi = l2_top2_plain(*args, compute_dtype=dtype)
            torch.cuda.synchronize()
            err = float((kd - pd).abs().max())
            tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
            idx_bad = int(((ki[..., 0] != pi[..., 0]) & ~tie).sum())
            print(f"kernel K1 {dtype} x{nb}: max|dist err| {err:.3g} (tol {dist_tol:g}), "
                  f"1-NN index mismatches off near-ties {idx_bad}")
            _check(err <= dist_tol and idx_bad == 0, f"K1 {dtype} x{nb} disagrees with plain")
            bound = _bound_of(fused_l2_top2, *args)
            times[nb] = (*measure(f"K1 {dtype} x{nb}", lambda *a: fused_l2_top2(
                *a, compute_dtype=dtype), lambda *a: l2_top2_plain(*a, compute_dtype=dtype),
                args, bound), bound)
            outs[nb] = (kd, ki)
            errs.append(err)
        # one pair alone gives that pair's rows of the batched launch, bit for bit
        same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[B]))
        print(f"kernel K1 {dtype}: one pair == its rows of the batch bit for bit: {same}")
        _check(same, f"K1 {dtype}: one-pair launch differs from the batched one")
        lib_ms = _library_top2_ms(q, t, t_mask, dtype)
        print(f"kernel K1 {dtype} x{B}: yardstick baddbmm + topk {lib_ms:.5f} ms (two calls)")
        report[f"K1_{dtype}"] = dict(entry(max(errs), times[B], times[1]), library_ms=lib_ms,
                                     library_calls="two calls: torch.baddbmm + topk")

    outs, times, errs = {}, {}, []
    for nb in (B, 1):
        args = (q[:nb], t[:nb], t_mask[:nb], pts[:nb])
        kd, ki, kp = fused_l2_top2_points(*args)
        pd, pi, pp = l2_top2_points_plain(*args)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        gathered = torch.gather(pts[:nb], 1, ki[..., :1].long().expand(-1, -1, 2))
        pts_exact = bool(torch.equal(kp, gathered))
        print(f"kernel K1b x{nb}: max|dist err| {err:.3g} (tol 1e-05), "
              f"pts == t_points[idx] exactly: {pts_exact}")
        _check(err <= 1e-5 and pts_exact, f"K1b x{nb} disagrees with plain")
        bound = _bound_of(fused_l2_top2_points, *args)
        times[nb] = (*measure(f"K1b x{nb}", fused_l2_top2_points, l2_top2_points_plain,
                              args, bound), bound)
        outs[nb] = (kd, ki, kp)
        errs.append(err)
    same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[B]))
    print(f"kernel K1b: one pair == its rows of the batch bit for bit: {same}")
    _check(same, "K1b: one-pair launch differs from the batched one")
    report["K1b"] = dict(entry(max(errs), times[B], times[1]),
                         library_ms=report["K1_f32"]["library_ms"],
                         library_calls="two calls: torch.baddbmm + topk (the top-2 alone, "
                                       "no point gather)")

    p1, p2, pmask = _scenes(B, N, gen, dev)
    # 8 distinct correspondences per hypothesis
    pick = torch.rand(B, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    sp1 = torch.gather(p1[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    sp2 = torch.gather(p2[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    # one instruction per scalar op (--fmad=false): counted on one sample
    per_sample = work.eight_point_ops_per_sample()
    times, errs, kFs, groups = {}, [], {}, {}
    for nb in (B, 1):
        args = (sp1[:nb], sp2[:nb])
        kF = kFs[nb] = minimal_eight_point(*args)
        pF = minimal_eight_point_plain(*args)
        torch.cuda.synchronize()
        err = float((kF - pF).abs().max())
        finite = bool(torch.isfinite(kF).all())
        groups[nb] = minimal_eight_point.last_group   # the G this launch ran with
        print(f"kernel K3 x{nb}: max|F err| {err:.3g} (tol 0) over all "
              f"{kF.shape[0] * kF.shape[1]} samples, finite {finite} "
              f"({per_sample} fp32 ops per sample), lanes per sample G = {groups[nb]}")
        # the plain version is the kernel's chain in the kernel's operation
        # order (--fmad=false, IEEE sqrt and division): the two agree to the
        # last bit on the card, for every G
        _check(finite and err == 0.0 and torch.equal(kF, pF),
               f"K3 x{nb} disagrees with plain")
        bound = _bound_of(minimal_eight_point, *args)
        times[nb] = (*measure(f"K3 x{nb}", minimal_eight_point, minimal_eight_point_plain,
                              args, bound, plain_iters=3), bound)
        errs.append(err)
    same = torch.equal(kFs[1], kFs[B][:1])
    print(f"kernel K3: one pair (G = {groups[1]}) == its rows of the batch "
          f"(G = {groups[B]}) bit for bit: {same}")
    _check(same, "K3: one-pair launch differs from the batched one")
    report["K3"] = dict(entry(max(errs), times[B], times[1]), group=groups[B],
                        group_one_pair=groups[1])
    kF = kFs[B]

    per_cell = work.ransac_score_ops_per_cell()
    times, errs, tiles = {}, [], {}
    for nb in (B, 1):
        args = (kF[:nb], p1[:nb], p2[:nb], pmask[:nb], 1.5)
        kc = ransac_score_hypotheses(*args)
        tiles[nb] = ransac_score_hypotheses.last_tile
        pc = ransac_score_plain(*args)
        torch.cuda.synchronize()
        cdiff = int((kc - pc).abs().max())
        print(f"kernel K2 x{nb}: max|count diff| {cdiff} (tol 0), "
              f"max count {int(kc.max())}/{N} ({per_cell} fp32 ops per valid cell), "
              f"tile (warps, hypotheses a warp) {tiles[nb]}")
        # same association order and --fmad=false: the same gates, every count equal
        _check(cdiff == 0 and int(kc.max()) > N // 2, f"K2 x{nb} disagrees with plain")
        bound = _bound_of(ransac_score_hypotheses, *args)
        times[nb] = (*measure(f"K2 x{nb}", ransac_score_hypotheses, ransac_score_plain,
                              args, bound), bound)
        errs.append(float(cdiff))
    report["K2"] = dict(entry(max(errs), times[B], times[1]), tile=tiles[B],
                        tile_one_pair=tiles[1])
    print(f"kernel K2 one pair {H}x{N}: {times[1][0]:.5f} ms beside the launch floor "
          f"{launch_floor:.5f} ms (bound {times[1][2]['bound_ms']:.5f} ms)")

    # K4: the ORB slice's shapes (1024 keypoints, 256-bit descriptors)
    HB, HN, HW = 64, 1024, 8
    hq, ht, hmask = _binary_descriptors(HB, HN, HW, gen, dev)
    outs, times, errs = {}, {}, []
    for nb in (HB, 1):
        args = (hq[:nb], ht[:nb], hmask[:nb])
        kd, ki = fused_hamming_top2(*args)
        pd, pi = hamming_top2_plain(*args)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        col0 = bool(torch.equal(ki[..., 0], pi[..., 0]))
        # column 1: the lowest index other than column 0 at the runner-up
        # distance, as two argmin passes give it
        col1 = bool(torch.equal(ki[..., 1], pi[..., 1]))
        ties = float((pd[..., 0] == pd[..., 1]).float().mean())
        print(f"kernel K4 x{nb}: max|dist err| {err:.3g} (tol 0), column 0 equal {col0}, "
              f"column 1 equal {col1}, tied best/runner-up on {ties:.4f} of rows")
        # integer counts: the distances and both indices are exact
        _check(err == 0.0 and col0 and col1, f"K4 x{nb} disagrees with plain")
        bound = _bound_of(fused_hamming_top2, *args)
        times[nb] = (*measure(f"K4 x{nb}", fused_hamming_top2, hamming_top2_plain, args,
                              bound, plain_iters=3 if nb > 1 else 20), bound)
        outs[nb] = (kd, ki)
        errs.append(err)
    same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[HB]))
    print(f"kernel K4: one pair == its rows of the batch bit for bit: {same}")
    _check(same, "K4: one-pair launch differs from the batched one")
    report["K4"] = entry(max(errs), times[HB], times[1])
    phase_s["kernels"] = time.perf_counter() - t_phase

    # K1 at the shapes the SfM slices launch it at: a frame against the
    # landmark bank and the bank's cross-check (most bank rows are
    # unused early in a run: 90 % of the train rows masked), and the
    # 32-d synthetic sequences
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    report["K1_sfm"] = [
        _k1_case("frame->bank", 1, 256, 8192, 64, 0.9, gen, dev, measure),
        _k1_case("bank->frame", 1, 8192, 256, 64, 0.9, gen, dev, measure),
        _k1_case("D=32", 64, 256, 256, 32, 0.05, gen, dev, measure),
    ]
    # ... and at config 4's (one pair, 32-d): a frame against a submap's
    # 2,048-row bank, whose rows are 22 % valid on average when a frame is
    # associated (6-50 % over the run's 288 associations on an NVIDIA H100,
    # examples/probe_config4_torch.py), the bank's cross-check against the
    # frame, and frame to frame (the bootstrap, the previous frame); the
    # bootstrap's RANSAC at 128 hypotheses over 256 correspondences
    report["K1_config4"] = [
        _k1_case("config4 frame->bank", 1, 256, 2048, 32, 0.78, gen, dev, measure),
        _k1_case("config4 bank->frame", 1, 2048, 256, 32, 0.0, gen, dev, measure),
        _k1_case("config4 frame->frame", 1, 256, 256, 32, 0.0, gen, dev, measure),
    ]
    report["ransac_config4"] = _ransac_case("config4", 128, 256, gen, dev, measure)
    # ... and at the segment axis's: config 4's stand-in builds its 16
    # segments as one batch, the full-length run its 283: each K1 launch
    # of a frame step at B = S, the bootstrap's RANSAC at S·C = 4·S pairs
    report["K1_segments"], report["ransac_segments"] = [], []
    for S in SEG4_BATCHES:
        report["K1_segments"] += [
            _k1_case("segments frame->bank", S, 256, 2048, 32, 0.78, gen, dev, measure),
            _k1_case("segments bank->frame", S, 2048, 256, 32, 0.0, gen, dev, measure),
            _k1_case("segments frame->frame", S, 256, 256, 32, 0.0, gen, dev, measure),
        ]
        report["ransac_segments"].append(
            _ransac_case("segments", 128, 256, gen, dev, measure, P=4 * S))
    phase_s["k1sfm"] = time.perf_counter() - t_phase

    # K1 / K1b and K4 at widths other than the SURF and ORB ones: padded
    # up to a built width, or the new instances (D = 128, W = 16)
    t_phase = time.perf_counter()
    report["widths"] = _widths(dev, measure)
    phase_s["widths"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    # -- 4. the slices: the port's main paths -----------------------------------
    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.matching import match_descriptors_points
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    imgs, *_ = render_sequence(num_frames=2, num_landmarks=500, image_size=(993, 660),
                               seed=0)
    im1, im2 = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)

    cfg = named_config("ransac")
    pcfg = dataclasses.replace(cfg.matcher, compact=False)

    def run_surf(seed: int):
        res = two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(seed), cfg)
        # the bench head's matcher: query-order matches + matched points (K1b)
        d1 = extract_descriptors(im1, res.kps1, cfg.descriptor)
        d2 = extract_descriptors(im2, res.kps2, cfg.descriptor)
        m, mp = match_descriptors_points(d1, d2, res.kps2.xy.contiguous(), pcfg)
        return res, m, mp

    run_surf(0)                 # warm-up (cuDNN algorithm choice, allocator)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res, mq, mpts = run_surf(0)
    torch.cuda.synchronize()
    surf_launches = K.launch_counts()
    print(f"slice surf: launches on the main path {surf_launches}")
    surf_kernels = ("fused_l2_top2", "fused_l2_top2_points", "minimal_eight_point",
                    "ransac_score_hypotheses")
    _check(all(surf_launches[k] > 0 for k in surf_kernels),
           "a kernel of the SURF path never launched")
    _, n_m, _ = _check_estimate("surf", res, 1, 8)
    # match_descriptors_points: same matches as the pipeline's matcher, and
    # pts[i] == kps2.xy[train_idx[i]] on every row
    _check(int(mq.mask.sum()) == n_m, "match_descriptors_points disagrees")
    _check(bool(torch.equal(mpts, res.kps2.xy[mq.train_idx.long()])),
           "matched-point invariant broken")
    _gpu_vs_cpu("surf", im1, im2, cfg, res, dev)
    _time_pipeline("surf", im1, im2, cfg, dev)

    ocfg = named_config("orb")

    def run_orb(seed: int):
        return two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(seed),
                                 ocfg)

    run_orb(0)                  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res = run_orb(0)
    torch.cuda.synchronize()
    orb_launches = K.launch_counts()
    print(f"slice orb: launches on the main path {orb_launches}")
    orb_kernels = ("fused_hamming_top2", "minimal_eight_point", "ransac_score_hypotheses")
    _check(all(orb_launches[k] > 0 for k in orb_kernels),
           "a kernel of the ORB path never launched")
    _check(orb_launches["fused_l2_top2"] == 0, "the ORB path launched the L2 kernel")
    _check(res.kps1.capacity == ocfg.detector.max_keypoints, "ORB capacity")
    _check_estimate("orb", res, ocfg.detector.max_keypoints, 64)
    _gpu_vs_cpu("orb", im1, im2, ocfg, res, dev)
    _time_pipeline("orb", im1, im2, ocfg, dev)

    phase_s["slices"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    report["staged"] = _staged(dev, K)
    staged_ws1 = report["staged"].pop("ws1")
    phase_s["staged"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    report["pairs"] = _pairs(dev, K)
    phase_s["pairs"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    report["probes"] = _probes(dev, K, q, t, kF, p1, p2, pmask, launch_floor)
    phase_s["probes"] = time.perf_counter() - t_phase

    # -- 5. SfM: BASELINE config 3 (without loop closure), the JAX bench's
    # synthetic 32-d sequence, and sparse BA at the bench's size ---------------
    for phase, fn in (("sfm", lambda: _slice_sfm(dev, K)),
                      ("sfm32", lambda: _slice_sfm32(dev, K)),
                      ("segment_sum", lambda: _segment_sum(dev, parent_tree)),
                      ("ba", lambda: _ba_sparse(dev, K)),
                      ("pose_graph", lambda: _pose_graph(dev, K)),
                      ("ba_dense", lambda: _ba_dense(dev, K)),
                      ("all_pairs", lambda: _all_pairs(dev, K)),
                      ("ranks", lambda: _ranks(dev, K, staged_ws1)),
                      ("distributed", lambda: _distributed(dev, K)),
                      ("slam", lambda: _slam(dev, K, measure, (im1, im2), (q, t, t_mask),
                                             report["K1_f32"]))):
        t_phase = time.perf_counter()
        report[phase] = fn()
        phase_s[phase] = time.perf_counter() - t_phase
    print("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    # -- 6. result -----------------------------------------------------------
    src = "points_matching_tpu_torch/csrc/"
    pallas = "points_matching_tpu/ops/pallas/"
    probe = "benchmarks/probe/"
    report["K1_f32"]["sfm_shapes"] = report["K1_sfm"]
    report["K1_f32"]["config4_shapes"] = report["K1_config4"]
    report["K3"]["config4_one_pair"] = report["ransac_config4"]["K3"]
    report["K2"]["config4_one_pair"] = report["ransac_config4"]["K2"]
    report["K1_f32"]["segment_shapes"] = report["K1_segments"]
    report["K3"]["segment_pairs"] = [r["K3"] for r in report["ransac_segments"]]
    report["K2"]["segment_pairs"] = [r["K2"] for r in report["ransac_segments"]]
    report["K1_f32"]["slam_shapes"] = report["slam"].pop("K1")
    slam_ransac = report["slam"].pop("ransac")
    report["K3"]["slam_one_pair"] = slam_ransac["K3"]
    report["K2"]["slam_one_pair"] = slam_ransac["K2"]
    report["K1_f32"]["widths"] = report["widths"]["K1"]
    report["K4"]["widths"] = report["widths"]["K4"]
    all_pairs = report["all_pairs"]
    report["K1_f32"]["all_pairs"] = {k: all_pairs[k] for k in (
        "shape", "seconds", "pairs_per_s", "bound_s", "bound_by", "launches")}
    sfm_launches = report["sfm"].pop("launches")
    loop_launches = report["sfm"]["loop"].pop("launches")
    staged_launches = report["staged"].pop("launches")
    pairs_launches = report["pairs"].pop("launches")
    dist_launches = report["distributed"].pop("launches")
    slam_launches = report["slam"].pop("launches")
    probe_launches = report["probes"].pop("launches")
    ba_launches = report["ba"].pop("launches")
    ba_dense_launches = report["ba_dense"].pop("launches")
    pg_launches = report["pose_graph"].pop("launches")
    ranks_launches = report["ranks"].pop("launches")
    report["K1_f32"]["ring"] = report["ranks"]["ring"]

    def launches(name):
        by_path = dict(surf=surf_launches[name], orb=orb_launches[name],
                       sfm=sfm_launches[name], loop=loop_launches[name],
                       all_pairs=all_pairs["launches"] if name == "fused_l2_top2" else 0,
                       staged=staged_launches[name], pairs=pairs_launches[name],
                       distributed=dist_launches[name],
                       slam=slam_launches[name], probe=probe_launches[name],
                       ba=ba_launches[name], ba_dense=ba_dense_launches[name],
                       pose_graph=pg_launches[name], ranks=ranks_launches[name])
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    # the segmented sum on every path that runs a BA or a pose graph
    seg = launches("segment_sum")
    print(f"segment sum: launches on the main paths {seg['launches_by_path']}")
    for path in ("sfm", "loop", "distributed", "slam", "ba", "pose_graph"):
        _check(seg["launches_by_path"][path] > 0, f"{path}: the segmented sum never launched")
    seg_cases = report.pop("segment_sum")["cases"]
    seg_head = seg_cases[0]          # the ba sparse camera rows at W = 36

    kernels = [
        dict(name="fused_l2_top2", route="cuda", source=src + "matching_top2.cu",
             replaces=pallas + "matching_kernel.py:192",
             **launches("fused_l2_top2"), **report["K1_f32"],
             bf16={k: report["K1_bf16"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "ms_one_pair", "plain_ms_one_pair")}),
        dict(name="fused_l2_top2_points", route="cuda", source=src + "matching_top2.cu",
             replaces=pallas + "matching_kernel.py:275",
             **launches("fused_l2_top2_points"), **report["K1b"]),
        dict(name="ransac_score_hypotheses", route="cuda", source=src + "ransac_score.cu",
             replaces=pallas + "ransac_kernel.py:122",
             stands_for=probe + "score_variants.py variants nodiv, stacked, ostack (the "
                                "multiply gate with fp32 products: K2's function)",
             **launches("ransac_score_hypotheses"), **report["K2"]),
        dict(name="minimal_eight_point", route="cuda", source=src + "eightpoint.cu",
             replaces=pallas + "eightpoint_kernel.py:240",
             **launches("minimal_eight_point"), **report["K3"]),
        dict(name="fused_hamming_top2", route="cuda", source=src + "hamming_top2.cu",
             replaces=pallas + "hamming.py:115",
             **launches("fused_hamming_top2"), **report["K4"]),
        dict(name="gemm_rowmin", route="cuda", source=src + "probe_match.cu",
             replaces=probe + "match_variants.py:116",
             **launches("gemm_rowmin"), **report["probes"]["gemm_rowmin"]),
        dict(name="packed_top2", route="cuda", source=src + "probe_match.cu",
             replaces=probe + "match_variants.py:192",
             **launches("packed_top2"), **report["probes"]["packed_top2"]),
        dict(name="score_variant", route="cuda", source=src + "probe_score.cu",
             replaces=probe + "score_variants.py:238",
             also_replaces=probe + "score_variants.py:176",
             headline="multiply gate, bf16 x 3 products (split3, stack3, ostack3)",
             **launches("score_variant"), **report["probes"]["score_variant"]),
        dict(name="segment_sum", route="cuda", source=src + "segment_sum.cu",
             replaces="points_matching_tpu/ba/sparse.py:97",
             replaces_note="no pallas_call: the semantics of the reference's 'sorted' "
                           "observation layout (_sorted_ops, _sort_obs_by_landmark:143)",
             **seg, **{k: seg_head[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_unit",
                 "library_ms", "library_deterministic_ms")},
             max_abs_err_all=max(c["max_abs_err"] for c in seg_cases),
             library_calls="torch.index_add (atomics); library_deterministic_ms: "
                           "index_put_(accumulate=True) under deterministic algorithms",
             headline="ba sparse camera rows, W = 36", shapes=seg_cases),
    ]
    _check(all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels),
           "non-finite timing or a kernel that never launched")
    print("sfm: " + json.dumps({k: report[k] for k in ("sfm", "sfm32", "ba", "ba_dense",
                                                        "pose_graph", "all_pairs", "ranks",
                                                        "staged", "pairs", "distributed",
                                                        "slam")}))
    print("probes: " + json.dumps(report["probes"].pop("rows")))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
