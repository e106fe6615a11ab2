#!/usr/bin/env python3
"""Drive the PyTorch port's two-view main paths once on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order, one line each; any failure exits non-zero before the
result line:

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
             K2 must equal their plain versions exactly.
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
5. result  — one JSON line of per-kernel numbers, then the last line
             ``{"ok": true, "device": {...}}``.

Bounds use the card's published peaks (NVIDIA H100 SXM data sheet): 3.35
TB/s of device memory and 67 TFLOP/s fp32, an FMA counted as two flops, so
33.5 T fp32 instructions/s.  Kernels built with ``--fmad=false`` (K2, K3)
execute one instruction per multiply or add.  Population counts (K4) retire
at 16 per clock per SM against 128 fp32 lanes (the CUDA programming guide's
throughput table for compute capability 9.0): 33.5e12 × 16/128 per second.

Imports nothing of JAX.  Writes no files besides the kernel build.
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

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12                 # an FMA is two flops
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
POPC_PER_S = FP32_INSTR_PER_S * 16 / 128


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Mean device milliseconds per call: `iters` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events.  The host's time to
    enqueue a call (the wrapper's checks and allocations, the ctypes call,
    some 20 µs) is not in it, so a kernel shorter than that is not hidden
    behind it; back-to-back kernels in a graph still cost a few µs each."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def _bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _elementwise_ops(fn, *args) -> int:
    """Scalar operations of a plain version written as elementwise tensor
    ops (K2, K3): the largest element count of each arithmetic,
    comparison or select op it dispatches.  Run on one sample or cell, it
    counts the kernel's per-item instructions, since the plain versions
    repeat the kernels' operation chains."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = {"add", "sub", "mul", "div", "reciprocal", "sqrt", "abs", "neg",
               "clamp_min", "clamp_max", "maximum", "minimum", "where", "isfinite",
               "gt", "lt", "ge", "le", "eq", "ne", "bitwise_and", "sum"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in counted:
                sizes = [x.numel() for x in (*args, out) if hasattr(x, "numel")]
                self.n += max(sizes)
            return out

    with Count() as c:
        fn(*args)
    return c.n


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


def main() -> int:
    import torch

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
    launch_floor = _graph_ms(lambda: one.add_(1))
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

    # -- 3. kernels against their plain versions -----------------------------
    # Each kernel runs at two shapes: the batched one (64 pairs, the bench
    # head's) and one pair, which is what the slices launch.  Kernel times
    # are CUDA-graph replays (`_graph_ms`), plain times CUDA events around
    # back-to-back calls (`_cuda_ms`).  No single PyTorch call computes any
    # of K1-K4 (a fused top-2 over L2 or Hamming distances, a batch of
    # Sampson-gated counts, a batch of rank-2 minimal 8-point solves), so
    # every library_ms is null.
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, D, H = 64, 512, 64, 512
    report = {}

    def measure(tag, kernel, plain, args, bound, plain_iters=20):
        ms = _graph_ms(lambda: kernel(*args))
        pms = _cuda_ms(lambda: plain(*args), iters=plain_iters,
                       warmup=1 if plain_iters < 20 else 3)
        print(f"kernel {tag}: {ms:.4f} ms vs plain {pms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        return ms, pms

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

    def k1_bound(nb, points=False):
        # q and t (f32), t_mask, dist (f32) and idx (i32), + t_points and
        # pts for K1b; one FMA per (query, train, dim) cell
        nbytes = 4 * nb * 2 * N * D + nb * N + 8 * nb * N * 2 + points * 4 * nb * N * 2 * 2
        return _bound(nbytes, 2 * nb * N * N * D, FP32_FLOPS_PER_S)

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
            bound = k1_bound(nb)
            times[nb] = (*measure(f"K1 {dtype} x{nb}", lambda *a: fused_l2_top2(
                *a, compute_dtype=dtype), lambda *a: l2_top2_plain(*a, compute_dtype=dtype),
                args, bound), bound)
            outs[nb] = (kd, ki)
            errs.append(err)
        # one pair alone gives that pair's rows of the batched launch, bit for bit
        same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[B]))
        print(f"kernel K1 {dtype}: one pair == its rows of the batch bit for bit: {same}")
        _check(same, f"K1 {dtype}: one-pair launch differs from the batched one")
        report[f"K1_{dtype}"] = entry(max(errs), times[B], times[1])

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
        bound = k1_bound(nb, points=True)
        times[nb] = (*measure(f"K1b x{nb}", fused_l2_top2_points, l2_top2_points_plain,
                              args, bound), bound)
        outs[nb] = (kd, ki, kp)
        errs.append(err)
    same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[B]))
    print(f"kernel K1b: one pair == its rows of the batch bit for bit: {same}")
    _check(same, "K1b: one-pair launch differs from the batched one")
    report["K1b"] = entry(max(errs), times[B], times[1])

    p1, p2, pmask = _scenes(B, N, gen, dev)
    # 8 distinct correspondences per hypothesis
    pick = torch.rand(B, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    sp1 = torch.gather(p1[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    sp2 = torch.gather(p2[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    # one instruction per scalar op (--fmad=false): counted on one sample
    per_sample = _elementwise_ops(minimal_eight_point_plain, sp1[:1, :1].cpu(),
                                  sp2[:1, :1].cpu())
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
        bound = _bound(nb * H * (2 * 8 * 2 + 9) * 4, nb * H * per_sample, FP32_INSTR_PER_S)
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

    per_cell = _elementwise_ops(ransac_score_plain, kF[:1, :1].cpu(), p1[:1, :1].cpu(),
                                p2[:1, :1].cpu(), pmask[:1, :1].cpu(), 1.5)
    times, errs = {}, []
    for nb in (B, 1):
        args = (kF[:nb], p1[:nb], p2[:nb], pmask[:nb], 1.5)
        kc = ransac_score_hypotheses(*args)
        pc = ransac_score_plain(*args)
        torch.cuda.synchronize()
        cdiff = int((kc - pc).abs().max())
        print(f"kernel K2 x{nb}: max|count diff| {cdiff} (tol 0), "
              f"max count {int(kc.max())}/{N} ({per_cell} fp32 ops per cell)")
        # same association order and --fmad=false: the same gates, every count equal
        _check(cdiff == 0 and int(kc.max()) > N // 2, f"K2 x{nb} disagrees with plain")
        bound = _bound(nb * H * (9 + 1) * 4 + nb * N * (2 * 2 * 4 + 1),
                       nb * H * N * per_cell, FP32_INSTR_PER_S)
        times[nb] = (*measure(f"K2 x{nb}", ransac_score_hypotheses, ransac_score_plain,
                              args, bound), bound)
        errs.append(float(cdiff))
    report["K2"] = entry(max(errs), times[B], times[1])

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
        bound = _bound(4 * nb * 2 * HN * HW + nb * HN + 8 * nb * HN * 2,
                       nb * HN * HN * HW, POPC_PER_S)
        times[nb] = (*measure(f"K4 x{nb}", fused_hamming_top2, hamming_top2_plain, args,
                              bound, plain_iters=3 if nb > 1 else 20), bound)
        outs[nb] = (kd, ki)
        errs.append(err)
    same = all(torch.equal(a, b[:1]) for a, b in zip(outs[1], outs[HB]))
    print(f"kernel K4: one pair == its rows of the batch bit for bit: {same}")
    _check(same, "K4: one-pair launch differs from the batched one")
    report["K4"] = entry(max(errs), times[HB], times[1])

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

    # -- 5. result -----------------------------------------------------------
    src = "points_matching_tpu_torch/csrc/"
    pallas = "points_matching_tpu/ops/pallas/"

    def launches(name):
        return dict(launches=surf_launches[name] + orb_launches[name],
                    launches_by_path=dict(surf=surf_launches[name],
                                          orb=orb_launches[name]))

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
             **launches("ransac_score_hypotheses"), **report["K2"]),
        dict(name="minimal_eight_point", route="cuda", source=src + "eightpoint.cu",
             replaces=pallas + "eightpoint_kernel.py:240",
             **launches("minimal_eight_point"), **report["K3"]),
        dict(name="fused_hamming_top2", route="cuda", source=src + "hamming_top2.cu",
             replaces=pallas + "hamming.py:115",
             **launches("fused_hamming_top2"), **report["K4"]),
    ]
    _check(all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels),
           "non-finite timing or a kernel that never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
