#!/usr/bin/env python3
"""Drive the PyTorch port's two-view main path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order, one line each; any failure exits non-zero before the
result line:

1. device  — ``nvidia-smi`` name and power limit; CUDA present; TF32 off.
2. build   — compile every CUDA kernel of the path from ``csrc/`` (nvcc,
             sm_90a) and report the seconds.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (64 pairs × 512 × 512 × 64 for K1/K1b,
             64 × 512 hypotheses × 512 points for K2, 64 × 512 samples for
             K3): errors, agreement, and CUDA-event times after a warm-up.
4. slice   — a rendered 993×660 pair through ``two_view_pipeline`` with the
             demo's ``--config ransac`` settings (512 keypoints, 512
             hypotheses) and ``match_descriptors_points``; the kernels'
             launch counters must rise; the output must be sane and agree
             with the same pipeline run on the CPU (plain versions) with
             the same RANSAC samples.
5. result  — one JSON line of per-kernel numbers, then the last line
             ``{"ok": true, "device": {...}}``.

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


def main() -> int:
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    built = _build.last_build
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built['seconds']:.2f} s, cached={built['cached']}) -> "
          f"{os.path.relpath(built['path'])}")

    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain, l2_top2_points_plain)
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        ransac_score_hypotheses, ransac_score_plain)

    # -- 3. kernels against their plain versions -----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, D, H = 64, 512, 64, 512
    report = {}

    q = torch.randn(B, N, D, generator=gen, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    t = torch.randn(B, N, D, generator=gen, device=dev)
    t = t / t.norm(dim=-1, keepdim=True)
    t_mask = torch.rand(B, N, generator=gen, device=dev) > 0.05
    # both dtypes: the kernel and the plain version round the same operands
    # and differ only in fp32 summation order (measured on the card: < 1e-6)
    for dtype, dist_tol in (("f32", 1e-5), ("bf16", 1e-5)):
        kd, ki = fused_l2_top2(q, t, t_mask, compute_dtype=dtype)
        pd, pi = l2_top2_plain(q, t, t_mask, compute_dtype=dtype)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
        idx_bad = int(((ki[..., 0] != pi[..., 0]) & ~tie).sum())
        ms = _cuda_ms(lambda: fused_l2_top2(q, t, t_mask, compute_dtype=dtype))
        pms = _cuda_ms(lambda: l2_top2_plain(q, t, t_mask, compute_dtype=dtype))
        print(f"kernel K1 {dtype}: max|dist err| {err:.3g} (tol {dist_tol:g}), "
              f"1-NN index mismatches off near-ties {idx_bad}, "
              f"{ms:.4f} ms vs plain {pms:.4f} ms")
        _check(err <= dist_tol and idx_bad == 0, f"K1 {dtype} disagrees with plain")
        report[f"K1_{dtype}"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    pts = torch.rand(B, N, 2, generator=gen, device=dev) * torch.tensor(
        [993.0, 660.0], device=dev)
    kd, ki, kp = fused_l2_top2_points(q, t, t_mask, pts)
    pd, pi, pp = l2_top2_points_plain(q, t, t_mask, pts)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    gathered = torch.gather(pts, 1, ki[..., :1].long().expand(-1, -1, 2))
    pts_exact = bool(torch.equal(kp, gathered))
    ms = _cuda_ms(lambda: fused_l2_top2_points(q, t, t_mask, pts))
    pms = _cuda_ms(lambda: l2_top2_points_plain(q, t, t_mask, pts))
    print(f"kernel K1b: max|dist err| {err:.3g} (tol 1e-05), "
          f"pts == t_points[idx] exactly: {pts_exact}, {ms:.4f} ms vs plain {pms:.4f} ms")
    _check(err <= 1e-5 and pts_exact, "K1b disagrees with plain")
    report["K1b"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    p1, p2, pmask = _scenes(B, N, gen, dev)
    # 8 distinct correspondences per hypothesis
    pick = torch.rand(B, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    sp1 = torch.gather(p1[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    sp2 = torch.gather(p2[:, None].expand(B, H, N, 2), 2,
                       pick[..., None].expand(B, H, 8, 2)).contiguous()
    kF = minimal_eight_point(sp1, sp2)
    pF = minimal_eight_point_plain(sp1, sp2)
    torch.cuda.synchronize()
    err = float((kF - pF).abs().max())
    finite = bool(torch.isfinite(kF).all())
    ms = _cuda_ms(lambda: minimal_eight_point(sp1, sp2))
    pms = _cuda_ms(lambda: minimal_eight_point_plain(sp1, sp2), iters=3, warmup=1)
    print(f"kernel K3: max|F err| {err:.3g} (tol 1e-05) over all {kF.shape[0] * kF.shape[1]} "
          f"samples, finite {finite}, {ms:.4f} ms vs plain {pms:.4f} ms")
    # the plain version is the kernel's chain in the kernel's operation order
    # (--fmad=false, IEEE sqrt and division): the two agree to the last bit
    # on the card, so every sample is held to 1e-5
    _check(finite and err <= 1e-5, "K3 disagrees with plain")
    report["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    kc = ransac_score_hypotheses(kF, p1, p2, pmask, 1.5)
    pc = ransac_score_plain(kF, p1, p2, pmask, 1.5)
    torch.cuda.synchronize()
    cdiff = int((kc - pc).abs().max())
    same = float((kc == pc).float().mean())
    ms = _cuda_ms(lambda: ransac_score_hypotheses(kF, p1, p2, pmask, 1.5))
    pms = _cuda_ms(lambda: ransac_score_plain(kF, p1, p2, pmask, 1.5))
    print(f"kernel K2: max|count diff| {cdiff} (tol 0), equal share {same:.4f}, "
          f"max count {int(kc.max())}/{N}, {ms:.4f} ms vs plain {pms:.4f} ms")
    # same association order and --fmad=false: the same gates, every count equal
    _check(cdiff == 0 and int(kc.max()) > N // 2, "K2 disagrees with plain")
    report["K2"] = dict(max_abs_err=float(cdiff), ms=ms, plain_ms=pms)

    # -- 4. the slice: the port's main path ------------------------------------
    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, surf_parity_config)
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.geometry.ransac import sample_minimal_points
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.matching import match_descriptors_points
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    cfg = dataclasses.replace(surf_parity_config(),
                              matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
                              ransac=RansacConfig(), use_ransac=True)
    imgs, *_ = render_sequence(num_frames=2, num_landmarks=500, image_size=(993, 660),
                               seed=0)
    im1, im2 = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)
    pcfg = dataclasses.replace(cfg.matcher, compact=False)

    def run(seed: int):
        res = two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(seed), cfg)
        # the bench head's matcher: query-order matches + matched points (K1b)
        d1 = extract_descriptors(im1, res.kps1, cfg.descriptor)
        d2 = extract_descriptors(im2, res.kps2, cfg.descriptor)
        m, mp = match_descriptors_points(d1, d2, res.kps2.xy.contiguous(), pcfg)
        return res, m, mp

    run(0)                      # warm-up (cuDNN algorithm choice, allocator)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res, mq, mpts = run(0)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"slice: launches on the main path {launches}")
    _check(all(v > 0 for v in launches.values()), "a kernel of the path never launched")

    n_kp1, n_kp2 = int(res.kps1.mask.sum()), int(res.kps2.mask.sum())
    n_m = int(res.matches.mask.sum())
    n_in = int(res.estimate.num_inliers)
    F = res.estimate.F.double().cpu()
    sv = torch.linalg.svdvals(F)
    print(f"slice: keypoints {n_kp1}/{n_kp2}, matches {n_m}, inliers {n_in}, "
          f"residual {float(res.estimate.residual_mean):.4g}, |F| {float(F.norm()):.6f}, "
          f"s3/s1 {float(sv[2] / sv[0]):.3g}")
    _check(n_kp1 > 0 and n_kp2 > 0, "no keypoints")
    _check(n_m >= 8, "fewer than 8 matches")
    _check(bool(torch.isfinite(F).all()) and abs(float(F.norm()) - 1.0) < 1e-4,
           "F not finite / not unit norm")
    _check(float(sv[2]) < 1e-4 * float(sv[0]), "F not rank 2")
    _check(2 * n_in >= n_m, "inliers below half the matches")
    _check(res.p1.shape == (512, 2) and res.epilines2.shape == (512, 3)
           and bool(torch.isfinite(res.epilines2).all()), "bad output shapes")
    # match_descriptors_points: same matches as the pipeline's matcher, and
    # pts[i] == kps2.xy[train_idx[i]] on every row
    _check(int(mq.mask.sum()) == n_m, "match_descriptors_points disagrees")
    _check(bool(torch.equal(mpts, res.kps2.xy[mq.train_idx.long()])),
           "matched-point invariant broken")

    # the same pair through the CPU (plain versions), same RANSAC samples
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
    print(f"slice: GPU vs CPU (kp1, matches, inliers) {g} vs {c}, |<F_gpu, F_cpu>| {cos:.6f}")
    _check(g[0] == c[0] and abs(g[1] - c[1]) <= max(2, c[1] // 50)
           and abs(g[2] - c[2]) <= max(2, c[2] // 20) and cos >= 0.99,
           "GPU and CPU runs of the slice disagree")

    torch.cuda.synchronize()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(i), cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"slice: two_view_pipeline 993x660 512 kp 512 hyp: "
          f"{float(np.median(times)):.3f} ms/pair (median of 5; runs {times})")

    # -- 5. result -----------------------------------------------------------
    src = "points_matching_tpu_torch/csrc/"
    pallas = "points_matching_tpu/ops/pallas/"
    kernels = [
        dict(name="fused_l2_top2", route="cuda", source=src + "matching_top2.cu",
             replaces=pallas + "matching_kernel.py:192",
             launches=launches["fused_l2_top2"], **report["K1_f32"],
             bf16={k: report["K1_bf16"][k] for k in ("max_abs_err", "ms", "plain_ms")}),
        dict(name="fused_l2_top2_points", route="cuda", source=src + "matching_top2.cu",
             replaces=pallas + "matching_kernel.py:275",
             launches=launches["fused_l2_top2_points"], **report["K1b"]),
        dict(name="ransac_score_hypotheses", route="cuda", source=src + "ransac_score.cu",
             replaces=pallas + "ransac_kernel.py:122",
             launches=launches["ransac_score_hypotheses"], **report["K2"]),
        dict(name="minimal_eight_point", route="cuda", source=src + "eightpoint.cu",
             replaces=pallas + "eightpoint_kernel.py:240",
             launches=launches["minimal_eight_point"], **report["K3"]),
    ]
    _check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite timing")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
