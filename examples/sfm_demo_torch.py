#!/usr/bin/env python
"""Incremental SfM demo on the PyTorch + CUDA port (BASELINE config 3 shape,
without loop closure): the register → triangulate → local-BA loop of
``pipelines/sfm.py`` on a synthetic sideways trajectory of 32-d
descriptor-tagged landmarks, with the ATE against ground truth.

Usage:
  python examples/sfm_demo_torch.py [--frames N] [--landmarks L]
      [--features F] [--noise PX] [--device cuda|cpu] [--seed N]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--landmarks", type=int, default=400)
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--noise", type=float, default=0.3, help="pixel noise sigma")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda raises when no CUDA device exists (no CPU fallback)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
    from points_matching_tpu_torch.core.device import resolve_device
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm
    from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error

    dev = resolve_device(args.device)
    frames, K, gt_centers = make_tracked_sequence(
        args.frames, device=dev, num_landmarks=args.landmarks, yaw_step=0.015, t_step=0.25,
        noise=args.noise, num_features=args.features, seed=args.seed)

    cfg = SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=max(32, args.frames + 2),
        max_landmarks=4 * args.landmarks,
        max_observations=16 * args.landmarks,
    )

    t0 = time.time()
    res = run_incremental_sfm(frames, K, cfg, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    st = res.state
    n_reg = sum(res.registered)
    print(f"device: {dev}")
    print(f"frames registered: {n_reg}/{args.frames}")
    print(f"landmarks: {int(st.num_lms)}  observations: {int(st.num_obs)}")
    print(f"wall time: {dt:.2f}s ({args.frames / dt:.2f} frames/s, first call "
          "included: kernel build and allocator warm-up)")
    ate = absolute_trajectory_error(res.trajectory[: args.frames].cpu(), gt_centers)
    print(f"ATE rmse: {float(ate.rmse):.4f}  mean: {float(ate.mean):.4f}  "
          f"(scale {float(ate.scale):.3f})")
    return 0 if n_reg == args.frames else 1


if __name__ == "__main__":
    sys.exit(main())
