#!/usr/bin/env python
"""Incremental SfM demo on the PyTorch + CUDA port (BASELINE config 3 shape):
the register → triangulate → local-BA loop of ``pipelines/sfm.py`` on a
synthetic sideways trajectory of 32-d descriptor-tagged landmarks, with the
ATE against ground truth.  ``--loop-closure`` flies out and back instead,
then detects, verifies and closes the loops (``pipelines/loop_closure.py``)
and re-polishes with a global BA over all cameras.

Usage:
  python examples/sfm_demo_torch.py [--frames N] [--landmarks L]
      [--features F] [--noise PX] [--device cuda|cpu] [--seed N] [--loop-closure]
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
    p.add_argument("--loop-closure", action="store_true",
                   help="out-and-back trajectory + detect/verify/close loops")
    args = p.parse_args()

    import torch

    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
    from points_matching_tpu_torch.core.device import resolve_device
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm
    from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error

    dev = resolve_device(args.device)
    offsets = None
    if args.loop_closure:
        half = args.frames // 2
        offsets = list(range(half)) + list(range(half - 2, -2, -1))
        offsets = (offsets + [0] * args.frames)[: args.frames]
    frames, K, gt_centers = make_tracked_sequence(
        args.frames, device=dev, num_landmarks=args.landmarks, yaw_step=0.015, t_step=0.25,
        noise=args.noise, num_features=args.features, seed=args.seed, offsets=offsets)

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

    if args.loop_closure:
        from points_matching_tpu_torch.pipelines.loop_closure import close_loops
        from points_matching_tpu_torch.pipelines.sfm import camera_centers, local_bundle_adjust

        num_cams = int(st.num_cams)
        corrected, cands = close_loops(st.poses, num_cams, frames, K, cfg, seed=args.seed)
        n_ver = sum(c.verified for c in cands)
        print(f"loop candidates: {len(cands)}  verified: {n_ver}")
        traj2 = camera_centers(corrected, st.cam_mask)[: args.frames].cpu()
        ate2 = absolute_trajectory_error(traj2, gt_centers)
        print(f"ATE after loop closure: {float(ate2.rmse):.4f}")

        # standard SLAM backend order: pose-graph closure, then a global BA
        # re-polish (the pose graph alone discards landmark information)
        st2, _ = local_bundle_adjust(st.replace(poses=corrected), K, cfg, window=num_cams)
        traj3 = camera_centers(st2.poses, st2.cam_mask)[: args.frames].cpu()
        ate3 = absolute_trajectory_error(traj3, gt_centers)
        print(f"ATE after closure + global BA: {float(ate3.rmse):.4f}")
    return 0 if n_reg == args.frames else 1


if __name__ == "__main__":
    sys.exit(main())
