#!/usr/bin/env python
"""Two-view demo CLI on the PyTorch + CUDA port (points_matching_tpu_torch):
loads two images, runs the two-view pipeline, prints the reference demo's
statistics and writes the three "windows" (keypoints / matches / epilines)
as PNGs (PNG output needs PIL).

Usage:
  python examples/two_view_demo_torch.py IMG1 IMG2 [--out OUT_DIR]
      [--config surf_parity|orb|ransac] [--device cuda|cpu] [--seed N]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import dataclasses
import sys


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img1")
    p.add_argument("img2")
    p.add_argument("--out", default="out_two_view")
    p.add_argument(
        "--config",
        default="ransac",
        choices=["surf_parity", "orb", "ransac"],
        help="surf_parity = reference semantics (midpoint filter, no RANSAC); "
        "ransac = SURF-class + ratio test + batched RANSAC; orb = BASELINE config 0 "
        "(FAST + rotated BRIEF + Hamming ratio match + RANSAC, 1024 keypoints)",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda raises when no CUDA device exists (no CPU fallback)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=None,
                   help="keypoint capacity (default: the configuration's own, "
                   "512 for the SURF configurations, 1024 for orb)")
    args = p.parse_args()

    import numpy as np

    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.pipelines.two_view import run_two_view_demo

    cfg = named_config(args.config)
    if args.max_keypoints is not None:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=args.max_keypoints))

    res = run_two_view_demo(args.img1, args.img2, cfg, out_dir=args.out, seed=args.seed,
                            device=args.device)
    print(f"keypoints: {int(res.kps1.mask.sum())} / {int(res.kps2.mask.sum())}")
    print(f"good matches: {int(res.matches.mask.sum())}")
    print(f"inliers: {int(res.estimate.num_inliers)}")
    print(f"mean |p1' F p2|: {float(res.estimate.residual_mean):.6e}")
    print(f"F =\n{np.asarray(res.estimate.F)}")
    print(f"wrote {args.out}/keypoints1.png keypoints2.png matches.png epilines.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
