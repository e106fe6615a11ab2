#!/usr/bin/env python
"""Per-stage times and a torch.profiler summary of the PyTorch port's
two-view slice on one CUDA GPU: a rendered 993×660 pair, the demo's
``--config ransac`` settings (512 keypoints, 512 hypotheses) or, with
``--config orb``, BASELINE config 0 (FAST + rotated BRIEF + Hamming match,
1024 keypoints, 512 hypotheses).

Stages are timed on the host clock with a ``torch.cuda.synchronize()`` after
each (detect ×2, describe ×2, match, RANSAC, audit + epilines), median of
10 runs after a warm-up; then the whole pipeline, unprofiled; then
five pipeline runs under ``torch.profiler`` for the device-busy share and
the kernels that take the device time.

Usage:
  python examples/profile_two_view_torch.py [--config ransac|orb]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import subprocess
import sys
import time


ITERS = 10


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="ransac", choices=["ransac", "orb"])
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.geometry.fundamental import (
        compute_epilines, epipolar_residual_audit)
    from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.detect import detect_keypoints
    from points_matching_tpu_torch.ops.matching import match_descriptors, match_stats
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    dev = resolve_device("cuda")
    pin_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    cfg = named_config(args.config)
    print(f"config {args.config}: {cfg.detector.max_keypoints} keypoints, "
          f"{cfg.ransac.num_hypotheses} hypotheses")
    imgs, *_ = render_sequence(num_frames=2, num_landmarks=500, image_size=(993, 660),
                               seed=0)
    im1, im2 = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)

    def pipeline(seed):
        return two_view_pipeline(im1, im2, torch.Generator(device=dev).manual_seed(seed), cfg)

    for _ in range(3):
        pipeline(0)
    torch.cuda.synchronize()

    stages = {k: [] for k in ("detect x2", "describe x2", "match", "ransac", "audit")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for it in range(ITERS):
        k1, k2 = timed("detect x2", lambda: (detect_keypoints(im1, cfg.detector),
                                             detect_keypoints(im2, cfg.detector)))
        d1, d2 = timed("describe x2", lambda: (extract_descriptors(im1, k1, cfg.descriptor),
                                               extract_descriptors(im2, k2, cfg.descriptor)))

        def match():
            m = match_descriptors(d1, d2, cfg.matcher)
            match_stats(m)
            return m, *m.gather_points(k1, k2)

        m, p1, p2 = timed("match", match)
        gen = torch.Generator(device=dev).manual_seed(it)
        est = timed("ransac", lambda: ransac_fundamental(gen, p1, p2, m.mask, cfg.ransac))
        timed("audit", lambda: (epipolar_residual_audit(est.F, p1, p2, m.mask),
                                compute_epilines(p1, 1, est.F)))
    print("stage ms (median of %d): %s" % (ITERS, {
        k: round(float(np.median(v)), 3) for k, v in stages.items()}))

    total = []
    for it in range(ITERS):
        t0 = time.perf_counter()
        pipeline(it)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
    print(f"two_view_pipeline ms/pair: median {float(np.median(total)):.3f}, "
          f"runs {[round(x, 3) for x in total]}")

    runs = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(runs):
            pipeline(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    device = [e for e in ka if e.device_type.name == "CUDA"]   # kernels, memcpys, memsets
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3 / runs
    events = sum(e.count for e in device) / runs
    # the profiler slows the host side, so the busy share is taken against
    # the unprofiled pipeline time above
    print(f"profiled: wall {wall * 1e3 / runs:.3f} ms/pair; device time {dev_ms:.3f} "
          f"ms/pair in {events:.0f} device events; busy share of the unprofiled "
          f"pair {dev_ms / float(np.median(total)):.3f}")
    print(ka.table(sort_by="self_device_time_total", row_limit=25,
                   max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
