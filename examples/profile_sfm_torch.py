#!/usr/bin/env python
"""Where the time of the PyTorch port's incremental SfM goes, on one CUDA GPU:
BASELINE config 3's rendered sequence (512 × 384, 900 landmarks, an
out-and-back trajectory; Hessian threshold 100 + SURF, 256 keypoints) through
``run_incremental_sfm`` (128 cameras / 8,192 landmarks / 65,536
observations, ``ba_every=4``, ``chunk_size=16``), as ``chip_smoke.py``'s
``slice sfm`` runs it.

Three runs after a warm-up:
1. the host-device synchronizations, counted with CUDA's sync debug mode
   and attributed to the line of the port that made each one;
2. the run unprofiled (host clock, ``synchronize`` at the end);
3. the run under ``torch.profiler``: host time per stage (the
   ``sfm.associate`` / ``sfm.pnp`` / ``sfm.map_update`` / ``sfm.local_ba``
   ranges of ``pipelines/sfm.py``), device time, and the device-busy share
   against the unprofiled run.

Usage:
  python examples/profile_sfm_torch.py [--frames 100]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import collections
import subprocess
import sys
import time
import traceback
import warnings

PKG = "points_matching_tpu_torch"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=100)
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from points_matching_tpu_torch.core.config import (
        DescriptorConfig, DetectorConfig, MatcherConfig, RansacConfig, SfMConfig,
        TwoViewConfig)
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.detect import detect_keypoints
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm

    dev = resolve_device("cuda")
    pin_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    n, step = args.frames, 0.25
    imgs, _, _, (fx, fy, cx, cy) = render_sequence(
        num_frames=n, num_landmarks=900, image_size=(512, 384), seed=0, loop=True,
        step=step, x_span=(-6.0, 6.0 + step * (n // 2 - 1)))
    dcfg = DetectorConfig(kind="hessian", threshold=100.0, max_keypoints=256)
    frames = []
    for im in imgs:
        g = torch.from_numpy(np.ascontiguousarray(im)).to(dev)
        kp = detect_keypoints(g, dcfg)
        d = extract_descriptors(g, kp, DescriptorConfig(kind="surf"))
        frames.append((kp.xy.contiguous(), d.data.contiguous(), kp.mask & d.mask))
    K = CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32, device=dev)
                           for v in (fx, fy, cx, cy)))
    cfg = SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=128, max_landmarks=8192, max_observations=65536)

    def run():
        return run_incremental_sfm(frames, K, cfg, seed=0, ba_every=4, chunk_size=16)

    run_incremental_sfm(frames[:6], K, cfg, seed=0)
    torch.cuda.synchronize()

    # 1. synchronizations, by the line of the port that made them
    sources = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if PKG in f.filename]
        where = ours[-1] if ours else traceback.extract_stack()[-3]
        sources[f"{where.filename.split(PKG + '/')[-1]}:{where.lineno} ({where.name})"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    total = sum(sources.values())
    print(f"host syncs: {total} in {n} frames ({total / n:.2f} a frame); "
          f"registered {sum(res.registered)}/{n}")
    for where, c in sources.most_common():
        print(f"  {c:5d}  {where}")

    # 2. unprofiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"unprofiled: {wall:.3f} s for {n} frames, {n / wall:.2f} frames/s")

    # 3. profiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    ka = prof.key_averages()
    # kernels, copies and fills (the sfm.* ranges also show up as device
    # rows, spanning their kernels; they are not counted again)
    device = [e for e in ka if e.device_type.name == "CUDA" and not e.key.startswith("sfm.")]
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3
    events = sum(e.count for e in device)
    print(f"profiled: {pwall:.3f} s; device time {dev_ms:.1f} ms in {events} device "
          f"events ({events / n:.0f} a frame); busy share of the unprofiled run "
          f"{dev_ms / 1e3 / wall:.4f}")
    for e in ka:
        if e.key.startswith("sfm.") and e.cpu_time_total > 0:
            print(f"  {e.key}: {e.count} calls, host {e.cpu_time_total / 1e3:.1f} ms "
                  f"({e.cpu_time_total / 1e3 / e.count:.3f} ms a call, profiled)")
    print(ka.table(sort_by="self_device_time_total", row_limit=20,
                   max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
