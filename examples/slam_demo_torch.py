#!/usr/bin/env python
"""Sequence SLAM/SfM on data from disk with the PyTorch + CUDA port
(BASELINE configs 3-4 entry point): a TUM RGB-D or KITTI odometry directory
→ batch decode → Hessian/SURF on the card → incremental SfM (+ optional
loop closure) → ATE against the ground truth; or, with ``--distributed``,
submap-parallel SLAM (``run_distributed_slam``).  Prints one JSON line of
the run's numbers and exits 1 when a frame did not register.

Usage:
  python examples/slam_demo_torch.py --tum  /path/to/rgbd_dataset_freiburg1_xyz [--frames 100]
  python examples/slam_demo_torch.py --kitti /path/to/kitti_odometry --seq 00 [--frames 200]
      [--features 512] [--loop-closure] [--checkpoint-dir DIR] [--ba-every 4]
      [--device cuda|cpu]
  python examples/slam_demo_torch.py --kitti ROOT --distributed [--segment-len 16] [--overlap 4]
  torchrun --nproc-per-node N examples/slam_demo_torch.py --kitti ROOT --distributed
      (every rank on a data × model mesh; CUDA rank r on cuda:LOCAL_RANK)
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--tum", help="TUM RGB-D sequence directory")
    g.add_argument("--kitti", help="KITTI odometry root directory")
    p.add_argument("--seq", default="00", help="KITTI sequence id")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--features", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda raises when no CUDA device exists (no CPU fallback)")
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the final map state here (utils/checkpoint)")
    p.add_argument("--ba-every", type=int, default=4)
    p.add_argument("--distributed", action="store_true",
                   help="submap-parallel SLAM (under torchrun: segments over the "
                        "mesh's data axis, the global BA over its model axis)")
    p.add_argument("--segment-len", type=int, default=16)
    p.add_argument("--overlap", type=int, default=4)
    args = p.parse_args()

    import torch

    from points_matching_tpu_torch.core.device import resolve_device
    from points_matching_tpu_torch.data.datasets import load_kitti_sequence, load_tum_sequence
    from points_matching_tpu_torch.pipelines.slam import run_slam_demo

    device = args.device
    if args.distributed and device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(device)            # raises when CUDA is asked and missing
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if args.tum:
        seq = load_tum_sequence(args.tum, max_frames=args.frames, device=device)
    else:
        seq = load_kitti_sequence(args.kitti, args.seq, max_frames=args.frames, device=device)

    run = run_slam_demo(seq, device=device, features=args.features,
                        loop_closure=args.loop_closure, checkpoint_dir=args.checkpoint_dir,
                        ba_every=args.ba_every, distributed=args.distributed,
                        segment_len=args.segment_len, overlap=args.overlap)
    nums = run.numbers
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(nums))
    if args.distributed:
        return 0 if nums["cameras_valid"] == nums["cameras"] else 1
    return 0 if nums["registered"] == nums["frames"] else 1


if __name__ == "__main__":
    sys.exit(main())
