"""Sequence SLAM on data from disk (BASELINE configs 3-4) — the body of
``examples/slam_demo_torch.py``, the counterpart of the JAX package's
``examples/slam_demo.py``.

A ``SequenceData`` (``data/datasets.load_tum_sequence`` /
``load_kitti_sequence``) → batch decode on the host (``data/images.load_batch``)
→ Hessian detection + SURF description on the device, frame by frame →
incremental SfM (``pipelines/sfm.run_incremental_sfm``) → optional loop
closure (``pipelines/loop_closure.close_loops``) → ATE against the ground
truth → optional checkpoint of the map (``utils/checkpoint``).  With
``distributed``, the frames go through ``run_distributed_slam`` instead: in
one process without a mesh, or under ``torchrun`` on a data × model mesh of
all ranks.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from points_matching_tpu_torch.core.config import (
    DetectorConfig,
    MatcherConfig,
    RansacConfig,
    SfMConfig,
    TwoViewConfig,
)
from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
from points_matching_tpu_torch.data import native
from points_matching_tpu_torch.data.datasets import SequenceData
from points_matching_tpu_torch.data.images import load_batch
from points_matching_tpu_torch.ops.descriptors import extract_descriptors
from points_matching_tpu_torch.ops.detect import detect_keypoints
from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error
from points_matching_tpu_torch.utils.logging import get_logger
from points_matching_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class SlamRun:
    numbers: Dict[str, Any]     # what the demo prints as its JSON line
    result: Any                 # SfMResult, or DistributedSlamResult
    frames: List[tuple]         # (kps_xy, desc, mask) a frame, on the device
    trajectory: np.ndarray      # [C, 3] camera centres (after loop closure)


def slam_config(features: int, num_frames: int) -> SfMConfig:
    """The demo's SfM settings (``examples/slam_demo.py``)."""
    return SfMConfig(
        two_view=TwoViewConfig(
            detector=DetectorConfig(kind="hessian", threshold=400.0, max_keypoints=features),
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=max(16, num_frames + 2),
        max_landmarks=64 * features,
        max_observations=256 * features,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ate(est: np.ndarray, gt: np.ndarray, ok: np.ndarray) -> Optional[float]:
    """ATE rmse after a Sim(3) alignment over the rows with ground truth."""
    if ok.sum() < 3:
        return None
    return float(absolute_trajectory_error(
        torch.as_tensor(est, dtype=torch.float32), torch.as_tensor(np.nan_to_num(gt),
                                                                   dtype=torch.float32),
        mask=torch.as_tensor(ok)).rmse)


def _extent(gt: np.ndarray) -> Optional[float]:
    ok = np.isfinite(gt).all(axis=-1)
    if ok.sum() < 2:
        return None
    g = gt[ok]
    return float(np.linalg.norm(g.max(0) - g.min(0)))


def run_slam_demo(
    seq: SequenceData,
    *,
    device="cuda",
    features: int = 512,
    loop_closure: bool = False,
    checkpoint_dir: Optional[str] = None,
    ba_every: int = 4,
    distributed: bool = False,
    segment_len: int = 16,
    overlap: int = 4,
    seed: int = 0,
    verbose: bool = True,
) -> SlamRun:
    """Run the demo's path on ``seq``, on the CUDA device unless
    ``device="cpu"`` is asked (raises where CUDA is missing), and return its
    numbers (seconds on the host clock; device work synchronized before
    each reading)."""
    dev = resolve_device(device)
    pin_fp32()
    log = get_logger("slam")
    log.disabled = not verbose
    n = len(seq)
    out: Dict[str, Any] = dict(frames=n, device=str(dev))

    with stage("slam.decode"):
        t0 = time.perf_counter()
        images = load_batch(seq.image_paths)
        out["decode_s"] = time.perf_counter() - t0
    out["decoder"] = "native" if native.image_info(seq.image_paths[0]) is not None else "pil"
    out["image_size"] = [int(images.shape[2]), int(images.shape[1])]
    log.info("decoded %d frames in %.2fs (%s)", n, out["decode_s"], out["decoder"])

    cfg = slam_config(features, n)
    frames = []
    with stage("slam.frontend"):
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(n):
            img = torch.from_numpy(images[i]).to(dev)
            kps = detect_keypoints(img, cfg.two_view.detector)
            d = extract_descriptors(img, kps, cfg.two_view.descriptor)
            frames.append((kps.xy.contiguous(), d.data.contiguous(), d.mask))
        counts = torch.stack([f[2].sum() for f in frames]).cpu().numpy()
        dt = time.perf_counter() - t0
    out.update(frontend_ms_per_frame=dt / n * 1e3, features_min=int(counts.min()),
               features_median=float(np.median(counts)))
    log.info("features: %.2fs (%.1f ms a frame), %d-%d a frame", dt, dt / n * 1e3,
             counts.min(), counts.max())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if distributed:
        run = _run_distributed(seq, frames, cfg, dev, segment_len, overlap, seed, out, log)
    else:
        run = _run_sfm(seq, frames, cfg, dev, ba_every, loop_closure, seed, out, log)
        if checkpoint_dir:
            from points_matching_tpu_torch.utils.checkpoint import CheckpointManager

            with stage("slam.checkpoint"):
                t0 = time.perf_counter()
                with CheckpointManager(checkpoint_dir) as mgr:
                    mgr.save(n, run.result.state)
                out["checkpoint_s"] = time.perf_counter() - t0
                out["checkpoint_step"] = n
            log.info("checkpointed map state to %s", checkpoint_dir)
    if dev.type == "cuda":
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return run


def _run_sfm(seq, frames, cfg, dev, ba_every, loop_closure, seed, out, log) -> SlamRun:
    from points_matching_tpu_torch.pipelines.sfm import camera_centers, run_incremental_sfm

    n = len(seq)
    with stage("slam.sfm"):
        t0 = time.perf_counter()
        res = run_incremental_sfm(frames, seq.K, cfg, seed=seed, ba_every=ba_every)
        _sync(dev)
        dt = time.perf_counter() - t0
    n_reg = sum(res.registered)
    out.update(sfm_s=dt, sfm_frames_per_s=n / dt, registered=n_reg,
               landmarks=int(res.state.num_lms), observations=int(res.state.num_obs))
    log.info("registered %d/%d frames in %.2fs (%.2f frames/s)", n_reg, n, dt, n / dt)

    # camera slots are compact over REGISTERED frames: slot k ↔ the k-th
    # frame with registered=True; align ground truth accordingly
    reg_idx = [i for i, r in enumerate(res.registered) if r]
    gt = seq.gt_positions[reg_idx]
    gt_ok = np.isfinite(gt).all(axis=-1)
    out["extent"] = _extent(seq.gt_positions)
    traj = res.trajectory[: len(reg_idx)].cpu().numpy()
    out["ate"] = out["ate_before_closure"] = _ate(traj, gt, gt_ok)
    if loop_closure:
        from points_matching_tpu_torch.pipelines.loop_closure import close_loops

        with stage("slam.loop_closure"):
            t0 = time.perf_counter()
            # camera slot k holds the k-th registered frame, so the frames go
            # in that order (the JAX demo passes every frame, which shifts the
            # pairing after the first frame that did not register)
            corrected, cands = close_loops(res.state.poses, int(res.state.num_cams),
                                           [frames[i] for i in reg_idx], seq.K, cfg, seed=seed)
            traj = camera_centers(corrected, res.state.cam_mask)[: len(reg_idx)].cpu().numpy()
            out["close_loops_s"] = time.perf_counter() - t0
        out.update(loop_candidates=len(cands), loops_verified=sum(c.verified for c in cands))
        out["ate"] = _ate(traj, gt, gt_ok)
        log.info("loops: %d candidates, %d verified", len(cands), out["loops_verified"])
    if out["ate"] is None:
        log.info("no ground truth — skipping ATE")
    else:
        log.info("ATE rmse: %.4f (Sim3-aligned, %d poses)", out["ate"], int(gt_ok.sum()))
    return SlamRun(numbers=out, result=res, frames=frames, trajectory=traj)


def _data_size(world: int, n_seg: int) -> int:
    """The mesh's data size: the largest that divides both the ranks and the
    segment count (the rest go to the model axis), as the JAX demo picks."""
    for d in range(min(world, n_seg), 0, -1):
        if n_seg % d == 0 and world % d == 0:
            return d
    return 1


def _run_distributed(seq, frames, cfg, dev, segment_len, overlap, seed, out, log) -> SlamRun:
    """Submap-parallel path: one process without a mesh, or under
    ``torchrun`` (``WORLD_SIZE`` > 1) every rank on a data × model mesh."""
    from points_matching_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        axis_size,
        initialize_distributed,
        make_mesh,
    )
    from points_matching_tpu_torch.pipelines.distributed_slam import run_distributed_slam

    kps = torch.stack([f[0] for f in frames])
    dsc = torch.stack([f[1] for f in frames])
    msk = torch.stack([f[2] for f in frames])
    world = int(os.environ.get("WORLD_SIZE", "1"))
    stride = segment_len - overlap
    n_seg = (len(frames) - overlap) // stride
    mesh = None
    if world > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            initialize_distributed(device=dev.type)
        n_data = _data_size(world, n_seg)
        mesh = make_mesh((n_data, world // n_data), (DATA_AXIS, MODEL_AXIS))
    n_model = axis_size(mesh, MODEL_AXIS)
    out.update(world_size=world, mesh=[axis_size(mesh, DATA_AXIS), n_model], segments=n_seg,
               segment_len=segment_len, overlap=overlap)
    log.info("mesh %s, %d segments (len %d, overlap %d)", out["mesh"], n_seg, segment_len,
             overlap)
    features = frames[0][1].shape[0]
    cfg = dataclasses.replace(
        cfg, max_cameras=segment_len,
        local_ba_window=min(cfg.local_ba_window, segment_len),
        max_landmarks=-(-8 * features // n_model) * n_model,
        max_observations=32 * features,
    )
    with stage("slam.distributed"):
        t0 = time.perf_counter()
        res = run_distributed_slam(kps, dsc, msk, seq.K, config=cfg, mesh=mesh,
                                   segment_len=segment_len, overlap=overlap, seed=seed)
        _sync(dev)
        dt = time.perf_counter() - t0
    n_frames = len(res.cam_valid)
    out.update(distributed_s=dt, distributed_frames_per_s=n_frames / dt,
               cameras=n_frames, cameras_valid=int(res.cam_valid.sum()),
               registered=int(res.registered_per_segment.sum()),
               registered_slots=int(res.registered_per_segment.size),
               stage_seconds=res.stage_seconds)
    if res.ba_stats is not None:
        out.update(ba_initial_cost=float(res.ba_stats.initial_cost),
                   ba_final_cost=float(res.ba_stats.final_cost),
                   ba_iterations=int(res.ba_stats.iterations))
    log.info("distributed SLAM: %d frames in %.2fs (%.2f frames/s), %d/%d valid", n_frames,
             dt, n_frames / dt, out["cameras_valid"], n_frames)
    gt = seq.gt_positions[:n_frames]
    out["extent"] = _extent(gt)
    out["ate"] = _ate(res.trajectory, gt, np.isfinite(gt).all(axis=-1) & res.cam_valid)
    if out["ate"] is not None:
        log.info("ATE rmse: %.4f (Sim3-aligned)", out["ate"])
    return SlamRun(numbers=out, result=res, frames=frames,
                   trajectory=np.asarray(res.trajectory))
