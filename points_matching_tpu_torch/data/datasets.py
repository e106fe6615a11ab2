"""Dataset loaders: TUM RGB-D and KITTI odometry formats (BASELINE
configs 3-4: "100-frame TUM fr1 sequence", "KITTI 00 full sequence") —
port of ``points_matching_tpu/data/datasets.py``.

Parsing and ground-truth association only; images are decoded by
``data/images.load_batch``.  The host arrays (timestamps, ground-truth
centres and quaternions) are numpy float64, as in the JAX package; the
intrinsics and the ground-truth poses are float32 tensors on the device the
caller names.  Quaternions follow TUM's (qx, qy, qz, qw) order; ground truth
is camera-to-world (R_wc, C), and ``world_to_camera_poses`` gives the
world→camera ``Pose`` the pipelines use.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose


@dataclasses.dataclass
class SequenceData:
    """A monocular sequence with ground truth.

    image_paths: per-frame file paths.
    timestamps:  [N] float64 seconds.
    gt_positions: [N, 3] camera centers (world), NaN when unassociated.
    gt_quats:    [N, 4] (qx, qy, qz, qw) camera-to-world, NaN likewise.
    K:           intrinsics (dataset defaults unless calib present), float32
                 scalars on the loader's device.
    """

    image_paths: List[str]
    timestamps: np.ndarray
    gt_positions: np.ndarray
    gt_quats: np.ndarray
    K: CameraIntrinsics

    def __len__(self) -> int:
        return len(self.image_paths)

    def world_to_camera_poses(self, *, device) -> Pose:
        """Ground-truth world→camera Pose batch (identity where NaN), float32
        on ``device``."""
        R_wc = _quat_to_rot(np.nan_to_num(self.gt_quats, nan=0.0))
        # fix invalid rows to identity
        bad = ~np.isfinite(self.gt_quats).all(axis=-1)
        R_wc[bad] = np.eye(3)
        C = np.nan_to_num(self.gt_positions, nan=0.0)
        R_cw = np.swapaxes(R_wc, -1, -2)
        t = -np.einsum("nij,nj->ni", R_cw, C)
        return Pose(R=torch.as_tensor(R_cw, dtype=torch.float32, device=device),
                    t=torch.as_tensor(t, dtype=torch.float32, device=device))


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) → rotation matrices, batched; zero quats → identity."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 1e-12, 2.0 / np.maximum(n, 1e-12), 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    R = np.stack(
        [
            1 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1 - (xx + yy),
        ],
        axis=-1,
    ).reshape(q.shape[:-1] + (3, 3))
    ident = np.broadcast_to(np.eye(3), R.shape).copy()
    return np.where((n > 1e-12)[..., None, None], R, ident)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrices → (qx, qy, qz, qw), batched, numerically safe."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = 0.5 * np.sqrt(np.maximum(1 + tr, 1e-12))
    qx = (R[..., 2, 1] - R[..., 1, 2]) / np.maximum(4 * qw, 1e-12)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / np.maximum(4 * qw, 1e-12)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / np.maximum(4 * qw, 1e-12)
    return np.stack([qx, qy, qz, qw], axis=-1)


# TUM RGB-D freiburg1 default intrinsics (fr1: 517.3 516.5 318.6 255.3).
TUM_FR1_K = (517.3, 516.5, 318.6, 255.3)
# KITTI odometry sequences 00-02, camera 0 (P0 of their calib.txt)
KITTI_00_K = (718.856, 718.856, 607.1928, 185.2157)


def _intrinsics(fx, fy, cx, cy, device) -> CameraIntrinsics:
    return CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32, device=device)
                              for v in (fx, fy, cx, cy)))


def _parse_tum_list(path: str) -> List[Tuple[float, List[str]]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def load_tum_sequence(
    root: str,
    max_frames: Optional[int] = None,
    max_dt: float = 0.02,
    intrinsics: Tuple[float, float, float, float] = TUM_FR1_K,
    *,
    device,
) -> SequenceData:
    """TUM RGB-D layout: ``rgb.txt`` (+ optional ``groundtruth.txt``).

    Ground truth is associated to each frame by nearest timestamp within
    ``max_dt`` seconds (the TUM association rule); frames without a match
    get NaN ground truth.  ``K`` is put on ``device``.
    """
    rgb = _parse_tum_list(os.path.join(root, "rgb.txt"))
    if max_frames:
        rgb = rgb[:max_frames]
    ts = np.asarray([r[0] for r in rgb])
    paths = [os.path.join(root, r[1][0]) for r in rgb]

    n = len(rgb)
    pos = np.full((n, 3), np.nan)
    quat = np.full((n, 4), np.nan)
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt = _parse_tum_list(gt_path)
        gt_ts = np.asarray([g[0] for g in gt])
        gt_vals = np.asarray([[float(v) for v in g[1][:7]] for g in gt])
        idx = np.searchsorted(gt_ts, ts)
        idx = np.clip(idx, 1, len(gt_ts) - 1)
        left, right = gt_ts[idx - 1], gt_ts[idx]
        use_left = np.abs(ts - left) < np.abs(ts - right)
        best = np.where(use_left, idx - 1, idx)
        dt = np.abs(gt_ts[best] - ts)
        ok = dt <= max_dt
        pos[ok] = gt_vals[best[ok], 0:3]
        quat[ok] = gt_vals[best[ok], 3:7]

    return SequenceData(image_paths=paths, timestamps=ts, gt_positions=pos,
                        gt_quats=quat, K=_intrinsics(*intrinsics, device))


def load_kitti_sequence(
    root: str,
    sequence: str = "00",
    camera: int = 0,
    max_frames: Optional[int] = None,
    *,
    device,
) -> SequenceData:
    """KITTI odometry layout: ``sequences/<seq>/image_<cam>/*.png``,
    ``sequences/<seq>/calib.txt`` (P0..P3), ``sequences/<seq>/times.txt``
    and ``poses/<seq>.txt`` (3×4 camera-to-world per line), all but the
    images optional.  ``K`` is put on ``device``."""
    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, f"image_{camera}")
    names = sorted(os.listdir(img_dir))
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(img_dir, n) for n in names]

    # calib: line "P0: fx 0 cx tx 0 fy cy ty 0 0 1 tz"
    fx, fy, cx, cy = KITTI_00_K
    calib = os.path.join(seq_dir, "calib.txt")
    if os.path.exists(calib):
        with open(calib) as f:
            for line in f:
                if line.startswith(f"P{camera}:"):
                    v = [float(x) for x in line.split()[1:]]
                    fx, cx, fy, cy = v[0], v[2], v[5], v[6]

    ts = np.arange(len(paths), dtype=np.float64) * 0.1
    tfile = os.path.join(seq_dir, "times.txt")
    if os.path.exists(tfile):
        with open(tfile) as f:
            all_ts = np.asarray([float(x) for x in f.read().split()])
        ts = all_ts[: len(paths)]

    n = len(paths)
    pos = np.full((n, 3), np.nan)
    quat = np.full((n, 4), np.nan)
    poses_file = os.path.join(root, "poses", f"{sequence}.txt")
    if os.path.exists(poses_file):
        P = np.loadtxt(poses_file).reshape(-1, 3, 4)[:n]
        pos[: len(P)] = P[:, :, 3]
        quat[: len(P)] = _rot_to_quat(P[:, :, :3])

    return SequenceData(image_paths=paths, timestamps=ts, gt_positions=pos,
                        gt_quats=quat, K=_intrinsics(fx, fy, cx, cy, device))
