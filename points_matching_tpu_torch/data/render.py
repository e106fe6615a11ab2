"""Synthetic image-sequence renderer: a textured-landmark world projected
through a moving pinhole camera, written as a TUM-format directory.

Purpose: end-to-end pipeline validation (decode → detect → describe →
match → SfM → ATE) without external datasets — every landmark carries a
fixed random texture patch, so detection finds corners and descriptors are
discriminative across views (SURVEY.md §4 "Integration tests").
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def render_sequence(
    num_frames: int = 12,
    num_landmarks: int = 300,
    image_size: Tuple[int, int] = (640, 480),
    patch: int = 9,
    step: float = 0.25,
    yaw_step: float = 0.01,
    seed: int = 0,
    loop: bool = False,
    x_span: Tuple[float, float] = (-6.0, 6.0),
):
    """Render frames + ground truth.

    ``x_span`` sets the landmark cloud's lateral extent — widen it (roughly
    to ``(-6, 6 + step * max_offset)``) for long trajectories so the camera
    never runs out of visible structure.

    Returns (images [N, H, W] float32, positions [N, 3] camera centers,
    quats [N, 4] (x,y,z,w) cam-to-world, K tuple (fx, fy, cx, cy)).
    """
    rng = np.random.RandomState(seed)
    w, h = image_size
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0

    X = rng.uniform(
        [x_span[0], -4, 6], [x_span[1], 4, 16], (num_landmarks, 3)
    ).astype(np.float32)
    textures = 80.0 + 140.0 * rng.rand(num_landmarks, patch, patch).astype(np.float32)

    if loop:
        half = num_frames // 2
        offs = list(range(half)) + list(range(half - 2, -2, -1))
        offs = (offs + [0] * num_frames)[:num_frames]
    else:
        offs = list(range(num_frames))

    images = np.zeros((num_frames, h, w), np.float32)
    positions = np.zeros((num_frames, 3), np.float32)
    quats = np.zeros((num_frames, 4), np.float32)
    r = patch // 2
    for f, o in enumerate(offs):
        yaw = yaw_step * o
        R = np.asarray(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
            np.float32,
        )
        t = np.asarray([-step * o, 0.0, 0.0], np.float32)
        positions[f] = -(R.T @ t)
        # cam-to-world quaternion from R_wc = Rᵀ
        quats[f] = _rot_to_quat_one(R.T)

        img = 30.0 + 3.0 * rng.randn(h, w).astype(np.float32)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * np.asarray([fx, fy]) + np.asarray([cx, cy])
        order = np.argsort(-Xc[:, 2])  # far first → near landmarks overdraw
        for li in order:
            if Xc[li, 2] < 0.5:
                continue
            u, v = int(round(uv[li, 0])), int(round(uv[li, 1]))
            if not (r <= u < w - r and r <= v < h - r):
                continue
            img[v - r: v + r + 1, u - r: u + r + 1] = textures[li]
        images[f] = np.clip(img, 0, 255)
    return images, positions, quats, (fx, fy, cx, cy)


def _rot_to_quat_one(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R)
    qw = 0.5 * np.sqrt(max(1 + tr, 1e-12))
    qx = (R[2, 1] - R[1, 2]) / max(4 * qw, 1e-12)
    qy = (R[0, 2] - R[2, 0]) / max(4 * qw, 1e-12)
    qz = (R[1, 0] - R[0, 1]) / max(4 * qw, 1e-12)
    return np.asarray([qx, qy, qz, qw], np.float32)


def write_tum_format(out_dir: str, images, positions, quats, fps: float = 30.0):
    """Write a rendered sequence as a TUM RGB-D directory (rgb.txt +
    groundtruth.txt + rgb/*.png)."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    rgb_lines = ["# synthetic sequence"]
    gt_lines = ["# ground truth"]
    for i in range(len(images)):
        ts = 1000.0 + i / fps
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(images[i].astype(np.uint8)).save(os.path.join(out_dir, name))
        rgb_lines.append(f"{ts:.6f} {name}")
        p, q = positions[i], quats[i]
        gt_lines.append(
            f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines))
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines))


def write_kitti_format(root: str, images, positions, quats, K, sequence: str = "00",
                       camera: int = 0, fps: float = 10.0):
    """Write a rendered sequence as a KITTI odometry tree:
    ``sequences/<seq>/image_<cam>/%06d.png``, ``sequences/<seq>/calib.txt``
    (``P<cam>`` carrying ``K`` = (fx, fy, cx, cy)), ``sequences/<seq>/times.txt``
    at ``fps`` and ``poses/<seq>.txt`` (3×4 camera-to-world a line)."""
    from PIL import Image

    from points_matching_tpu_torch.data.datasets import _quat_to_rot

    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, f"image_{camera}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i in range(len(images)):
        Image.fromarray(images[i].astype(np.uint8)).save(os.path.join(img_dir, f"{i:06d}.png"))
    fx, fy, cx, cy = K
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(f"P{camera}: {fx:.12e} 0 {cx:.12e} 0 0 {fy:.12e} {cy:.12e} 0 0 0 1 0\n")
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(f"{i / fps:.6e}" for i in range(len(images))) + "\n")
    R = _quat_to_rot(np.asarray(quats, np.float64))
    P = np.concatenate([R, np.asarray(positions, np.float64)[:, :, None]], -1)
    with open(os.path.join(root, "poses", f"{sequence}.txt"), "w") as f:
        f.write("\n".join(" ".join(f"{v:.12e}" for v in row.ravel()) for row in P) + "\n")
