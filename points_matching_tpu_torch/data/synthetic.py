"""Synthetic two-view / multi-view scenes for tests and the card's runs —
port of ``points_matching_tpu/data/synthetic.py``.

The JAX generators draw from a PRNG key; these draw from a
``torch.Generator`` (``make_two_view_scene``, ``make_ba_problem``) with the
same distributions, so the scenes are alike but not equal.
``make_sparse_ba_problem`` is numpy with a seed in both packages and gives
the same problem to f32 rounding.  ``make_tracked_sequence`` is the
synthetic SfM sequence of tests/test_sfm.py and the JAX bench's ``sfm``
section, in numpy with the same draws, and ``make_stacked_sequence`` is
BASELINE config 4's stand-in (tests/test_distributed_slam.py), likewise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from points_matching_tpu_torch.ba.lm import BAState, make_ba_state
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose
from points_matching_tpu_torch.geometry.fundamental import _sign_normalize
from points_matching_tpu_torch.geometry.homogeneous import skew
from points_matching_tpu_torch.geometry.se3 import so3_exp

Tensor = torch.Tensor


class TwoViewScene(NamedTuple):
    p1: Tensor           # [N, 2] pixel coords in view 1
    p2: Tensor           # [N, 2] pixel coords in view 2
    X: Tensor            # [N, 3] world points (cam-1 frame)
    K: Tensor            # [3, 3] shared intrinsics
    pose: Pose           # cam1 → cam2
    E: Tensor            # essential (= [t]x R)
    F: Tensor            # fundamental (unit Frobenius norm, sign-normalized)
    mask: Tensor         # [N] all-True


def essential_from_pose(R: Tensor, t: Tensor) -> Tensor:
    """E = [t]× R for x2 ~ R x1 + t (so p2ᵀ E p1 = 0 in normalized coords)."""
    return skew(t) @ R


def _intrinsics(image_size: Tuple[int, int]):
    w, h = image_size
    fx = fy = 0.8 * w
    K = torch.tensor([[fx, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1]], dtype=torch.float32)
    return K, fx, fy, w / 2.0, h / 2.0


def make_two_view_scene(generator: torch.Generator, num_points: int = 128,
                        noise: float = 0.0, image_size: Tuple[int, int] = (640, 480),
                        rotation_scale: float = 0.15, baseline: float = 0.5,
                        outlier_fraction: float = 0.0) -> TwoViewScene:
    """Random well-conditioned two-view scene (CPU tensors): points in the
    view-1 frustum at depths 4–12; view 2 a random small rotation plus a
    baseline; an ``outlier_fraction`` of p2 rows replaced by uniform pixels
    (the mask stays all-True)."""
    w, h = image_size
    K, fx, fy, cx, cy = _intrinsics(image_size)

    def unif(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    uv = unif((num_points, 2), -0.4, 0.4)
    z = unif((num_points, 1), 4.0, 12.0)
    X = torch.cat([uv * z, z], -1)
    R = so3_exp(rotation_scale * torch.randn(3, generator=generator))
    t = baseline * torch.tensor([1.0, 0.2, 0.1]) + 0.05 * torch.randn(3, generator=generator)
    pose = Pose(R=R, t=t)
    f, c = torch.tensor([fx, fy]), torch.tensor([cx, cy])

    def project(P):
        return P[..., :2] / P[..., 2:3] * f + c

    p1, p2 = project(X), project(pose.transform(X))
    if noise > 0:
        p1 = p1 + noise * torch.randn(p1.shape, generator=generator)
        p2 = p2 + noise * torch.randn(p2.shape, generator=generator)
    if outlier_fraction > 0:
        num_out = int(round(outlier_fraction * num_points))
        rand_px = torch.rand((num_points, 2), generator=generator) * torch.tensor([w, h])
        is_out = torch.zeros(num_points, dtype=torch.bool)
        is_out[torch.randperm(num_points, generator=generator)[:num_out]] = True
        p2 = torch.where(is_out[:, None], rand_px, p2)

    E = essential_from_pose(R, t)
    K_inv = torch.linalg.inv(K)
    return TwoViewScene(p1=p1, p2=p2, X=X, K=K, pose=pose, E=E,
                        F=_sign_normalize(K_inv.T @ E @ K_inv),
                        mask=torch.ones(num_points, dtype=torch.bool))


def make_ba_problem(generator: torch.Generator, num_cameras: int = 6,
                    num_landmarks: int = 64, noise: float = 0.5,
                    image_size: Tuple[int, int] = (640, 480)) -> dict:
    """Dense multi-view BA problem: a camera arc looking at a point cloud,
    every camera observing every landmark (CPU tensors).  Returns a dict
    with K, poses (Pose [C]), X [L, 3], uv [C, L, 2] noisy observations and
    mask [C, L]."""
    w, h = image_size
    K, fx, fy, cx, cy = _intrinsics(image_size)
    X = -2.0 + 4.0 * torch.rand((num_landmarks, 3), generator=generator)
    X = X + torch.tensor([0.0, 0.0, 8.0])
    angles = torch.linspace(-0.3, 0.3, num_cameras)
    zeros = torch.zeros_like(angles)
    Rs = so3_exp(torch.stack([zeros, angles, zeros], -1))
    ts = torch.stack([torch.linspace(-1.0, 1.0, num_cameras), zeros, zeros], -1)
    poses = Pose(R=Rs, t=ts)
    Xc = (Rs[:, None] * X[None, :, None, :]).sum(-1) + ts[:, None, :]
    uv = Xc[..., :2] / Xc[..., 2:3] * torch.tensor([fx, fy]) + torch.tensor([cx, cy])
    uv = uv + noise * torch.randn(uv.shape, generator=generator)
    mask = ((uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
            & (Xc[..., 2] > 0.1))
    return dict(K=K, poses=poses, X=X, uv=uv, mask=mask)


def make_perturbed_ba_problem(seed: int, num_cameras: int = 6, num_landmarks: int = 64,
                              dtype: torch.dtype = torch.float32, device="cpu"
                              ) -> Tuple[BAState, CameraIntrinsics]:
    """The dense BA tests' setup: ``make_ba_problem`` (generator seed
    ``seed``) from a start off its truth (seed ``seed + 1``), every camera
    but the first two turned by 0.01·N(0, I) rad and moved by 0.05·N(0, I),
    every landmark moved by 0.05·N(0, I); the two unmoved cameras are the
    state's gauge.  Drawn on the CPU in float32, so every device and
    process gets the same start.  Returns (state, K) in ``dtype`` on
    ``device``."""
    gauge = 2
    g = torch.Generator().manual_seed(seed)
    prob = make_ba_problem(g, num_cameras=num_cameras, num_landmarks=num_landmarks)
    g.manual_seed(seed + 1)
    free = (torch.arange(num_cameras) >= gauge)
    dR = so3_exp(0.01 * torch.randn((num_cameras, 3), generator=g))
    dt = 0.05 * torch.randn((num_cameras, 3), generator=g)
    R, t = prob["poses"].R, prob["poses"].t
    R = torch.where(free[:, None, None], dR @ R, R)
    t = torch.where(free[:, None], t + dt, t)
    X = prob["X"] + 0.05 * torch.randn(prob["X"].shape, generator=g)

    def put(x):
        return x.to(device=device, dtype=dtype)

    state = make_ba_state(Pose(R=put(R), t=put(t)), put(X), put(prob["uv"]),
                          prob["mask"].to(device), num_fixed_cameras=gauge)
    return state, CameraIntrinsics.from_matrix(put(prob["K"]))


def make_sparse_ba_problem(seed: int = 0, num_cameras: int = 64,
                           num_landmarks: int = 16384, obs_per_landmark: int = 8,
                           noise: float = 0.5, image_size: Tuple[int, int] = (640, 480),
                           *, device) -> dict:
    """Synthetic sparse BA problem in observation-list form (the JAX bench's
    BA shape by default: 64 cameras × 16,384 landmarks × 131,072
    observations): landmarks along a corridor, each observed by a window of
    ``obs_per_landmark`` consecutive cameras; out-of-frustum rows masked.
    Host numpy from ``seed``, then moved to ``device``.

    Returns a dict with K [3, 3], poses (Pose [C]), X [L, 3] and the flat
    cam_idx / lm_idx / uv / obs_mask [O] arrays.
    """
    w, h = image_size
    K, fx, fy, cx, cy = _intrinsics(image_size)
    rng = np.random.RandomState(seed)
    span = num_cameras * 0.25
    X = np.stack([
        rng.uniform(-span / 2 - 2, span / 2 + 2, num_landmarks),
        rng.uniform(-2.0, 2.0, num_landmarks),
        rng.uniform(6.0, 10.0, num_landmarks),
    ], axis=-1).astype(np.float32)
    angles = np.linspace(-0.3, 0.3, num_cameras)
    wvecs = np.stack([np.zeros_like(angles), angles, np.zeros_like(angles)], axis=-1)
    Rs = so3_exp(torch.from_numpy(wvecs.astype(np.float32))).numpy()
    ts = np.stack([np.linspace(-span / 2, span / 2, num_cameras),
                   np.zeros_like(angles), np.zeros_like(angles)], axis=-1).astype(np.float32)
    ts = -np.einsum("cij,cj->ci", Rs, ts)       # t = −R C, centres along the corridor

    base = np.clip(
        np.round((X[:, 0] + span / 2) / max(span, 1e-6) * (num_cameras - 1)).astype(np.int64)
        - obs_per_landmark // 2, 0, num_cameras - obs_per_landmark)
    lm_idx = np.repeat(np.arange(num_landmarks), obs_per_landmark)
    cam_idx = (base[:, None] + np.arange(obs_per_landmark)[None, :]).reshape(-1)
    Xc = np.einsum("oij,oj->oi", Rs[cam_idx], X[lm_idx]) + ts[cam_idx]
    z = Xc[:, 2:3]
    uv = Xc[:, :2] / np.maximum(z, 1e-6) * np.asarray([fx, fy]) + np.asarray([cx, cy])
    uv = (uv + noise * rng.randn(*uv.shape)).astype(np.float32)
    obs_mask = ((z[:, 0] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h))

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return dict(K=K.to(device), poses=Pose(R=dev(Rs), t=dev(ts.astype(np.float32))),
                X=dev(X), cam_idx=dev(cam_idx, torch.int32), lm_idx=dev(lm_idx, torch.int32),
                uv=dev(uv), obs_mask=dev(obs_mask))


def make_tracked_sequence(num_frames: int, *, device, num_landmarks: int = 300,
                          x_range: Tuple[float, float] = (-4.0, 4.0), yaw_step: float = 0.02,
                          t_step: float = 0.35, noise: float = 0.3, num_features: int = 256,
                          seed: int = 0, offsets: Optional[Sequence[int]] = None):
    """Synthetic tracked sequence: a 640 × 480 camera (f = 500) sweeping
    sideways (frame i: yaw ``yaw_step``·i, world→camera t = (−``t_step``·i,
    0, 0)) past landmarks uniform in ``x_range`` × (−3, 3) × (6, 14), each
    tagged with a unit 32-d descriptor (``offsets[i]`` in place of i when
    given: the out-and-back trajectory of the loop-closure demo); a frame's
    features are up to
    ``num_features`` visible projections, shuffled, with ``noise`` pixels of
    noise and noisy copies of their descriptors.  Numpy from ``seed``.

    The defaults are tests/test_sfm.py's ``_make_sequence``; the JAX bench's
    ``sfm`` section (bench.py ``_make_sfm_sequence``) is ``num_landmarks=600,
    x_range=(-6, 10), yaw_step=0.01, t_step=0.12``.  Both draw in this order.

    Returns (frames [(xy [N, 2], desc [N, D], mask [N])] on ``device``,
    K (CameraIntrinsics on ``device``), ground-truth camera centres [F, 3]
    on the CPU).
    """
    rng = np.random.RandomState(seed)
    w, h, f, d_dim = 640, 480, 500.0, 32
    X = rng.uniform([x_range[0], -3, 6], [x_range[1], 3, 14],
                    (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, d_dim).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)
    frames, centers = [], []
    for i in range(num_frames):
        o = i if offsets is None else offsets[i]
        R = so3_exp(torch.tensor([0.0, yaw_step * o, 0.0])).numpy()
        t = np.asarray([-t_step * o, 0.0, 0.0], np.float32)
        centers.append(-(R.T @ t))
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * f + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:num_features]
        k = len(idx)
        xy = np.zeros((num_features, 2), np.float32)
        dd = np.zeros((num_features, d_dim), np.float32)
        mm = np.zeros((num_features,), bool)
        xy[:k] = uv[idx] + noise * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, d_dim).astype(np.float32)
        dd[:k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mm[:k] = True
        frames.append(tuple(torch.from_numpy(a).to(device) for a in (xy, dd, mm)))
    K = CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32, device=device)
                           for v in (f, f, w / 2, h / 2)))
    return frames, K, torch.from_numpy(np.stack(centers).astype(np.float32))


def make_stacked_sequence(num_frames: int = 16, *, device, num_landmarks: int = 400,
                          n_feat: int = 256, seed: int = 0, px_noise: float = 0.3,
                          desc_dim: int = 32, corridor: bool = False,
                          on_axis: bool = False):
    """BASELINE config 4's stand-in, tests/test_distributed_slam.py's
    ``_make_stacked_sequence`` in numpy with the same draws: landmarks spread
    along a forward corridor (``corridor``; else a 10 × 6 × 8 box), the
    camera moving 0.3 a frame along x with a bounded yaw, up to ``n_feat``
    visible landmarks a frame with ``px_noise`` pixels of noise and noisy
    unit descriptors.  Config 4's stand-in is ``num_frames=272,
    num_landmarks=3000, seed=5, corridor=True``.

    The reference's camera frame moves by t = (−0.3 i, 0, 0), so its centre
    −Rᵀt swings off the corridor's axis by 0.3 i·sin(yaw): past ~500 frames
    the camera leaves the landmarks' depth band (6–14) and frames see none.
    ``on_axis`` keeps the centre at (0.3 i, 0, 0) (t = −R·centre), the same
    draws otherwise: KITTI 00's length (4,541 frames) needs it.

    Returns (kps [F, N, 2], desc [F, N, D], mask [F, N]) on ``device``, K
    (CameraIntrinsics on ``device``) and the ground-truth centres [F, 3] as
    numpy.
    """
    rng = np.random.RandomState(seed)
    w, h = 640, 480
    fx = fy = 500.0
    if corridor:
        x_hi = 0.3 * num_frames + 6.0
        X = np.stack([rng.uniform(-6.0, x_hi, num_landmarks),
                      rng.uniform(-3.0, 3.0, num_landmarks),
                      rng.uniform(6.0, 14.0, num_landmarks)], axis=-1).astype(np.float32)
    else:
        X = rng.uniform([-5, -3, 6], [5, 3, 14], (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, desc_dim).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)
    kps = np.zeros((num_frames, n_feat, 2), np.float32)
    dsc = np.zeros((num_frames, n_feat, desc_dim), np.float32)
    msk = np.zeros((num_frames, n_feat), bool)
    centers = []
    for i in range(num_frames):
        ang = 0.05 * np.sin(0.05 * i) if corridor else 0.015 * i
        R = so3_exp(torch.tensor([0.0, ang, 0.0], dtype=torch.float32)).numpy()
        t = np.asarray([-0.3 * i, 0.0, 0.0], np.float32)
        if on_axis:
            t = (R @ t).astype(np.float32)
        centers.append(-(R.T @ t))
        Xc = X @ R.T + t
        with np.errstate(divide="ignore", invalid="ignore"):     # z = 0: not visible
            uv = Xc[:, :2] / Xc[:, 2:3] * np.asarray([fx, fy]) + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:n_feat]
        k = len(idx)
        kps[i, :k] = uv[idx] + px_noise * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, desc_dim).astype(np.float32)
        dsc[i, :k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        msk[i, :k] = True
    K = CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32, device=device)
                           for v in (fx, fy, w / 2, h / 2)))
    return (torch.from_numpy(kps).to(device), torch.from_numpy(dsc).to(device),
            torch.from_numpy(msk).to(device), K, np.stack(centers))
