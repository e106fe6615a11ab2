"""Reprojection residuals and Jacobians for bundle adjustment on the dense
[C, L] camera×landmark grid — port of ``points_matching_tpu/ba/residuals.py``.

The reference takes the Jacobians with a vmapped ``jax.jacfwd`` at zero
tangent; here they are written in closed form (the same forms as
``ba/sparse.py``), for the left-multiplicative pose tangent (v, w) of
``_residual_one``: with x = R·X + t and z' = max(z, ε),

    Jproj = [[fx/z', 0, −fx·x/z'²·𝟙(z>ε)], [0, fy/z', −fy·y/z'²·𝟙(z>ε)]]
    ∂r/∂v = Jproj,   ∂r/∂w = x × (each row of Jproj),   ∂r/∂X = Jproj·R.
"""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose
from points_matching_tpu_torch.geometry.se3 import se3_exp

Tensor = torch.Tensor
_EPS = 1e-6


def _project(K: CameraIntrinsics, x_cam: Tensor, eps: float = _EPS) -> Tensor:
    z = x_cam[..., 2:3].clamp_min(eps)     # BA keeps points in front; clamp guards
    f = torch.stack([K.fx, K.fy], -1)
    c = torch.stack([K.cx, K.cy], -1)
    return x_cam[..., :2] / z * f + c


def _residual_one(delta_pose: Tensor, delta_lm: Tensor, R: Tensor, t: Tensor,
                  X: Tensor, uv: Tensor, K: CameraIntrinsics) -> Tensor:
    """Residual of one observation after the tangent update (δpose [6],
    δX [3]) — the function the Jacobians below differentiate."""
    Rd, td = se3_exp(delta_pose)
    Rn = Rd @ R
    tn = Rd @ t + td
    return _project(K, Rn @ (X + delta_lm) + tn) - uv


def reprojection_residuals(poses: Pose, X: Tensor, uv: Tensor, mask: Tensor,
                           K: CameraIntrinsics) -> Tensor:
    """Masked residuals on the [C, L] grid → [C, L, 2] (invalid → 0)."""
    x_cam = (poses.R[:, None] * X[None, :, None, :]).sum(-1) + poses.t[:, None, :]
    r = _project(K, x_cam) - uv
    return torch.where(mask[..., None], r, torch.zeros_like(r))


def projection_jacobians(x_cam: Tensor, R: Tensor, K: CameraIntrinsics
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """(u, v, Jc [..., 2, 6], Jl [..., 2, 3]) at camera-frame points x_cam
    [..., 3] with rotations R [..., 3, 3] (broadcast); u, v are x/z', y/z'."""
    z = x_cam[..., 2].clamp_min(_EPS)
    inv = 1.0 / z
    u = x_cam[..., 0] * inv
    v = x_cam[..., 1] * inv
    live = (x_cam[..., 2] > _EPS).to(x_cam.dtype)
    zero = torch.zeros_like(inv)
    fx, fy = K.fx, K.fy
    Jp = torch.stack([
        torch.stack([fx * inv, zero, -fx * u * inv * live], -1),
        torch.stack([zero, fy * inv, -fy * v * inv * live], -1),
    ], -2)                                                          # [..., 2, 3]
    Jw = torch.linalg.cross(x_cam[..., None, :].expand_as(Jp), Jp)
    Jc = torch.cat([Jp, Jw], -1)                                    # [..., 2, 6]
    Jl = (Jp[..., :, :, None] * R[..., None, :, :]).sum(-2)         # [..., 2, 3]
    return u, v, Jc, Jl


def residuals_and_jacobians(poses: Pose, X: Tensor, uv: Tensor, mask: Tensor,
                            K: CameraIntrinsics) -> Tuple[Tensor, Tensor, Tensor]:
    """Residuals and per-observation Jacobians on the grid.

    Returns r [C, L, 2], Jc [C, L, 2, 6] (∂r/∂pose tangent), Jl [C, L, 2, 3]
    (∂r/∂landmark); invalid cells are zero.
    """
    R = poses.R[:, None]                                            # [C, 1, 3, 3]
    x_cam = (R * X[None, :, None, :]).sum(-1) + poses.t[:, None, :]
    u, v, Jc, Jl = projection_jacobians(x_cam, R, K)
    r = torch.stack([K.fx * u + K.cx, K.fy * v + K.cy], -1) - uv
    m = mask[..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(m, r, zero), torch.where(m[..., None], Jc, zero),
            torch.where(m[..., None], Jl, zero))


def huber_weights(r: Tensor, delta: float) -> Tensor:
    """IRLS weights for the Huber loss on per-observation L2 norms
    ([..., 2] → [...]); delta ≤ 0 disables robustification (ones)."""
    if delta <= 0:
        return torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(norm <= delta, torch.ones_like(norm),
                       delta / norm.clamp_min(1e-12))
