"""SO(3)/SE(3) exponential and logarithm maps — port of
``points_matching_tpu/geometry/se3.py``.

Batched and f32-safe.  Each trig coefficient is a function of the smooth
quantity θ² = Σw² with a Taylor branch below θ² = 1e-8 (``_coefficients``),
so θ = 0 — the linearisation point of every Gauss-Newton step in BA and
PnP — gives finite values; the non-smooth ops (sqrt, arccos, division)
get a safe dummy input on the branch that is not taken.  The port writes
its Jacobians in closed form (no autograd in the solvers), but it keeps
the same branches and constants, so both packages take the same branch on
the same input.
"""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.geometry.homogeneous import skew

Tensor = torch.Tensor

_EPS = 1e-8
_SMALL_T2 = 1e-8  # θ² switch point: θ < 1e-4


def _coefficients(t2: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(A, B, C) = (sinθ/θ, (1−cosθ)/θ², (1−sinθ/θ)/θ²) from θ² with
    Taylor branches."""
    small = t2 < _SMALL_T2
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(theta)) / t2_safe)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (1.0 - A) / t2_safe)
    return A, B, C


def _eye_like(W: Tensor) -> Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues: [..., 3] axis-angle → [..., 3, 3] rotation."""
    t2 = (w * w).sum(-1)
    A, B, _ = _coefficients(t2)
    W = skew(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: Tensor) -> Tensor:
    """[..., 3, 3] rotation → [..., 3] axis-angle (|w| ≤ π), with the
    small-angle series and the near-π branch (axis from the diagonal)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    # vee(R − Rᵀ)/2 = sin(θ)·axis
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1) * 0.5
    s2 = (v * v).sum(-1)  # sin²θ

    small = cos_theta > 1.0 - 1e-6      # θ ≲ 1.4e-3
    near_pi = cos_theta < -1.0 + 1e-5   # θ ≈ π

    zero = torch.zeros_like(cos_theta)
    cos_safe = torch.where(small | near_pi, zero, cos_theta)
    theta_g = torch.arccos(cos_safe)
    sin_safe = torch.sqrt((1.0 - cos_safe * cos_safe).clamp_min(1e-12))
    w_general = v * (theta_g / sin_safe)[..., None]

    w_small = v * (1.0 + s2 / 6.0)[..., None]

    theta_pi = torch.arccos(torch.where(near_pi, cos_theta, zero))
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    one_m_cos = (1.0 - cos_theta[..., None]).clamp_min(_EPS)
    axis_sq = ((diag - cos_theta[..., None]) / one_m_cos).clamp(0.0, 1.0)
    axis = torch.sqrt(axis_sq.clamp_min(1e-12))
    one = torch.ones_like(cos_theta)
    sign_y = torch.where(R[..., 0, 1] + R[..., 1, 0] < 0, -one, one)
    sign_z = torch.where(R[..., 0, 2] + R[..., 2, 0] < 0, -one, one)
    axis = axis * torch.stack([one, sign_y, sign_z], -1)
    w_pi = axis * theta_pi[..., None]

    out = torch.where(small[..., None], w_small, w_general)
    return torch.where(near_pi[..., None], w_pi, out)


def _left_jacobian(w: Tensor) -> Tensor:
    """SO(3) left Jacobian V(w): the se3_exp translation factor."""
    t2 = (w * w).sum(-1)
    _, B, C = _coefficients(t2)
    W = skew(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def se3_exp(xi: Tensor) -> Tuple[Tensor, Tensor]:
    """[..., 6] twist (v, w) → (R [..., 3, 3], t [..., 3])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return R, t


def se3_log(R: Tensor, t: Tensor) -> Tensor:
    """(R, t) → [..., 6] twist (v, w)."""
    w = so3_log(R)
    v = torch.linalg.solve(_left_jacobian(w), t[..., None])[..., 0]
    return torch.cat([v, w], -1)
