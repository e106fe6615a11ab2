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
    # solve_ex: the same solve without the error check, which would read
    # the device on the host
    v = torch.linalg.solve_ex(_left_jacobian(w), t[..., None])[0][..., 0]
    return torch.cat([v, w], -1)


def se3_adjoint(R: Tensor, t: Tensor) -> Tensor:
    """[..., 6, 6] adjoint of (R, t) in the twists' [v, w] order:
    T·exp(ξ)·T⁻¹ = exp(Ad(T)·ξ) with Ad(T) = [[R, [t]×R], [0, R]]."""
    top = torch.cat([R, skew(t) @ R], -1)
    bottom = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bottom], -2)


# θ² below which the left-Jacobian coefficients take their Taylor series:
# the closed forms cancel to ~ε/θ² relative there (4 terms: < 1e-9 at θ = 0.5)
_SERIES_T2 = 0.25


def _series(t2: Tensor, small: Tensor, exact, coeffs) -> Tensor:
    """``exact(θ², θ)`` off the ``small`` branch, the series Σ cₖ θ²ᵏ on it
    (the closed form gets a safe θ = 1 there)."""
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    series = sum(c * t2 ** k for k, c in enumerate(coeffs))
    return torch.where(small, series, exact(t2_safe, torch.sqrt(t2_safe)))


def se3_left_jacobian_inverse(xi: Tensor) -> Tensor:
    """[..., 6, 6] inverse SE(3) left Jacobian of the twist ξ = (v, w):
    log(exp(δ)·exp(ξ)) = ξ + J_l⁻¹(ξ)·δ + O(δ²).  In [v, w] order
    J_l⁻¹ = [[J⁻¹, −J⁻¹QJ⁻¹], [0, J⁻¹]], J⁻¹ = I − W/2 + c·W² the inverse
    SO(3) left Jacobian (c = (1 − (θ/2)·cot(θ/2))/θ², finite up to θ = π)
    and Q(v, w) the translation coupling (Barfoot, State Estimation for
    Robotics, eq. 7.86)."""
    v, w = xi[..., :3], xi[..., 3:]
    t2 = (w * w).sum(-1)
    small = t2 < _SERIES_T2
    c = _series(t2, small, lambda a, th: (1.0 - 0.5 * th / torch.tan(0.5 * th)) / a,
                (1 / 12, 1 / 720, 1 / 30240, 1 / 1209600))
    c1 = _series(t2, small, lambda a, th: (th - torch.sin(th)) / (a * th),
                 (1 / 6, -1 / 120, 1 / 5040, -1 / 362880))
    c2 = _series(t2, small, lambda a, th: (a + 2.0 * torch.cos(th) - 2.0) / (2.0 * a * a),
                 (1 / 24, -1 / 720, 1 / 40320, -1 / 3628800))
    c3 = _series(t2, small,
                 lambda a, th: (2.0 * th - 3.0 * torch.sin(th) + th * torch.cos(th))
                 / (2.0 * a * a * th),
                 (1 / 120, -1 / 2520, 1 / 120960, -1 / 9979200))
    W, V = skew(w), skew(v)
    WV, VW, WW = W @ V, V @ W, W @ W
    WVW = WV @ W
    cc = [x[..., None, None] for x in (c, c1, c2, c3)]
    Q = (0.5 * V + cc[1] * (WV + VW + WVW) + cc[2] * (WW @ V + VW @ W - 3.0 * WVW)
         + cc[3] * (WVW @ W + W @ WVW))
    Jinv = _eye_like(W) - 0.5 * W + cc[0] * WW
    top = torch.cat([Jinv, -(Jinv @ Q @ Jinv)], -1)
    bottom = torch.cat([torch.zeros_like(W), Jinv], -1)
    return torch.cat([top, bottom], -2)
