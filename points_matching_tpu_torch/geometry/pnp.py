"""Perspective-n-Point: camera pose from 2D↔3D correspondences — port of
``points_matching_tpu/geometry/pnp.py``.

The DLT solve is a batched 12×12 smallest-eigenvector problem (the fixed
step inverse iteration of ``geometry/eigen.py``); RANSAC scores every
hypothesis at once; refinement is a fixed-count Gauss-Newton loop on the
SE(3) tangent whose Jacobian is written in closed form (the reference
takes it with ``jax.jacfwd`` at ξ = 0; it is the camera block of
``ba/sparse.py:sparse_residuals_and_jacobians``).

Randomness comes from a ``torch.Generator``; ``ransac_pnp`` also accepts the
minimal sets themselves (``samples=(sX, suv)``), which is how the parity
tests feed both packages the same draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from points_matching_tpu_torch.core.types import Pose, take_rows
from points_matching_tpu_torch.geometry.eigen import (
    nearest_rotation_so3,
    smallest_eigvec_psd,
)
from points_matching_tpu_torch.geometry.ransac import Generators, sample_minimal_points
from points_matching_tpu_torch.geometry.se3 import se3_exp

Tensor = torch.Tensor


def pnp_dlt(X: Tensor, uv_norm: Tensor, weights: Optional[Tensor] = None) -> Pose:
    """Direct linear transform PnP (≥ 6 points), batched over leading dims.

    Args:
      X: [..., N, 3] world points; uv_norm: [..., N, 2] normalized image
      coordinates; weights: [..., N] optional weights / mask.

    Returns the world→camera Pose: the 3-D points are centred on their
    weighted centroid and scaled to RMS √3 first (without it AᵀA's
    condition number grows with the scene's extent²), R is the nearest
    proper rotation (Horn), t is scaled by mean(σ) and un-normalized, and
    the sign makes the mean cheirality positive.
    """
    if weights is None:
        weights = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    w = weights[..., None]
    wsum = w.sum(-2).clamp_min(1e-12)
    cen = (X * w).sum(-2) / wsum                                   # [..., 3]
    Xc_ = X - cen[..., None, :]
    rms = torch.sqrt(((Xc_ * Xc_).sum(-1) * weights).sum(-1)
                     / weights.sum(-1).clamp_min(1e-12))
    s = 3.0 ** 0.5 / rms.clamp_min(1e-9)                          # [...]
    X_n = Xc_ * s[..., None, None]

    Xh = torch.cat([X_n, torch.ones_like(X_n[..., :1])], -1)       # [..., N, 4]
    z = torch.zeros_like(Xh)
    u, v = uv_norm[..., 0:1], uv_norm[..., 1:2]
    r1 = torch.cat([Xh, z, -u * Xh], -1) * w
    r2 = torch.cat([z, Xh, -v * Xh], -1) * w
    A = torch.cat([r1, r2], -2)                                    # [..., 2N, 12]
    AtA = A.transpose(-1, -2) @ A
    p = smallest_eigvec_psd(AtA, iters=6)
    P = p.reshape(*p.shape[:-1], 3, 4)

    M = P[..., :3]
    depth = (M[..., None, 2, :] * X_n).sum(-1) + P[..., 2, 3][..., None]
    sign = torch.where((torch.sign(depth) * weights).sum(-1) < 0, -1.0, 1.0).to(X.dtype)
    P = P * sign[..., None, None]
    M = P[..., :3]

    R = nearest_rotation_so3(M)
    scale = (R * M).sum((-2, -1)) / 3.0
    t_n = P[..., 3] / scale.clamp_min(1e-12)[..., None]
    t = t_n / s[..., None] - (R * cen[..., None, :]).sum(-1)
    return Pose(R=R, t=t)


def _refine_step(pose: Pose, X: Tensor, uv_norm: Tensor, weights: Tensor,
                 damping: float) -> Pose:
    """One damped Gauss-Newton step in the left-multiplicative tangent
    (v, w): x(δ) = exp([w]×)·x + V·v.  With z' = max(z, 1e-6),
    ∂(x/z')/∂x = [[1/z', 0, −x/z'²·𝟙(z>ε)], [0, 1/z', −y/z'²·𝟙(z>ε)]],
    ∂r/∂v = that, ∂r/∂w = x × each of its rows, all times the weight."""
    eps = 1e-6
    xc = pose.transform(X)                                         # [..., N, 3]
    zc = xc[..., 2]
    zs = zc.clamp_min(eps)
    inv = 1.0 / zs
    u, v = xc[..., 0] * inv, xc[..., 1] * inv
    wt = weights
    r = torch.stack([(u - uv_norm[..., 0]) * wt, (v - uv_norm[..., 1]) * wt], -1)
    live = (zc > eps).to(xc.dtype)
    zero = torch.zeros_like(inv)
    Jp = torch.stack([
        torch.stack([inv, zero, -u * inv * live], -1),
        torch.stack([zero, inv, -v * inv * live], -1),
    ], -2) * wt[..., None, None]                                   # [..., N, 2, 3]
    Jw = torch.linalg.cross(xc[..., None, :].expand_as(Jp), Jp)
    J = torch.cat([Jp, Jw], -1).flatten(-3, -2)                    # [..., 2N, 6]
    rf = r.flatten(-2)                                             # [..., 2N]
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    H = J.transpose(-1, -2) @ J + damping * eye
    # Jᵀr as a product and a sum over the rows, accumulated in float64: a
    # batched matrix-vector product of one batch takes another CPU kernel
    # than of several, which rounds otherwise, and an f32 running sum over
    # 2N rows loses what a blocked product keeps
    g = -(J.double() * rf.double()[..., None]).sum(-2).to(J.dtype)
    dx = torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
    Rd, td = se3_exp(dx)
    return Pose(R=Rd @ pose.R, t=(Rd @ pose.t[..., None])[..., 0] + td)


def pnp_refine(pose: Pose, X: Tensor, uv_norm: Tensor, weights: Tensor,
               iterations: int = 5, damping: float = 1e-6) -> Pose:
    """Fixed-count Gauss-Newton refinement of a PnP pose (normalized
    coordinates; minimizes the weighted reprojection error).  Batched over
    the pose's and the weights' leading dims; X/uv_norm [..., N, ·]
    broadcast against them."""
    for _ in range(iterations):
        pose = _refine_step(pose, X, uv_norm, weights, damping)
    return pose


class PnPResult(NamedTuple):
    pose: Pose
    inlier_mask: Tensor
    num_inliers: Tensor


def _reproj_err(pose: Pose, X: Tensor, uv_norm: Tensor) -> Tensor:
    xc = pose.transform(X)
    z = xc[..., 2:3]
    uv = xc[..., :2] / z.clamp_min(1e-6)
    e = torch.linalg.vector_norm(uv - uv_norm, dim=-1)
    return torch.where(z[..., 0] > 1e-3, e, torch.full_like(e, torch.inf))


def top_k_first(counts: Tensor, k: int) -> Tensor:
    """Indices of the k largest counts along the last axis, the lower index
    first among equal counts (``jax.lax.top_k``'s order; ``torch.topk`` on
    CUDA promises no order for ties): a stable descending sort."""
    return torch.sort(counts, descending=True, stable=True).indices[..., :k]


def ransac_pnp(
    generator: Optional[Generators],
    X: Tensor,
    uv_norm: Tensor,
    mask: Tensor,
    num_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_threshold: Union[float, Tensor] = 0.01,
    refine_iterations: int = 5,
    sample_logits: Optional[Tensor] = None,
    refine_top_k: int = 8,
    prior_pose: Optional[Pose] = None,
    samples: Optional[Tuple[Tensor, Tensor]] = None,
) -> PnPResult:
    """Batched-hypothesis RANSAC PnP with top-k LO refinement, for one
    problem or a leading segment axis (each segment on its own: its draws,
    its top k, its winner).

    Args:
      generator: random source for the minimal sets (unused with
        ``samples``): one generator, or one per segment.
      X: [*B, N, 3] world points; uv_norm: [*B, N, 2] normalized image coords.
      mask: [*B, N] valid correspondences.
      inlier_threshold: reprojection error in normalized units.
      sample_logits: [*B, N] optional log-weights of the minimal-set draw
        (P ∝ exp(logits) within each stratified bucket).
      refine_top_k: the k best hypotheses by count (lower index first on
        ties) are each GN-refined on their own consensus and re-gated; the
        best refined consensus wins (the first on ties).
      prior_pose: optional extra hypothesis [*B] appended after the samples
        (the previous frame's pose in incremental tracking).
      samples: optional injected minimal sets (sX [*B, H, S, 3], suv
        [*B, H, S, 2]).
    """
    mask = mask.bool()
    if samples is None:
        sX, suv = sample_minimal_points(generator, mask, num_hypotheses, sample_size,
                                        (X, uv_norm), logits=sample_logits)
    else:
        sX, suv = (s.to(device=X.device, dtype=X.dtype) for s in samples)

    poses = pnp_dlt(sX, suv)                                       # [*B, H]
    if prior_pose is not None:
        poses = Pose(R=torch.cat([poses.R, prior_pose.R[..., None, :, :]], -3),
                     t=torch.cat([poses.t, prior_pose.t[..., None, :]], -2))

    # the hypothesis axis, for the correspondences shared by a segment's
    # hypotheses
    Xh, uvh, mh = X[..., None, :, :], uv_norm[..., None, :, :], mask[..., None, :]
    inl = (_reproj_err(poses, Xh, uvh) < inlier_threshold) & mh    # [*B, H, N]
    counts = inl.sum(-1)

    top = top_k_first(counts, min(refine_top_k, counts.shape[-1]))
    cand = Pose(R=take_rows(poses.R, top), t=take_rows(poses.t, top))
    refined = pnp_refine(cand, Xh, uvh, take_rows(inl, top).to(X.dtype),
                         iterations=refine_iterations)
    r_inl = (_reproj_err(refined, Xh, uvh) < inlier_threshold) & mh
    best = r_inl.sum(-1).argmax(-1, keepdim=True)                  # first on ties
    # the winner keeps a hypothesis axis of one, so that one problem's 3×3
    # products are batched as a segment axis's are (a 2-D product takes
    # another CPU kernel, which rounds otherwise)
    win = Pose(R=take_rows(refined.R, best), t=take_rows(refined.t, best))
    pose = pnp_refine(win, Xh, uvh, take_rows(r_inl, best).to(X.dtype),
                      iterations=refine_iterations)
    pose = Pose(R=pose.R[..., 0, :, :], t=pose.t[..., 0, :])
    final_inl = (_reproj_err(pose, X, uv_norm) < inlier_threshold) & mask
    return PnPResult(pose=pose, inlier_mask=final_inl,
                     num_inliers=final_inl.sum(-1, dtype=torch.int32))
