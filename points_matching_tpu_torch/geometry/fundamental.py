"""Fundamental-matrix estimation — batched, mask-aware, fp32 (port of
``points_matching_tpu/geometry/fundamental.py``).

Conventions (matching OpenCV): with correspondences (p1 in image 1, p2 in
image 2), the estimated F satisfies p2ᵀ F p1 = 0.  The reference demo audits
the *transpose* form p1ᵀ F p2; both are provided.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from points_matching_tpu_torch.geometry.eigen import (
    project_rank2,
    smallest_eigvec_psd,
    smallest_eigvecs_psd,
    svd3_rotational,
)
from points_matching_tpu_torch.geometry.homogeneous import to_homogeneous
from points_matching_tpu_torch.geometry.normalize import hartley_normalize

Tensor = torch.Tensor


def _constraint_rows(p1: Tensor, p2: Tensor) -> Tensor:
    """Epipolar constraint rows A f = 0 for f = vec(F) (row-major), with the
    convention p2ᵀ F p1 = 0.  [..., N, 2] × 2 → [..., N, 9]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1
    )


def _sign_normalize(F: Tensor, eps: float = 1e-12) -> Tensor:
    """Unit Frobenius norm, then flip so the largest-|entry| (first on ties)
    is positive."""
    norm = torch.linalg.vector_norm(F, dim=(-2, -1), keepdim=True)
    F = F / norm.clamp_min(eps)
    flat = F.reshape(*F.shape[:-2], 9)
    idx = flat.abs().argmax(-1, keepdim=True)
    pivot = flat.gather(-1, idx)[..., 0]
    sign = torch.where(pivot < 0, -1.0, 1.0).to(F.dtype)
    return F * sign[..., None, None]


def eight_point(p1: Tensor, p2: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Normalized 8-point (weighted least-squares) fundamental-matrix solve.

    Args:
      p1, p2:  [..., N, 2] corresponding pixel coordinates (N ≥ 8 valid).
      weights: [..., N] optional weights / validity mask.

    Returns: [..., 3, 3] rank-2, Frobenius-normalized F with p2ᵀ F p1 ≈ 0.
    """
    if weights is None:
        weights = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    w = weights.to(p1.dtype)

    p1n, T1 = hartley_normalize(p1, w)
    p2n, T2 = hartley_normalize(p2, w)

    A = _constraint_rows(p1n, p2n) * w[..., None]
    ATA = A.transpose(-1, -2) @ A
    f = smallest_eigvec_psd(ATA)
    Fn = project_rank2(f.reshape(*f.shape[:-1], 3, 3))
    F = T2.transpose(-1, -2) @ Fn @ T1
    return _sign_normalize(F)


def _cbrt(x: Tensor) -> Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _cubic_roots_real(a: Tensor, b: Tensor, c: Tensor, d: Tensor,
                      eps: float = 1e-12) -> Tuple[Tensor, Tensor]:
    """Real roots of a·x³+b·x²+c·x+d (batched, branchless).

    Returns (roots [..., 3], valid [..., 3]) — trig/Cardano method; when the
    cubic degenerates to a quadratic/linear the extra slots are masked out.
    """
    is_cubic = a.abs() > eps
    a_safe = torch.where(is_cubic, a, torch.ones_like(a))

    # depressed cubic t³ + pt + q, x = t − b/(3a)
    bn = b / a_safe
    cn = c / a_safe
    dn = d / a_safe
    shift = bn / 3.0
    p = cn - bn * bn / 3.0
    q = 2.0 * bn ** 3 / 27.0 - bn * cn / 3.0 + dn
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three real roots (disc ≤ 0): trig method
    p_neg = p.clamp_max(-eps)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    acos_arg = (3.0 * q / (p_neg * m)).clamp(-1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    r_trig = torch.stack(
        [m * torch.cos(theta), m * torch.cos(theta - two_pi_3),
         m * torch.cos(theta + two_pi_3)], dim=-1)

    # one real root (disc > 0): Cardano
    sq = torch.sqrt(disc.clamp_min(0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    r_card = (u + v)[..., None].expand(*u.shape, 3)

    one_real = disc > 0
    roots = torch.where(one_real[..., None], r_card, r_trig) - shift[..., None]
    first_only = torch.tensor([True, False, False], device=a.device)
    valid = torch.where(one_real[..., None], first_only,
                        torch.ones_like(first_only))

    # quadratic fallback (a ≈ 0): b·x² + c·x + d
    big_b = b.abs() > eps
    is_quad = ~is_cubic & big_b
    b_safe = torch.where(big_b, b, torch.ones_like(b))
    qdisc = c * c - 4.0 * b * d
    qs = torch.sqrt(qdisc.clamp_min(0.0))
    zero = torch.zeros_like(c)
    qroots = torch.stack(
        [(-c + qs) / (2.0 * b_safe), (-c - qs) / (2.0 * b_safe), zero], dim=-1)
    qok = qdisc >= 0
    qvalid = torch.stack([qok, qok, torch.zeros_like(qok)], dim=-1)
    # linear fallback (a ≈ b ≈ 0): c·x + d
    big_c = c.abs() > eps
    c_safe = torch.where(big_c, c, torch.ones_like(c))
    lroots = torch.stack([-d / c_safe, zero, zero], dim=-1)
    no = torch.zeros_like(big_c)
    lvalid = torch.stack([big_c, no, no], dim=-1)

    roots = torch.where(is_cubic[..., None], roots,
                        torch.where(is_quad[..., None], qroots, lroots))
    valid = torch.where(is_cubic[..., None], valid,
                        torch.where(is_quad[..., None], qvalid, lvalid))
    return roots, valid


def seven_point(p1: Tensor, p2: Tensor) -> Tuple[Tensor, Tensor]:
    """7-point fundamental solve — up to 3 solutions.

    Args:   p1, p2: [..., 7, 2].
    Returns (F [..., 3, 3, 3], valid [..., 3]) — candidate matrices and a
    mask of which candidate slots hold real roots.
    """
    p1n, T1 = hartley_normalize(p1)
    p2n, T2 = hartley_normalize(p2)

    A = _constraint_rows(p1n, p2n)                      # [..., 7, 9]
    ATA = A.transpose(-1, -2) @ A
    # any orthonormal basis of the 2-dim nullspace parametrizes the same
    # pencil F1 + λF2
    vecs = smallest_eigvecs_psd(ATA, k=2, iters=6)
    F1 = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    F2 = vecs[..., :, 1].reshape(*vecs.shape[:-2], 3, 3)

    # det(F1 + λF2) = aλ³ + bλ² + cλ + d, from samples at λ ∈ {0, ±1, 2}
    det = torch.linalg.det
    d0 = det(F1)
    s1 = det(F1 + F2) - d0
    sm1 = det(F1 - F2) - d0
    s2 = det(F1 + 2.0 * F2) - d0
    b_ = (s1 + sm1) / 2.0
    a_ = (s2 - 2.0 * b_ - 2.0 * s1) / 6.0
    c_ = s1 - a_ - b_

    roots, valid = _cubic_roots_real(a_, b_, c_, d0)

    Fn = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    F = T2.transpose(-1, -2)[..., None, :, :] @ Fn @ T1[..., None, :, :]
    return _sign_normalize(F), valid


def find_fundamental(p1: Tensor, p2: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """OpenCV ``findFundamentalMat(..., CV_FM_7POINT)`` dispatch parity (the
    call the reference demo makes): the 7-point solver runs only when
    exactly 7 valid correspondences are given; otherwise the normalized
    8-point least-squares path runs.

    Args:
      p1, p2: [N, 2] correspondences (padded rows allowed, N ≥ 7).
      mask:   [N] validity.

    Returns (F [3, 3, 3] candidate stack, valid [3]): the 7-point branch
    fills up to 3 real-root candidates; the 8-point branch fills slot 0.
    """
    mask = mask.bool()
    if int(mask.sum()) == 7:     # host branch: one sync per call
        # valid correspondences to the front (stable)
        order = torch.argsort((~mask).to(torch.int8), stable=True)
        return seven_point(p1[order[:7]], p2[order[:7]])
    F = eight_point(p1, p2, mask.to(p1.dtype))
    valid = torch.tensor([True, False, False], device=p1.device)
    return torch.stack([F, F, F], dim=0), valid


def epipolar_residuals(F: Tensor, p1: Tensor, p2: Tensor) -> Tensor:
    """Algebraic residual p2ᵀ F p1 per correspondence.  [..., N]."""
    return torch.einsum("...ni,...ij,...nj->...n",
                        to_homogeneous(p2), F, to_homogeneous(p1))


def epipolar_residual_audit(
    F: Tensor,
    p1: Tensor,
    p2: Tensor,
    mask: Optional[Tensor] = None,
    form: str = "reference",
) -> Tuple[Tensor, Tensor]:
    """The reference demo's self-audit: per-match algebraic residual and the
    mean of absolute values.

    ``form='reference'`` computes p1ᵀ F p2 exactly as the demo does;
    ``form='standard'`` computes the constraint direction p2ᵀ F p1.

    Returns (residuals [..., N], mean_abs [...]).
    """
    if form == "reference":
        r = torch.einsum("...ni,...ij,...nj->...n",
                         to_homogeneous(p1), F, to_homogeneous(p2))
    elif form == "standard":
        r = epipolar_residuals(F, p1, p2)
    else:
        raise ValueError(f"unknown form: {form!r}")
    if mask is None:
        mean = r.abs().mean(-1)
    else:
        m = mask.to(r.dtype)
        mean = (r.abs() * m).sum(-1) / m.sum(-1).clamp_min(1.0)
    return r, mean


def sampson_distance(F: Tensor, p1: Tensor, p2: Tensor, eps: float = 1e-12) -> Tensor:
    """First-order geometric (Sampson) distance per correspondence — the
    RANSAC gating metric.  [..., N]."""
    p1h = to_homogeneous(p1)
    p2h = to_homogeneous(p2)
    Fp1 = torch.einsum("...ij,...nj->...ni", F, p1h)
    Ftp2 = torch.einsum("...ji,...nj->...ni", F, p2h)
    r = (p2h * Fp1).sum(-1)
    denom = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return (r * r) / denom.clamp_min(eps)


def compute_epilines(points: Tensor, which_image: int, F: Tensor) -> Tensor:
    """Epipolar lines for points — ``cv::computeCorrespondEpilines`` parity.

    For points in image 1 (``which_image=1``) returns lines in image 2,
    l2 = F p1; for image 2, l1 = Fᵀ p2.  Lines (a, b, c) are normalized so
    a² + b² = 1.  [..., N, 2] → [..., N, 3].
    """
    ph = to_homogeneous(points)
    if which_image == 1:
        lines = torch.einsum("...ij,...nj->...ni", F, ph)
    elif which_image == 2:
        lines = torch.einsum("...ji,...nj->...ni", F, ph)
    else:
        raise ValueError("which_image must be 1 or 2")
    norm = torch.linalg.vector_norm(lines[..., :2], dim=-1, keepdim=True)
    return lines / norm.clamp_min(1e-12)


def essential_from_fundamental(F: Tensor, K1: Tensor, K2: Tensor) -> Tensor:
    """E = K2ᵀ F K1, projected to the essential manifold (σ = (1, 1, 0))
    through the fixed-step rotational 3×3 SVD."""
    E = K2.transpose(-1, -2) @ F @ K1
    U, S, Vt = svd3_rotational(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    S_proj = torch.stack([s, s, torch.zeros_like(s)], -1)
    return U @ (S_proj[..., :, None] * Vt)


def fundamental_from_essential(E: Tensor, K1: Tensor, K2: Tensor) -> Tensor:
    """F = K2⁻ᵀ E K1⁻¹ (sign-normalised)."""
    K1_inv = torch.linalg.inv(K1)
    K2_inv_t = torch.linalg.inv(K2).transpose(-1, -2)
    return _sign_normalize(K2_inv_t @ E @ K1_inv)
