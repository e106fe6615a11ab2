"""Batched DLT triangulation — port of
``points_matching_tpu/geometry/triangulate.py``."""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.geometry.eigen import smallest_eigvec_psd

Tensor = torch.Tensor


def _center(P: Tensor) -> Tensor:
    """Camera centre C = −M⁻¹ t of a [..., 3, 4] projection (M a general
    3×3: callers pass both K[R|t] and [R|t]); 0 where M is singular, so one
    failed hypothesis camera cannot poison a whole batch element."""
    C = -torch.linalg.solve_ex(P[..., :3], P[..., 3:4])[0][..., 0]
    ok = torch.isfinite(C).all(-1, keepdim=True)
    return torch.where(ok, C, torch.zeros_like(C))


def triangulate_dlt(P1: Tensor, P2: Tensor, p1: Tensor, p2: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Linear (DLT) two-view triangulation.

    Args:
      P1, P2: [..., 3, 4] projection matrices (K [R|t]).
      p1, p2: [..., N, 2] pixel coordinates.

    Returns (X [..., N, 3] world points, depth_ok [..., N] — positive depth
    in BOTH cameras, the cheirality mask).

    As the reference: the world origin is shifted to the camera pair's
    midpoint (far from the origin the t-column's ‖C‖-scale entries cost the
    DLT rows their significance in f32), every constraint row is scaled to
    unit norm, and the 4×4 null vector comes from 8 steps of shifted
    Cholesky inverse iteration.
    """
    Cm = 0.5 * (_center(P1) + _center(P2))                     # [..., 3]

    def shift(P):
        t_new = (P[..., :3] * Cm[..., None, :]).sum(-1) + P[..., 3]
        return torch.cat([P[..., :3], t_new[..., None]], -1)

    P1s, P2s = shift(P1), shift(P2)

    def rows(P, p):
        x, y = p[..., 0:1], p[..., 1:2]
        P0, P1_, P2_ = P[..., None, 0, :], P[..., None, 1, :], P[..., None, 2, :]
        return torch.stack([x * P2_ - P0, y * P2_ - P1_], -2)

    A = torch.cat([rows(P1s, p1), rows(P2s, p2)], -2)         # [..., N, 4, 4]
    A = A / torch.linalg.vector_norm(A, dim=-1, keepdim=True).clamp_min(1e-12)
    ATA = A.transpose(-1, -2) @ A
    Xh = smallest_eigvec_psd(ATA, iters=8)
    w = Xh[..., 3:4]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    Xs = Xh[..., :3] / w_safe

    Xh1 = torch.cat([Xs, torch.ones_like(Xs[..., :1])], -1)
    z1 = (Xh1 * P1s[..., None, 2, :]).sum(-1)
    z2 = (Xh1 * P2s[..., None, 2, :]).sum(-1)
    return Xs + Cm[..., None, :], (z1 > 0) & (z2 > 0)
