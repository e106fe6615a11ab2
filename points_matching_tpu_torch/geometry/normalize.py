"""Hartley normalization — the numerical backbone of the 8-point solver
(port of ``points_matching_tpu/geometry/normalize.py``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def hartley_normalize(
    pts: Tensor, weights: Optional[Tensor] = None, eps: float = 1e-9
) -> Tuple[Tensor, Tensor]:
    """Translate the (weighted) centroid to the origin and scale so the mean
    distance from the origin is sqrt(2).

    Args:
      pts:     [..., N, 2] points.
      weights: [..., N] optional non-negative weights (a validity mask may be
               passed directly); None → all-ones.

    Returns:
      (pts_norm [..., N, 2], T [..., 3, 3]) with
      ``pts_norm_h = (T @ pts_h)`` for homogeneous points.
    """
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    w = weights.to(pts.dtype)
    wsum = w.sum(-1, keepdim=True).clamp_min(eps)

    centroid = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    centered = pts - centroid
    dist = torch.linalg.vector_norm(centered, dim=-1)
    mean_dist = (dist * w).sum(-1, keepdim=True) / wsum
    scale = torch.full_like(mean_dist, math.sqrt(2.0)) / mean_dist.clamp_min(eps)

    pts_norm = centered * scale[..., None]

    s = scale[..., 0]
    cx = centroid[..., 0, 0]
    cy = centroid[..., 0, 1]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, z, -s * cx], dim=-1),
            torch.stack([z, s, -s * cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return pts_norm, T
