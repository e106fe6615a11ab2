"""Homogeneous-coordinate helpers (port of
``points_matching_tpu/geometry/homogeneous.py``)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def to_homogeneous(x: Tensor) -> Tensor:
    """[..., D] → [..., D+1] by appending 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x: Tensor, eps: float = 1e-12) -> Tensor:
    """[..., D+1] → [..., D] by perspective division (a last coordinate
    within ``eps`` of 0 divides as ±``eps``, keeping its sign)."""
    w = x[..., -1:]
    w = torch.where(w.abs() < eps, torch.where(w < 0, torch.full_like(w, -eps),
                                               torch.full_like(w, eps)), w)
    return x[..., :-1] / w


def skew(v: Tensor) -> Tensor:
    """[..., 3] → [..., 3, 3] cross-product (hat) matrix."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ]
    return torch.stack(rows, -2)
