"""Homogeneous-coordinate helpers (port of
``points_matching_tpu/geometry/homogeneous.py``)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def to_homogeneous(x: Tensor) -> Tensor:
    """[..., D] → [..., D+1] by appending 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
