"""Descriptor extraction, SURF-class kind — port of
``points_matching_tpu/ops/descriptors.py``.

64-dim float, unit-norm: a 4×4 grid of (Σdx, Σdy, Σ|dx|, Σ|dy|) Haar-type
responses in an oriented, scale-adaptive window, as one batched bilinear
sampling of a 22×22 lattice per keypoint.  Padded (masked-out) keypoints
produce zero descriptors with mask=False.
"""
from __future__ import annotations

import torch

from points_matching_tpu_torch.core.config import DescriptorConfig
from points_matching_tpu_torch.core.types import Descriptors, Keypoints
from points_matching_tpu_torch.ops.sampling import bilinear_sample

Tensor = torch.Tensor

_GRID = 20        # 20×20 sample lattice → 4×4 cells of 5×5 samples
_EXT = _GRID + 2  # extended lattice holding every inner sample's Haar taps


def _lattice(n: int, device) -> Tensor:
    """[n², 2] (x, y) offsets of an n×n unit lattice centred on 0."""
    c = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
    oy, ox = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([ox, oy], -1).reshape(-1, 2)


def surf_describe(image: Tensor, kps: Keypoints, upright: bool = False) -> Descriptors:
    """64-d float SURF-class descriptors for all (padded) keypoints at once.

    Args:
      image: [H, W] float32 grayscale.
      kps:   Keypoints (capacity N).

    Returns Descriptors([N, 64] float32, unit rows).
    """
    dev = image.device
    inner = _lattice(_GRID, dev)
    w = torch.exp(-0.5 * (inner[:, 0] ** 2 + inner[:, 1] ** 2) / 3.3**2)
    ext = _lattice(_EXT, dev)                              # [484, 2]
    n = kps.capacity

    angle = torch.zeros_like(kps.angle) if upright else kps.angle
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    s = kps.scale.clamp_min(0.8)[:, None]                  # [N, 1]
    ex, ey = ext[None, :, 0], ext[None, :, 1]
    # world offsets R @ (ext · s), R = [[ca, -sa], [sa, ca]]
    offs = torch.stack([(ca * ex + (-sa) * ey) * s, (sa * ex + ca * ey) * s], -1)
    pts = kps.xy[:, None, :] + offs                        # [N, 484, 2]

    # ONE extended-lattice sampling; the Haar taps of inner sample (iy, ix)
    # are its lattice neighbours
    E = bilinear_sample(image, pts).reshape(n, _EXT, _EXT)
    wg = w.reshape(1, _GRID, _GRID)
    dx = (E[:, 1:-1, 2:] - E[:, 1:-1, :-2]) * wg           # [N, 20, 20]
    dy = (E[:, 2:, 1:-1] - E[:, :-2, 1:-1]) * wg

    def cells(v: Tensor) -> Tensor:
        return v.reshape(n, 4, 5, 4, 5).sum(dim=(2, 4)).reshape(n, 16)

    feat = torch.stack([cells(dx), cells(dy), cells(dx.abs()), cells(dy.abs())],
                       -1).reshape(n, 64)   # per-cell (Σdx, Σdy, Σ|dx|, Σ|dy|)
    norm = torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
    feat = feat / norm.clamp_min(1e-9)
    feat = torch.where(kps.mask[:, None], feat, 0.0)
    return Descriptors(data=feat.to(torch.float32), mask=kps.mask, binary=False)


def extract_descriptors(image: Tensor, kps: Keypoints,
                        config: DescriptorConfig = DescriptorConfig()) -> Descriptors:
    """Dispatch on the configured family."""
    if config.kind == "surf":
        return surf_describe(image, kps, upright=config.upright)
    if config.kind == "orb":
        raise NotImplementedError("ORB descriptors are not ported yet (ORB slice)")
    raise ValueError(f"unknown descriptor kind: {config.kind!r}")
