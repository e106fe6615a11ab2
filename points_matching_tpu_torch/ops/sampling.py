"""Bilinear image sampling — the gather primitive under descriptor
extraction and orientation (port of ``points_matching_tpu/ops/sampling.py``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def bilinear_sample(image: Tensor, xy: Tensor, fill: float = 0.0) -> Tensor:
    """Sample ``image`` ([H, W] or [H, W, C]) at continuous (x, y) locations.

    Args:
      image: [H, W] or [H, W, C].
      xy:    [..., 2] (x = column, y = row) sample coordinates.
      fill:  value for out-of-bounds taps.

    Each of the four taps is read at its own (clamped) pixel and replaced by
    ``fill`` when it lies outside the image, so a sample in the [-1, 0)
    fringe blends ``fill`` with pixel 0 (not pixel 1).

    Returns: [...] or [..., C] sampled values.
    """
    H, W = image.shape[0], image.shape[1]
    flat = image.reshape(H * W, -1)              # [HW, C] (C = 1 for [H, W])
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi: Tensor, xi: Tensor) -> Tensor:
        v = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]     # [..., C]
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        return torch.where(inb[..., None], v, fill)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    out = top * (1 - wy) + bot * wy
    return out if image.dim() == 3 else out[..., 0]
