"""Descriptor extraction — port of ``points_matching_tpu/ops/descriptors.py``.

Two families:

* ``surf``: 64-dim float, unit-norm — a 4×4 grid of (Σdx, Σdy, Σ|dx|,
  Σ|dy|) Haar-type responses in an oriented, scale-adaptive window, as one
  batched bilinear sampling of a 22×22 lattice per keypoint.
* ``orb``: 256-bit binary — BRIEF point-pair tests steered by the keypoint
  angle on the σ = 2 blurred image, packed LSB-first into 8 words.  The
  words are ``torch.int32`` holding the uint32 bits (torch's uint32 lacks
  ``>>`` and ``+``); ``.numpy().view(np.uint32)`` gives the reference's
  words back.

Padded (masked-out) keypoints produce zero descriptors with mask=False.
"""
from __future__ import annotations

import numpy as np
import torch

from points_matching_tpu_torch.core.config import DescriptorConfig
from points_matching_tpu_torch.core.types import Descriptors, Keypoints
from points_matching_tpu_torch.ops.detect import gaussian_blur
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


def _brief_pattern(num_bits: int = 256, patch: float = 31.0, seed: int = 7):
    """Deterministic BRIEF test pattern: Gaussian point pairs in the patch
    (σ = patch/5), clipped to ±patch/2 — the reference's generator, so the
    float32 pattern is equal, not merely close.  Returns numpy (a, b), each
    [num_bits, 2] float32."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    a = np.clip(rng.randn(num_bits, 2) * sigma, -patch / 2, patch / 2)
    b = np.clip(rng.randn(num_bits, 2) * sigma, -patch / 2, patch / 2)
    return a.astype(np.float32), b.astype(np.float32)


def pack_bits(bits: Tensor) -> Tensor:
    """[..., 32·W] bool → [..., W] int32 words holding the uint32 bits,
    LSB-first: bit b of word w is entry 32·w + b."""
    w = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    words = (w << torch.arange(32, device=bits.device)).sum(-1)
    # the uint32 bit pattern as int32: words ≥ 2³¹ wrap to negative
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def orb_describe(image: Tensor, kps: Keypoints, num_bits: int = 256) -> Descriptors:
    """Rotation-steered BRIEF (ORB-class) binary descriptors, bit-packed.

    Bit b of word w is the test 32·w + b: ``va < vb`` with both endpoints
    of the pattern pair rotated by the keypoint angle, scaled by
    max(scale/1.2, 1) and bilinearly sampled on the σ = 2 blurred image.

    Returns Descriptors([N, num_bits/32] int32 words, binary=True).
    """
    if num_bits % 32:
        raise ValueError(f"num_bits must be a multiple of 32, got {num_bits}")
    pa, pb = (torch.as_tensor(p, device=image.device) for p in _brief_pattern(num_bits))
    smoothed = gaussian_blur(image.to(torch.float32), 2.0)

    ca, sa = torch.cos(kps.angle)[:, None], torch.sin(kps.angle)[:, None]
    s = (kps.scale / 1.2).clamp_min(1.0)[:, None]           # pattern scales with σ

    def endpoints(p: Tensor) -> Tensor:
        # xy + (R @ p) · s, R = [[ca, -sa], [sa, ca]]
        px, py = p[None, :, 0], p[None, :, 1]
        offs = torch.stack([ca * px + (-sa) * py, sa * px + ca * py], -1)
        return kps.xy[:, None, :] + offs * s[..., None]       # [N, B, 2]

    bits = bilinear_sample(smoothed, endpoints(pa)) < bilinear_sample(smoothed, endpoints(pb))
    words = torch.where(kps.mask[:, None], pack_bits(bits), 0)
    return Descriptors(data=words, mask=kps.mask, binary=True)


def extract_descriptors(image: Tensor, kps: Keypoints,
                        config: DescriptorConfig = DescriptorConfig()) -> Descriptors:
    """Dispatch on the configured family."""
    if config.kind == "surf":
        return surf_describe(image, kps, upright=config.upright)
    if config.kind == "orb":
        return orb_describe(image, kps)
    raise ValueError(f"unknown descriptor kind: {config.kind!r}")
