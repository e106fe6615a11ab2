"""Keypoint detection — port of ``points_matching_tpu/ops/detect.py``.

Three kinds: ``hessian`` (SURF-class determinant of Hessian over a scale
ladder), ``harris`` (Harris corners over the same ladder) and ``fast``
(FAST-9 on one scale, the ORB configuration's detector).  Responses are
separable Gaussian(-derivative) convolutions at full resolution
(``F.conv2d``, SAME zero padding, fp32 with TF32 off) or, for FAST, ring
shifts that wrap at the image edges like the reference's ``jnp.roll``;
then spatial and scale non-max suppression by window maxima, a
fixed-capacity exact top-k over the response volume, a per-winner
sub-pixel parabola step and a smooth dominant orientation (none for FAST,
whose keypoints stay upright as in the reference).  Static capacity +
validity mask, as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from points_matching_tpu_torch.core.config import DetectorConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import Keypoints
from points_matching_tpu_torch.ops.sampling import bilinear_sample

Tensor = torch.Tensor


def _gaussian_kernel1d(sigma: float, radius: int, order: int = 0) -> np.ndarray:
    """1-D Gaussian (order 0), first (1) or second (2) derivative taps."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = g / np.sum(g)
    if order == 0:
        return g
    if order == 1:
        return (g * (-x / sigma**2)).astype(np.float32)
    if order == 2:
        return (g * ((x**2 - sigma**2) / sigma**4)).astype(np.float32)
    raise ValueError(order)


def _conv_sep(img: Tensor, kys, kxs) -> Tensor:
    """Separable 2-D correlations of [H, W] with pairs of 1-D taps
    (``kys[c]`` along y, then ``kxs[c]`` along x), SAME zero padding.
    All taps have the same length.  Returns [C, H, W]."""
    n = len(kys[0])
    R = (n - 1) // 2
    ky = torch.as_tensor(np.stack(kys), device=img.device)[:, None, :, None]
    kx = torch.as_tensor(np.stack(kxs), device=img.device)[:, None, None, :]
    cols = F.conv2d(img[None, None], ky, padding=(R, 0))           # [1, C, H, W]
    return F.conv2d(cols, kx, padding=(0, R), groups=len(kxs))[0]


def _blur_maps(maps: Tensor, sigma: float) -> Tensor:
    """Gaussian blur of each of [C, H, W] maps (SAME zero padding)."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    g = torch.as_tensor(_gaussian_kernel1d(sigma, r, 0), device=maps.device)
    C = maps.shape[0]
    cols = F.conv2d(maps[None], g.view(1, 1, -1, 1).expand(C, 1, -1, 1),
                    padding=(r, 0), groups=C)
    return F.conv2d(cols, g.view(1, 1, 1, -1).expand(C, 1, 1, -1),
                    padding=(0, r), groups=C)[0]


def gaussian_blur(img: Tensor, sigma: float) -> Tensor:
    """Gaussian blur of an [H, W] image, radius ⌈3σ⌉, SAME zero padding."""
    return _blur_maps(img[None], sigma)[0]


def hessian_response(img: Tensor, sigma: float) -> Tensor:
    """Scale-normalized determinant of Hessian at scale ``sigma``:
    σ⁴·(Lxx·Lyy − (0.9·Lxy)²)."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    g0 = _gaussian_kernel1d(sigma, r, 0)
    g1 = _gaussian_kernel1d(sigma, r, 1)
    g2 = _gaussian_kernel1d(sigma, r, 2)
    Lxx, Lyy, Lxy = _conv_sep(img, [g0, g2, g1], [g2, g0, g1])
    s4 = sigma**4
    return s4 * (Lxx * Lyy - (0.9 * Lxy) ** 2)


def harris_response(img: Tensor, sigma: float, k: float = 0.04) -> Tensor:
    """Harris corner response at integration scale ``sigma`` (derivative
    scale 0.7σ): σ²·(det S − k·tr(S)²) of the blurred structure tensor S."""
    gd = 0.7 * sigma
    r = max(1, int(math.ceil(3.0 * gd)))
    g0 = _gaussian_kernel1d(gd, r, 0)
    g1 = _gaussian_kernel1d(gd, r, 1)
    Ix, Iy = _conv_sep(img, [g0, g1], [g1, g0])
    Sxx, Syy, Sxy = _blur_maps(torch.stack([Ix * Ix, Iy * Iy, Ix * Iy]), sigma)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return sigma**2 * (det - k * tr * tr)


_FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_response(img: Tensor, threshold: float, arc: int = 9) -> Tensor:
    """FAST-N corner score: a pixel is a corner when ``arc`` contiguous
    pixels of its 16-pixel ring are all brighter (or all darker) than it by
    more than ``threshold``; the score is Σ|diff| over the ring pixels
    beyond the threshold, 0 elsewhere.  The ring is the image shifted by
    the 16 offsets with ``torch.roll``, which wraps at the edges exactly as
    the reference's ``jnp.roll`` does."""
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dy, dx in _FAST_OFFSETS])                  # [16, H, W]
    diff = ring - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def has_arc(bits: Tensor) -> Tensor:
        acc = bits
        for s in range(1, arc):
            acc = acc & torch.roll(bits, -s, dims=0)
        return acc.any(0)

    is_corner = has_arc(brighter) | has_arc(darker)
    score = torch.where(brighter | darker, diff.abs(), 0.0).sum(0)
    return torch.where(is_corner, score, 0.0)


def detector_sigmas(config: DetectorConfig) -> Tuple[float, ...]:
    """Scale ladder: SURF-like geometric progression from σ₀ = 1.2."""
    return tuple(
        1.2 * (2.0 ** (o + l / config.layers_per_octave))
        for o in range(config.num_octaves)
        for l in range(config.layers_per_octave)
    )


def _spatial_nms(resp: Tensor, radius: int) -> Tensor:
    """True where resp equals the local max in a (2r+1)² window."""
    k = 2 * radius + 1
    mx = F.max_pool2d(resp[:, None], k, stride=1, padding=radius)[:, 0]
    return resp >= mx


def _scale_nms(resp: Tensor) -> Tensor:
    """True where resp is ≥ its scale neighbors (3-tap over scale axis 0)."""
    ninf = torch.full_like(resp[:1], -math.inf)
    up = torch.cat([resp[1:], ninf], 0)
    dn = torch.cat([ninf, resp[:-1]], 0)
    return (resp >= up) & (resp >= dn)


def _orientation(img: Tensor, xy: Tensor, scale: Tensor) -> Tensor:
    """Dominant orientation: Gaussian-weighted average gradient direction in
    a 6σ window (smooth analogue of SURF's Haar-sector vote)."""
    g = torch.linspace(-1.0, 1.0, 13, device=img.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    offs = torch.stack([gx, gy], -1).reshape(-1, 2)                # [169, 2]
    w = torch.exp(-0.5 * (offs[:, 0] ** 2 + offs[:, 1] ** 2) / 0.5**2)

    pts = xy[:, None, :] + 3.0 * scale[:, None, None] * offs[None]  # [N, 169, 2]
    ex = torch.tensor([[1.0, 0.0]], device=img.device)
    ey = torch.tensor([[0.0, 1.0]], device=img.device)
    h = scale[:, None].clamp_min(1.0)[..., None]
    gx_s = bilinear_sample(img, pts + ex * h) - bilinear_sample(img, pts - ex * h)
    gy_s = bilinear_sample(img, pts + ey * h) - bilinear_sample(img, pts - ey * h)
    mx = (gx_s * w[None]).sum(1)
    my = (gy_s * w[None]).sum(1)
    return torch.atan2(my, mx)


def _parab(prev: Tensor, c: Tensor, nxt: Tensor) -> Tensor:
    denom = prev - 2.0 * c + nxt
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    return (0.5 * (prev - nxt) / denom).clamp(-0.5, 0.5)


def _pad_to(x: Tensor, k: int, value) -> Tensor:
    return x if x.shape[0] >= k else F.pad(x, (0, k - x.shape[0]), value=value)


def _top_k_peaks(score_m: Tensor, k: int, nms_radius: int):
    """The k best cells of the [S, H, W] masked response (``-inf`` off the
    peaks), best first: (scores, s, y, x), at most k entries (fewer on a
    small image).  With ``nms_radius`` ≥ 1 (at most one peak per 2×2
    block) the finite entries are a flat ``torch.topk``'s over all cells,
    taken in two stages."""
    S, H, W = score_m.shape
    if nms_radius >= 1:
        # radius ≥ 1 NMS leaves at most one distinct peak per 2×2 block:
        # top-k over block maxima, then recover the winning cell
        H2, W2 = -(-H // 2), -(-W // 2)
        p = F.pad(score_m, (0, 2 * W2 - W, 0, 2 * H2 - H), value=-math.inf)
        bmax = p.reshape(S, H2, 2, W2, 2).amax(dim=(2, 4))             # [S, H2, W2]
        # exact two-stage top-k: every global top-k element is in its own
        # scale's top-k (capped at the plane size for small images)
        k1 = min(k, H2 * W2)
        ts, ti = torch.topk(bmax.reshape(S, -1), k1)
        top_scores, sel = torch.topk(ts.reshape(-1), min(k, S * k1))
        s_idx = sel // k1
        rem = ti.reshape(-1)[sel]
        yb, xb = rem // W2, rem % W2
        pf = p.reshape(-1)
        Wp = 2 * W2
        base = s_idx * (2 * H2 * Wp) + (2 * yb) * Wp + 2 * xb
        cells = torch.stack([pf[base], pf[base + 1], pf[base + Wp],
                             pf[base + Wp + 1]], -1)                  # [k, 4]
        la = cells.argmax(-1)                                         # first on ties
        y_idx = yb * 2 + (la >> 1)
        x_idx = xb * 2 + (la & 1)
    else:
        top_scores, top_idx = torch.topk(score_m.reshape(-1), min(k, score_m.numel()))
        s_idx = top_idx // (H * W)
        rem = top_idx % (H * W)
        y_idx, x_idx = rem // W, rem % W
    return top_scores, s_idx, y_idx, x_idx


def detect_keypoints(image: Tensor, config: DetectorConfig = DetectorConfig()) -> Keypoints:
    """Detect up to ``config.max_keypoints`` keypoints (padded + masked).

    Args:
      image: [H, W] float32 grayscale in [0, 255].

    Returns a fixed-capacity ``Keypoints`` on the image's device.
    """
    pin_fp32()   # the responses are convolutions: keep cuDNN off TF32
    img = image.to(torch.float32)
    H, W = img.shape
    sigmas = detector_sigmas(config)

    if config.kind == "hessian":
        resp = torch.stack([hessian_response(img, s) for s in sigmas])   # [S, H, W]
        thresh = config.threshold * 1e-4  # SURF box-filter units → DoH units
    elif config.kind == "harris":
        resp = torch.stack([harris_response(img, s) for s in sigmas])
        thresh = config.threshold
    elif config.kind == "fast":
        resp = fast_response(img, config.threshold)[None]
        sigmas = (1.0,)
        thresh = 1e-6
    else:
        raise ValueError(f"unknown detector kind: {config.kind!r}")

    is_peak = _spatial_nms(resp, config.nms_radius) & _scale_nms(resp)
    yy = torch.arange(H, device=img.device)[None, :, None]
    xx = torch.arange(W, device=img.device)[None, None, :]
    b = config.border
    in_border = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    valid = is_peak & in_border & (resp > thresh)
    score_m = torch.where(valid, resp, -math.inf)

    k = config.max_keypoints
    top_scores, s_idx, y_idx, x_idx = _top_k_peaks(score_m, k, config.nms_radius)
    top_scores = _pad_to(top_scores, k, -math.inf)
    s_idx, y_idx, x_idx = (_pad_to(v, k, 0) for v in (s_idx, y_idx, x_idx))

    # per-winner sub-pixel offsets from the winner's 4 response neighbors
    rf = resp.reshape(-1)
    yc = y_idx.clamp(1, H - 2)
    xc = x_idx.clamp(1, W - 2)
    basec = s_idx * (H * W) + yc * W + xc
    cur = rf[basec]
    dxv = _parab(rf[basec - 1], cur, rf[basec + 1])
    dyv = _parab(rf[basec - W], cur, rf[basec + W])

    xy = torch.stack([x_idx.to(torch.float32) + dxv,
                      y_idx.to(torch.float32) + dyv], -1)
    scale = torch.tensor(sigmas, dtype=torch.float32, device=img.device)[s_idx]
    mask = torch.isfinite(top_scores)
    score = torch.where(mask, top_scores, 0.0)

    if config.compute_orientation and config.kind != "fast":
        angle = _orientation(img, xy, scale)
    else:
        angle = torch.zeros((k,), dtype=torch.float32, device=img.device)
    return Keypoints(xy=xy, scale=scale, angle=angle, score=score, mask=mask)
