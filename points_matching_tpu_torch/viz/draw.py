"""Offline visualization — replaces the reference's interactive
``imshow``/``waitKey`` windows and ``drawKeypoints``/``drawMatches``/
``cv::line`` overlays (components E3/E8/E12/E13, N8;
``Points Matching/main.cpp:29-33, 82-84, 127-145``) with PNG rendering,
since an accelerator host has no GUI.

Pure-numpy rasterization (circles, segments) — no GUI/toolkit dependency.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]
_GREEN: Color = (0, 220, 80)
_WHITE: Color = (255, 255, 255)
_RED: Color = (230, 60, 40)


def _as_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _draw_circle(img: np.ndarray, cx: float, cy: float, r: float, color: Color):
    H, W = img.shape[:2]
    r = max(float(r), 1.0)
    t = np.linspace(0, 2 * np.pi, max(int(4 * r), 16))
    xs = np.round(cx + r * np.cos(t)).astype(int)
    ys = np.round(cy + r * np.sin(t)).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def _draw_segment(img: np.ndarray, x0, y0, x1, y1, color: Color):
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.round(np.linspace(x0, x1, n)).astype(int)
    ys = np.round(np.linspace(y0, y1, n)).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def draw_keypoints(
    image: np.ndarray,
    kps,
    rich: bool = False,
    color: Color = _GREEN,
) -> np.ndarray:
    """``cv::drawKeypoints`` equivalent; ``rich=True`` mirrors
    DRAW_RICH_KEYPOINTS (scale circle + orientation tick, ``main.cpp:30``)."""
    img = _as_rgb(image)
    xy = np.asarray(kps.xy)
    mask = np.asarray(kps.mask)
    scale = np.asarray(kps.scale)
    angle = np.asarray(kps.angle)
    for i in np.nonzero(mask)[0]:
        x, y = xy[i]
        if rich:
            r = 3.0 * scale[i]
            _draw_circle(img, x, y, r, color)
            _draw_segment(img, x, y, x + r * np.cos(angle[i]), y + r * np.sin(angle[i]), color)
        else:
            _draw_circle(img, x, y, 2.0, color)
    return img


def draw_matches(
    image1: np.ndarray,
    kps1,
    image2: np.ndarray,
    kps2,
    matches,
    max_draw: int = 200,
) -> np.ndarray:
    """``cv::drawMatches`` equivalent (NOT_DRAW_SINGLE_POINTS semantics:
    only matched keypoints are rendered; ``main.cpp:82-83``).  Images are
    placed side by side."""
    im1 = _as_rgb(image1)
    im2 = _as_rgb(image2)
    H = max(im1.shape[0], im2.shape[0])
    W = im1.shape[1] + im2.shape[1]
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[: im1.shape[0], : im1.shape[1]] = im1
    canvas[: im2.shape[0], im1.shape[1] :] = im2
    off = im1.shape[1]

    xy1 = np.asarray(kps1.xy)
    xy2 = np.asarray(kps2.xy)
    q = np.asarray(matches.query_idx)
    t = np.asarray(matches.train_idx)
    mask = np.asarray(matches.mask)
    rng = np.random.RandomState(0)
    drawn = 0
    for i in np.nonzero(mask)[0]:
        if drawn >= max_draw:
            break
        color = tuple(int(c) for c in rng.randint(60, 255, 3))
        x1, y1 = xy1[q[i]]
        x2, y2 = xy2[t[i]]
        _draw_circle(canvas, x1, y1, 2, color)
        _draw_circle(canvas, x2 + off, y2, 2, color)
        _draw_segment(canvas, x1, y1, x2 + off, y2, color)
        drawn += 1
    return canvas


def draw_epilines(
    image: np.ndarray,
    lines: np.ndarray,
    mask: Optional[np.ndarray] = None,
    color: Color = _WHITE,
) -> np.ndarray:
    """Draw epipolar lines a·x + b·y + c = 0 across the full image width —
    exactly the reference's rendering (white segments from x=0 to x=W,
    ``main.cpp:137-142``)."""
    img = _as_rgb(image)
    H, W = img.shape[:2]
    lines = np.asarray(lines)
    if mask is None:
        mask = np.ones(len(lines), bool)
    for (a, b, c), m in zip(lines, np.asarray(mask)):
        if not m or abs(b) < 1e-9:
            continue
        y0 = -c / b
        y1 = -(c + a * (W - 1)) / b
        _draw_segment(img, 0, y0, W - 1, y1, color)
    return img


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image  # imported here: PIL is optional

    Image.fromarray(_as_rgb(img)).save(path)
