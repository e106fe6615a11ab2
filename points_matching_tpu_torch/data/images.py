"""Host-side image loading feeding device buffers (implicit component N7:
``cv::imread`` replacement; demo call site ``Points Matching/main.cpp:14-15``).

Decode order: the native C++ layer (``native/pmt_native.cc`` — libjpeg/
libpng/BMP/PNM with a thread-pool batch path; same native/host split as the
reference, whose decoding lives in OpenCV's C++ highgui) → PIL fallback when
the shared library has not been built.  Output is float32 grayscale in
[0, 255] (the value scale the reference's 8-bit pipeline and its Hessian
threshold assume); callers move it to the device once per frame.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from points_matching_tpu_torch.data import native


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma (identical weights to OpenCV's cvtColor)."""
    if rgb.ndim == 2:
        return rgb.astype(np.float32)
    if rgb.shape[-1] == 1:
        return rgb[..., 0].astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(np.float32)


def _pil_decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_image(path: str, grayscale: bool = True) -> np.ndarray:
    """Decode an image file.

    Returns float32 [H, W] grayscale (0-255) by default, or uint8 [H, W, 3].
    """
    if grayscale:
        arr = native.decode_gray(path)
        if arr is not None:
            return arr
        return rgb_to_gray(_pil_decode(path))
    return _pil_decode(path)


def load_batch(
    paths: Sequence[str], num_threads: int = 0
) -> np.ndarray:
    """Decode a uniform-size image sequence → float32 [N, H, W].

    Native path: one C++ thread-pool call filling a single contiguous
    buffer (the shape ``torch.from_numpy`` wants).  Fallback: sequential PIL.
    """
    if not paths:
        return np.zeros((0, 0, 0), np.float32)
    info = native.image_info(paths[0])
    if info is not None:
        w, h = info
        out = native.decode_batch_gray(paths, w, h, num_threads)
        if out is not None:
            return out
    imgs = [load_image(p) for p in paths]
    return np.stack(imgs)


def load_pair(path1: str, path2: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load the two demo images (reference ``main.cpp:14-15``)."""
    return load_image(path1), load_image(path2)
