"""ctypes binding for the native C++ decode layer (``native/pmt_native.cc``).

Builds with ``make -C native`` (libjpeg/libpng + hand-rolled BMP/PNM).  All
entry points return None / raise cleanly when the shared library has not
been built, so the pure-Python PIL path keeps working everywhere.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def load_library() -> Optional[ctypes.CDLL]:
    """Load libpmt_native.so once; None if unbuilt/unloadable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB or None
    _TRIED = True
    so = os.environ.get(
        "PMT_NATIVE_LIB",
        os.path.join(_repo_root(), "native", "libpmt_native.so"),
    )
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.pmt_image_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pmt_image_info.restype = ctypes.c_int
    lib.pmt_decode_gray_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.pmt_decode_gray_f32.restype = ctypes.c_int
    lib.pmt_decode_batch_gray_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.pmt_decode_batch_gray_f32.restype = ctypes.c_int
    _LIB = lib
    return lib


def image_info(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from the file header, or None without native lib."""
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.pmt_image_info(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_gray(path: str) -> Optional[np.ndarray]:
    """Decode one image to float32 [H, W] grayscale (0-255), or None."""
    lib = load_library()
    if lib is None:
        return None
    info = image_info(path)
    if info is None:
        return None
    w, h = info
    out = np.empty((h, w), np.float32)
    rc = lib.pmt_decode_gray_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h
    )
    return out if rc == 0 else None


def decode_batch_gray(
    paths: Sequence[str], width: int, height: int, num_threads: int = 0
) -> Optional[np.ndarray]:
    """Thread-pool decode of uniform-size images → float32 [N, H, W].

    The sequence-data fast path (TUM/KITTI frames are uniform): one call,
    C++ threads saturate the disks/cores, a single contiguous buffer goes
    straight to ``torch.from_numpy``.  Failed slots decode as zeros.
    """
    lib = load_library()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.pmt_decode_batch_gray_f32(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        width, height, num_threads,
    )
    if failures:
        import logging

        logging.getLogger("pmt.data").warning(
            "native batch decode: %d/%d files failed (zero-filled)", failures, n
        )
    return out
