"""Build and load the port's CUDA kernels.

All kernel sources in ``points_matching_tpu_torch/csrc/`` are compiled by
``nvcc`` for Hopper (``sm_90a``), one process a source, all at once, and
linked into ONE shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is included, so the
build takes seconds, not minutes.  The library lands in ``build/kernels/``
at the repository root, named by a hash of the sources and flags, and is
built at first use: a fresh checkout builds everything it needs.

Flags: ``-O3``; no ``--use_fast_math`` (approximate sqrt/rsqrt/division
would move the 8-point solve and the Sampson gate away from their plain
versions); ``--fmad=false`` so that ``a*b + c`` written out in the K2/K3
sources rounds twice, exactly like PyTorch's eager elementwise ops in the
plain versions.  Kernels that want fused multiply-adds (K1's dot product)
call ``fmaf`` explicitly, which the flag does not touch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argtypes (pointers, ints, floats, then the stream)
_SIGNATURES: Dict[str, list] = {
    # q, t, t_mask, t_points, dist, idx, pts, part, q2, B, N1, N2, D, P, S, bf16, stream
    "pmt_l2_top2": [_P] * 9 + [_I] * 7 + [_P],
    # F, p1, p2, mask, counts, B, H, N, tau2, warps, per_warp, stream
    "pmt_ransac_score": [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P],
    # sp1, sp2, F, count, group, stream
    "pmt_eight_point": [_P] * 3 + [_I, _I, _P],
    # q, t, t_mask, dist, idx, part, B, N1, N2, W, S, stream
    "pmt_hamming_top2": [_P] * 6 + [_I] * 5 + [_P],
    # q, t, out, part, B, N1, N2, D, S, design, stream
    "pmt_probe_gemm_rowmin": [_P] * 4 + [_I] * 6 + [_P],
    # q, t, t2, dist, idx, part, q2, B, N1, N2, D, S, design, stream
    "pmt_probe_packed_top2": [_P] * 7 + [_I] * 6 + [_P],
    # F, p1, p2, mask, counts, B, H, N, S, tau2, gate, products, design, stream
    "pmt_probe_score": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # values, perm, offsets, pieces, piece_rows, out, scratch, arrivals, n, W, long_blocks,
    # f64, stream
    "pmt_segment_sum": [_P] * 8 + [_I] * 4 + [_P],
}

last_build: Dict[str, object] = {}


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def library_path() -> str:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpmt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if it is not built yet; return its path.
    Each source compiles to an object in its own ``nvcc``, all started
    together, and one more ``nvcc`` links them.  ``last_build`` records the
    seconds taken."""
    so = library_path()
    if os.path.exists(so):
        last_build.update(path=so, seconds=0.0, cached=True)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    objdir = tempfile.mkdtemp(dir=BUILD_DIR)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [os.path.join(objdir, os.path.basename(src) + ".o") for src in cu]
    t0 = time.perf_counter()
    procs = []
    try:
        for src, obj in zip(cu, objs):
            procs.append(subprocess.Popen(
                [_nvcc(), *compile_flags, "-I", CSRC, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for src, proc in zip(cu, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        os.unlink(tmp)
        raise
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, so)          # atomic: a concurrent loader never sees half a file
    last_build.update(path=so, seconds=seconds, cached=False)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once) and load the kernel library, with argtypes declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmt_error_string.argtypes = [ctypes.c_int]
    lib.pmt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch status)."""
    if rc != 0:
        msg = lib.pmt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def pad_width(x, built: Tuple[int, ...], chunk: int):
    """``x`` [..., n] with zeros appended on its last axis: up to the
    narrowest width in ``built`` that holds n, or, above the widest, up to a
    whole number of ``chunk``-wide chunks (the kernels' chunked path); ``x``
    itself when n is already such a width.  The matchers' widths pad
    exactly: a zero column adds 0 to ⟨q,t⟩, ‖q‖² and ‖t‖², a zero word no
    bits to an XOR.  The chunked kernels loop over the width inside a cell's
    sum, which ends before the cell reaches the top-2, so no width is too
    wide."""
    n = x.shape[-1]
    width = next((w for w in built if w >= n), None)
    if width is None:
        width = -(-n // chunk) * chunk
    if width == n:
        return x
    import torch.nn.functional as F

    return F.pad(x, (0, width - n))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def train_splits(pairs: int, query_tiles: int, n_train: int, num_sms: int,
                 min_cols: int) -> int:
    """How many blocks share one query tile's train axis in the top-2
    matchers (K1, K4): the fewest that give pairs × query tiles × splits ≥
    ``num_sms`` blocks, with at least ``min_cols`` train columns a split;
    1 where the pairs and query tiles alone fill the card.  The splits'
    partial top-2s merge exactly, so the count changes no result."""
    blocks = pairs * query_tiles
    if blocks == 0 or blocks >= num_sms:
        return 1
    return max(1, min(-(-num_sms // blocks), n_train // min_cols))


def one_wave_splits(blocks: int, n_axis: int, num_sms: int, min_per_split: int) -> int:
    """How many blocks share one block's loop axis (train rows, points) in
    the probes' wgmma kernels, which run one block an SM: the most splits
    that keep ``blocks`` × splits within one wave of ``num_sms`` blocks,
    with at least ``min_per_split`` items a split; 1 where ``blocks`` alone
    fill a wave or more.  A second, partial wave would cost a whole block's
    time; fewer splits leave SMs idle.  The splits' partials combine
    exactly, so the count changes no result."""
    if blocks <= 0:
        return 1
    return max(1, min(num_sms // blocks, n_axis // min_per_split))


# K3 gives each sample 8 lanes while the batch holds at most this many
# samples an SM (4,224 on an H100's 132 SMs), else 1.  On the H100, G = 8
# was fastest from 512 to 4,096 samples and G = 1 from 6,144 to 32,768
# (examples/probe_eightpoint_torch.py --groups, PERF.md); G = 2 and 4 were
# fastest at no count and are not built.
EIGHT_POINT_GROUP_SAMPLES_PER_SM = 32


def eight_point_group(count: int, num_sms: int) -> int:
    """Lanes per sample G ∈ {1, 8} of the 8-point kernel (K3): 8 while
    count ≤ ``EIGHT_POINT_GROUP_SAMPLES_PER_SM`` × ``num_sms``, else 1.
    The 8 lanes shorten a sample's chain (they share its Hartley roots and
    AᵀA entries) but add shared-memory traffic and warps; once the batch
    alone gives the SMs their warps, the extra lanes only queue.  G changes
    no bit of the result."""
    return 8 if count <= EIGHT_POINT_GROUP_SAMPLES_PER_SM * num_sms else 1


# K2 (the RANSAC scorer) is built for these warps a block and hypotheses a
# warp.  On the H100, from one pair to 1,132 (examples/probe_ransac_score_torch.py
# --shapes, PERF.md): two warps a block were fastest while the batch held at
# most 4 hypotheses an SM (one pair of 128 to 512), eight above; and the
# most hypotheses a warp of 1, 2, 4, 8, 16 that still left 8 warps an SM.  Four
# warps a block were fastest at no shape the paths launch and are not built.
RANSAC_SCORE_WARPS = (2, 8)
RANSAC_SCORE_PER_WARP = (1, 2, 4, 8, 16)
RANSAC_SCORE_FEW_HYPS_PER_SM = 4
RANSAC_SCORE_WARPS_PER_SM = 8


def ransac_score_tile(pairs: int, hyps: int, num_sms: int) -> Tuple[int, int]:
    """(warps a block, hypotheses a warp) of the RANSAC scorer (K2) for
    ``pairs`` × ``hyps`` hypotheses: 2 warps a block while there are at most
    ``RANSAC_SCORE_FEW_HYPS_PER_SM`` hypotheses an SM, else 8; hypotheses a
    warp the most of ``RANSAC_SCORE_PER_WARP`` that leaves at least
    ``RANSAC_SCORE_WARPS_PER_SM`` warps an SM.  A warp scores its hypotheses
    over the same points in registers, so more hypotheses a warp load each
    point fewer times but spread the batch over fewer warps.  The tile
    changes no count."""
    total = pairs * hyps
    warps = 2 if total <= RANSAC_SCORE_FEW_HYPS_PER_SM * num_sms else 8
    per_warp = 1
    while (per_warp < RANSAC_SCORE_PER_WARP[-1]
           and total // (2 * per_warp) >= RANSAC_SCORE_WARPS_PER_SM * num_sms):
        per_warp *= 2
    return warps, per_warp
