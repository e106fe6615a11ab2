"""K2 — RANSAC hypothesis scoring (Sampson gate + inlier count), batched over
pairs.

Replaces the TPU kernel ``points_matching_tpu/ops/pallas/ransac_kernel.py``
``ransac_score_hypotheses``.  CUDA source:
``points_matching_tpu_torch/csrc/ransac_score.cu``: a warp scores one
hypothesis at a time with its lanes splitting the pair's points, which a
block stages once into shared memory (a masked point as NaN, which no gate
passes) and each lane then holds in registers across its warp's
hypotheses; a warp's count is one REDUX.  The tile — (warps a block,
hypotheses a warp) — comes from ``_build.ransac_score_tile``; it changes no
count.
On the card it is bound by fp32 issue (~36 operations per hypothesis ×
point; K = 3 products gain nothing from tensor cores).  Only the [B, H]
counts leave the chip.

Both the kernel and the plain version score in exact fp32 — the TPU's
``exact``/``fast`` split existed only for its bf16 passes.
"""
from __future__ import annotations

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite, check_index

Tensor = torch.Tensor

# every (warps a block, hypotheses a warp) the CUDA kernel is built for
TILES = tuple((w, k) for w in _build.RANSAC_SCORE_WARPS for k in _build.RANSAC_SCORE_PER_WARP)


def _check_inputs(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor) -> None:
    if F_h.dim() != 4 or tuple(F_h.shape[2:]) != (3, 3):
        raise ValueError(f"F_h must be [B, H, 3, 3], got {tuple(F_h.shape)}")
    B = F_h.shape[0]
    if p1.dim() != 3 or p1.shape[0] != B or p1.shape[2] != 2 \
            or p2.shape != p1.shape:
        raise ValueError(f"p1/p2 must be [B, N, 2], got {tuple(p1.shape)} "
                         f"and {tuple(p2.shape)}")
    if tuple(mask.shape) != tuple(p1.shape[:2]) or mask.dtype != torch.bool:
        raise ValueError("mask must be bool [B, N]")
    if any(x.dtype != torch.float32 for x in (F_h, p1, p2)):
        raise TypeError("F_h, p1 and p2 must be float32")
    devices = {x.device for x in (F_h, p1, p2, mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def ransac_score_plain(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor,
                       threshold: float) -> Tensor:
    """Plain PyTorch K2: counts [B, H] int32 of correspondences with
    r² < τ²·max(denom, 1e-12) and mask set (same association order as
    ``geometry/fundamental.sampson_distance``)."""
    tau2 = float(threshold) ** 2
    f = [F_h[:, :, i // 3, i % 3, None] for i in range(9)]    # [B, H, 1] each
    x1, y1 = p1[:, None, :, 0], p1[:, None, :, 1]              # [B, 1, N]
    x2, y2 = p2[:, None, :, 0], p2[:, None, :, 1]
    a1 = f[0] * x1 + f[1] * y1 + f[2]
    a2 = f[3] * x1 + f[4] * y1 + f[5]
    a3 = f[6] * x1 + f[7] * y1 + f[8]
    b1 = f[0] * x2 + f[3] * y2 + f[6]
    b2 = f[1] * x2 + f[4] * y2 + f[7]
    r = a1 * x2 + a2 * y2 + a3
    denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2
    ok = (r * r < tau2 * denom.clamp_min(1e-12)) & mask[:, None, :]
    return ok.sum(-1, dtype=torch.int32)


def ransac_score_hypotheses(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor,
                            threshold: float, *, _tile=None) -> Tensor:
    """Per-hypothesis inlier counts under the Sampson gate.

    Args:
      F_h: [B, H, 3, 3] hypotheses; p1, p2: [B, N, 2] points;
      mask: [B, N] bool validity; threshold: gate in pixels (d < threshold²).
      _tile: (warps a block, hypotheses a warp) of the CUDA kernel, forced
        (tests and probes); None lets ``_build.ransac_score_tile`` choose.

    Returns counts [B, H] int32.
    """
    _check_inputs(F_h, p1, p2, mask)
    if _tile is not None and (not isinstance(_tile, tuple) or _tile not in TILES):
        raise ValueError(f"_tile must be one of {TILES}, got {_tile!r}")
    if F_h.device.type == "cpu":
        counts = ransac_score_plain(F_h, p1, p2, mask, threshold)
    elif F_h.device.type == "cuda":
        counts = _launch(F_h, p1, p2, mask, threshold, _tile)
        ransac_score_hypotheses.launches += 1
    else:
        raise ValueError(f"unsupported device {F_h.device}")
    # inside a utils/sanitize.checked run: every count in [0, N]
    check_index(counts, p1.shape[1] + 1, "ransac_score_hypotheses")
    return counts


def _launch(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, threshold: float,
            _tile) -> Tensor:
    if not all(x.is_contiguous() for x in (F_h, p1, p2, mask)):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    if p1.data_ptr() % 8 or p2.data_ptr() % 8:
        raise ValueError("the CUDA kernel needs 8-byte aligned p1 and p2")
    lib = _build.library()
    B, H = F_h.shape[:2]
    N = p1.shape[1]
    tile = _tile or _build.ransac_score_tile(B, H, _build.sm_count(F_h.device.index))
    counts = torch.empty((B, H), dtype=torch.int32, device=F_h.device)
    with torch.cuda.device(F_h.device):
        rc = lib.pmt_ransac_score(
            F_h.data_ptr(), p1.data_ptr(), p2.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), B, H, N, float(threshold) ** 2, *tile,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "pmt_ransac_score")
    ransac_score_hypotheses.last_tile = tile
    return counts


ransac_score_hypotheses.launches = 0
ransac_score_hypotheses.last_tile = None     # (warps, per_warp) of the last launch
ransac_score_hypotheses.work = _work.ransac_score_work
