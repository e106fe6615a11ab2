"""K1 / K1b — fused squared-L2 distance + top-2 matching, batched over pairs.

Replaces the TPU kernels ``points_matching_tpu/ops/pallas/matching_kernel.py``
``fused_l2_top2`` and ``fused_l2_top2_points``.  CUDA source:
``points_matching_tpu_torch/csrc/matching_top2.cu``: blocks of 128 query
rows × one of S train splits × one pair; 4 × 16 register tiles of fp32 FMA
chains over cp.async double-buffered train tiles in shared memory; a
running top-2 per thread, merged across threads and then across splits
lexicographically by (distance, column), which is exact — the [N1, N2]
matrix never exists.  The wrapper picks S (``_build.train_splits``) so that
a launch has at least as many blocks as the card has SMs (one pair of 512 ×
512: 4 × 33 = 132 blocks; 64 pairs: S = 1), and gives the kernel its
scratch for the S partials.  On the card the kernel is bound by fp32 FMA
issue (2·N1·N2·D flops per pair against (N1+N2)·D·4 bytes).

Each wrapper takes a leading pair axis, launches the kernel for CUDA
tensors, and runs the plain PyTorch version (``*_plain``) for CPU tensors.
The kernel is built for D ∈ ``BUILT_DIMS``; on the card the wrapper pads
any narrower D with zero columns up to the next built width, which changes
no distance and no index.  Above the widest, D is padded to a multiple of
``CHUNK_DIM`` and the chunked kernel loops over the width inside each
cell's sum (still one fmaf chain over k in order), so any D runs.
The plain version is the same function written with ``torch.matmul`` and
two argmin passes; the tests hold it against the JAX kernel in interpret
mode, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite, check_index

Tensor = torch.Tensor
_BIG = 1e30
ROWS_PER_BLOCK = 128    # query rows of a block: kRowsPerBlock in matching_top2.cu
MIN_SPLIT_COLS = 8      # train columns a split keeps at least
# descriptor widths the CUDA kernel is instantiated for (32: the synthetic
# SfM sequences, 64: SURF, 128: SIFT); the wrapper pads narrower ones
BUILT_DIMS = (32, 64, 128)
CHUNK_DIM = 64          # width chunk of the kernel above 128: kChunk in matching_top2.cu


def _check_inputs(q: Tensor, t: Tensor, t_mask: Tensor,
                  t_points: Optional[Tensor], compute_dtype: str) -> None:
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown compute_dtype: {compute_dtype!r}")
    if q.dim() != 3 or t.dim() != 3 or q.shape[0] != t.shape[0] \
            or q.shape[2] != t.shape[2]:
        raise ValueError(f"expected q [B, N1, D] and t [B, N2, D], got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    if tuple(t_mask.shape) != tuple(t.shape[:2]):
        raise ValueError(f"t_mask must be [B, N2], got {tuple(t_mask.shape)}")
    if t_points is not None and (t_points.dim() != 3
                                 or tuple(t_points.shape[:2]) != tuple(t.shape[:2])
                                 or t_points.shape[2] > 8):
        raise ValueError(f"t_points must be [B, N2, P≤8], got {tuple(t_points.shape)}")
    if q.dtype != torch.float32 or t.dtype != torch.float32 or \
            (t_points is not None and t_points.dtype != torch.float32):
        raise TypeError("q, t and t_points must be float32")
    if t_mask.dtype != torch.bool:
        raise TypeError("t_mask must be bool")
    devices = {x.device for x in (q, t, t_mask, t_points) if x is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def l2_top2_plain(q: Tensor, t: Tensor, t_mask: Tensor,
                  compute_dtype: str = "f32") -> Tuple[Tensor, Tensor]:
    """Plain PyTorch K1: (dist [B, N1, 2], idx [B, N1, 2] int32).

    d = ‖t‖² − 2⟨q,t⟩ with ‖t‖² = 1e30 on invalid train rows, best and
    runner-up with ties to the lowest column, then + ‖q‖² and clamp at 0."""
    t2 = (t * t).sum(-1)
    t2 = torch.where(t_mask, t2, torch.full_like(t2, _BIG))
    if compute_dtype == "bf16":
        qg = q.to(torch.bfloat16).float()
        tg = t.to(torch.bfloat16).float()
    else:
        qg, tg = q, t
    d = t2[:, None, :] - 2.0 * (qg @ tg.transpose(-1, -2))      # [B, N1, N2]
    m1, i1 = d.min(-1)                   # first minimum on ties
    masked = d.scatter(-1, i1[..., None], _BIG)
    m2, i2 = masked.min(-1)
    q2 = (q * q).sum(-1)
    dist = torch.stack([m1 + q2, m2 + q2], -1).clamp_min(0.0)
    idx = torch.stack([i1, i2], -1).to(torch.int32)
    return dist, idx


def l2_top2_points_plain(q: Tensor, t: Tensor, t_mask: Tensor, t_points: Tensor,
                         compute_dtype: str = "f32") -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch K1b: K1 + ``t_points[idx[..., 0]]`` per query row."""
    dist, idx = l2_top2_plain(q, t, t_mask, compute_dtype)
    best = idx[..., 0].long()[..., None].expand(-1, -1, t_points.shape[-1])
    return dist, idx, t_points.gather(1, best)


def _launch(q, t, t_mask, t_points, compute_dtype):
    for x in (q, t, t_mask, t_points):
        if x is not None and not x.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous inputs")
    # zero columns up to the next built width or whole chunk (a fresh,
    # aligned copy)
    q, t = (_build.pad_width(x, BUILT_DIMS, CHUNK_DIM) for x in (q, t))
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned q and t")
    lib = _build.library()
    B, N1, _ = q.shape
    N2 = t.shape[1]
    P = 0 if t_points is None else t_points.shape[2]
    S = _build.train_splits(B, -(-N1 // ROWS_PER_BLOCK), N2,
                            _build.sm_count(q.device.index), MIN_SPLIT_COLS)
    dist = torch.empty((B, N1, 2), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, N1, 2), dtype=torch.int32, device=q.device)
    pts = None if t_points is None else torch.empty(
        (B, N1, P), dtype=torch.float32, device=q.device)
    # the splits' partial top-2s (int4 each) and ‖q‖², for the merge kernel
    part = q2 = None
    if S > 1:
        part = torch.empty((B, S, N1, 4), dtype=torch.int32, device=q.device)
        q2 = torch.empty((B, N1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pmt_l2_top2(
            q.data_ptr(), t.data_ptr(), t_mask.data_ptr(),
            None if t_points is None else t_points.data_ptr(),
            dist.data_ptr(), idx.data_ptr(),
            None if pts is None else pts.data_ptr(),
            None if part is None else part.data_ptr(),
            None if q2 is None else q2.data_ptr(),
            B, N1, N2, q.shape[2], P, S, int(compute_dtype == "bf16"), stream)
    _build.check(lib, rc, "pmt_l2_top2")
    return dist, idx, pts


def _check_outputs(name: str, n2: int, dist: Tensor, idx: Tensor,
                   pts: Optional[Tensor] = None) -> None:
    """Inside a ``utils/sanitize.checked`` run: the kernel's distances
    (and points) finite, its indices in [0, N2)."""
    check_finite(dist, name)
    check_index(idx, n2, name)
    if pts is not None:
        check_finite(pts, name)


def fused_l2_top2(q: Tensor, t: Tensor, t_mask: Tensor,
                  compute_dtype: str = "f32") -> Tuple[Tensor, Tensor]:
    """Squared-L2 (best, second-best) distances and indices per query row.

    Args:
      q: [B, N1, D] query descriptors; t: [B, N2, D] train descriptors.
      t_mask: [B, N2] bool — invalid train rows are excluded.

    Returns (dist [B, N1, 2] f32, idx [B, N1, 2] int32); column 0 is the
    1-NN, column 1 the 2-NN.  The caller applies query-side masking.
    """
    _check_inputs(q, t, t_mask, None, compute_dtype)
    if q.device.type == "cpu":
        dist, idx = l2_top2_plain(q, t, t_mask, compute_dtype)
    elif q.device.type == "cuda":
        dist, idx, _ = _launch(q, t, t_mask, None, compute_dtype)
        fused_l2_top2.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    _check_outputs("fused_l2_top2", t.shape[1], dist, idx)
    return dist, idx


def fused_l2_top2_points(q: Tensor, t: Tensor, t_mask: Tensor, t_points: Tensor,
                         compute_dtype: str = "f32") -> Tuple[Tensor, Tensor, Tensor]:
    """``fused_l2_top2`` + the 1-NN train point per query row:
    (dist [B, N1, 2], idx [B, N1, 2], pts [B, N1, P]) with
    ``pts[b, i] == t_points[b, idx[b, i, 0]]`` exactly."""
    _check_inputs(q, t, t_mask, t_points, compute_dtype)
    if q.device.type == "cpu":
        out = l2_top2_points_plain(q, t, t_mask, t_points, compute_dtype)
    elif q.device.type == "cuda":
        out = _launch(q, t, t_mask, t_points, compute_dtype)
        fused_l2_top2_points.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    _check_outputs("fused_l2_top2_points", t.shape[1], *out)
    return out


fused_l2_top2.launches = 0
fused_l2_top2_points.launches = 0
fused_l2_top2.work = _work.l2_top2_work            # bytes and flops of a call
fused_l2_top2_points.work = _work.l2_top2_work
