"""K4 — fused popcount-Hamming distance + top-2 matching for packed binary
descriptors, batched over pairs.

Replaces the TPU kernel ``points_matching_tpu/ops/pallas/hamming.py``
``fused_hamming_top2``.  CUDA source:
``points_matching_tpu_torch/csrc/hamming_top2.cu``: blocks of 256 query rows
(2 per thread, in registers) × one of S train splits × one pair; cp.async
double-buffered train tiles read as warp broadcasts, 8 XOR + ``__popc`` per
distance, a running top-2 per row, merged across splits lexicographically
by (distance, column), which is exact — the [N1, N2] matrix never exists.
The wrapper picks S (``_build.train_splits``) so that a launch has at least
as many blocks as the card has SMs (one pair of 1024 × 1024: 4 × 33 = 132
blocks; 64 pairs: S = 1), and gives the kernel its scratch for the S
partials.  On the card the kernel is bound by POPC throughput (B·N1·N2·W
population counts at 16 per clock per SM).

Descriptor words are ``torch.int32`` tensors holding the uint32 bits.  The
wrapper takes a leading pair axis, launches the kernel for CUDA tensors and
runs the plain PyTorch version (``hamming_top2_plain``) for CPU tensors.
The kernel is built for W ∈ ``BUILT_WORDS``; on the card the wrapper pads
any narrower W with zero words up to the next built width, which adds no
bits.  Above the widest, W is padded to a multiple of ``CHUNK_WORDS`` and
the chunked kernel sums each distance over the chunks before it enters the
top-2, so any W runs.

Semantics (distances are small integers, so ties are the normal case):
both distance columns and both index columns (the lowest column attaining
the minimum; the lowest other column attaining the runner-up) equal two
argmin passes over the full matrix, with every invalid train entry exactly
1e30 — the reference's ``knn_match(..., k=2, metric='hamming')`` and the
plain version.  The TPU kernel may return another index tied at the
runner-up distance, so parity with it holds column 1 to "attains the
runner-up distance".
"""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite, check_index

Tensor = torch.Tensor
_BIG = 1e30
# word counts the kernel is built for (8: 256-bit ORB/BRIEF, 16: 512-bit);
# the wrapper pads narrower ones with zero words
BUILT_WORDS = (8, 16)
CHUNK_WORDS = 8         # width chunk of the kernel above 16: kChunkWords in hamming_top2.cu
ROWS_PER_BLOCK = 256    # query rows of a block: kRowsPerBlock in hamming_top2.cu
MIN_SPLIT_COLS = 16     # train columns a split keeps at least


def popcount32(x: Tensor) -> Tensor:
    """Population count of int32 words holding uint32 bits, as int64
    (SWAR bit-twiddling in int64, where nothing overflows)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _check_inputs(q: Tensor, t: Tensor, t_mask: Tensor) -> None:
    if q.dim() != 3 or t.dim() != 3 or q.shape[0] != t.shape[0] \
            or q.shape[2] != t.shape[2]:
        raise ValueError(f"expected q [B, N1, W] and t [B, N2, W], got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    if tuple(t_mask.shape) != tuple(t.shape[:2]):
        raise ValueError(f"t_mask must be [B, N2], got {tuple(t_mask.shape)}")
    if t.shape[1] == 0:
        raise ValueError("need at least one train row")
    if q.dtype != torch.int32 or t.dtype != torch.int32:
        raise TypeError("q and t must be int32 words (the uint32 bits)")
    if t_mask.dtype != torch.bool:
        raise TypeError("t_mask must be bool")
    devices = {x.device for x in (q, t, t_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def hamming_top2_plain(q: Tensor, t: Tensor, t_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch K4: (dist [B, N1, 2] f32 counts, idx [B, N1, 2] int32).

    XOR, popcount, the full [N1, N2] matrix with 1e30 on invalid train
    rows, then two argmin passes (lowest index on ties).  One pair at a
    time, so the int64 intermediates stay at N1·N2·W per pair."""
    dists, idxs = [], []
    for qb, tb, mb in zip(q, t, t_mask):
        counts = popcount32(qb[:, None, :] ^ tb[None, :, :]).sum(-1)      # [N1, N2]
        d = counts.to(torch.float32) + torch.where(mb, 0.0, _BIG)[None, :]
        m1, i1 = d.min(-1)                   # first minimum on ties
        m2, i2 = d.scatter(-1, i1[:, None], _BIG).min(-1)
        dists.append(torch.stack([m1, m2], -1))
        idxs.append(torch.stack([i1, i2], -1).to(torch.int32))
    return torch.stack(dists), torch.stack(idxs)


def fused_hamming_top2(q: Tensor, t: Tensor, t_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Hamming (best, second-best) distances and indices per query row.

    Args:
      q: [B, N1, W] int32 packed query words; t: [B, N2, W] train words.
      t_mask: [B, N2] bool — invalid train rows are excluded (1e30).

    Returns (dist [B, N1, 2] f32 counts, idx [B, N1, 2] int32); column 0 is
    the 1-NN, column 1 the 2-NN.  The caller applies query-side masking.
    """
    _check_inputs(q, t, t_mask)
    if q.device.type == "cpu":
        dist, idx = hamming_top2_plain(q, t, t_mask)
    elif q.device.type == "cuda":
        dist, idx = _launch(q, t, t_mask)
        fused_hamming_top2.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    # inside a utils/sanitize.checked run: finite distances, indices in range
    check_finite(dist, "fused_hamming_top2")
    check_index(idx, t.shape[1], "fused_hamming_top2")
    return dist, idx


def _launch(q: Tensor, t: Tensor, t_mask: Tensor) -> Tuple[Tensor, Tensor]:
    if not all(x.is_contiguous() for x in (q, t, t_mask)):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    # zero words up to the next built width or whole chunk (a fresh,
    # aligned copy)
    q, t = (_build.pad_width(x, BUILT_WORDS, CHUNK_WORDS) for x in (q, t))
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned q and t")
    lib = _build.library()
    B, N1, _ = q.shape
    N2 = t.shape[1]
    S = _build.train_splits(B, -(-N1 // ROWS_PER_BLOCK), N2,
                            _build.sm_count(q.device.index), MIN_SPLIT_COLS)
    dist = torch.empty((B, N1, 2), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, N1, 2), dtype=torch.int32, device=q.device)
    # the splits' partial top-2s (int4 each), for the merge kernel
    part = None if S == 1 else torch.empty((B, S, N1, 4), dtype=torch.int32,
                                           device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.pmt_hamming_top2(
            q.data_ptr(), t.data_ptr(), t_mask.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), None if part is None else part.data_ptr(),
            B, N1, N2, q.shape[2], S, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "pmt_hamming_top2")
    return dist, idx


fused_hamming_top2.launches = 0
fused_hamming_top2.work = _work.hamming_top2_work
