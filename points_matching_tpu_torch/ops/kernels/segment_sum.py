"""Segmented sum in a fixed order, over a plan sorted once — the reduction of
the sparse bundle adjustment (``ba/sparse.py``) and of the pose graph
(``ba/pose_graph.py``).

Ports the semantics of the reference's ``'sorted'`` observation layout
(``points_matching_tpu/ba/sparse.py`` ``_sort_obs_by_landmark``,
``_sorted_ops``): the observations are sorted once per BA call and every
row is summed in an order fixed by its own observations, so two runs give
the same bits.  Not its TPU mechanics (the ``[C, O]`` one-hot GEMM and the
cumsum-diff, which also loses precision on long rows).  It replaces no
Pallas kernel.

``build_plan(index, n, mask)`` sorts the flat entries of ``index`` ([*B, O],
rows from ``core/types.flat_rows``, so row ``s·C + c`` belongs to problem
s) stably by target row: row r's entries are ``perm[offsets[r] :
offsets[r+1]]``, in their own order.  Masked entries are left out: they
sort past the last row (key ``n``), beyond ``offsets[n]``.  ``pieces``
and ``piece_rows`` list the kernel's work (``PIECE`` entries a warp, and
the row of each).  An index that does not change across LM iterations
gives one plan that every sum of the call reuses.

``segment_sum(values, plan)`` → ``out[r] = Σ values[perm[offsets[r] :
offsets[r+1]]]``.  CUDA source: ``points_matching_tpu_torch/csrc/
segment_sum.cu`` — no float atomics: each row is summed in chunks of 32
entries (a fixed xor butterfly over a warp's lanes), chunks in order
within pieces of ``PIECE`` entries, pieces in order; nothing of the order
depends on the launch or on the other rows, so a batch of problems gives
each problem the bits it gets alone, and two runs the same bits.  Built
for f32 and f64 rows of ``WIDTHS`` elements (the BA's 3, 6, 9, 36, the
pose graph's 6, 36).  The plain version, for CPU tensors, adds the
permuted rows with ``index_add_``, which on the CPU runs in order, so it
sums each row in the same entry order as a scatter over the original
index would.

A plan is int32 and contiguous as ``build_plan`` makes it, so a call
checks only ``values`` and that the plan lies on its device.  The kernel's scratch (the pieces' sums of rows longer than a
piece) lives in the plan, one buffer a dtype and width, made at the first
launch: the launches through one plan are ordered on one stream.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite

Tensor = torch.Tensor

PIECE = 256          # entries a warp sums: 32 · kChunksPerPiece in segment_sum.cu
WIDTHS = (3, 6, 9, 36)   # elements a row of the kernel's instances, f32 and f64


class SegPlan(NamedTuple):
    """A sort-once plan of a flat index into ``n`` rows (``build_plan``)."""

    perm: Tensor       # int32 [R]: entries stably sorted by target row, masked last
    offsets: Tensor    # int32 [n + 1]: row r's entries are perm[offsets[r]:offsets[r+1]]
    pieces: Tensor     # int32 [n + 1]: row r's pieces of PIECE entries start at pieces[r]
    piece_rows: Tensor  # int32 [max_pieces]: the row of each piece, n past the last
    scratch: dict      # (dtype, W) → [max_pieces, W] piece sums, made at first launch

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_entries(self) -> int:
        return self.perm.shape[0]


def build_plan(index: Tensor, n: int, mask: Optional[Tensor] = None) -> SegPlan:
    """The plan of ``index`` (any shape, flattened; values in [0, n)) into
    ``n`` rows, leaving out the entries where ``mask`` (same shape) is
    False.  Sorting, searching and counting only: no read on the host."""
    keys = index.reshape(-1).long()
    if keys.numel() >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("a plan holds fewer than 2**31 entries and rows")
    if mask is not None:
        keys = torch.where(mask.reshape(-1), keys, torch.full_like(keys, n))
    sorted_keys, perm = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(sorted_keys, torch.arange(n + 1, device=keys.device))
    counts = (offsets[1:] - offsets[:-1] + PIECE - 1) // PIECE
    pieces = torch.cat([offsets.new_zeros(1), torch.cumsum(counts, 0)])
    # the last row whose pieces start at or before each piece
    piece_rows = torch.searchsorted(
        pieces, torch.arange(max_pieces(keys.numel(), n), device=keys.device), right=True) - 1
    return SegPlan(perm=perm.to(torch.int32), offsets=offsets.to(torch.int32),
                   pieces=pieces.to(torch.int32), piece_rows=piece_rows.to(torch.int32),
                   scratch={})


def max_pieces(R: int, n: int) -> int:
    """An upper bound of a plan's piece count from its R entries and n rows
    alone (every piece holds an entry, and a row has at most one partial
    piece): no read of the device."""
    return min(R, -(-R // PIECE) + n)


def _check_inputs(values: Tensor, plan: SegPlan) -> None:
    if values.dim() < 1 or values.shape[0] != plan.num_entries:
        raise ValueError(f"values must be [R = {plan.num_entries}, ...], got "
                         f"{tuple(values.shape)}")
    if not values.is_floating_point():
        raise TypeError(f"values must be floating point, got {values.dtype}")
    if values.device != plan.perm.device:
        raise ValueError(f"values on {values.device}, the plan on {plan.perm.device}")


def segment_sum_plain(values: Tensor, plan: SegPlan) -> Tensor:
    """Plain PyTorch segmented sum: the rows gathered with ``perm`` and
    added into their rows by ``offsets`` (``index_add_``; masked entries
    into a dump row that is sliced off).  [R, ...] → [n, ...]."""
    R, n = plan.num_entries, plan.num_rows
    dev = values.device
    lengths = torch.diff(plan.offsets.long(), append=torch.full((1,), R, device=dev))
    rows = torch.repeat_interleave(torch.arange(n + 1, device=dev), lengths, output_size=R)
    out = torch.zeros((n + 1, *values.shape[1:]), dtype=values.dtype, device=dev)
    out.index_add_(0, rows, values[plan.perm.long()])
    return out[:n]


def rounding_bound(values: Tensor, plan: SegPlan) -> Tensor:
    """How far the kernel may lie from ``segment_sum_plain`` of
    ``values.double()`` on each output element, [n, ...] in float64.  The
    kernel rounds on the way from any term to its row's sum at most
    k = 5 + (kChunksPerPiece − 1) + (pieces − 1) times (the butterfly, the
    chunks, the pieces), so it is within γ_k·Σ|v| of the exact sum (u the
    type's unit roundoff, γ_k = k·u / (1 − k·u)); the float64 reference, m − 1
    adds in order, within γ_{m−1}(u_f64)·Σ|v|.  The bound is their sum."""
    def gamma(k, u):
        return k * u / (1 - k * u)

    p = plan.pieces.long()
    k = 5 + 7 + (p[1:] - p[:-1] - 1).clamp(min=0)
    m1 = (plan.offsets[1:] - plan.offsets[:-1]).long().clamp(min=1) - 1
    u, u64 = torch.finfo(values.dtype).eps / 2, torch.finfo(torch.float64).eps / 2
    g = gamma(k.double(), u) + gamma(m1.double(), u64)
    mag = segment_sum_plain(values.abs().double(), plan)
    return g.reshape(-1, *(1,) * (values.dim() - 1)) * mag


def segment_sum(values: Tensor, plan: SegPlan) -> Tensor:
    """``out[r] = Σ values[perm[offsets[r]:offsets[r+1]]]`` over the leading
    axis of ``values`` [R, ...] → [n, ...] (module docstring).  The CUDA
    kernel for CUDA tensors (f32 and f64 rows of ``WIDTHS`` elements, else
    it raises), the plain version for CPU tensors."""
    _check_inputs(values, plan)
    if values.is_cuda:
        out = _launch(values, plan)
        segment_sum.launches += 1
    elif values.device.type == "cpu":
        out = segment_sum_plain(values, plan)
    else:
        raise ValueError(f"unsupported device {values.device}")
    check_finite(out, "segment_sum")
    return out


def _launch(values: Tensor, plan: SegPlan) -> Tensor:
    rest = values.shape[1:]
    W = math.prod(rest)
    if W not in WIDTHS or values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the segmented-sum kernel is built for f32 and f64 rows of "
                         f"{WIDTHS} elements, got {values.dtype} rows of {W}")
    values = values.contiguous()
    if values.data_ptr() % 16:
        values = values.clone()          # a fresh allocation is 16-byte aligned
    lib = _build.library()
    n = plan.num_rows
    mp = plan.piece_rows.shape[0]
    out = torch.empty((n, *rest), dtype=values.dtype, device=values.device)
    part = plan.scratch.get((values.dtype, W))
    if part is None:
        part = plan.scratch[values.dtype, W] = torch.empty(
            (mp, W), dtype=values.dtype, device=values.device)
    args = (values.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            plan.pieces.data_ptr(), plan.piece_rows.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, W, mp, int(values.dtype == torch.float64))
    # the raw handle of the device's current stream: the Stream object
    # costs the host ~5 µs a call, a fifth of the whole wrapper
    stream = torch._C._cuda_getCurrentRawStream(values.device.index)
    if values.device.index == torch.cuda.current_device():
        rc = lib.pmt_segment_sum(*args, stream)
    else:
        with torch.cuda.device(values.device):
            rc = lib.pmt_segment_sum(*args, stream)
    _build.check(lib, rc, "pmt_segment_sum")
    return out


segment_sum.launches = 0
segment_sum.work = _work.segment_sum_work
