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
and ``piece_rows`` list the kernel's blocks for the long rows (more than
``SHORT`` entries; ``PIECE`` entries a block, and the row of each).  An
index that does not change across LM iterations gives one plan that every
sum of the call reuses.

``segment_sum(values, plan)`` → ``out[r] = Σ values[perm[offsets[r] :
offsets[r+1]]]``.  CUDA source: ``points_matching_tpu_torch/csrc/
segment_sum.cu``, one launch a call, no float atomics.  The order depends
on each row's length and entries alone: a chunk of ``CHUNK`` consecutive
entries is summed column by column in entry order from 0, a piece of
``PIECE // CHUNK`` chunks in chunk order, the row's pieces in order (a row
of at most ``CHUNK`` entries is its one chunk).  Nothing of it depends on
the launch or on the other rows, so a batch of problems gives each
problem the bits it gets alone, and two runs the same bits;
``segment_sum_ordered`` adds in that order in plain PyTorch (the tests'
and ``chip_smoke.py``'s yardstick of the kernel's bits).  Built for f32
and f64 rows of ``WIDTHS`` elements (the BA's 3, 6, 9, 36, the pose
graph's 6, 36).  The plain version, for CPU tensors, adds the permuted
rows with ``index_add_``, which on the CPU runs in order, so it sums each
row in the same entry order as a scatter over the original index would.

A plan is int32 and contiguous as ``build_plan`` makes it, so a call
checks only ``values`` and that the plan lies on its device.  The kernel's
scratch (the piece sums of rows of several pieces, one buffer a dtype and
width, and one integer counter a row) lives in the plan, made at the first
launch: the launches through one plan are ordered on one stream.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite

Tensor = torch.Tensor

CHUNK = 32           # entries a chunk, summed in entry order (kChunk in segment_sum.cu)
PIECE = 256          # entries a piece, its chunks summed in order (kPiece)
SHORT = CHUNK        # rows of more entries are long: pieces of blocks (kShort)
WIDTHS = (3, 6, 9, 36)   # elements a row of the kernel's instances, f32 and f64
LONG_BLOCKS_PER_SM = 4   # the launch's blocks that stride over the pieces, an SM


class SegPlan(NamedTuple):
    """A sort-once plan of a flat index into ``n`` rows (``build_plan``)."""

    perm: Tensor       # int32 [R]: entries stably sorted by target row, masked last
    offsets: Tensor    # int32 [n + 1]: row r's entries are perm[offsets[r]:offsets[r+1]]
    pieces: Tensor     # int32 [n + 1]: a long row r's pieces of PIECE entries start at
    #                    pieces[r]; a row of at most SHORT entries has none
    piece_rows: Tensor  # int32 [max_pieces]: the row of each piece, n past the last
    scratch: dict      # (dtype, W) → [max_pieces, W] piece sums; "arrivals" → int32
    #                    [n] counters, zero between launches; made at first launch

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
    lengths = offsets[1:] - offsets[:-1]
    counts = torch.where(lengths > SHORT, (lengths + PIECE - 1) // PIECE, 0)
    pieces = torch.cat([offsets.new_zeros(1), torch.cumsum(counts, 0)])
    # the last row whose pieces start at or before each piece
    piece_rows = torch.searchsorted(
        pieces, torch.arange(max_pieces(keys.numel(), n), device=keys.device), right=True) - 1
    return SegPlan(perm=perm.to(torch.int32), offsets=offsets.to(torch.int32),
                   pieces=pieces.to(torch.int32), piece_rows=piece_rows.to(torch.int32),
                   scratch={})


def max_pieces(R: int, n: int) -> int:
    """An upper bound of a plan's piece count from its R entries and n rows
    alone, no read of the device: a long row of m > SHORT entries has
    ⌈m / PIECE⌉ ≤ m / (SHORT + 1) pieces, and at most one partial piece."""
    return min(R // (SHORT + 1), -(-R // PIECE) + n)


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


def _split(first: Tensor, count: Tensor, size: int):
    """Groups (``first``, ``count``) of a flat axis cut into consecutive
    parts of ``size``: each part's (first, count) and each group's first
    part and number of parts."""
    parts = (count + size - 1) // size
    part_first = torch.cumsum(parts, 0) - parts
    total = int(parts.sum())
    group = torch.repeat_interleave(torch.arange(count.shape[0], device=count.device), parts,
                                    output_size=total)
    k = torch.arange(total, device=count.device) - part_first[group]
    return (first[group] + size * k, (count[group] - size * k).clamp(max=size),
            part_first, parts)


def _in_order(x: Tensor, first: Tensor, count: Tensor) -> Tensor:
    """0 + x[first] + x[first + 1] + … over ``count`` terms, left to right,
    for each group, in ``x``'s dtype."""
    acc = torch.zeros((first.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    for j in range(int(count.max()) if count.numel() else 0):
        sel = (count > j).nonzero()[:, 0]
        acc[sel] = acc[sel] + x[first[sel] + j]
    return acc


def segment_sum_ordered(values: Tensor, plan: SegPlan) -> Tensor:
    """The kernel's sums in the kernel's order, in plain PyTorch on any
    device, vectorised over rows (a loop over the entries of a chunk, the
    chunks of a piece and the pieces of a row; reads the host, so it is
    the tests' and ``chip_smoke.py``'s yardstick and no path's): each row's
    entries in chunks of ``CHUNK`` summed in order from 0, the chunks in
    pieces of ``PIECE // CHUNK``, the pieces in order.  [R, ...] →
    [n, ...], the bits of ``segment_sum`` on the card."""
    _check_inputs(values, plan)
    n = plan.num_rows
    x = values.reshape(values.shape[0], -1)[plan.perm[:int(plan.offsets[-1])].long()]
    offsets = plan.offsets.long()
    first, count = offsets[:-1], offsets[1:] - offsets[:-1]
    piece_first, piece_count, row_piece, row_pieces = _split(first, count, PIECE)
    chunk_first, chunk_count, piece_chunk, piece_chunks = _split(piece_first, piece_count, CHUNK)
    chunks = _in_order(x, chunk_first, chunk_count)
    pieces = _in_order(chunks, piece_chunk, piece_chunks)
    return _in_order(pieces, row_piece, row_pieces).reshape(n, *values.shape[1:])


def rounding_bound(values: Tensor, plan: SegPlan) -> Tensor:
    """How far the kernel may lie from ``segment_sum_plain`` of
    ``values.double()`` on each output element, [n, ...] in float64.  In
    the kernel's order (module docstring) a term of a row of m entries
    passes through at most k = (min(m, CHUNK) − 1) + (min(⌈m / CHUNK⌉,
    PIECE / CHUNK) − 1) + (⌈m / PIECE⌉ − 1) roundings (its chunk, its piece,
    the row; each level's first add, to 0, is exact), so the kernel is
    within γ_k·Σ|v| of the exact sum (u the type's unit roundoff, γ_k =
    k·u / (1 − k·u)); the float64 reference, m − 1 adds in order, within
    γ_{m−1}(u_f64)·Σ|v|.  The bound is their sum."""
    def gamma(k, u):
        return k * u / (1 - k * u)

    m = (plan.offsets[1:] - plan.offsets[:-1]).long()
    k = (m.clamp(max=CHUNK) - 1 + ((m + CHUNK - 1) // CHUNK).clamp(max=PIECE // CHUNK) - 1
         + (m + PIECE - 1) // PIECE - 1).clamp(min=0)
    m1 = m.clamp(min=1) - 1
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
    dev = values.device
    out = torch.empty((n, *rest), dtype=values.dtype, device=dev)
    part = plan.scratch.get((values.dtype, W))
    if part is None:
        part = plan.scratch[values.dtype, W] = torch.empty((mp, W), dtype=values.dtype,
                                                           device=dev)
        if "arrivals" not in plan.scratch:
            plan.scratch["arrivals"] = torch.zeros(n, dtype=torch.int32, device=dev)
    long_blocks = min(mp, LONG_BLOCKS_PER_SM * _sm_count(dev.index))
    args = (values.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            plan.pieces.data_ptr(), plan.piece_rows.data_ptr(), out.data_ptr(),
            part.data_ptr(), plan.scratch["arrivals"].data_ptr(), n, W, long_blocks,
            int(values.dtype == torch.float64))
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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return _build.sm_count(device_index)


segment_sum.launches = 0
segment_sum.work = _work.segment_sum_work
