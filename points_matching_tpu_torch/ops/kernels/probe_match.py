"""P1 / P2 — the matching probe's tensor-core kernels, batched over pairs.

Replace the TPU kernels of ``benchmarks/probe/match_variants.py``:
``gemm_only`` (P1: the row minimum of a bf16 q·tᵀ, a raw dot product with
no mask) and ``packed_top2`` (P2: the L2 top-2 from a bf16 q·tᵀ with the
distance and the column packed into one int32 key).  CUDA source:
``points_matching_tpu_torch/csrc/probe_match.cu``, in two designs that the
host picks between by the launch's size (``design``): ``warpgroup`` —
Hopper's warpgroup tensor cores (``wgmma``), a block 256 query rows of one
pair looping over its split of the train rows, which a producer warp
streams through a ring of bulk async copies, the epilogue overlapping the
next step's products — where the launch fills the card; and ``warp`` — the
warp-level ``mma.sync`` kernel with 128-row blocks — on small launches,
where its shorter blocks win.  Both: bf16 operands, fp32 accumulation, the
epilogue in registers; see there.
Neither kernel is on a path of the package.  They measure what K1 in bf16
would cost on the tensor cores (``examples/probe_match_variants_torch.py``
and ``chip_smoke.py``'s ``probes`` phase); the production matcher's
contract stays K1's fp32 one.

Each wrapper takes a leading pair axis (the JAX probe vmaps over it) and
launches its kernel once for CUDA tensors, or raises; CPU tensors take the
plain PyTorch version.  On the card a cell's sum differs from the plain
version's only in its order (the products are exact): P1 within 1e-5 on
unit-norm rows; P2's keys lose their low ``idx_bits`` mantissa bits, so an
index may differ where two keys lie within a quantum or two.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite, check_index

Tensor = torch.Tensor
DESIGNS = ("warp", "warpgroup")                    # the C entries' `design` argument
ROWS_PER_BLOCK = {"warp": 128, "warpgroup": 256}   # mma::kRows, tc::kRows in probe_match.cu
MIN_SPLIT_COLS = {"warp": 16, "warpgroup": 8}      # train columns a split keeps at least
# the warpgroup design from this many of its blocks (pairs × 256-row tiles)
# an SM: on the H100, in turns with the warp design from 1 to 64 pairs of
# 512 × 512 × 64 (examples/probe_match_variants_torch.py --parent, PERF.md),
# P1 was faster from 16 pairs (0.24 blocks an SM) and P2, whose epilogue the
# products overlap, from 8 (0.12)
WARPGROUP_MIN_BLOCKS_PER_SM = {"gemm_rowmin": 0.2, "packed_top2": 0.1}
MAX_DIM = 128           # widest row the kernels stage (k-steps of 16, up to 8)
KEY_SENTINEL = 0x7FFFFFFF


def idx_bits(n2: int) -> int:
    """Low key bits that hold the column: ``bit_length(N2 − 1)``, at least 1."""
    return max((n2 - 1).bit_length(), 1)


def _check_inputs(q: Tensor, t: Tensor, t2=None) -> None:
    if q.dim() != 3 or t.dim() != 3 or q.shape[0] != t.shape[0] or q.shape[2] != t.shape[2]:
        raise ValueError(f"expected q [B, N1, D] and t [B, N2, D], got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    if t.shape[1] == 0:
        raise ValueError("t needs at least one row")
    if t2 is not None and tuple(t2.shape) != tuple(t.shape[:2]):
        raise ValueError(f"t2 must be [B, N2], got {tuple(t2.shape)}")
    if any(x.dtype != torch.float32 for x in (q, t, t2) if x is not None):
        raise TypeError("q, t and t2 must be float32")
    devices = {x.device for x in (q, t, t2) if x is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def _bf16_product(q: Tensor, t: Tensor) -> Tensor:
    """⟨bf16(q_i), bf16(t_j)⟩ accumulated in fp32, [B, N1, N2]."""
    return q.to(torch.bfloat16).float() @ t.to(torch.bfloat16).float().transpose(-1, -2)


def monotone_key(x: Tensor) -> Tensor:
    """int32 bits of fp32 ``x`` that order like ``x`` (negative values flip
    their magnitude bits); its own inverse on the bits."""
    u = x.view(torch.int32) if x.dtype == torch.float32 else x
    return u ^ ((u >> 31) & KEY_SENTINEL)


def gemm_rowmin_plain(q: Tensor, t: Tensor) -> Tensor:
    """Plain PyTorch P1: ``min_j ⟨bf16(q_i), bf16(t_j)⟩`` [B, N1, 1] f32."""
    return _bf16_product(q, t).amin(-1, keepdim=True)


def packed_keys(q: Tensor, t: Tensor, t2: Tensor) -> Tensor:
    """P2's keys [B, N1, N2] int32: d = t2 − 2·⟨bf16 q, bf16 t⟩ as a
    monotone int32 whose low ``idx_bits`` bits hold the column."""
    n2 = t.shape[1]
    low = (1 << idx_bits(n2)) - 1
    d = t2[:, None, :] - 2.0 * _bf16_product(q, t)
    col = torch.arange(n2, dtype=torch.int32, device=q.device)
    return (monotone_key(d) & ~low) | col


def packed_top2_plain(q: Tensor, t: Tensor, t2: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch P2: (dist [B, N1, 2] f32, idx [B, N1, 2] int32).  The
    best key is the minimum, the runner-up the minimum of the others;
    dist = max(unpacked key + ‖q‖², 0), idx = the key's low bits."""
    low = (1 << idx_bits(t.shape[1])) - 1
    keys = packed_keys(q, t, t2)
    k1 = keys.amin(-1, keepdim=True)
    k2 = torch.where(keys == k1, KEY_SENTINEL, keys).amin(-1, keepdim=True)
    k = torch.cat([k1, k2], -1)
    q2 = (q * q).sum(-1, keepdim=True)
    dist = (monotone_key(k & ~low).view(torch.float32) + q2).clamp_min(0.0)
    return dist, k & low


def near_tie_rows(q: Tensor, t: Tensor, t2: Tensor, quanta: int = 2) -> Tensor:
    """Rows [B, N1] where plain's competing keys lie within ``quanta``
    quanta (2^idx_bits ulp of d): the best and the runner-up, or the
    runner-up and the third.  Only there may a kernel whose fp32 sums run
    in another order pick other columns than ``packed_top2_plain``."""
    v = packed_keys(q, t, t2) >> idx_bits(t.shape[1])
    v = v.to(torch.int64).topk(min(3, v.shape[-1]), -1, largest=False).values
    if v.shape[-1] < 3:
        return torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device)
    return ((v[..., 1] - v[..., 0]) <= quanta) | ((v[..., 2] - v[..., 1]) <= quanta)


def quantum(q: Tensor, t2: Tensor) -> float:
    """One quantum of P2's distances: 2^idx_bits ulp of the largest |d| the
    inputs can give, |t2 − 2⟨q, t⟩| ≤ max t2 + 2·√(max ‖q‖² · max t2) (3 for
    unit rows, whose quantum at N2 = 512 is 2^-13)."""
    t2max = float(t2.max())
    d_max = t2max + 2.0 * math.sqrt(float((q * q).sum(-1).max()) * max(t2max, 0.0))
    return 2.0 ** (idx_bits(t2.shape[-1]) + math.frexp(d_max)[1] - 24)


def design(kernel: str, B: int, N1: int, num_sms: int) -> str:
    """The design of ``kernel`` (``gemm_rowmin`` or ``packed_top2``) for B
    pairs of N1 query rows: ``warpgroup`` once its 256-row blocks are at
    least ``WARPGROUP_MIN_BLOCKS_PER_SM[kernel]`` an SM (the card then
    streams train tiles, where the ring and the overlap of products and
    epilogue win), else ``warp`` (a launch of a few blocks is latency, where
    the shorter blocks win).  Both designs give the same results up to the
    order of a cell's sum."""
    blocks = B * -(-N1 // ROWS_PER_BLOCK["warpgroup"])
    return ("warpgroup" if blocks >= WARPGROUP_MIN_BLOCKS_PER_SM[kernel] * num_sms
            else "warp")


def splits(design: str, B: int, N1: int, N2: int, num_sms: int) -> int:
    """Train splits S of a launch: the warp design as K1's (its blocks run
    several an SM), the warpgroup design one block an SM, so the most
    splits that keep the launch within one wave."""
    tiles, cols = -(-N1 // ROWS_PER_BLOCK[design]), -(-N2 // 8) * 8
    if design == "warp":
        return _build.train_splits(B, tiles, cols, num_sms, MIN_SPLIT_COLS[design])
    return _build.one_wave_splits(B * tiles, cols, num_sms, MIN_SPLIT_COLS[design])


def _plan(fn, q: Tensor, t: Tensor, forced):
    """(design, S) of a launch, the design recorded on the wrapper.  The
    warp design loads rows 16 bytes at a time when D % 4 = 0, so such rows
    off 16 bytes take the warpgroup design, which copies them with plain
    loads."""
    (B, N1, D), N2 = q.shape, t.shape[1]
    sms = _build.sm_count(q.device.index)
    unaligned = D % 4 == 0 and (q.data_ptr() % 16 or t.data_ptr() % 16)
    d = forced or ("warpgroup" if unaligned else design(fn.__name__, B, N1, sms))
    if d not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {d!r}")
    if d == "warp" and unaligned:
        raise ValueError("the warp design needs 16-byte aligned q and t")
    fn.last_design = d
    return d, splits(d, B, N1, N2, sms)


def _prepare(q: Tensor, t: Tensor, t2=None):
    if not all(x.is_contiguous() for x in (q, t, t2) if x is not None):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    if q.shape[2] > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes D ≤ {MAX_DIM}, got {q.shape[2]}")
    return _build.library()


def gemm_rowmin(q: Tensor, t: Tensor, _design=None) -> Tensor:
    """P1: the row minima of bf16(q)·bf16(t)ᵀ, fp32-accumulated.

    Args: q [B, N1, D], t [B, N2, D] float32 (D ≤ 128 on the card).
    Returns [B, N1, 1] float32.  ``_design`` forces a kernel design (card
    tests, probes).
    """
    _check_inputs(q, t)
    if q.device.type == "cpu":
        out = gemm_rowmin_plain(q, t)
    elif q.device.type == "cuda":
        lib = _prepare(q, t)
        B, N1, D = q.shape
        N2 = t.shape[1]
        d, S = _plan(gemm_rowmin, q, t, _design)
        out = torch.empty((B, N1, 1), dtype=torch.float32, device=q.device)
        part = torch.empty((B, S, N1), dtype=torch.float32, device=q.device) if S > 1 else None
        with torch.cuda.device(q.device):
            rc = lib.pmt_probe_gemm_rowmin(
                q.data_ptr(), t.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), B, N1, N2, D, S, DESIGNS.index(d),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "pmt_probe_gemm_rowmin")
        gemm_rowmin.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    check_finite(out, "gemm_rowmin")
    return out


def packed_top2(q: Tensor, t: Tensor, t2: Tensor, _design=None) -> Tuple[Tensor, Tensor]:
    """P2: the packed-key L2 top-2 of bf16(q)·bf16(t)ᵀ.

    Args: q [B, N1, D], t [B, N2, D] float32 (D ≤ 128 on the card), t2
      [B, N2] float32 (‖t_j‖², as the JAX probe passes it).
    Returns (dist [B, N1, 2] float32, idx [B, N1, 2] int32).  ``_design``
    forces a kernel design (card tests, probes).
    """
    _check_inputs(q, t, t2)
    if q.device.type == "cpu":
        dist, idx = packed_top2_plain(q, t, t2)
    elif q.device.type == "cuda":
        lib = _prepare(q, t, t2)
        B, N1, D = q.shape
        N2 = t.shape[1]
        d, S = _plan(packed_top2, q, t, _design)
        dist = torch.empty((B, N1, 2), dtype=torch.float32, device=q.device)
        idx = torch.empty((B, N1, 2), dtype=torch.int32, device=q.device)
        part = q2 = None
        if S > 1:
            part = torch.empty((B, S, N1, 2), dtype=torch.int32, device=q.device)
            q2 = torch.empty((B, N1), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            rc = lib.pmt_probe_packed_top2(
                q.data_ptr(), t.data_ptr(), t2.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                None if part is None else part.data_ptr(),
                None if q2 is None else q2.data_ptr(), B, N1, N2, D, S, DESIGNS.index(d),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "pmt_probe_packed_top2")
        packed_top2.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    check_index(idx, t.shape[1], "packed_top2")
    return dist, idx


gemm_rowmin.launches = 0
packed_top2.launches = 0
gemm_rowmin.last_design = packed_top2.last_design = None
gemm_rowmin.work = _work.probe_gemm_rowmin_work
packed_top2.work = _work.probe_packed_top2_work
