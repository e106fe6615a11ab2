"""Descriptor matching — port of ``points_matching_tpu/ops/matching.py``.

Exact brute-force 1-NN / 2-NN over squared-L2 distances (float
descriptors) or popcount-Hamming counts (packed binary descriptors), then
the configured filter: Lowe ratio, the reference demo's midpoint rule
``d < min + (max − min)/2`` (with its min=1 / max=0 start), an absolute
threshold, or none; optional mutual cross-check; optional compaction of the
survivors to a dense prefix.

Backends (``MatcherConfig.backend``): ``'auto'``/``'pallas'`` go through the
fused distance + top-2 kernel (K1 for 'l2', ``ops/kernels/matching_kernel.py``;
K4 for 'hamming', ``ops/kernels/hamming_kernel.py`` — the CUDA kernel on
CUDA tensors, its plain version on CPU tensors); ``'xla'`` materializes the
[N1, N2] distance matrix.  Hamming distances are float32 counts and the
filters compare them raw (no sqrt).

The matchers take one pair ([N, D] descriptors) or a leading pair axis
([P, N, D]), the port of the JAX package's ``jax.vmap`` over pairs: every
pair is filtered, cross-checked and compacted on its own, and a batch
launches each kernel once for all P pairs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.core.config import MatcherConfig
from points_matching_tpu_torch.core.types import Descriptors, Matches
from points_matching_tpu_torch.ops.kernels.hamming_kernel import (
    fused_hamming_top2,
    popcount32,
)
from points_matching_tpu_torch.ops.kernels.matching_kernel import (
    fused_l2_top2,
    fused_l2_top2_points,
)

Tensor = torch.Tensor
_BIG = 1e30


def hamming_distance_matrix(a_bits: Tensor, b_bits: Tensor) -> Tensor:
    """[N1, W] × [N2, W] packed words → [N1, N2] int32 Hamming distances
    (XOR + popcount over the word axis)."""
    x = a_bits[..., :, None, :] ^ b_bits[..., None, :, :]
    return popcount32(x).sum(-1).to(torch.int32)


def l2_distance_matrix(a: Tensor, b: Tensor, compute_dtype: str = "f32") -> Tensor:
    """[N1, D] × [N2, D] → [N1, N2] squared-L2 distances via
    ‖a−b‖² = ‖a‖² + ‖b‖² − 2⟨a, b⟩.  ``compute_dtype='bf16'`` rounds the
    GEMM operands to bf16 (fp32 accumulation); the norms stay fp32."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    if compute_dtype == "bf16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    ab = a @ b.transpose(-1, -2)
    return (a2 + b2.transpose(-1, -2) - 2.0 * ab).clamp_min(0.0)


def distance_matrix(d1: Descriptors, d2: Descriptors, metric: str = "l2",
                    compute_dtype: str = "f32") -> Tensor:
    """Masked distance matrix [N1, N2]; invalid rows/cols get 1e30."""
    if metric == "hamming":
        d = hamming_distance_matrix(d1.data, d2.data).to(torch.float32)
    elif metric == "l2":
        d = l2_distance_matrix(d1.data, d2.data, compute_dtype)
    elif metric == "dot":
        d = -(d1.data @ d2.data.transpose(-1, -2))
    else:
        raise ValueError(f"unknown metric: {metric!r}")
    invalid = ~d1.mask[..., :, None] | ~d2.mask[..., None, :]
    return torch.where(invalid, _BIG, d)


def _argmin_top2(d: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact top-2 smallest per row by two argmin passes (lowest index on
    ties; duplicated minima still give two distinct positions)."""
    v1, i1 = d.min(-1)
    masked = d.scatter(-1, i1[..., None], _BIG)
    v2, i2 = masked.min(-1)
    return torch.stack([v1, v2], -1), torch.stack([i1, i2], -1).to(torch.int32)


def knn_match(d1: Descriptors, d2: Descriptors, k: int = 2, metric: str = "l2",
              compute_dtype: str = "f32") -> Tuple[Tensor, Tensor]:
    """k nearest train descriptors per query row: (dist [N1, k], idx [N1, k]);
    distances are squared-L2 for the 'l2' metric."""
    d = distance_matrix(d1, d2, metric, compute_dtype)
    if k == 1:
        v1, i1 = d.min(-1)
        return v1[..., None], i1[..., None].to(torch.int32)
    if k == 2:
        return _argmin_top2(d)
    v, idx = torch.topk(d, k, largest=False)
    return v, idx.to(torch.int32)


def _use_fused(d1: Descriptors, config: MatcherConfig) -> bool:
    """The fused kernels (K1 for 'l2', K4 for 'hamming') serve the
    'auto'/'pallas' backends for one pair or a batch (no size gate: that
    was a TPU crossover)."""
    if config.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend: {config.backend!r}")
    return config.metric in ("l2", "hamming") and config.backend != "xla"


def _pairs(x: Tensor) -> Tensor:
    """[..., N, C] → [B, N, C]: the leading axes (none for one pair) as
    the kernels' one pair axis."""
    return x.reshape(-1, *x.shape[-2:]).contiguous()


def _fused_top2(dq: Descriptors, dt: Descriptors, config: MatcherConfig):
    """(dist [..., N1, 2], idx [..., N1, 2]) of K1 or K4, one launch for
    every pair."""
    lead = dq.data.shape[:-2]
    t_mask = dt.mask.reshape(-1, dt.mask.shape[-1]).contiguous()
    if config.metric == "hamming":
        dist, idx = fused_hamming_top2(_pairs(dq.data), _pairs(dt.data), t_mask)
    else:
        dist, idx = fused_l2_top2(_pairs(dq.data), _pairs(dt.data), t_mask,
                                  compute_dtype=config.compute_dtype)
    dist, idx = dist.reshape(*lead, *dist.shape[1:]), idx.reshape(*lead, *idx.shape[1:])
    # query-side masking (the kernel only masks train rows)
    return torch.where(dq.mask[..., None], dist, _BIG), idx


def _filter(config: MatcherConfig, valid: Tensor, best_reported: Tensor,
            second_reported) -> Tensor:
    if config.filter == "ratio":
        keep = best_reported < config.ratio * second_reported.clamp_min(1e-12)
    elif config.filter == "midpoint":
        # reference rule: min initialized to 1, max to 0; keep d < min + (max-min)/2
        dmin = torch.where(valid, best_reported, torch.inf).amin(-1, keepdim=True)
        dmin = dmin.clamp_max(1.0)
        dmax = torch.where(valid, best_reported, -torch.inf).amax(-1, keepdim=True)
        dmax = dmax.clamp_min(0.0)
        keep = best_reported < dmin + (dmax - dmin) / 2.0
    elif config.filter == "threshold":
        keep = best_reported < config.threshold
    elif config.filter == "none":
        keep = torch.ones_like(valid)
    else:
        raise ValueError(f"unknown filter: {config.filter!r}")
    return keep & valid


def _query_idx(keep: Tensor) -> Tensor:
    """[..., N1] int32 query index of each row, one copy per pair."""
    n1 = keep.shape[-1]
    return torch.arange(n1, dtype=torch.int32, device=keep.device).expand(keep.shape)


def match_descriptors(d1: Descriptors, d2: Descriptors,
                      config: MatcherConfig = MatcherConfig()) -> Matches:
    """1-NN matching with the configured filter.

    ``d1``, ``d2``: one pair ([N, D] data) or P pairs ([P, N, D], the
    masks [P, N]); every pair is matched on its own, and the fused kernel
    launches once for all of them.

    Returns a fixed-capacity Matches (capacity = query capacity, or
    ``config.max_matches``) with the descriptors' leading axes; with
    ``compact`` each pair's survivors form a dense prefix, otherwise row i
    is query i's match and the mask says whether it survived.
    """
    k = 2 if config.filter == "ratio" else 1
    use_fused = _use_fused(d1, config)
    if use_fused:
        dist, idx = _fused_top2(d1, d2, config)
    else:
        dist, idx = knn_match(d1, d2, k=k, metric=config.metric,
                              compute_dtype=config.compute_dtype)
    best = dist[..., 0]
    best_idx = idx[..., 0]
    valid = d1.mask & (best < _BIG / 2)

    if config.metric == "l2":
        # FLANN reports true L2: thresholds/ratios compare sqrt distances
        best_reported = torch.sqrt(best)
        second_reported = torch.sqrt(dist[..., 1]) if k == 2 else None
    else:
        best_reported = best
        second_reported = dist[..., 1] if k == 2 else None
    keep = _filter(config, valid, best_reported, second_reported)

    n1 = d1.capacity
    query_idx = _query_idx(keep)
    if config.cross_check:
        # mutual 1-NN: train j's best query must be this query i
        if use_fused:
            _, it = _fused_top2(d2, d1, config)
        else:
            _, it = knn_match(d2, d1, k=1, metric=config.metric,
                              compute_dtype=config.compute_dtype)
        reverse_best = it[..., 0].gather(-1, best_idx.long().clamp(0, d2.capacity - 1))
        keep = keep & (reverse_best == query_idx)

    best_idx = best_idx.to(torch.int32)
    if not config.compact:
        return Matches(
            query_idx=query_idx,
            train_idx=torch.where(keep, best_idx, 0),
            distance=torch.where(keep, best_reported, 0.0),
            mask=keep,
        )

    # stable compaction of each pair's survivors to its front: discarded
    # entries all land in an overflow slot that the final slice drops
    cap = min(config.max_matches or n1, n1)
    slot = torch.where(keep, torch.cumsum(keep, -1) - 1, n1)
    n_keep = keep.sum(-1, keepdim=True)

    def compact(vals: Tensor, fill) -> Tensor:
        buf = torch.full((*keep.shape[:-1], n1 + 1), fill, dtype=vals.dtype,
                         device=vals.device)
        return buf.scatter(-1, slot, vals)[..., :cap]

    return Matches(
        query_idx=compact(query_idx, 0),
        train_idx=compact(best_idx, 0),
        distance=compact(best_reported, 0.0),
        mask=torch.arange(cap, device=keep.device) < n_keep,
    )


def match_descriptors_points(d1: Descriptors, d2: Descriptors, t_points: Tensor,
                             config: MatcherConfig = MatcherConfig()
                             ) -> Tuple[Matches, Tensor]:
    """Query-order 1-NN matching + the matched TRAIN POINT per query row,
    for one pair or P pairs (``t_points`` [..., N2, C] with the
    descriptors' leading axes).

    On the fused path (metric 'l2', no cross-check, no compaction, filter
    ratio/threshold/none, backend 'auto'/'pallas') the point comes out of
    the matching kernel (K1b, one launch for every pair); anything else
    runs ``match_descriptors`` and an explicit gather.

    Returns (Matches in query order, pts [..., N1, C]) with
    ``pts[i] == t_points[train_idx[i]]`` on EVERY row — filtered rows report
    train_idx 0 and t_points[0] on both paths.
    """
    fast = (
        config.metric == "l2"
        and not config.cross_check
        and not config.compact
        and config.filter in ("ratio", "threshold", "none")
        and _use_fused(d1, config)
    )
    if not fast:
        m = match_descriptors(d1, d2, config)
        n2 = t_points.shape[-2]
        idx = m.train_idx.long().clamp(0, n2 - 1)
        return m, torch.take_along_dim(t_points, idx[..., None], dim=-2)

    lead = d1.data.shape[:-2]
    dist, idx, pts = fused_l2_top2_points(
        _pairs(d1.data), _pairs(d2.data),
        d2.mask.reshape(-1, d2.mask.shape[-1]).contiguous(), _pairs(t_points),
        compute_dtype=config.compute_dtype)
    dist, idx, pts = (x.reshape(*lead, *x.shape[1:]) for x in (dist, idx, pts))
    dist = torch.where(d1.mask[..., None], dist, _BIG)
    best = dist[..., 0]
    valid = d1.mask & (best < _BIG / 2)
    keep = _filter(config, valid, torch.sqrt(best), torch.sqrt(dist[..., 1]))
    # filtered rows report train_idx 0, so they carry t_points[0]
    pts = torch.where(keep[..., None], pts, t_points[..., :1, :])
    m = Matches(
        query_idx=_query_idx(keep),
        train_idx=torch.where(keep, idx[..., 0], 0),
        distance=torch.where(keep, torch.sqrt(best), 0.0),
        mask=keep,
    )
    return m, pts


def match_stats(m: Matches) -> Tuple[Tensor, Tensor]:
    """(min, max) distance over valid matches — the reference's min/max scan
    with its min=1 / max=0 initialization."""
    dmin = torch.where(m.mask, m.distance, torch.inf).amin(-1).clamp_max(1.0)
    dmax = torch.where(m.mask, m.distance, -torch.inf).amax(-1).clamp_min(0.0)
    return dmin, dmax
