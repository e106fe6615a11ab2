"""Batched-hypothesis RANSAC for F — port of
``points_matching_tpu/geometry/ransac.py``.

All hypotheses are sampled, solved and scored at once: the minimal 8-point
solve goes through kernel K3 and the consensus scoring through kernel K2
(``ops/kernels/``), then a least-squares refit on the consensus set.

Randomness comes from an explicit ``torch.Generator``.  It cannot reproduce
the JAX package's threefry draws, so ``ransac_fundamental`` also accepts the
minimal sets themselves (``samples=(sp1, sp2)``): the parity tests feed
both packages the same samples.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from points_matching_tpu_torch.core.config import RansacConfig
from points_matching_tpu_torch.core.types import TwoViewEstimate, take
from points_matching_tpu_torch.geometry.fundamental import (
    eight_point,
    epipolar_residual_audit,
    sampson_distance,
    seven_point,
)
from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import minimal_eight_point
from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses

Tensor = torch.Tensor


def _stratified_positions(
    generator: torch.Generator,
    mask: Tensor,
    num_hypotheses: int,
    sample_size: int,
    logits: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, int]:
    """Bucket-local draw positions of the stratified sampler.

    A fresh random permutation splits the N slots into S equal buckets
    (slots ≥ N are virtual padding and invalid); every hypothesis draws its
    s-th element from bucket s with P ∝ exp(logits) over the bucket's valid
    slots (uniform without logits).  Buckets are disjoint, so a minimal set
    never repeats an index.  An all-invalid bucket draws its last slot (a
    duplicate-free but invalid pick that scores ~0 inliers).

    Returns (j [H, S] position within each bucket, slot_idx [S·bucket]
    original index per slot, bucket size).
    """
    n = mask.shape[-1]
    S = sample_size
    bucket = -(-n // S)
    dev = mask.device
    perm = torch.randperm(bucket * S, generator=generator, device=dev)
    slot_idx = perm.clamp_max(n - 1)
    slot_valid = (perm < n) & mask[slot_idx]
    if logits is None:
        w = slot_valid.to(torch.float32).reshape(S, bucket)
    else:
        # shift by the per-bucket max so exp() cannot overflow (the draw is
        # bucket-local, so the shift is distribution-exact)
        lg = torch.where(mask, logits, -torch.inf)[slot_idx]
        lgb = torch.where(slot_valid, lg, -torch.inf).reshape(S, bucket)
        lmax = lgb.amax(-1, keepdim=True)
        lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
        w = torch.where(slot_valid.reshape(S, bucket),
                        torch.exp((lgb - lmax).clamp(-60.0, 0.0)), 0.0)
    cdf = torch.cumsum(w, -1)                                   # [S, bucket]
    total = cdf[:, -1:]                                         # [S, 1]
    u = torch.rand((S, num_hypotheses), generator=generator, device=dev) * total
    # smallest j with cdf[j] > u == #{j : cdf[j] <= u}
    j = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    j = j.clamp_max(bucket - 1).T                               # [H, S]
    return j, slot_idx, bucket


def sample_index_sets(generator: torch.Generator, mask: Tensor, num_hypotheses: int,
                      sample_size: int, logits: Optional[Tensor] = None) -> Tensor:
    """[H, S] index sets, no repeats within a set, P ∝ exp(logits) within
    each stratified bucket (see ``_stratified_positions``)."""
    j, slot_idx, bucket = _stratified_positions(
        generator, mask, num_hypotheses, sample_size, logits)
    offs = torch.arange(sample_size, device=mask.device)[None, :] * bucket
    return slot_idx[offs + j]


def sample_minimal_points(generator: torch.Generator, mask: Tensor, num_hypotheses: int,
                          sample_size: int, tables: Tuple[Tensor, ...],
                          logits: Optional[Tensor] = None) -> Tuple[Tensor, ...]:
    """Stratified minimal-set sampling returning the sampled ROWS of each
    [N, C] table as [H, S, C] (a plain gather)."""
    picks = sample_index_sets(generator, mask, num_hypotheses, sample_size, logits)
    return tuple(t[picks] for t in tables)


def ransac_fundamental(
    generator: Optional[torch.Generator],
    p1: Tensor,
    p2: Tensor,
    mask: Tensor,
    config: RansacConfig = RansacConfig(),
    samples: Optional[Tuple[Tensor, Tensor]] = None,
) -> TwoViewEstimate:
    """Batched-hypothesis RANSAC for F with least-squares refit.

    Args:
      generator: random source for the minimal sets (on p1's device).
      p1, p2: [N, 2] matched pixel coordinates (padded rows allowed).
      mask:   [N] validity of each correspondence.
      config: RansacConfig.
      samples: optional injected minimal sets (sp1, sp2), each [H, S, 2];
        when given, ``generator`` is not used.

    Returns TwoViewEstimate (F, inlier mask, count, reference-form residual).
    """
    mask = mask.bool()
    if config.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend: {config.backend!r}")
    sample_size = 7 if config.solver == "7pt" else config.sample_size
    if samples is None:
        sp1, sp2 = sample_minimal_points(
            generator, mask, config.num_hypotheses, sample_size, (p1, p2))
    else:
        sp1, sp2 = (s.to(device=p1.device, dtype=p1.dtype) for s in samples)
    tau2 = config.inlier_threshold ** 2

    if config.solver == "7pt":
        # ≤3 real cubic roots per sample, all scored as hypotheses
        F_cand, root_valid = seven_point(sp1, sp2)      # [H, 3, 3, 3], [H, 3]
        F_h = F_cand.reshape(-1, 3, 3)
        hyp_valid = root_valid.reshape(-1)
    elif config.solver != "8pt":
        raise ValueError(f"unknown solver: {config.solver!r}")
    elif config.backend != "xla" and sample_size == 8:
        F_h = minimal_eight_point(sp1.contiguous(), sp2.contiguous())   # K3
        hyp_valid = None
    else:
        F_h = eight_point(sp1, sp2)
        hyp_valid = None

    if config.backend != "xla":
        # K2: only the [H] counts come back; the winner's inlier mask is
        # recomputed from its F alone
        counts = ransac_score_hypotheses(
            F_h[None].contiguous(), p1[None].contiguous(),
            p2[None].contiguous(), mask[None].contiguous(),
            config.inlier_threshold)[0]
    else:
        d = sampson_distance(F_h, p1[None], p2[None])
        counts = ((d < tau2) & mask[None]).sum(-1, dtype=torch.int32)
    if hyp_valid is not None:
        counts = torch.where(hyp_valid, counts, -1)
    F = take(F_h, counts.argmax())
    best_inliers = (sampson_distance(F, p1, p2) < tau2) & mask

    if config.refit:
        for _ in range(config.refit_iterations):
            w = best_inliers.to(p1.dtype)
            # refitting needs ≥ 8 inliers; otherwise keep the model
            F = torch.where(w.sum() >= 8.0, eight_point(p1, p2, w), F)
            best_inliers = (sampson_distance(F, p1, p2) < tau2) & mask

    num_inliers = best_inliers.sum(dtype=torch.int32)
    _, res_mean = epipolar_residual_audit(F, p1, p2, best_inliers, form="reference")
    return TwoViewEstimate(F=F, inlier_mask=best_inliers, num_inliers=num_inliers,
                           residual_mean=res_mean)
