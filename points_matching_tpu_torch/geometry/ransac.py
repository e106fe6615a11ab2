"""Batched-hypothesis RANSAC for F — port of
``points_matching_tpu/geometry/ransac.py``.

All hypotheses are sampled, solved and scored at once: the minimal 8-point
solve goes through kernel K3 and the consensus scoring through kernel K2
(``ops/kernels/``), then a least-squares refit on the consensus set.

Every function takes one pair or a leading pair axis ([P, N, 2] points),
the port of the JAX package's ``jax.vmap`` over pairs: each pair draws,
wins, refits and is audited on its own, and K3 and K2 launch once for all
P pairs.

Randomness comes from an explicit ``torch.Generator``.  It cannot reproduce
the JAX package's threefry draws, so ``ransac_fundamental`` also accepts the
minimal sets themselves (``samples=(sp1, sp2)``): the parity tests feed
both packages the same samples.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

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
Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _stratified_positions(
    generator: Generators,
    mask: Tensor,
    num_hypotheses: int,
    sample_size: int,
    logits: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, int]:
    """Bucket-local draw positions of the stratified sampler, for one mask
    [N] or a batch [..., N], each pair drawn on its own.

    A fresh random permutation (the pair's own) splits the N slots into S
    equal buckets (slots ≥ N are virtual padding and invalid); every
    hypothesis draws its s-th element from bucket s with P ∝ exp(logits)
    over the bucket's valid slots (uniform without logits).  Buckets are
    disjoint, so a minimal set never repeats an index.  An all-invalid
    bucket draws its last slot (a duplicate-free but invalid pick that
    scores ~0 inliers).

    The random numbers are drawn pair by pair (a permutation, then the
    [S, H] uniforms), so a batch of P pairs draws exactly what P one-pair
    calls draw in turn; all the rest runs once for the batch.  ``generator``
    is one generator, or a sequence of one per index of the first leading
    axis (a segment axis): entry s then draws its rows, in row-major order,
    from generator s, as a call on entry s alone draws them.

    Returns (j [..., H, S] position within each bucket, slot_idx
    [..., S·bucket] original index per slot, bucket size).
    """
    lead, n = mask.shape[:-1], mask.shape[-1]
    S = sample_size
    bucket = -(-n // S)
    dev = mask.device
    rows = math.prod(lead)
    if isinstance(generator, torch.Generator) or generator is None:
        gens = [generator] * rows
    else:
        if not lead or len(generator) != lead[0]:
            raise ValueError(f"{len(generator)} generators for leading axes {tuple(lead)}")
        gens = [g for g in generator for _ in range(rows // lead[0])]
    perms, us = [], []
    for g in gens:
        perms.append(torch.randperm(bucket * S, generator=g, device=dev))
        us.append(torch.rand((S, num_hypotheses), generator=g, device=dev))
    perm = torch.stack(perms).reshape(*lead, bucket * S)
    slot_idx = perm.clamp_max(n - 1)
    slot_valid = (perm < n) & mask.gather(-1, slot_idx)
    if logits is None:
        w = slot_valid.to(torch.float32).reshape(*lead, S, bucket)
    else:
        # shift by the per-bucket max so exp() cannot overflow (the draw is
        # bucket-local, so the shift is distribution-exact)
        lg = torch.where(mask, logits, -torch.inf).gather(-1, slot_idx)
        lgb = torch.where(slot_valid, lg, -torch.inf).reshape(*lead, S, bucket)
        lmax = lgb.amax(-1, keepdim=True)
        lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
        w = torch.where(slot_valid.reshape(*lead, S, bucket),
                        torch.exp((lgb - lmax).clamp(-60.0, 0.0)), 0.0)
    cdf = torch.cumsum(w, -1)                                   # [..., S, bucket]
    total = cdf[..., -1:]                                       # [..., S, 1]
    u = torch.stack(us).reshape(*lead, S, num_hypotheses) * total
    # smallest j with cdf[j] > u == #{j : cdf[j] <= u}
    j = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    j = j.clamp_max(bucket - 1).transpose(-1, -2)               # [..., H, S]
    return j, slot_idx, bucket


def sample_index_sets(generator: Generators, mask: Tensor, num_hypotheses: int,
                      sample_size: int, logits: Optional[Tensor] = None) -> Tensor:
    """[..., H, S] index sets (one [H, S] per mask row of [..., N]), no
    repeats within a set, P ∝ exp(logits) within each stratified bucket
    (see ``_stratified_positions``)."""
    j, slot_idx, bucket = _stratified_positions(
        generator, mask, num_hypotheses, sample_size, logits)
    offs = torch.arange(sample_size, device=mask.device) * bucket
    pos = (offs + j).flatten(-2)                                # [..., H·S]
    return slot_idx.gather(-1, pos).reshape(j.shape)


def sample_minimal_points(generator: Generators, mask: Tensor, num_hypotheses: int,
                          sample_size: int, tables: Tuple[Tensor, ...],
                          logits: Optional[Tensor] = None) -> Tuple[Tensor, ...]:
    """Stratified minimal-set sampling returning the sampled ROWS of each
    [..., N, C] table as [..., H, S, C] (a plain gather per pair)."""
    picks = sample_index_sets(generator, mask, num_hypotheses, sample_size, logits)
    rows = picks.flatten(-2)[..., None]                         # [..., H·S, 1]
    return tuple(torch.take_along_dim(t, rows, dim=-2).reshape(*picks.shape, t.shape[-1])
                 for t in tables)


def ransac_fundamental(
    generator: Optional[Generators],
    p1: Tensor,
    p2: Tensor,
    mask: Tensor,
    config: RansacConfig = RansacConfig(),
    samples: Optional[Tuple[Tensor, Tensor]] = None,
) -> TwoViewEstimate:
    """Batched-hypothesis RANSAC for F with least-squares refit, for one
    pair or a batch of pairs.

    Args:
      generator: random source for the minimal sets (on p1's device): one
        generator, or one per index of the first leading axis.
      p1, p2: [..., N, 2] matched pixel coordinates (padded rows allowed);
        leading axes are pairs, each estimated on its own.
      mask:   [..., N] validity of each correspondence.
      config: RansacConfig.
      samples: optional injected minimal sets (sp1, sp2), each
        [..., H, S, 2]; when given, ``generator`` is not used.

    Every pair's hypotheses are solved by one launch of K3 and scored by one
    launch of K2, whatever the number of pairs; the winner, the refit (with
    its ≥ 8-inlier guard) and the audit are per pair.

    Returns TwoViewEstimate (F, inlier mask, count, reference-form residual)
    with p1's leading axes.
    """
    mask = mask.bool()
    if config.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend: {config.backend!r}")
    sample_size = 7 if config.solver == "7pt" else config.sample_size
    lead, n = p1.shape[:-2], p1.shape[-2]
    if samples is None:
        sp1, sp2 = sample_minimal_points(
            generator, mask, config.num_hypotheses, sample_size, (p1, p2))
    else:
        sp1, sp2 = (s.to(device=p1.device, dtype=p1.dtype) for s in samples)
    # one pair axis B (B = 1 for one pair) for the kernels and the winner
    p1, p2, mask = p1.reshape(-1, n, 2), p2.reshape(-1, n, 2), mask.reshape(-1, n)
    B = p1.shape[0]
    sp1, sp2 = (s.reshape(B, *s.shape[-3:]) for s in (sp1, sp2))
    tau2 = config.inlier_threshold ** 2

    if config.solver == "7pt":
        # ≤3 real cubic roots per sample, all scored as hypotheses
        F_cand, root_valid = seven_point(sp1, sp2)      # [B, H, 3, 3, 3], [B, H, 3]
        F_h = F_cand.reshape(B, -1, 3, 3)
        hyp_valid = root_valid.reshape(B, -1)
    elif config.solver != "8pt":
        raise ValueError(f"unknown solver: {config.solver!r}")
    elif config.backend != "xla" and sample_size == 8:
        F_h = minimal_eight_point(sp1.contiguous(), sp2.contiguous())   # K3
        hyp_valid = None
    else:
        F_h = eight_point(sp1, sp2)
        hyp_valid = None

    if config.backend != "xla":
        # K2: only the [B, H] counts come back; each winner's inlier mask is
        # recomputed from its F alone
        counts = ransac_score_hypotheses(
            F_h.contiguous(), p1.contiguous(), p2.contiguous(), mask.contiguous(),
            config.inlier_threshold)
    else:
        d = sampson_distance(F_h, p1[:, None], p2[:, None])
        counts = ((d < tau2) & mask[:, None]).sum(-1, dtype=torch.int32)
    if hyp_valid is not None:
        counts = torch.where(hyp_valid, counts, -1)
    F = take(F_h, counts.argmax(-1))                             # first on ties
    best_inliers = (sampson_distance(F, p1, p2) < tau2) & mask

    if config.refit:
        # An f32 least-squares F is good to ~1e-4 (its normal matrix's two
        # smallest eigenvalues lie close), so the order of its sums moves it
        # that far.
        # The card's matmul and reduction kernels sum a batch of pairs in
        # another order than one pair (F 6e-4 apart at 64 pairs on an
        # H100); the CPU's sum both alike.  So on the card the refit solves
        # in float64, where a batch and its pairs one by one give the same
        # f32 F, and on the CPU in the reference's float32.
        ls = torch.float64 if p1.device.type == "cuda" else p1.dtype
        for _ in range(config.refit_iterations):
            w = best_inliers.to(p1.dtype)
            # refitting needs ≥ 8 inliers; otherwise keep the model
            enough = (w.sum(-1) >= 8.0)[:, None, None]
            F_ls = eight_point(p1.to(ls), p2.to(ls), w.to(ls)).to(p1.dtype)
            F = torch.where(enough, F_ls, F)
            best_inliers = (sampson_distance(F, p1, p2) < tau2) & mask

    num_inliers = best_inliers.sum(-1, dtype=torch.int32)
    _, res_mean = epipolar_residual_audit(F, p1, p2, best_inliers, form="reference")
    return TwoViewEstimate(F=F.reshape(*lead, 3, 3),
                           inlier_mask=best_inliers.reshape(*lead, n),
                           num_inliers=num_inliers.reshape(lead),
                           residual_mean=res_mean.reshape(lead))
