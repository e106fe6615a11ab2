"""RANSAC for the fundamental matrix, plainly: stratified minimal sets of 8
distinct valid correspondences, the normalised 8-point solve (Hartley
normalisation, the smallest eigenvector of AᵀA, the nearest rank-2 matrix),
every hypothesis scored under the Sampson gate d < τ², the first hypothesis
with the most inliers kept, then least-squares refits on its inlier set
(each only with ≥ 8 inliers), each followed by a new gate."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from gpu_bench.reference import dtype_of, matmul

Tensor = torch.Tensor
# elements of one [pairs, hypotheses, points] block of Sampson distances
_BLOCK_CELLS = 1 << 24
# cyclic Jacobi sweeps: 9 × 9 symmetric matrices converge to the last bit in
# fewer (quadratic convergence after the first few)
_JACOBI_SWEEPS = 12


def sample_sets(gen: torch.Generator, mask: Tensor, hyps: int, size: int = 8) -> Tensor:
    """[B, H, size] indices: a random permutation of each pair's slots cut
    into ``size`` buckets, and each hypothesis's s-th index drawn uniformly
    from bucket s's valid slots, so a set never repeats an index."""
    B, N = mask.shape
    bucket = -(-N // size)
    dev = mask.device
    perm = torch.rand(B, bucket * size, generator=gen, device=dev).argsort(-1)
    slot = perm.clamp_max(N - 1)
    valid = ((perm < N) & mask.gather(1, slot)).view(B, size, bucket)
    slot = slot.view(B, size, bucket)
    slot = slot.gather(-1, (~valid).to(torch.int8).argsort(dim=-1, stable=True))   # valid first
    n_valid = valid.sum(-1)                                                   # [B, size]
    u = torch.rand(B, hyps, size, generator=gen, device=dev)
    j = (u * n_valid[:, None, :]).floor().long()
    j = torch.minimum(j, (n_valid - 1).clamp_min(0)[:, None, :])
    offs = torch.arange(size, device=dev) * bucket
    return slot.view(B, size * bucket).gather(1, (offs + j).view(B, hyps * size)).view(
        B, hyps, size)


def _hartley(p: Tensor, w: Tensor):
    """Weighted centroid to the origin, mean distance sqrt(2): (p', T)."""
    wsum = w.sum(-1, keepdim=True).clamp_min(1e-9)
    c = (p * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    mean = (torch.linalg.vector_norm(p - c, dim=-1) * w).sum(-1, keepdim=True) / wsum
    s = math.sqrt(2.0) / mean.clamp_min(1e-9)
    pn = (p - c) * s[..., None]
    s = s[..., 0]
    T = torch.zeros(*s.shape, 3, 3, dtype=p.dtype, device=p.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * c[..., 0, 0]
    T[..., 1, 2] = -s * c[..., 0, 1]
    T[..., 2, 2] = 1.0
    return pn, T


def smallest_eigvec(M: Tensor) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric
    [..., n, n] matrix, by cyclic Jacobi rotations over the whole batch (no
    library eigensolver: cuSOLVER's batched one refuses large batches)."""
    lead, n = M.shape[:-2], M.shape[-1]
    A = M.reshape(-1, n, n).clone()
    V = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(A).clone()
    for _ in range(_JACOBI_SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = A[:, p, q], A[:, p, p], A[:, q, q]
                nz = apq != 0
                theta = (aqq - app) / torch.where(nz, 2.0 * apq, torch.ones_like(apq))
                t = torch.where(theta >= 0, 1.0, -1.0).to(M.dtype) / (
                    theta.abs() + torch.sqrt(theta * theta + 1.0))
                c = torch.where(nz, 1.0 / torch.sqrt(t * t + 1.0), torch.ones_like(t))
                sn = torch.where(nz, t * c, torch.zeros_like(t))
                c, sn = c[:, None], sn[:, None]
                for X in (A, V):                          # columns p, q
                    xp, xq = X[:, :, p].clone(), X[:, :, q].clone()
                    X[:, :, p] = c * xp - sn * xq
                    X[:, :, q] = sn * xp + c * xq
                ap, aq = A[:, p, :].clone(), A[:, q, :].clone()   # rows p, q
                A[:, p, :] = c * ap - sn * aq
                A[:, q, :] = sn * ap + c * aq
    k = torch.diagonal(A, dim1=-2, dim2=-1).argmin(-1)
    v = V.gather(2, k[:, None, None].expand(-1, n, 1))[..., 0]
    return v.reshape(*lead, n)


def eight_point(p1: Tensor, p2: Tensor, w: Optional[Tensor], precision: str) -> Tensor:
    """[..., N, 2] × 2 (weights [..., N]) → [..., 3, 3] rank-2 F with
    p2ᵀ F p1 ≈ 0, unit Frobenius norm, its largest-magnitude entry
    positive."""
    dt = dtype_of(precision)
    p1, p2 = p1.to(dt), p2.to(dt)
    w = torch.ones(p1.shape[:-1], dtype=dt, device=p1.device) if w is None else w.to(dt)
    a, T1 = _hartley(p1, w)
    b, T2 = _hartley(p2, w)
    x1, y1, x2, y2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1) * w[..., None]
    M = matmul(A.transpose(-1, -2), A, precision)
    lead = M.shape[:-2]
    Fn = smallest_eigvec(M).reshape(*lead, 3, 3)
    # the nearest rank-2 matrix: Fn less its smallest singular direction
    # (v3, the smallest eigenvector of FnᵀFn): Fn (I − v3 v3ᵀ)
    v3 = smallest_eigvec(matmul(Fn.transpose(-1, -2), Fn, precision))
    Fn = Fn - matmul(matmul(Fn, v3[..., :, None], precision), v3[..., None, :], precision)
    F = matmul(matmul(T2.transpose(-1, -2), Fn, precision), T1, precision)
    F = F / torch.linalg.vector_norm(F, dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    flat = F.reshape(*lead, 9)
    pivot = flat.gather(-1, flat.abs().argmax(-1, keepdim=True))
    return F * torch.where(pivot < 0, -1.0, 1.0).to(dt)[..., None]


def sampson(F: Tensor, p1: Tensor, p2: Tensor, precision: str) -> Tensor:
    """Sampson distances: F [..., 3, 3] against points [..., N, 2] →
    [..., N] (F may carry more leading axes than the points)."""
    dt = dtype_of(precision)
    F = F.to(dt)
    one = torch.ones(*p1.shape[:-1], 1, dtype=dt, device=p1.device)
    h1 = torch.cat([p1.to(dt), one], -1)
    h2 = torch.cat([p2.to(dt), one], -1)
    extra = F.dim() - 2 - (h1.dim() - 2)
    for _ in range(extra):
        h1, h2 = h1.unsqueeze(-3), h2.unsqueeze(-3)
    Fp1 = matmul(h1, F.transpose(-1, -2), precision)
    Ftp2 = matmul(h2, F, precision)
    r = (h2 * Fp1).sum(-1)
    den = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return r * r / den.clamp_min(1e-12)


def gate(F: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, tau: float,
         precision: str) -> Tensor:
    """Inliers of one F a pair: valid and Sampson distance < τ²."""
    return (sampson(F, p1, p2, precision) < tau * tau) & mask


def ransac(gen: torch.Generator, p1: Tensor, p2: Tensor, mask: Tensor, hyps: int, tau: float,
           refits: int, precision: str) -> Dict[str, Tensor]:
    """F, inlier mask and count of each of B pairs ([B, N, 2] points, [B, N]
    mask), from ``hyps`` stratified minimal sets a pair."""
    B, N = mask.shape
    sets = sample_sets(gen, mask, hyps)
    take = lambda p: p.gather(1, sets.view(B, -1, 1).expand(B, hyps * 8, 2)).view(B, hyps, 8, 2)
    F_h = eight_point(take(p1), take(p2), None, precision)                  # [B, H, 3, 3]
    counts = torch.empty(B, hyps, dtype=torch.int64, device=mask.device)
    hc = max(1, _BLOCK_CELLS // max(1, N))
    for b in range(B):
        for h0 in range(0, hyps, hc):
            d = sampson(F_h[b, h0:h0 + hc], p1[b], p2[b], precision)        # [hc, N]
            counts[b, h0:h0 + hc] = ((d < tau * tau) & mask[b]).sum(-1)
    F = F_h[torch.arange(B, device=mask.device), counts.argmax(-1)]
    inl = gate(F, p1, p2, mask, tau, precision)
    for _ in range(refits):
        enough = (inl.sum(-1) >= 8)[:, None, None]
        F = torch.where(enough, eight_point(p1, p2, inl, precision), F)
        inl = gate(F, p1, p2, mask, tau, precision)
    return dict(F=F, inliers=inl, count=inl.sum(-1))
