"""Small-matrix eigen-solvers with a fixed number of steps (port of
``smallest_eigvecs_psd``, ``smallest_eigvec_psd`` and ``project_rank2``
from ``points_matching_tpu/geometry/eigen.py``).

Same algorithm and constants as the reference — shift-regularized inverse
subspace iteration with shift ε = eps_scale·tr/n + 1e-20, the golden-angle
start vector cos(i·2.399963) + 0.1, the sqrt(max(·, 1e-30)) Cholesky pivot
guard and the same trip counts — so the two packages agree to f32 rounding.
``torch.linalg.eigh`` would converge to the same subspace by another route
and give other rounding, so it is deliberately not used.

The Cholesky factor and the triangular solves work column by column over
the batch ([..., n] vector ops), not element by element: n launches per
factor on the card instead of n³/6.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cholesky(M: Tensor) -> Tensor:
    """Batched lower Cholesky factor of a small SPD matrix [..., n, n], with
    the reference's sqrt(max(·, 1e-30)) pivot guard: a non-PD or non-finite
    input gives finite garbage instead of NaNs."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        Lj = L[..., j, :j]                                   # [..., j]
        s = M[..., j:, j] - (L[..., j:, :j] * Lj[..., None, :]).sum(-1)
        d = torch.sqrt(s[..., 0].clamp_min(1e-30))
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] * (1.0 / d)[..., None]
    return L


def _cho_solve(L: Tensor, b: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = b for b [..., n] by forward + back substitution."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        s = b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)
        y[..., i] = s / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        s = y[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
        x[..., i] = s / L[..., i, i]
    return x


def smallest_eigvecs_psd(M: Tensor, k: int = 1, iters: int = 8,
                         eps_scale: float = 1e-5) -> Tensor:
    """Orthonormal basis of the k-smallest-eigenvalue subspace of PSD ``M``.

    Batched over leading dims; [..., n, n] → [..., n, k].  For k > 1 the
    columns span the subspace but are not eigenvalue-ordered.  Designed for
    near-singular matrices (constraint normal matrices), where a few
    iterations reach f32 precision.
    """
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eps = eps_scale * tr / n + 1e-20
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    L = _cholesky(M + eps * eye)

    phase = torch.arange(n * k, dtype=M.dtype, device=M.device).reshape(n, k)
    V = torch.cos(phase * 2.399963) + 0.1  # golden-angle phases
    V = V.expand(*M.shape[:-2], n, k)

    def orthonormalize(X: Tensor) -> Tensor:
        cols = []
        for j in range(k):
            v = X[..., :, j]
            for q in cols:
                v = v - (q * v).sum(-1, keepdim=True) * q
            norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            # collapsed direction or non-finite input: fixed basis vector
            ok = (norm > 1e-20) & torch.isfinite(norm)
            fallback = torch.zeros_like(v)
            fallback[..., j] = 1.0
            v = torch.where(ok, v / norm.clamp_min(1e-20), fallback)
            cols.append(v)
        return torch.stack(cols, dim=-1)

    for _ in range(iters):
        X = torch.stack([_cho_solve(L, V[..., :, j]) for j in range(k)], dim=-1)
        V = orthonormalize(X)
    return V


def smallest_eigvec_psd(M: Tensor, iters: int = 4) -> Tensor:
    """[..., n, n] PSD → [..., n] unit eigenvector of the smallest eigenvalue."""
    return smallest_eigvecs_psd(M, k=1, iters=iters)[..., :, 0]


def project_rank2(F: Tensor) -> Tensor:
    """Nearest rank-2 matrix (Frobenius) to a 3×3, SVD-free:
    F − (F v₃) v₃ᵀ with v₃ the smallest eigenvector of FᵀF."""
    M = F.transpose(-1, -2) @ F
    v3 = smallest_eigvec_psd(M, iters=8)
    Fv = (F * v3[..., None, :]).sum(-1)
    return F - Fv[..., :, None] * v3[..., None, :]
