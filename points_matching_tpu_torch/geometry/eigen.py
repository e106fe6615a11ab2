"""Small-matrix eigen-solvers with a fixed number of steps (port of
``smallest_eigvecs_psd``, ``smallest_eigvec_psd``, ``nearest_rotation_so3``,
``svd3_rotational`` and ``project_rank2`` from
``points_matching_tpu/geometry/eigen.py``).

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
    # basis vectors from eye (a kernel), not a scalar write into a device
    # tensor, which waits for the device
    eye = torch.eye(n, dtype=M.dtype, device=M.device)

    def orthonormalize(X: Tensor) -> Tensor:
        cols = []
        for j in range(k):
            v = X[..., :, j]
            for q in cols:
                v = v - (q * v).sum(-1, keepdim=True) * q
            norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            # collapsed direction or non-finite input: fixed basis vector
            ok = (norm > 1e-20) & torch.isfinite(norm)
            v = torch.where(ok, v / norm.clamp_min(1e-20), eye[j].expand_as(v))
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


def _row(*e: Tensor) -> Tensor:
    return torch.stack(e, -1)


def nearest_rotation_so3(M: Tensor, iters: int = 24) -> Tensor:
    """Nearest proper rotation (Frobenius) to a 3×3 — det(R) = +1.

    Horn's quaternion method: the dominant eigenvector of a symmetric 4×4
    built from M, by shifted power iteration with a fixed trip count and
    the start vector (1, 0, 0, 0), as the reference.
    """
    S = M.transpose(-1, -2)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        _row(Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx),
        _row(Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz),
        _row(Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy),
        _row(Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz),
    ], -2)
    # |λ(K)| ≤ √3‖M‖_F, so +2‖M‖_F I makes the target eigenvalue dominant
    eye4 = torch.eye(4, dtype=M.dtype, device=M.device)
    shift = 2.0 * torch.linalg.matrix_norm(M)[..., None, None] + 1e-20
    Ks = K + shift * eye4
    Ks = torch.where(torch.isfinite(Ks), Ks, eye4)

    q = eye4[0].expand(*M.shape[:-2], 4)
    for _ in range(iters):
        q = (Ks * q[..., None, :]).sum(-1)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-20)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        _row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        _row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        _row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], -2)


def _matvec(A: Tensor, v: Tensor) -> Tensor:
    return (A * v[..., None, :]).sum(-1)


def _unit(v: Tensor) -> Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-20)


def svd3_rotational(A: Tensor):
    """SVD of a 3×3 with det(U) = det(V) = +1 ("SVD with rotations").

    Same construction as the reference: v₃ = smallest eigenvector of AᵀA
    (inverse iteration, 8 steps); v₁, v₂ from one exact Jacobi angle on AᵀA
    restricted to the plane ⊥ v₃ (robust when σ₁ ≈ σ₂, the essential-matrix
    case); v₂ = v₃ × v₁; uᵢ = A vᵢ / σᵢ, u₂ re-orthogonalised, u₃ = u₁ × u₂.

    Returns (U, s, Vt) with s[0] ≥ s[1] ≥ |s[2]|; s[2] carries sign(det A).
    """
    M = A.transpose(-1, -2) @ A
    v3 = smallest_eigvec_psd(M, iters=8)

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    ez, ey = eye[2].expand(v3.shape), eye[1].expand(v3.shape)
    a = torch.linalg.cross(v3, ez)
    a_alt = torch.linalg.cross(v3, ey)
    use_alt = (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
               < torch.linalg.vector_norm(a_alt, dim=-1, keepdim=True))
    a = _unit(torch.where(use_alt, a_alt, a))
    b = torch.linalg.cross(v3, a)

    Ma = _matvec(M, a)
    Mb = _matvec(M, b)
    maa = (a * Ma).sum(-1)
    mab = (a * Mb).sum(-1)
    mbb = (b * Mb).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * mab, maa - mbb)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    v1 = c * a + s * b
    v2c = -s * a + c * b
    lam1 = (v1 * _matvec(M, v1)).sum(-1)
    lam2 = (v2c * _matvec(M, v2c)).sum(-1)
    v1 = torch.where((lam2 > lam1)[..., None], v2c, v1)
    v2 = torch.linalg.cross(v3, v1)

    Av1, Av2, Av3 = _matvec(A, v1), _matvec(A, v2), _matvec(A, v3)
    s1 = torch.linalg.vector_norm(Av1, dim=-1)
    s2 = torch.linalg.vector_norm(Av2, dim=-1)
    u1 = Av1 / s1.clamp_min(1e-20)[..., None]
    u2 = Av2 / s2.clamp_min(1e-20)[..., None]
    u2 = _unit(u2 - (u1 * u2).sum(-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2)
    s3 = (u3 * Av3).sum(-1)

    U = torch.stack([u1, u2, u3], -1)
    Vt = torch.stack([v1, v2, v3], -2)
    return U, torch.stack([s1, s2, s3], -1), Vt
