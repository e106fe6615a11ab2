"""Schur-complement reduction of the dense-grid BA normal equations — port
of ``points_matching_tpu/ba/schur.py``.

    [ U   W ] [dc]   [bc]
    [ Wᵀ  V ] [dl] = [bl]

U block-diagonal over cameras (6×6), V over landmarks (3×3), W the
camera×landmark coupling [C, L, 6, 3].  Eliminating landmarks gives the
reduced camera system S dc = g with S = U − W V⁻¹ Wᵀ and g = bc − W V⁻¹ bl;
then dl = V⁻¹ (bl − Wᵀ dc).  Solved by Cholesky (``solve_schur``) or by
Jacobi-preconditioned CG with an implicit S (``solve_schur_pcg``).

Landmark sharding (the reference under GSPMD, ``parallel/sharded_ba.py``):
with a process ``group``, each rank holds a block of the landmarks (its
columns of the [C, L] grid).  U, bc, the Σ_l terms of S, g and the matvec,
and the preconditioner's Σ_l term are completed by an ``all_reduce``; the
camera solve is then replicated, and V, W, bl and the back-substitution stay
local.  ``group=None`` reduces nothing (bit for bit the single process).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


def _preduce(x: Tensor, group) -> Tensor:
    """Complete a local partial sum over ``group`` (``x`` itself for None)."""
    if group is None:
        return x
    from points_matching_tpu_torch.parallel.comm import Comm

    return Comm(group).psum(x)


class NormalEqBlocks(NamedTuple):
    U: Tensor   # [C, 6, 6]
    V: Tensor   # [L, 3, 3]
    W: Tensor   # [C, L, 6, 3]
    bc: Tensor  # [C, 6]
    bl: Tensor  # [L, 3]


def build_normal_equations(r: Tensor, Jc: Tensor, Jl: Tensor, weights: Tensor,
                           group=None) -> NormalEqBlocks:
    """Weighted GN blocks from grid residuals/Jacobians: r [C, L, 2],
    Jc [C, L, 2, 6], Jl [C, L, 2, 3], weights [C, L] (0 for invalid); with
    ``group``, U and bc are reduced over it."""
    Jcw = Jc * weights[..., None, None]
    U = _preduce(torch.einsum("clki,clkj->cij", Jcw, Jc), group)
    V = torch.einsum("clki,clkj->lij", Jl * weights[..., None, None], Jl)
    W = torch.einsum("clki,clkj->clij", Jcw, Jl)
    wr = r * weights[..., None]
    bc = _preduce(-torch.einsum("clki,clk->ci", Jc, wr), group)
    bl = -torch.einsum("clki,clk->li", Jl, wr)
    return NormalEqBlocks(U=U, V=V, W=W, bc=bc, bl=bl)


def _damp(M: Tensor, lam) -> Tensor:
    """Levenberg damping: M + λ·diag(M) + 1e-9·I (keeps blocks SPD)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + lam * (d[..., None] * eye) + 1e-9 * eye


def _inv3(V: Tensor) -> Tensor:
    """Batched closed-form 3×3 symmetric inverse (adjugate / det, |det|
    floored at 1e-12)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    e, f_ = V[..., 1, 1], V[..., 1, 2]
    i = V[..., 2, 2]
    A = e * i - f_ * f_
    B = c * f_ - b * i
    C = b * f_ - c * e
    E = a * i - c * c
    F = b * c - a * f_
    I_ = a * e - b * b
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    rows = [torch.stack([A, B, C], -1), torch.stack([B, E, F], -1),
            torch.stack([C, F, I_], -1)]
    return torch.stack(rows, -2) / det[..., None, None]


def schur_reduce(blocks: NormalEqBlocks, lam, group=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Damped Schur complement: (S [C, 6, C, 6], g [C, 6], Vinv [L, 3, 3])."""
    C = blocks.U.shape[0]
    U = _damp(blocks.U, lam)
    Vinv = _inv3(_damp(blocks.V, lam))
    Y = torch.einsum("clij,ljk->clik", blocks.W, Vinv)             # W V⁻¹
    S = _preduce(-torch.einsum("clik,dljk->cidj", Y, blocks.W), group)
    idx = torch.arange(C, device=U.device)
    S[idx, :, idx, :] += U
    g = blocks.bc - _preduce(torch.einsum("clik,lk->ci", Y, blocks.bl), group)
    return S, g, Vinv


def _back_substitute(blocks: NormalEqBlocks, Vinv: Tensor, dc: Tensor) -> Tensor:
    rhs = blocks.bl - torch.einsum("clij,ci->lj", blocks.W, dc)
    return torch.einsum("lij,lj->li", Vinv, rhs)


def solve_schur(blocks: NormalEqBlocks, lam, group=None) -> Tuple[Tensor, Tensor]:
    """Dense Cholesky on the reduced camera system + landmark
    back-substitution → (dc [C, 6], dl [L, 3]).  A failed factor
    (``info`` ≠ 0) gives a NaN step, whose cost the LM loop rejects, as the
    reference's NaN factor does; nothing is read on the host."""
    C = blocks.U.shape[0]
    S, g, Vinv = schur_reduce(blocks, lam, group)
    Lc, info = torch.linalg.cholesky_ex(S.reshape(C * 6, C * 6))
    dc = torch.cholesky_solve(g.reshape(C * 6, 1), Lc).reshape(C, 6)
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    return dc, _back_substitute(blocks, Vinv, dc)


def schur_matvec(blocks: NormalEqBlocks, Vinv: Tensor, lam, x: Tensor,
                 group=None) -> Tensor:
    """Implicit S @ x ([C, 6] → [C, 6]) without forming S."""
    Ux = torch.einsum("cij,cj->ci", _damp(blocks.U, lam), x)
    Wtx = torch.einsum("clij,ci->lj", blocks.W, x)
    VWtx = torch.einsum("lij,lj->li", Vinv, Wtx)
    return Ux - _preduce(torch.einsum("clij,lj->ci", blocks.W, VWtx), group)


def pcg(mv, precond, g: Tensor, iterations: int) -> Tensor:
    """Fixed-count preconditioned conjugate gradients for S x = g from
    x = 0, with the reference's 1e-12 floors on both denominators.  ``g`` is
    [..., C, 6]: each leading index is its own system, with its own dot
    products (a sum over all would couple them)."""
    def dot(a, b):
        return (a * b).sum((-2, -1), keepdim=True)

    x = torch.zeros_like(g)
    r = g - mv(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    for _ in range(iterations):
        Ap = mv(p)
        alpha = rz / dot(p, Ap).clamp_min(1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + rz_new / rz.clamp_min(1e-12) * p
        rz = rz_new
    return x


def solve_schur_pcg(blocks: NormalEqBlocks, lam, iterations: int = 50, group=None
                    ) -> Tuple[Tensor, Tensor]:
    """Jacobi-preconditioned CG on the reduced camera system (the 6×6
    diagonal blocks of S inverted), then back-substitution."""
    Vinv = _inv3(_damp(blocks.V, lam))
    g = blocks.bc - _preduce(torch.einsum("clij,ljk,lk->ci", blocks.W, Vinv, blocks.bl),
                             group)
    Y = torch.einsum("clij,ljk->clik", blocks.W, Vinv)
    S_diag = _damp(blocks.U, lam) - _preduce(torch.einsum("clik,cljk->cij", Y, blocks.W),
                                             group)
    Minv = torch.linalg.inv_ex(S_diag)[0]
    dc = pcg(lambda x: schur_matvec(blocks, Vinv, lam, x, group),
             lambda r: torch.einsum("cij,cj->ci", Minv, r), g, iterations)
    return dc, _back_substitute(blocks, Vinv, dc)
