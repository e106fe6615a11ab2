"""K3 — batched minimal 8-point solve (the RANSAC hypothesis factory).

Replaces the TPU kernel ``points_matching_tpu/ops/pallas/eightpoint_kernel.py``
``minimal_eight_point``.  CUDA source:
``points_matching_tpu_torch/csrc/eightpoint.cu``: a block is one warp of 32 / G
samples, a group of G lanes per sample sharing its independent work
(Hartley's 16 point distances, the 45 AᵀA entries) in shared memory, then
one lane a sample running its serial core (Cholesky, inverse iteration,
the 3×3 stage, the sign) in registers.  G comes from
``_build.eight_point_group``; it changes no bit.  On the card the kernel is
bound by the latency of one sample's chain of IEEE square roots and
divisions, not memory (~2.5 k fp32 operations per sample against 164
bytes).

The plain version below is the same chain written over per-scalar [count]
tensors — one PyTorch elementwise op per scalar operation of the kernel, in
the kernel's order — so on the card the two agree to the last bit wherever
sqrt and division are IEEE-exact.  Constants are those of the reference
(``geometry/eigen.py``): shift ε = 1e-5·tr/n + 1e-20, golden-angle start
cos(i·2.399963) + 0.1, 4 iterations for the 9×9 and 8 for the 3×3, the
sqrt(max(·, 1e-30)) pivot guard and max(mean_dist, 1e-9).
"""
from __future__ import annotations

import math
from typing import List

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.utils.sanitize import check_finite, check_index

Tensor = torch.Tensor

GROUPS = (1, 8)           # lanes per sample the CUDA kernel is built for


def samples_per_block(group: int) -> int:
    """Samples a block of the CUDA kernel holds with G = ``group`` lanes
    each: a block is one warp (kWarp / G in csrc/eightpoint.cu)."""
    return 32 // group


# golden-angle start vector, computed in double and rounded to fp32 (as the
# reference kernel's trace-time constants are)
_START = [math.cos(i * 2.399963) + 0.1 for i in range(9)]


def _smallest_eigvec(M: dict, n: int, iters: int) -> List[Tensor]:
    """Inverse-iteration smallest eigenvector of the PSD matrix whose lower
    triangle is M[(i, j)], j ≤ i (each a [count] tensor)."""
    tr = M[(0, 0)]
    for i in range(1, n):
        tr = tr + M[(i, i)]
    eps = tr * (1e-5 / n) + 1e-20
    L: dict = {}
    invd = [None] * n
    for j in range(n):
        s = M[(j, j)] + eps
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        d = torch.sqrt(s.clamp_min(1e-30))
        inv = 1.0 / d
        L[(j, j)] = d
        invd[j] = inv
        for i in range(j + 1, n):
            s2 = M[(i, j)]
            for k in range(j):
                s2 = s2 - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s2 * inv

    v = [torch.full_like(tr, _START[i]) for i in range(n)]
    for _ in range(iters):
        y = [None] * n
        for i in range(n):
            s = v[i]
            for k in range(i):
                s = s - L[(i, k)] * y[k]
            y[i] = s * invd[i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[(k, i)] * x[k]
            x[i] = s * invd[i]
        ss = x[0] * x[0]
        for i in range(1, n):
            ss = ss + x[i] * x[i]
        norm = torch.sqrt(ss)
        ok = (norm > 1e-20) & torch.isfinite(norm)
        inv = 1.0 / norm.clamp_min(1e-20)
        v = [torch.where(ok, x[i] * inv, 1.0 if i == 0 else 0.0)
             for i in range(n)]
    return v


def _hartley(xs: List[Tensor], ys: List[Tensor]):
    """Unweighted Hartley normalization of the 8 sample points."""
    cx, cy = xs[0], ys[0]
    for p in range(1, 8):
        cx = cx + xs[p]
        cy = cy + ys[p]
    cx = cx * 0.125
    cy = cy * 0.125
    dxs = [x - cx for x in xs]
    dys = [y - cy for y in ys]
    md = torch.sqrt(dxs[0] * dxs[0] + dys[0] * dys[0])
    for p in range(1, 8):
        md = md + torch.sqrt(dxs[p] * dxs[p] + dys[p] * dys[p])
    md = md * 0.125
    # tensor / tensor: one rounding, like the kernel (scalar / tensor would
    # be reciprocal-then-multiply in PyTorch)
    s = torch.full_like(md, math.sqrt(2.0)) / md.clamp_min(1e-9)
    return [d * s for d in dxs], [d * s for d in dys], cx, cy, s


def minimal_eight_point_plain(sp1: Tensor, sp2: Tensor) -> Tensor:
    """Plain PyTorch K3: [..., 8, 2] × 2 → [..., 3, 3] rank-2,
    Frobenius- and sign-normalized F with p2ᵀ F p1 ≈ 0."""
    batch = sp1.shape[:-2]
    a = sp1.reshape(-1, 8, 2)
    c = sp2.reshape(-1, 8, 2)
    x1n, y1n, cx1, cy1, s1 = _hartley([a[:, p, 0] for p in range(8)],
                                      [a[:, p, 1] for p in range(8)])
    x2n, y2n, cx2, cy2, s2 = _hartley([c[:, p, 0] for p in range(8)],
                                      [c[:, p, 1] for p in range(8)])

    zero = torch.zeros_like(cx1)
    one = torch.ones_like(cx1)
    ATA = {(i, j): zero for i in range(9) for j in range(i + 1)}
    for p in range(8):
        r = [x2n[p] * x1n[p], x2n[p] * y1n[p], x2n[p],
             y2n[p] * x1n[p], y2n[p] * y1n[p], y2n[p],
             x1n[p], y1n[p], one]
        for i in range(9):
            for j in range(i + 1):
                # r[8] ≡ 1: r[i]·1 and 1·1 are exact, so skip those multiplies
                prod = r[i] if j == 8 else r[j] if i == 8 else r[i] * r[j]
                ATA[(i, j)] = ATA[(i, j)] + prod

    f = _smallest_eigvec(ATA, 9, 4)

    M = {}
    for i in range(3):
        for j in range(i + 1):
            s = f[i] * f[j]
            for k in range(1, 3):
                s = s + f[3 * k + i] * f[3 * k + j]
            M[(i, j)] = s
    v3 = _smallest_eigvec(M, 3, 8)
    Fr = []
    for i in range(3):
        fv = f[3 * i] * v3[0] + f[3 * i + 1] * v3[1] + f[3 * i + 2] * v3[2]
        Fr.append([f[3 * i + j] - fv * v3[j] for j in range(3)])

    G = []
    for i in range(3):
        g0 = Fr[i][0] * s1
        g1 = Fr[i][1] * s1
        G.append([g0, g1, Fr[i][2] - cx1 * g0 - cy1 * g1])
    F = [[None] * 3 for _ in range(3)]
    for j in range(3):
        F[0][j] = G[0][j] * s2
        F[1][j] = G[1][j] * s2
        F[2][j] = G[2][j] - cx2 * F[0][j] - cy2 * F[1][j]

    flat_raw = [F[k // 3][k % 3] for k in range(9)]
    ss = flat_raw[0] * flat_raw[0]
    for k in range(1, 9):
        ss = ss + flat_raw[k] * flat_raw[k]
    inv = 1.0 / torch.sqrt(ss).clamp_min(1e-12)
    flat = [x * inv for x in flat_raw]
    best_abs = flat[0].abs()
    best = flat[0]
    for k in range(1, 9):
        ak = flat[k].abs()
        take = ak > best_abs
        best_abs = torch.where(take, ak, best_abs)
        best = torch.where(take, flat[k], best)
    sign = torch.where(best < 0, -1.0, 1.0)
    out = torch.stack([x * sign for x in flat], dim=-1)
    return out.reshape(*batch, 3, 3)


def minimal_eight_point(sp1: Tensor, sp2: Tensor, *, _group=None) -> Tensor:
    """Batched normalized 8-point solve for minimal RANSAC samples.

    Args:
      sp1, sp2: [..., 8, 2] float32 sampled correspondences (typically
        [B, H, 8, 2]: pairs × hypotheses).
      _group: lanes per sample of the CUDA kernel, forced (tests and
        probes); None lets ``_build.eight_point_group`` choose.

    Returns [..., 3, 3] rank-2, Frobenius/sign-normalized F.
    """
    if sp1.shape != sp2.shape or sp1.dim() < 2 or tuple(sp1.shape[-2:]) != (8, 2):
        raise ValueError(f"expected sp1/sp2 [..., 8, 2], got {tuple(sp1.shape)} "
                         f"and {tuple(sp2.shape)}")
    if sp1.dtype != torch.float32 or sp2.dtype != torch.float32:
        raise TypeError("sp1 and sp2 must be float32")
    if sp1.device != sp2.device:
        raise ValueError("sp1 and sp2 on different devices")
    if _group is not None and _group not in GROUPS:
        raise ValueError(f"_group must be one of {GROUPS}, got {_group!r}")
    if sp1.device.type == "cpu":
        F = minimal_eight_point_plain(sp1, sp2)
    elif sp1.device.type == "cuda":
        F = _launch(sp1, sp2, _group)
    else:
        raise ValueError(f"unsupported device {sp1.device}")
    check_finite(F, "minimal_eight_point")      # inside a utils/sanitize.checked run
    return F


def _launch(sp1: Tensor, sp2: Tensor, _group) -> Tensor:
    if not (sp1.is_contiguous() and sp2.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    if sp1.data_ptr() % 16 or sp2.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned inputs")
    count = sp1.numel() // 16
    F = torch.empty((*sp1.shape[:-2], 3, 3), dtype=torch.float32,
                    device=sp1.device)
    if count == 0:
        return F
    group = _group or _build.eight_point_group(count, _build.sm_count(sp1.device.index))
    lib = _build.library()
    with torch.cuda.device(sp1.device):
        rc = lib.pmt_eight_point(sp1.data_ptr(), sp2.data_ptr(), F.data_ptr(),
                                 count, group, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "pmt_eight_point")
    minimal_eight_point.launches += 1
    minimal_eight_point.last_group = group
    return F


minimal_eight_point.launches = 0
minimal_eight_point.work = _work.eight_point_work
minimal_eight_point.last_group = None    # G of the last kernel launch
