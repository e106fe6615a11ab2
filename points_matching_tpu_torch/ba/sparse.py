"""Sparse observation-list bundle adjustment, O(observations) memory — port
of ``points_matching_tpu/ba/sparse.py``.

Everything is computed from the flat observation arrays (cam_idx, lm_idx,
uv): per-observation residuals and closed-form Jacobians, normal-equation
blocks by segmented sums (the reference's ``segment_sum``), and the reduced
camera system solved by Jacobi-preconditioned CG with an implicit Schur
matvec — ``[C, L]`` never exists:

    S x = U x − Σ_l W_{·l} V_l⁻¹ (Σ_o W_oᵀ x_{cam(o)})

Duplicate (c, l) observations add, exactly.  Every layout of
``BAConfig.obs_layout`` (``'auto'``, ``'sorted'``, ``'scatter'``) runs the
semantics of the reference's sorted layout, and the reference's two
layouts give the same bits: the observations are sorted once per BA call
into two plans (by camera and by landmark;
``ops/kernels/segment_sum.build_plan``, masked observations left out) and
every sum of the call reuses them.  On the card the segmented-sum kernel
adds each row in an order fixed by its own observations, without atomics,
so two runs give the same bits; on the CPU the plain version adds each row
in observation order, as a scatter over the observation index would.  The
reference's TPU mechanics for the sorted layout (one-hot GEMM camera sums,
cumsum-diff landmark sums) are not ported.

Observation sharding (the reference's ``axis_name`` under ``shard_map``):
with a process ``group``, the observation arrays are this rank's shard,
poses and landmarks are replicated, and every local partial sum (U, V, bc,
bl; the matvec's two sums; the gradient and preconditioner sums; the
back-substitution; the cost) is completed by one ``all_reduce`` over the
group.  The plans are this rank's.  The CG state is replicated, so its dot
products need none.  ``parallel/sharded_ba.py`` splits the observations.
With ``group=None`` nothing is reduced and every result is the single
process's, bit for bit.

A leading batch axis (the segment axis of ``pipelines/distributed_slam.py``:
poses [S, C], X [S, L, 3], observations [S, O]) holds S problems solved
side by side, the port of the reference's ``vmap``: each observation's
camera and landmark index is offset by s·C and s·L into the flattened
[S·C] and [S·L] rows, so every sum lands in its own problem's rows in its
own order, and the LM loop (``ba/lm.lm_loop``) and the CG dot products
(``ba/schur.pcg``) run per problem.  Each problem gets what it gets alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from points_matching_tpu_torch.ba.lm import LMStats, lm_loop, retract, robust_cost
from points_matching_tpu_torch.ba.residuals import huber_weights, projection_jacobians
from points_matching_tpu_torch.ba.schur import _damp, _inv3, _preduce, pcg
from points_matching_tpu_torch.core.config import BAConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose, flat_rows
from points_matching_tpu_torch.ops.kernels.segment_sum import SegPlan, build_plan, segment_sum

Tensor = torch.Tensor
SparseLMStats = LMStats


@dataclasses.dataclass
class SparseBAState:
    """BA problem as flat observation lists (padded + masked)."""

    poses: Pose               # [*B, C] world→camera
    X: Tensor                 # [*B, L, 3]
    cam_idx: Tensor           # [*B, O] int32 camera per observation
    lm_idx: Tensor            # [*B, O] int32 landmark per observation
    uv: Tensor                # [*B, O, 2] measurements
    obs_mask: Tensor          # [*B, O] validity
    cam_fixed: Tensor         # [*B, C] bool — gauge-fixed cameras
    lm_fixed: Tensor          # [*B, L] bool — held-constant landmarks: their
                              # observations still constrain cameras (the U
                              # term) but they leave the Schur elimination
                              # (V⁻¹ rows zeroed, so dl is exactly 0)

    @property
    def num_cameras(self) -> int:
        return self.poses.t.shape[-2]

    @property
    def num_landmarks(self) -> int:
        return self.X.shape[-2]

    @property
    def num_observations(self) -> int:
        return self.uv.shape[-2]


def make_sparse_ba_state(poses: Pose, X: Tensor, cam_idx: Tensor, lm_idx: Tensor,
                         uv: Tensor, obs_mask: Tensor, num_fixed_cameras: int = 1,
                         cam_fixed: Optional[Tensor] = None,
                         lm_fixed: Optional[Tensor] = None) -> SparseBAState:
    """The first ``num_fixed_cameras`` cameras fixed and no landmark fixed,
    unless ``cam_fixed`` / ``lm_fixed`` masks are given."""
    lead, C, L = X.shape[:-2], poses.t.shape[-2], X.shape[-2]
    dev = X.device
    if cam_fixed is None:
        cam_fixed = (torch.arange(C, device=dev) < num_fixed_cameras).expand(*lead, C)
    if lm_fixed is None:
        lm_fixed = torch.zeros(*lead, L, dtype=torch.bool, device=dev)
    return SparseBAState(poses=poses, X=X, cam_idx=cam_idx.to(torch.int32),
                         lm_idx=lm_idx.to(torch.int32), uv=uv, obs_mask=obs_mask.bool(),
                         cam_fixed=cam_fixed.bool(), lm_fixed=lm_fixed.bool())


def _at(x: Tensor, flat: Tensor) -> Tensor:
    """Rows ``flat`` ([*B, O], from ``flat_rows``) of x [*B, n, ...] → [*B, O, ...]."""
    return x.reshape(-1, *x.shape[flat.dim():])[flat]


def _flat_index(state: SparseBAState) -> Tuple[Tensor, Tensor]:
    """Clipped per-observation camera and landmark indices, flattened
    (``flat_rows``)."""
    C, L = state.num_cameras, state.num_landmarks
    return (flat_rows(state.cam_idx.long().clamp(0, C - 1), C),
            flat_rows(state.lm_idx.long().clamp(0, L - 1), L))


def _gathered(state: SparseBAState):
    """Clipped per-observation indices (``_flat_index``) and the gathered
    R, t, X."""
    c, l_ = _flat_index(state)
    return c, l_, _at(state.poses.R, c), _at(state.poses.t, c), _at(state.X, l_)


def sparse_plans(state: SparseBAState) -> Tuple[SegPlan, SegPlan]:
    """The sort-once plans of the camera and the landmark index (masked
    observations left out), for every sum of a BA call."""
    c, l_ = _flat_index(state)
    rows = math.prod(state.obs_mask.shape[:-1])
    return (build_plan(c, rows * state.num_cameras, state.obs_mask),
            build_plan(l_, rows * state.num_landmarks, state.obs_mask))


def sparse_residuals(state: SparseBAState, K: CameraIntrinsics) -> Tensor:
    """Masked per-observation residuals [*B, O, 2] (invalid → 0)."""
    _, _, R, t, Xo = _gathered(state)
    xc = (R * Xo[..., None, :]).sum(-1) + t
    z = xc[..., 2].clamp_min(1e-6)
    r = torch.stack([K.fx * xc[..., 0] / z + K.cx - state.uv[..., 0],
                     K.fy * xc[..., 1] / z + K.cy - state.uv[..., 1]], -1)
    return torch.where(state.obs_mask[..., None], r, torch.zeros_like(r))


def sparse_residuals_and_jacobians(state: SparseBAState, K: CameraIntrinsics
                                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """r [*B, O, 2], Jc [*B, O, 2, 6], Jl [*B, O, 2, 3] in closed form
    (masked rows zero); see ``ba/residuals.py`` for the forms."""
    _, _, R, t, Xo = _gathered(state)
    xc = (R * Xo[..., None, :]).sum(-1) + t
    u, v, Jc, Jl = projection_jacobians(xc, R, K)
    r = torch.stack([K.fx * u + K.cx - state.uv[..., 0],
                     K.fy * v + K.cy - state.uv[..., 1]], -1)
    m = state.obs_mask[..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(m, r, zero), torch.where(m[..., None], Jc, zero),
            torch.where(m[..., None], Jl, zero))


class SparseNormalEq(NamedTuple):
    """Normal-equation blocks in observation-list form; the coupling W stays
    per observation ([*B, O, 6, 3])."""

    U: Tensor        # [*B, C, 6, 6]
    V: Tensor        # [*B, L, 3, 3]
    Wo: Tensor       # [*B, O, 6, 3] per-observation coupling Jcᵀ w Jl
    bc: Tensor       # [*B, C, 6]
    bl: Tensor       # [*B, L, 3]
    cam: Tensor      # [*B, O] clipped camera index (int64), flattened (``flat_rows``)
    lm: Tensor       # [*B, O] clipped landmark index (int64), flattened
    cam_plan: SegPlan  # the sort-once plans of cam and lm (``sparse_plans``)
    lm_plan: SegPlan


def _seg_sum(values: Tensor, index: Tensor, n: int, plan: SegPlan) -> Tensor:
    """Σ of the rows of ``values`` [*B, O, ...] per flattened index
    [*B, O] (``flat_rows``) → [*B, n, ...] through ``index``'s ``plan``: each
    leading index's sums in its own rows, in an order fixed by each row's
    observations."""
    lead, rest = index.shape[:-1], values.shape[index.dim():]
    return segment_sum(values.reshape(-1, *rest), plan).reshape(*lead, n, *rest)


def _outer2(A: Tensor, B: Tensor) -> Tensor:
    """Σ_k A[..., k, :, None] · B[..., k, None, :] over the residual axis
    k = 2 (broadcast products, not a batched GEMM)."""
    return (A[..., 0, :, None] * B[..., 0, None, :]
            + A[..., 1, :, None] * B[..., 1, None, :])


def _lam(lam):
    """The damping, [*B] → [*B, 1, 1, 1] against [*B, n, k, k] blocks."""
    return lam.reshape(*lam.shape, 1, 1, 1) if isinstance(lam, torch.Tensor) else lam


def build_sparse_normal_equations(state: SparseBAState, r: Tensor, Jc: Tensor,
                                  Jl: Tensor, weights: Tensor, group=None,
                                  plans: Optional[Tuple[SegPlan, SegPlan]] = None
                                  ) -> SparseNormalEq:
    """Segmented-sum assembly of the GN blocks; weights [*B, O] (robust ×
    valid).  ``plans`` (``sparse_plans``, made here when None) are carried
    in the result for the solve's sums.  With ``group``, U/V/bc/bl are
    reduced over it; Wo/cam/lm stay local."""
    C, L = state.num_cameras, state.num_landmarks
    cam, lm = _flat_index(state)
    cp, lp = plans if plans is not None else sparse_plans(state)
    w = weights[..., None, None]
    Jcw = Jc * w
    Uo = _outer2(Jcw, Jc)
    Vo = _outer2(Jl * w, Jl)
    Wo = _outer2(Jcw, Jl)
    wr = r * weights[..., None]
    bco = -(Jc[..., 0, :] * wr[..., 0:1] + Jc[..., 1, :] * wr[..., 1:2])
    blo = -(Jl[..., 0, :] * wr[..., 0:1] + Jl[..., 1, :] * wr[..., 1:2])
    return SparseNormalEq(U=_preduce(_seg_sum(Uo, cam, C, cp), group),
                          V=_preduce(_seg_sum(Vo, lm, L, lp), group), Wo=Wo,
                          bc=_preduce(_seg_sum(bco, cam, C, cp), group),
                          bl=_preduce(_seg_sum(blo, lm, L, lp), group), cam=cam, lm=lm,
                          cam_plan=cp, lm_plan=lp)


def sparse_schur_matvec(eq: SparseNormalEq, Vinv: Tensor, lam, x: Tensor,
                        group=None) -> Tensor:
    """Implicit S @ x = (U − W V⁻¹ Wᵀ) x via two segmented sums.  [*B, C, 6]."""
    C, L = eq.U.shape[-3], eq.V.shape[-3]
    Ux = (_damp(eq.U, _lam(lam)) * x[..., None, :]).sum(-1)
    t = _preduce(_seg_sum((eq.Wo * _at(x, eq.cam)[..., :, None]).sum(-2), eq.lm, L,
                          eq.lm_plan), group)
    u = (Vinv * t[..., None, :]).sum(-1)
    y = _preduce(_seg_sum((eq.Wo * _at(u, eq.lm)[..., None, :]).sum(-1), eq.cam, C,
                          eq.cam_plan), group)
    return Ux - y


def _sparse_schur_prep(eq: SparseNormalEq, lam, lm_fixed: Optional[Tensor] = None,
                       group=None):
    """Damped V⁻¹ (zero on ``lm_fixed`` rows), the reduced gradient g, and
    the Jacobi preconditioner (inverse 6×6 diagonal blocks of S)."""
    C = eq.U.shape[-3]
    Vinv = _inv3(_damp(eq.V, _lam(lam)))
    if lm_fixed is not None:
        Vinv = torch.where(lm_fixed[..., None, None], torch.zeros_like(Vinv), Vinv)
    Vb = (Vinv * eq.bl[..., None, :]).sum(-1)
    g = eq.bc - _preduce(_seg_sum((eq.Wo * _at(Vb, eq.lm)[..., None, :]).sum(-1), eq.cam, C,
                                  eq.cam_plan), group)
    Vv = _at(Vinv, eq.lm)                                                  # [*B, O, 3, 3]
    WV = (eq.Wo[..., :, :, None] * Vv[..., None, :, :]).sum(-2)           # [*B, O, 6, 3]
    WVWo = (WV[..., :, None, :] * eq.Wo[..., None, :, :]).sum(-1)         # [*B, O, 6, 6]
    S_diag = _damp(eq.U, _lam(lam)) - _preduce(_seg_sum(WVWo, eq.cam, C, eq.cam_plan), group)
    return Vinv, g, torch.linalg.inv_ex(S_diag)[0]


def solve_sparse_schur_pcg(eq: SparseNormalEq, lam, iterations: int = 50,
                           lm_fixed: Optional[Tensor] = None,
                           group=None) -> Tuple[Tensor, Tensor]:
    """Jacobi-preconditioned CG on the implicit reduced camera system +
    landmark back-substitution → (dc [*B, C, 6], dl [*B, L, 3]; ``lm_fixed``
    rows of dl exactly 0)."""
    L = eq.V.shape[-3]
    Vinv, g, Minv = _sparse_schur_prep(eq, lam, lm_fixed, group)
    dc = pcg(lambda x: sparse_schur_matvec(eq, Vinv, lam, x, group),
             lambda r: (Minv * r[..., None, :]).sum(-1), g, iterations)
    rhs = eq.bl - _preduce(_seg_sum((eq.Wo * _at(dc, eq.cam)[..., :, None]).sum(-2), eq.lm, L,
                                    eq.lm_plan), group)
    return dc, (Vinv * rhs[..., None, :]).sum(-1)


def sparse_ba_cost(state: SparseBAState, K: CameraIntrinsics,
                   huber_delta: float = 0.0, group=None) -> Tensor:
    """The robust cost, one per leading index ([*B])."""
    return _preduce(robust_cost(sparse_residuals(state, K), state.obs_mask, huber_delta,
                                dims=-1), group)


def bundle_adjust_sparse(state: SparseBAState, K: CameraIntrinsics,
                         config: BAConfig = BAConfig(), group=None,
                         active: Optional[Tensor] = None
                         ) -> Tuple[SparseBAState, SparseLMStats]:
    """LM on observation lists — the contract of ``ba.lm.bundle_adjust``
    (monotone cost, same stopping rule) at O(observations) memory.  The
    solver is always the implicit-Schur PCG (``config.pcg_iterations``).
    The observations are sorted once here, whatever ``config.obs_layout``
    names (module docstring).  With ``group``, ``state``'s observations are
    this rank's shard and the sums are completed over the group (module
    docstring); every rank then holds the same poses, landmarks and stats.
    A state with a leading batch axis is that many problems, each with its
    own LM loop (stats [*B]); ``active`` [*B] leaves the problems it marks
    False untouched."""
    pin_fp32()
    if config.obs_layout not in ("auto", "sorted", "scatter"):
        raise ValueError(f"unknown obs_layout: {config.obs_layout!r}")
    # the observations' indices and mask do not change across iterations
    plans = sparse_plans(state)

    def step(st: SparseBAState, lam: Tensor) -> SparseBAState:
        r, Jc, Jl = sparse_residuals_and_jacobians(st, K)
        w = huber_weights(r, config.huber_delta) * st.obs_mask.to(r.dtype)
        eq = build_sparse_normal_equations(st, r, Jc, Jl, w, group, plans)
        dc, dl = solve_sparse_schur_pcg(eq, lam, config.pcg_iterations,
                                        lm_fixed=st.lm_fixed, group=group)
        return dataclasses.replace(st, poses=retract(st.poses, st.cam_fixed, dc),
                                   X=st.X + dl)

    return lm_loop(state, lambda st: sparse_ba_cost(st, K, config.huber_delta, group),
                   step, config, active)
