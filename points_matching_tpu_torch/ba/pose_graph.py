"""Pose-graph optimisation — port of ``points_matching_tpu/ba/pose_graph.py``.

Problem: poses T_i (world→camera) and relative measurements Z_ij ≈ T_i T_j⁻¹
from odometry and loop closures.  Cost = ½ Σ w_ij ‖log(Z_ij⁻¹ T_i T_j⁻¹)‖².

The edge list is fixed-capacity (``edges_i/edges_j/Z/weight/mask``),
residuals and Jacobians evaluate batched over edges, and the Gauss-Newton
normal equations assemble by segmented sums into the [P, 6, 6] block
structure; then one dense Cholesky on the [6P, 6P] system, or a
matrix-free block-Jacobi PCG for long trajectories.  Every sum goes
through a plan sorted once a call (``ops/kernels/segment_sum``): the
edges' endpoints [ei; ej] for the per-pose sums, the (row pose, column
pose) pairs of the four block lists for the dense system.  On the card the
segmented-sum kernel adds each pose's terms in an order fixed by its own
edges, without atomics, so two runs give the same bits; on the CPU the
plain version adds them in edge order.

The Gauss-Newton loop runs in float64 whatever the graph's dtype, and
returns the poses in that dtype.  In float32 the optimum of a long chain is
flat below the rounding of its residuals: at BASELINE config 3's 100 poses
two float32 runs of the same graph on the GPU and the CPU ended 3e-3 apart,
each 2e-3 from the float64 optimum (``chip_smoke.py``, NVIDIA H100).  The
reference runs in float32 because its TPU has no float64.

The reference differentiates the residual with ``jax.jacfwd`` at ξ = 0;
here the Jacobians are in closed form: with E = Z⁻¹·T_i·T_j⁻¹ and
r = log(E), left perturbations exp(ξ)·T give ∂r/∂ξi = J_l⁻¹(r)·Ad(Z⁻¹)
and ∂r/∂ξj = −J_l⁻¹(r)·Ad(E) (``geometry/se3.se3_left_jacobian_inverse``).
The reference's ``lax.while_loop`` is a host loop with the same accept
rule, relative-decrease test and iteration cap; the host reads one
boolean per iteration (the stopping test) and nothing else.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from points_matching_tpu_torch.core.types import Pose
from points_matching_tpu_torch.ops.kernels.segment_sum import SegPlan, build_plan, segment_sum
from points_matching_tpu_torch.geometry.se3 import (
    se3_adjoint,
    se3_exp,
    se3_left_jacobian_inverse,
    se3_log,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class PoseGraph:
    """Fixed-capacity pose graph.

    Attributes:
      poses:   Pose with [P] batch — current estimates (world→camera).
      edges_i: [E] int — source pose index.
      edges_j: [E] int — target pose index.
      Z:       Pose with [E] batch — measured relative transform T_i T_j⁻¹.
      weight:  [E] float — per-edge information scale (loop vs odom).
      mask:    [E] bool — valid edges.
      fixed:   [P] bool — gauge-fixed poses (typically pose 0).
    """

    poses: Pose
    edges_i: Tensor
    edges_j: Tensor
    Z: Pose
    weight: Tensor
    mask: Tensor
    fixed: Tensor

    @property
    def num_poses(self) -> int:
        return self.poses.t.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges_i.shape[0]

    def replace(self, **kw) -> "PoseGraph":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PoseGraph":
        def mv(x):
            return Pose(R=x.R.to(device), t=x.t.to(device)) if isinstance(x, Pose) \
                else x.to(device)

        return PoseGraph(**{f.name: mv(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def _edge_error(g: PoseGraph) -> Pose:
    """E = Z⁻¹ (T_i T_j⁻¹) per edge."""
    Ti = g.poses[g.edges_i.long()]
    Tj = g.poses[g.edges_j.long()]
    return g.Z.inverse().compose(Ti.compose(Tj.inverse()))


def edge_residuals(g: PoseGraph) -> Tensor:
    """[E, 6] SE(3) log residuals log(Z⁻¹ T_i T_j⁻¹) (masked → 0)."""
    err = _edge_error(g)
    r = se3_log(err.R, err.t)
    return torch.where(g.mask[:, None], r, torch.zeros_like(r))


def pose_graph_cost(g: PoseGraph) -> Tensor:
    r = edge_residuals(g)
    return 0.5 * (g.weight * g.mask * (r * r).sum(-1)).sum()


def _edge_jacobians(g: PoseGraph) -> Tuple[Tensor, Tensor, Tensor]:
    """Residual + Jacobians wrt left-multiplicative tangents of T_i and T_j
    at ξ = 0: (r [E, 6], Ji [E, 6, 6], Jj [E, 6, 6]), masked edges zero.

    r(ξi, ξj) = log(Z⁻¹·exp(ξi)·T_i·(exp(ξj)·T_j)⁻¹).  exp(ξi) moves to the
    front as exp(Ad(Z⁻¹)ξi)·E, and exp(−ξj) at the back as exp(−Ad(E)ξj)·E;
    a left perturbation δ of E moves log(E) by J_l⁻¹(r)·δ."""
    err = _edge_error(g)
    r = se3_log(err.R, err.t)
    Jl_inv = se3_left_jacobian_inverse(r)
    Zinv = g.Z.inverse()
    Ji = Jl_inv @ se3_adjoint(Zinv.R, Zinv.t)
    Jj = -(Jl_inv @ se3_adjoint(err.R, err.t))
    m = g.mask[:, None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(m, r, zero), torch.where(m[..., None], Ji, zero),
            torch.where(m[..., None], Jj, zero))


class PGOStats(NamedTuple):
    iterations: Tensor
    initial_cost: Tensor
    final_cost: Tensor


def _block_plan(g: PoseGraph) -> SegPlan:
    """The plan of the dense system's four block lists [Hii; Hjj; Hij; Hijᵀ]
    into the P² (row pose, column pose) blocks."""
    P = g.num_poses
    ei, ej = g.edges_i.long(), g.edges_j.long()
    return build_plan(torch.cat([ei * P + ei, ej * P + ej, ei * P + ej, ej * P + ei]), P * P)


def _solve_dense(g: PoseGraph, Hii, Hjj, Hij, b, damping, plan: SegPlan) -> Tensor:
    """Materialize [6P, 6P] and Cholesky-solve — exact, O(P²) memory.  The
    blocks add into H through ``plan`` (``_block_plan``)."""
    P = g.num_poses
    dev, dt = b.device, b.dtype
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
    H = segment_sum(blocks, plan).reshape(P, P, 6, 6).transpose(1, 2).reshape(P * 6, P * 6)

    # Gauge fixing: project fixed poses out of the system.
    fr = (~g.fixed).to(dt).repeat_interleave(6)
    Hd = H * fr[:, None] * fr[None, :]
    Hd = Hd + torch.diag(torch.where(fr > 0, torch.full_like(fr, damping), torch.ones_like(fr)))
    bd = b.reshape(P * 6) * fr
    eye = torch.eye(P * 6, dtype=dt, device=dev)
    # cholesky_ex: no error check, which would read the device on the host
    L = torch.linalg.cholesky_ex(Hd + 1e-9 * eye)[0]
    return torch.cholesky_solve(bd[:, None], L)[:, 0].reshape(P, 6)


def _solve_pcg(g: PoseGraph, Hii, Hjj, Hij, b, damping, iterations: int,
               plan: SegPlan) -> Tensor:
    """Matrix-free block-sparse PCG: the Hessian-vector product gathers x at
    the edge endpoints, applies the per-edge 6×6 blocks and sums back
    through ``plan`` (the endpoints [ei; ej]) — O(E·36) memory, so
    KITTI-00-length trajectories (thousands of poses) fit.  Block-Jacobi
    preconditioner from the exact 6×6 diagonal blocks."""
    ends = torch.stack([g.edges_i, g.edges_j], -1).long()     # [E, 2]
    free = (~g.fixed).to(b.dtype)[:, None]          # [P, 1]
    b = b * free
    # each edge's two rows of H as one [6, 12] block a side: [Hii Hij] for
    # pose i, [Hijᵀ Hjj] for pose j, applied to (x_i, x_j); stacked [2, E]
    # as the plan's entries [ei; ej]
    A = torch.stack([torch.cat([Hii, Hij], -1), torch.cat([Hij.transpose(-1, -2), Hjj], -1)])

    def hv(x: Tensor) -> Tensor:
        x = x * free
        c = (A @ x[ends].reshape(-1, 12, 1))[..., 0]          # [2, E, 6]: ci; cj
        return (segment_sum(c.reshape(-1, 6), plan) + damping * x) * free

    # Block-Jacobi: exact diagonal blocks, damped; identity on fixed poses
    # (their rows of b are zero, so PCG keeps them at zero).
    eye = torch.eye(6, dtype=b.dtype, device=b.device)
    D = segment_sum(torch.cat([Hii, Hjj]), plan) + damping * eye
    D = torch.where(g.fixed[:, None, None], eye, D)
    Minv = torch.linalg.inv_ex(D)[0]

    def precond(r: Tensor) -> Tensor:
        return (Minv @ r[..., None])[..., 0] * free

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iterations):
        Ap = hv(p)
        alpha = rz / (p * Ap).sum().clamp_min(1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = rz_new / rz.clamp_min(1e-20)
        p = z + beta * p
        rz = rz_new
    return x


# Above this many poses the dense [6P, 6P] Cholesky is replaced by the
# matrix-free PCG under solver="auto" (dense is exact and faster when small).
_DENSE_POSE_LIMIT = 384


def optimize_pose_graph(
    g: PoseGraph,
    max_iterations: int = 20,
    damping: float = 1e-6,
    rtol: float = 1e-9,
    solver: str = "auto",
    pcg_iterations: int = 100,
) -> Tuple[PoseGraph, PGOStats]:
    """Gauss-Newton (lightly damped) pose-graph optimisation.

    ``solver``: "dense" (Cholesky on the materialized [6P, 6P] system),
    "pcg" (matrix-free block-sparse PCG — linear memory in edges), or
    "auto" (dense up to ``_DENSE_POSE_LIMIT`` poses, PCG beyond).  A step
    is kept when it lowers the cost; the loop stops at the first rejected
    step, at a relative decrease below ``rtol``, or after
    ``max_iterations``.  Computes in float64 (module docstring).
    """
    P = g.num_poses
    if solver == "auto":
        solver = "dense" if P <= _DENSE_POSE_LIMIT else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown pose-graph solver: {solver!r}")
    dtype = g.poses.t.dtype
    g = _with_dtype(g, torch.float64)
    # the edges do not change across iterations: one plan of the endpoints
    # [ei; ej] for the per-pose sums, one of the block pairs for "dense"
    plan = build_plan(torch.cat([g.edges_i, g.edges_j]), P)
    block_plan = _block_plan(g) if solver == "dense" else None
    cost0 = pose_graph_cost(g)
    cost = cost0
    it = 0
    while it < max_iterations:
        r, Ji, Jj = _edge_jacobians(g)
        w = (g.weight * g.mask).to(r.dtype)[:, None, None]

        # Per-edge normal-equation blocks.
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
        Hii = w * (JiT @ Ji)
        Hjj = w * (JjT @ Jj)
        Hij = w * (JiT @ Jj)
        bi = -(w * (JiT @ r[..., None]))[..., 0]
        bj = -(w * (JjT @ r[..., None]))[..., 0]
        b = segment_sum(torch.cat([bi, bj]), plan)

        if solver == "dense":
            dx = _solve_dense(g, Hii, Hjj, Hij, b, damping, block_plan)
        else:
            dx = _solve_pcg(g, Hii, Hjj, Hij, b, damping, pcg_iterations, plan)
        dx = torch.where(g.fixed[:, None], torch.zeros_like(dx), dx)

        Rd, td = se3_exp(dx)
        new_poses = Pose(R=Rd @ g.poses.R, t=(Rd @ g.poses.t[..., None])[..., 0] + td)
        new_cost = pose_graph_cost(g.replace(poses=new_poses))

        accept = new_cost < cost
        g = g.replace(poses=Pose(R=torch.where(accept, new_poses.R, g.poses.R),
                                 t=torch.where(accept, new_poses.t, g.poses.t)))
        cost_next = torch.where(accept, new_cost, cost)
        rel = (cost - cost_next).abs() / cost.clamp_min(1e-12)
        done = ~accept | (rel < rtol)
        cost = cost_next
        it += 1
        if bool(done):                 # the one read of the device an iteration
            break
    iterations = torch.full((), it, dtype=torch.int64, device=cost.device)
    return _with_dtype(g, dtype), PGOStats(iterations=iterations, initial_cost=cost0.to(dtype),
                                           final_cost=cost.to(dtype))


def _with_dtype(g: PoseGraph, dtype) -> PoseGraph:
    """The graph with its poses, measurements and weights in ``dtype``."""
    return g.replace(poses=Pose(R=g.poses.R.to(dtype), t=g.poses.t.to(dtype)),
                     Z=Pose(R=g.Z.R.to(dtype), t=g.Z.t.to(dtype)), weight=g.weight.to(dtype))


def make_odometry_chain(
    poses_gt: Pose,
    generator: Optional[torch.Generator] = None,
    odom_noise: float = 0.01,
    loop_edges: Sequence[Tuple[int, int]] = (),
    loop_weight: float = 10.0,
    noise: Optional[Tensor] = None,
) -> PoseGraph:
    """Build a test pose graph: noisy odometry chain + exact loop closures,
    on ``poses_gt``'s device.

    Each odometry measurement is exp(ξ)·T_i·T_{i+1}⁻¹ with ξ [P−1, 6] drawn
    as ``odom_noise`` × N(0, 1) from ``generator``, or given as ``noise``
    (the twists themselves, e.g. the reference's own draw).
    """
    dev = poses_gt.t.device
    Pn = poses_gt.t.shape[0]
    ei = torch.arange(Pn - 1, device=dev)
    ej = ei + 1
    Z = poses_gt[ei].compose(poses_gt[ej].inverse())
    if noise is None and odom_noise > 0:
        noise = odom_noise * torch.randn((Pn - 1, 6), generator=generator, device=dev)
    if noise is not None:
        Rd, td = se3_exp(noise.to(device=dev, dtype=Z.t.dtype))
        Z = Pose(R=Rd @ Z.R, t=(Rd @ Z.t[..., None])[..., 0] + td)
    w = torch.ones((Pn - 1,), dtype=torch.float32, device=dev)

    if loop_edges:
        li = torch.stack([torch.full((), a, device=dev) for a, _ in loop_edges])
        lj = torch.stack([torch.full((), b, device=dev) for _, b in loop_edges])
        Zl = poses_gt[li].compose(poses_gt[lj].inverse())
        ei = torch.cat([ei, li])
        ej = torch.cat([ej, lj])
        Z = Pose(R=torch.cat([Z.R, Zl.R]), t=torch.cat([Z.t, Zl.t]))
        w = torch.cat([w, torch.full((len(loop_edges),), loop_weight, device=dev)])

    E = ei.shape[0]
    return PoseGraph(poses=poses_gt, edges_i=ei.to(torch.int32), edges_j=ej.to(torch.int32),
                     Z=Z, weight=w, mask=torch.ones((E,), dtype=torch.bool, device=dev),
                     fixed=torch.arange(Pn, device=dev) == 0)
