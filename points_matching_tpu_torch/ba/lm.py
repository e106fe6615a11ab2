"""Levenberg-Marquardt bundle adjustment on the dense [C, L] grid — port of
``points_matching_tpu/ba/lm.py``.

The reference runs the loop as one ``lax.while_loop``; here it is a host
loop with the same stopping rule, accept/reject and damping updates.  The
updates themselves are masked ``torch.where`` selects on the device; the
host reads one boolean per iteration (the stopping test).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from points_matching_tpu_torch.ba.residuals import (
    huber_weights,
    reprojection_residuals,
    residuals_and_jacobians,
)
from points_matching_tpu_torch.ba.schur import (
    _preduce,
    build_normal_equations,
    solve_schur,
    solve_schur_pcg,
)
from points_matching_tpu_torch.core.config import BAConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose, put_rows_last
from points_matching_tpu_torch.geometry.se3 import se3_exp

Tensor = torch.Tensor


@dataclasses.dataclass
class BAState:
    """Bundle-adjustment problem state on the dense [C, L] grid."""

    poses: Pose               # [C] world→camera
    X: Tensor                 # [L, 3]
    uv: Tensor                # [C, L, 2] measurements
    mask: Tensor              # [C, L] observation validity
    cam_fixed: Tensor         # [C] bool — gauge-fixed cameras (no update)

    @property
    def num_cameras(self) -> int:
        return self.poses.t.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.X.shape[0]


def make_ba_state(poses: Pose, X: Tensor, uv: Tensor, mask: Tensor,
                  num_fixed_cameras: int = 1) -> BAState:
    """Fix the first ``num_fixed_cameras`` poses (the gauge)."""
    C = poses.t.shape[0]
    return BAState(poses=poses, X=X, uv=uv, mask=mask.bool(),
                   cam_fixed=torch.arange(C, device=X.device) < num_fixed_cameras)


def robust_cost(r: Tensor, mask: Tensor, huber_delta: float, dims=None) -> Tensor:
    """Σ over valid rows of ½‖r‖² (or the Huber loss of ‖r‖): over every
    row, or over the axes ``dims`` (a cost per leading index)."""
    if huber_delta > 0:
        n = torch.linalg.vector_norm(r, dim=-1)
        per = torch.where(n <= huber_delta, 0.5 * n ** 2,
                          huber_delta * (n - 0.5 * huber_delta))
    else:
        per = 0.5 * (r * r).sum(-1)
    per = torch.where(mask, per, torch.zeros_like(per))
    return per.sum() if dims is None else per.sum(dims)


def ba_cost(state: BAState, K: CameraIntrinsics, huber_delta: float = 0.0,
            group=None) -> Tensor:
    """Total (optionally Huber-robustified) reprojection cost (summed over
    ``group``'s landmark shards when given)."""
    r = reprojection_residuals(state.poses, state.X, state.uv, state.mask, K)
    return _preduce(robust_cost(r, state.mask, huber_delta), group)


def retract(poses: Pose, cam_fixed: Tensor, dc: Tensor) -> Pose:
    """Left-multiplicative retraction of the pose deltas; fixed cameras
    get a zero delta, which leaves them exactly unchanged."""
    dc = torch.where(cam_fixed[..., None], torch.zeros_like(dc), dc)
    Rd, td = se3_exp(dc)
    return Pose(R=Rd @ poses.R, t=(Rd @ poses.t[..., None])[..., 0] + td)


class LMStats(NamedTuple):
    iterations: Tensor
    initial_cost: Tensor
    final_cost: Tensor
    lam: Tensor


def lm_loop(state, cost_fn, step_fn, config: BAConfig, active=None):
    """The LM loop both engines share, for one problem or a batch of them.

    ``cost_fn(state)`` → the cost (0-d, or [*B] for a batch of problems);
    ``step_fn(state, lam)`` → the proposed state.  A step is taken when its
    cost is lower (else the damping goes up); a problem stops after
    ``config.max_iterations`` or when an accepted step lowers its cost by
    less than ``config.rtol`` relative.  Each problem of a batch runs its own
    iterations and damping: once it has stopped, its state, damping and
    cost stay as they are while the others go on, as the reference's
    ``while_loop`` under ``vmap`` keeps them.  ``active`` [*B] (all by
    default) marks the problems that may move at all; the others are left
    untouched.  The loop ends when every problem has stopped, read on the
    host once an iteration.
    """
    cost0 = cost_fn(state)
    cost = cost0
    lam = torch.full_like(cost0, config.damping_init)
    running = (torch.ones_like(cost0, dtype=torch.bool) if active is None
               else active.to(device=cost0.device, dtype=torch.bool).clone())
    its = torch.zeros_like(cost0, dtype=torch.int64)
    it = 0
    while it < config.max_iterations:
        new_state = step_fn(state, lam)
        new_cost = cost_fn(new_state)
        accept = running & (new_cost < cost)
        state = _select(accept, new_state, state)
        cost_next = torch.where(accept, new_cost, cost)
        lam = torch.where(running, torch.where(accept, lam * config.damping_down,
                                               lam * config.damping_up).clamp(1e-10, 1e6), lam)
        rel = (cost - cost_next).abs() / cost.clamp_min(1e-12)
        cost = cost_next
        its = its + running.to(torch.int64)
        running = running & ~(accept & (rel < config.rtol))
        it += 1
        if not bool(running.any()):
            break
    return state, LMStats(iterations=its, initial_cost=cost0, final_cost=cost, lam=lam)


def _select(accept: Tensor, new, old):
    """Field-wise ``torch.where(accept, new, old)`` over a state dataclass
    (poses and X change; the rest is shared); ``accept`` [*B] picks per
    leading index."""
    def sel(a, b):
        return torch.where(accept.reshape(*accept.shape, *(1,) * (a.dim() - accept.dim())), a, b)

    return dataclasses.replace(
        old, poses=Pose(R=sel(new.poses.R, old.poses.R), t=sel(new.poses.t, old.poses.t)),
        X=sel(new.X, old.X))


def bundle_adjust(state: BAState, K: CameraIntrinsics, config: BAConfig = BAConfig(),
                  group=None) -> Tuple[BAState, LMStats]:
    """Run LM to convergence (or ``config.max_iterations``); the cost never
    increases (rejected steps keep the state and raise the damping).  With
    ``group``, ``state`` holds this rank's landmarks (its columns of the
    grid) and the camera terms are reduced over the group (``ba/schur.py``);
    the poses and stats come out the same on every rank."""
    pin_fp32()
    if config.solver not in ("cholesky", "pcg"):
        raise ValueError(f"unknown solver: {config.solver!r}")

    def step(st: BAState, lam: Tensor) -> BAState:
        r, Jc, Jl = residuals_and_jacobians(st.poses, st.X, st.uv, st.mask, K)
        w = huber_weights(r, config.huber_delta) * st.mask.to(r.dtype)
        blocks = build_normal_equations(r, Jc, Jl, w, group)
        if config.solver == "pcg":
            dc, dl = solve_schur_pcg(blocks, lam, config.pcg_iterations, group)
        else:
            dc, dl = solve_schur(blocks, lam, group)
        return dataclasses.replace(st, poses=retract(st.poses, st.cam_fixed, dc),
                                   X=st.X + dl)

    return lm_loop(state, lambda st: ba_cost(st, K, config.huber_delta, group), step,
                   config)


def grid_from_obs(cam_idx: Tensor, lm_idx: Tensor, uv: Tensor, obs_mask: Tensor,
                  num_cameras: int, num_landmarks: int) -> Tuple[Tensor, Tensor]:
    """Flattened observation list → dense [C, L] grid (uv, mask).  Each
    valid row writes the flat cell c·L + l through ``put_rows_last``, so
    for a duplicate (c, l) pair the last valid row wins on every device, as
    in the reference (whose scatter gives that on the CPU).  Invalid rows,
    and valid ones whose indices fall outside the grid, write a spare cell
    that is sliced off (the reference's scatter drops them)."""
    C, L = num_cameras, num_landmarks
    ok = obs_mask.bool() & (cam_idx >= 0) & (cam_idx < C) & (lm_idx >= 0) & (lm_idx < L)
    cell = torch.where(ok, cam_idx.long() * L + lm_idx.long(), C * L)
    uv_grid = put_rows_last(uv.new_zeros(C * L + 1, 2), cell, uv)
    m_grid = put_rows_last(torch.zeros(C * L + 1, dtype=torch.bool, device=uv.device), cell, ok)
    return uv_grid[:C * L].view(C, L, 2), m_grid[:C * L].view(C, L)
