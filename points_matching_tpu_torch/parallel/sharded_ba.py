"""Distributed bundle adjustment over the ``model`` process group — port of
``points_matching_tpu/parallel/sharded_ba.py``.

Two entry points, as in the reference:

* ``distributed_bundle_adjust`` — the dense [C, L] grid with its landmark
  axis split over the group: each rank holds L/n landmarks and their grid
  columns, the camera terms are reduced with ``all_reduce`` and the camera
  solve is replicated (``ba/schur.py``).  The reference lets GSPMD place
  these reductions; here they are written out.  The landmark count must
  divide the group, as in the reference.
* ``distributed_bundle_adjust_sparse`` — the observation list split over
  the group (``ba/sparse.py``'s ``group`` path): poses and landmarks stay
  replicated, every per-observation sum is a local segmented sum (through
  this rank's plans) plus one ``all_reduce``.  The observations are padded with masked rows to a
  multiple of the group size, which adds nothing to any sum.

Both return the full state (landmarks gathered) and the same stats on every
rank of the group.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from points_matching_tpu_torch.ba.lm import BAState, LMStats, bundle_adjust
from points_matching_tpu_torch.ba.sparse import (
    SparseBAState,
    SparseLMStats,
    bundle_adjust_sparse,
)
from points_matching_tpu_torch.core.config import BAConfig
from points_matching_tpu_torch.core.types import CameraIntrinsics
from points_matching_tpu_torch.parallel.mesh import MODEL_AXIS, axis_comm, shard


def shard_ba_state(state: BAState, mesh, axis: str = MODEL_AXIS) -> BAState:
    """This rank's block of the landmarks of a dense ``BAState`` (rank i of
    ``axis`` holds landmarks [i·L/n, (i+1)·L/n) and their grid columns;
    poses replicated).  Raises unless L divides the axis."""
    comm = axis_comm(mesh, axis)
    n, i = comm.size(), comm.index()
    L = state.X.shape[0]
    if L % n:
        raise ValueError(f"landmark capacity ({L}) must divide the {axis} axis ({n}); "
                         "pad with masked landmarks")
    b = L // n
    return dataclasses.replace(state, X=state.X[i * b:(i + 1) * b],
                               uv=state.uv[:, i * b:(i + 1) * b],
                               mask=state.mask[:, i * b:(i + 1) * b])


def distributed_bundle_adjust(state: BAState, K: CameraIntrinsics, mesh,
                              config: BAConfig = BAConfig(), axis: str = MODEL_AXIS
                              ) -> Tuple[BAState, LMStats]:
    """Landmark-sharded LM bundle adjustment over ``mesh``'s ``axis``:
    every rank passes the same full ``state`` and solves with its block
    (``shard_ba_state``)."""
    comm = axis_comm(mesh, axis)
    local = shard_ba_state(state, mesh, axis)
    out, stats = bundle_adjust(local, K, config, group=comm.group)
    return dataclasses.replace(state, poses=out.poses,
                               X=comm.all_gather(out.X, tiled=True)), stats


def pad_sparse_state_for_mesh(state: SparseBAState, n_shards: int) -> SparseBAState:
    """The observation axis padded to a multiple of ``n_shards`` with masked
    rows (zero weight: zero contribution to every sum, exactly)."""
    rem = (-state.num_observations) % n_shards
    if rem == 0:
        return state

    def pad(a):
        return torch.cat([a, a.new_zeros((rem,) + a.shape[1:])])

    return dataclasses.replace(state, cam_idx=pad(state.cam_idx), lm_idx=pad(state.lm_idx),
                               uv=pad(state.uv), obs_mask=pad(state.obs_mask))


def distributed_bundle_adjust_sparse(state: SparseBAState, K: CameraIntrinsics, mesh,
                                     config: BAConfig = BAConfig(), axis: str = MODEL_AXIS
                                     ) -> Tuple[SparseBAState, SparseLMStats]:
    """Observation-sharded sparse LM over ``mesh``'s ``axis``: every rank
    passes the same full ``state`` and solves with its block of the (padded)
    observations.  Returns ``state`` with the adjusted poses and landmarks
    (the caller's observation arrays) and the stats."""
    comm = axis_comm(mesh, axis)
    padded = pad_sparse_state_for_mesh(state, comm.size())
    local = dataclasses.replace(padded, **{f: shard(getattr(padded, f), mesh, axis) for f in
                                           ("cam_idx", "lm_idx", "uv", "obs_mask")})
    out, stats = bundle_adjust_sparse(local, K, config, group=comm.group)
    return dataclasses.replace(state, poses=out.poses, X=out.X), stats
