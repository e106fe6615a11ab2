"""Carry configs and typed inputs across from the JAX package.

The system has no weights; what has to agree between the two packages is
the configuration and the typed arrays.  Everything here takes plain
Python / numpy-convertible values (``np.asarray`` of a JAX array works), so
this module imports no JAX.  Every converter takes the tensors' ``device``
as a required keyword: nothing lands on the CPU unless the caller says so.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping

import numpy as np
import torch

from points_matching_tpu_torch.core import config as _config
from points_matching_tpu_torch.core.types import (
    CameraIntrinsics,
    Descriptors,
    Keypoints,
    Matches,
    Pose,
)


def config_from_dict(d: Mapping[str, Any], cls: type = _config.TwoViewConfig):
    """Build the port's config of type ``cls`` from a (nested) dict, e.g.
    ``dataclasses.asdict`` of the JAX package's config of the same name.
    Unknown keys raise (the two packages' fields must stay in step)."""
    hints = typing.get_type_hints(cls, vars(_config))
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise TypeError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    kwargs = {}
    for name, value in d.items():
        ftype = hints[name]
        if dataclasses.is_dataclass(ftype) and isinstance(value, Mapping):
            value = config_from_dict(value, ftype)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def keypoints_from_numpy(kps, *, device) -> Keypoints:
    """Keypoints from any object with ``xy/scale/angle/score/mask`` arrays."""
    f32 = torch.float32
    return Keypoints(
        xy=_tensor(kps.xy, f32, device),
        scale=_tensor(kps.scale, f32, device),
        angle=_tensor(kps.angle, f32, device),
        score=_tensor(kps.score, f32, device),
        mask=_tensor(kps.mask, torch.bool, device),
    )


def descriptors_from_numpy(desc, *, device) -> Descriptors:
    """Descriptors from any object with ``data/mask`` arrays (and
    ``binary``, default False).  Binary descriptors arrive as uint32 words
    and are held as int32 with identical bits: every bit is kept."""
    mask = _tensor(desc.mask, torch.bool, device)
    if not getattr(desc, "binary", False):
        return Descriptors(data=_tensor(desc.data, torch.float32, device), mask=mask)
    words = np.array(desc.data)
    if words.dtype == np.uint32:
        words = words.view(np.int32)
    elif words.dtype != np.int32:
        raise TypeError(f"binary descriptors must be uint32 or int32 words, got {words.dtype}")
    return Descriptors(data=torch.from_numpy(words).to(device), mask=mask, binary=True)


def matches_from_numpy(m, *, device) -> Matches:
    """Matches from any object with ``query_idx/train_idx/distance/mask``."""
    return Matches(
        query_idx=_tensor(m.query_idx, torch.int32, device),
        train_idx=_tensor(m.train_idx, torch.int32, device),
        distance=_tensor(m.distance, torch.float32, device),
        mask=_tensor(m.mask, torch.bool, device),
    )


def pose_from_numpy(pose, *, device) -> Pose:
    """Pose from any object with ``R`` [..., 3, 3] and ``t`` [..., 3]."""
    return Pose(R=_tensor(pose.R, torch.float32, device),
                t=_tensor(pose.t, torch.float32, device))


def intrinsics_from_numpy(K, *, device) -> CameraIntrinsics:
    """CameraIntrinsics from any object with ``fx/fy/cx/cy``, or from a 3×3
    matrix."""
    if hasattr(K, "fx"):
        return CameraIntrinsics(*(_tensor(getattr(K, k), torch.float32, device)
                                  for k in ("fx", "fy", "cx", "cy")))
    return CameraIntrinsics.from_matrix(_tensor(K, torch.float32, device))


def sfm_state_from_numpy(state, *, device):
    """The port's ``SfMState`` from any object with the reference's SfM
    state fields (``poses``, ``cam_mask``, ``X``, ..., ``num_obs``), e.g. a
    state the JAX package built, so that both packages continue from it."""
    from points_matching_tpu_torch.pipelines.sfm import SfMState

    kinds = {"cam_mask": torch.bool, "lm_mask": torch.bool, "obs_mask": torch.bool,
             "prev_mask": torch.bool, "obs_cam": torch.int32, "obs_lm": torch.int32,
             "prev_lm": torch.int32, "num_cams": torch.int32, "num_lms": torch.int32,
             "num_obs": torch.int32}
    fields = {}
    for f in dataclasses.fields(SfMState):
        value = getattr(state, f.name)
        fields[f.name] = (pose_from_numpy(value, device=device) if f.name == "poses" else
                          _tensor(value, kinds.get(f.name, torch.float32), device))
    return SfMState(**fields)


def sparse_ba_state_from_numpy(state, *, device):
    """The port's ``SparseBAState`` from any object with the reference's
    sparse-BA state fields (``cam_fixed`` and ``lm_fixed`` included)."""
    from points_matching_tpu_torch.ba.sparse import make_sparse_ba_state

    return make_sparse_ba_state(
        pose_from_numpy(state.poses, device=device), _tensor(state.X, torch.float32, device),
        _tensor(state.cam_idx, torch.int32, device), _tensor(state.lm_idx, torch.int32, device),
        _tensor(state.uv, torch.float32, device), _tensor(state.obs_mask, torch.bool, device),
        cam_fixed=_tensor(state.cam_fixed, torch.bool, device),
        lm_fixed=_tensor(state.lm_fixed, torch.bool, device))


def pose_graph_from_numpy(g, *, device):
    """The port's ``PoseGraph`` from any object with the reference's pose
    graph fields (``poses``, ``edges_i``, ``edges_j``, ``Z``, ``weight``,
    ``mask``, ``fixed``)."""
    from points_matching_tpu_torch.ba.pose_graph import PoseGraph

    return PoseGraph(
        poses=pose_from_numpy(g.poses, device=device),
        edges_i=_tensor(g.edges_i, torch.int32, device),
        edges_j=_tensor(g.edges_j, torch.int32, device),
        Z=pose_from_numpy(g.Z, device=device),
        weight=_tensor(g.weight, torch.float32, device),
        mask=_tensor(g.mask, torch.bool, device),
        fixed=_tensor(g.fixed, torch.bool, device))


def frames_from_numpy(frames, *, device):
    """A sequence's frames ``[(kps_xy [N, 2], desc [N, D], mask [N])]``, as
    the reference's SfM and loop-closure functions take them, as tensors."""
    kinds = (torch.float32, torch.float32, torch.bool)
    return [tuple(_tensor(x, k, device) for x, k in zip(f, kinds)) for f in frames]


def loop_candidates_from_list(cands):
    """The port's ``LoopCandidate``s from any objects with ``i``, ``j``,
    ``score``, ``verified`` and ``num_inliers`` (the reference's list)."""
    from points_matching_tpu_torch.pipelines.loop_closure import LoopCandidate

    return [LoopCandidate(i=int(c.i), j=int(c.j), score=int(c.score),
                          verified=bool(c.verified), num_inliers=int(c.num_inliers))
            for c in cands]
