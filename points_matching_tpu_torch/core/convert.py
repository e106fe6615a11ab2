"""Carry configs and typed inputs across from the JAX package.

The system has no weights; what has to agree between the two packages is
the configuration and the typed arrays.  Everything here takes plain
Python / numpy-convertible values (``np.asarray`` of a JAX array works), so
this module imports no JAX.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping

import numpy as np
import torch

from points_matching_tpu_torch.core import config as _config
from points_matching_tpu_torch.core.types import Descriptors, Keypoints, Matches


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


def keypoints_from_numpy(kps, device="cpu") -> Keypoints:
    """Keypoints from any object with ``xy/scale/angle/score/mask`` arrays."""
    f32 = torch.float32
    return Keypoints(
        xy=_tensor(kps.xy, f32, device),
        scale=_tensor(kps.scale, f32, device),
        angle=_tensor(kps.angle, f32, device),
        score=_tensor(kps.score, f32, device),
        mask=_tensor(kps.mask, torch.bool, device),
    )


def descriptors_from_numpy(desc, device="cpu") -> Descriptors:
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


def matches_from_numpy(m, device="cpu") -> Matches:
    """Matches from any object with ``query_idx/train_idx/distance/mask``."""
    return Matches(
        query_idx=_tensor(m.query_idx, torch.int32, device),
        train_idx=_tensor(m.train_idx, torch.int32, device),
        distance=_tensor(m.distance, torch.float32, device),
        mask=_tensor(m.mask, torch.bool, device),
    )
