"""Core containers for the PyTorch port.

Same *static-shape + validity-mask* discipline as
``points_matching_tpu/core/types.py``: data-dependent counts (keypoints
detected, matches kept, RANSAC inliers) are fixed-capacity tensors plus a
boolean mask, so both packages hand each other (and the parity tests) arrays
of the same shapes.  The containers are plain ``@dataclass``es of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Keypoints:
    """Fixed-capacity set of 2D keypoints.

    Attributes:
      xy:    [N, 2] float32 — (x, y) pixel coordinates (x = column).
      scale: [N]    float32 — detection scale (sigma, pixels).
      angle: [N]    float32 — orientation in radians (0 if upright).
      score: [N]    float32 — detector response.
      mask:  [N]    bool    — True for valid entries; padded slots are False.
    """

    xy: Tensor
    scale: Tensor
    angle: Tensor
    score: Tensor
    mask: Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self) -> Tensor:
        return self.mask.sum(-1, dtype=torch.int32)


@dataclasses.dataclass
class Descriptors:
    """Fixed-capacity descriptor set.

    Attributes:
      data: [N, D] float32 (float descriptors, unit rows) or [N, W] packed
            bits (binary descriptors): ``torch.int32`` words holding the
            reference's uint32 bits unchanged (torch's uint32 lacks ``>>``
            and ``+``; ``.numpy().view(np.uint32)`` converts back).
      mask: [N] bool.
      binary: True if ``data`` holds packed bits.
    """

    data: Tensor
    mask: Tensor
    binary: bool = False

    @property
    def capacity(self) -> int:
        return self.data.shape[-2]


@dataclasses.dataclass
class Matches:
    """Fixed-capacity correspondence set between two keypoint sets.

    Entry i matches query index ``query_idx[i]`` to train index
    ``train_idx[i]`` with descriptor distance ``distance[i]``.

    Attributes:
      query_idx: [M] int32 — index into the query (image-1) keypoints.
      train_idx: [M] int32 — index into the train (image-2) keypoints.
      distance:  [M] float32 — descriptor distance.
      mask:      [M] bool.
    """

    query_idx: Tensor
    train_idx: Tensor
    distance: Tensor
    mask: Tensor

    @property
    def capacity(self) -> int:
        return self.query_idx.shape[-1]

    @property
    def count(self) -> Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def gather_points(self, kps1: Keypoints, kps2: Keypoints) -> Tuple[Tensor, Tensor]:
        """Return ([M, 2], [M, 2]) matched point arrays (padded rows are
        junk; use ``self.mask``)."""
        q = self.query_idx.long().clamp(0, kps1.capacity - 1)
        t = self.train_idx.long().clamp(0, kps2.capacity - 1)
        return kps1.xy[q], kps2.xy[t]


@dataclasses.dataclass
class TwoViewEstimate:
    """Result of two-view geometry estimation.

    Attributes:
      F:             [3, 3] fundamental matrix (rank 2, Frobenius-normalized).
      inlier_mask:   [M] bool over the match list used for estimation.
      num_inliers:   scalar int32.
      residual_mean: scalar float32 — mean |p1ᵀ F p2| over inliers (the
                     reference demo's audit statistic).
    """

    F: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor
    residual_mean: Tensor
