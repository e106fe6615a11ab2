"""Core containers for the PyTorch port.

Same *static-shape + validity-mask* discipline as
``points_matching_tpu/core/types.py``: data-dependent counts (keypoints
detected, matches kept, RANSAC inliers) are fixed-capacity tensors plus a
boolean mask, so both packages hand each other (and the parity tests) arrays
of the same shapes.  The containers are plain ``@dataclass``es of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def take(x: Tensor, i: Tensor) -> Tensor:
    """``x[b, i[b]]`` for every leading index b, without reading ``i`` on
    the host: ``x [*B, K, ...]`` and ``i [*B]`` give ``[*B, ...]``.  With a
    0-d ``i`` (B = ()) it is ``x[i]``; plain indexing with a 0-d CUDA tensor
    would convert it to a Python int, which waits for the device.  Over a
    pair axis it picks each pair's winner in one gather."""
    d = i.dim()
    idx = i.long().reshape(*i.shape, *(1,) * (x.dim() - d))
    return x.gather(d, idx.expand(*i.shape, 1, *x.shape[d + 1:])).squeeze(d)


def take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` [*B, m] of ``x`` [*B, n, ...] → [*B, m, ...]: a gather
    per leading index (``x[idx]`` without one)."""
    return torch.take_along_dim(x, idx.reshape(*idx.shape, *(1,) * (x.dim() - idx.dim())),
                                dim=idx.dim() - 1)


def flat_rows(index: Tensor, n: int) -> Tensor:
    """Indices [*B, m] into the rows of [*B, n, ...] → indices into the
    flattened [prod(B)·n, ...] rows (b·n added for leading index b), so
    that one scatter or gather serves every leading index in its own rows."""
    lead = index.shape[:-1]
    if not lead:
        return index
    return index + torch.arange(math.prod(lead), device=index.device).reshape(*lead, 1) * n


def put_rows(dst: Tensor, pos: Tensor, src) -> Tensor:
    """``dst`` [*B, n, ...] with rows ``pos`` [*B, m] set to ``src``
    (broadcast to [*B, m, ...]); rows with pos == n land in a spare row
    that is sliced off (dropped), the reference's ``mode="drop"``."""
    nb = pos.dim() - 1
    n, rest = dst.shape[nb], dst.shape[nb + 1:]
    out = torch.cat([dst, dst.new_zeros((*dst.shape[:nb], 1, *rest))], nb)
    if not isinstance(src, torch.Tensor):
        # a Python value written by index would be copied to the device
        # first, which waits for it
        src = torch.full((), src, dtype=dst.dtype, device=dst.device)
    flat = out.view(-1, *rest)
    flat[flat_rows(pos.long(), n + 1).reshape(-1)] = (
        src.to(dst.dtype).expand(*pos.shape, *rest).reshape(-1, *rest))
    return out.narrow(nb, 0, n)


def put_rows_last(dst: Tensor, pos: Tensor, src: Tensor) -> Tensor:
    """``put_rows`` where several rows may target one slot: the last such
    row wins, deterministically on every device (the rule of the
    reference's scatter on the CPU); the others are dropped."""
    n = dst.shape[pos.dim() - 1]
    pos = pos.long()
    rows = torch.arange(pos.shape[-1], device=pos.device).expand(pos.shape)
    winner = torch.full((*pos.shape[:-1], n + 1), -1, dtype=torch.long, device=pos.device)
    winner = winner.scatter_reduce(-1, pos, rows, "amax")
    return put_rows(dst, torch.where(winner.gather(-1, pos) == rows, pos, n), src)


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
    ``train_idx[i]`` with descriptor distance ``distance[i]``.  A batch of
    pairs carries a leading pair axis on every field ([P, M]).

    Attributes:
      query_idx: [..., M] int32 — index into the query (image-1) keypoints.
      train_idx: [..., M] int32 — index into the train (image-2) keypoints.
      distance:  [..., M] float32 — descriptor distance.
      mask:      [..., M] bool.
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
        """Return ([..., M, 2], [..., M, 2]) matched point arrays, each pair
        from its own keypoints (padded rows are junk; use ``self.mask``)."""
        q = self.query_idx.long().clamp(0, kps1.capacity - 1)
        t = self.train_idx.long().clamp(0, kps2.capacity - 1)
        return (torch.take_along_dim(kps1.xy, q[..., None], dim=-2),
                torch.take_along_dim(kps2.xy, t[..., None], dim=-2))


@dataclasses.dataclass
class TwoViewEstimate:
    """Result of two-view geometry estimation.

    A batch of pairs carries a leading pair axis on every field.

    Attributes:
      F:             [..., 3, 3] fundamental matrix (rank 2, Frobenius-normalized).
      inlier_mask:   [..., M] bool over the match list used for estimation.
      num_inliers:   [...] int32.
      residual_mean: [...] float32 — mean |p1ᵀ F p2| over inliers (the
                     reference demo's audit statistic).
    """

    F: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor
    residual_mean: Tensor


@dataclasses.dataclass
class CameraIntrinsics:
    """Pinhole intrinsics.

    Attributes:
      fx, fy, cx, cy: float32 scalar tensors.
    """

    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor

    @classmethod
    def from_matrix(cls, K: Tensor) -> "CameraIntrinsics":
        return cls(fx=K[..., 0, 0], fy=K[..., 1, 1], cx=K[..., 0, 2], cy=K[..., 1, 2])

    def to(self, device) -> "CameraIntrinsics":
        return CameraIntrinsics(*(x.to(device) for x in (self.fx, self.fy, self.cx, self.cy)))

    def matrix(self) -> Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        rows = [
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1),
        ]
        return torch.stack(rows, -2)

    def normalize_points(self, xy: Tensor) -> Tensor:
        """Pixel → normalized camera coordinates."""
        f = torch.stack([self.fx, self.fy], -1)
        c = torch.stack([self.cx, self.cy], -1)
        return (xy - c) / f

    def project(self, xyz_cam: Tensor, eps: float = 1e-9) -> Tensor:
        """Camera-frame 3D points → pixel coordinates."""
        z = xyz_cam[..., 2:3]
        uv = xyz_cam[..., :2] / torch.where(z.abs() < eps, torch.full_like(z, eps), z)
        f = torch.stack([self.fx, self.fy], -1)
        c = torch.stack([self.cx, self.cy], -1)
        return uv * f + c


@dataclasses.dataclass
class Pose:
    """SE(3) world→camera transform: x_cam = R @ x_world + t.

    Attributes:
      R: [..., 3, 3] rotation.
      t: [..., 3] translation.
    """

    R: Tensor
    t: Tensor

    @classmethod
    def identity(cls, batch: tuple = (), dtype=torch.float32, *, device) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
        return cls(R=R, t=torch.zeros(*batch, 3, dtype=dtype, device=device))

    def __getitem__(self, i) -> "Pose":
        return Pose(R=self.R[i], t=self.t[i])

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: apply ``other`` first, then ``self``."""
        return Pose(R=self.R @ other.R,
                    t=(self.R @ other.t[..., None])[..., 0] + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(R=Rt, t=-(Rt @ self.t[..., None])[..., 0])

    def transform(self, xyz: Tensor) -> Tensor:
        """Apply to points [..., N, 3] (the pose broadcasts over N)."""
        return (self.R[..., None, :, :] * xyz[..., None, :]).sum(-1) + self.t[..., None, :]

    def matrix34(self) -> Tensor:
        return torch.cat([self.R, self.t[..., :, None]], -1)


@dataclasses.dataclass
class Landmarks:
    """Fixed-capacity 3D map points.

    Attributes:
      xyz:  [L, 3] float32 world coordinates.
      mask: [L] bool — valid landmarks.
    """

    xyz: Tensor
    mask: Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @classmethod
    def empty(cls, capacity: int, dtype=torch.float32, *, device) -> "Landmarks":
        return cls(xyz=torch.zeros(capacity, 3, dtype=dtype, device=device),
                   mask=torch.zeros(capacity, dtype=torch.bool, device=device))


@dataclasses.dataclass
class Observations:
    """Fixed-capacity reprojection-observation list for bundle adjustment:
    entry k links camera ``cam_idx[k]`` and landmark ``lm_idx[k]`` to a
    measured pixel ``uv[k]``.

    Attributes:
      cam_idx: [K] int32.
      lm_idx:  [K] int32.
      uv:      [K, 2] float32 measured pixel coordinates.
      mask:    [K] bool.
    """

    cam_idx: Tensor
    lm_idx: Tensor
    uv: Tensor
    mask: Tensor

    @property
    def capacity(self) -> int:
        return self.cam_idx.shape[-1]
