"""Pose recovery from the essential matrix — port of
``points_matching_tpu/geometry/pose.py``."""
from __future__ import annotations

from typing import Tuple

import torch

from points_matching_tpu_torch.core.types import Pose, take
from points_matching_tpu_torch.geometry.eigen import svd3_rotational
from points_matching_tpu_torch.geometry.triangulate import triangulate_dlt

Tensor = torch.Tensor


def decompose_essential(E: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The 4 (R, t) candidates of E: (R [..., 2, 3, 3] ∈ {Ra, Rb},
    t [..., 2, 3] ∈ {+u3, −u3}, u3).  The rotational SVD has det(U) =
    det(V) = +1 by construction, so no determinant fix is needed."""
    U, _, Vt = svd3_rotational(E)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-eye[1], eye[0], eye[2]])          # [[0,-1,0],[1,0,0],[0,0,1]]
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    u3 = U[..., :, 2]
    return torch.stack([Ra, Rb], -3), torch.stack([u3, -u3], -2), u3


def recover_pose(E: Tensor, p1_norm: Tensor, p2_norm: Tensor, weights: Tensor
                 ) -> Tuple[Pose, Tensor, Tensor]:
    """The (R, t) candidate with the most points in front of both cameras
    (``cv::recoverPose``), for one E or a batch.  Each E's 4 candidates are
    scored as one batch; on a tie the first candidate wins, as
    ``jnp.argmax``, per E.

    Args:
      E: [..., 3, 3]; p1_norm, p2_norm: [..., N, 2] normalized coordinates;
      weights: [..., N] validity.

    Returns (pose cam1 → cam2 [...], X [..., N, 3] in the cam-1 frame for
    the winner, cheirality mask [..., N]).
    """
    R2, t2, _ = decompose_essential(E)
    Rs = torch.stack([R2[..., 0, :, :], R2[..., 0, :, :],
                      R2[..., 1, :, :], R2[..., 1, :, :]], -3)    # [..., 4, 3, 3]
    ts = torch.stack([t2[..., 0, :], t2[..., 1, :], t2[..., 0, :], t2[..., 1, :]], -2)
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device).expand(*Rs.shape[:-2], 3, 4)
    P2 = torch.cat([Rs, ts[..., None]], -1)
    n = p1_norm.shape[-2]
    X, ok = triangulate_dlt(eye34, P2, p1_norm[..., None, :, :].expand(*Rs.shape[:-2], n, 2),
                            p2_norm[..., None, :, :].expand(*Rs.shape[:-2], n, 2))
    good = ok & (weights[..., None, :] > 0)                    # [..., 4, N]
    best = good.sum(-1).argmax(-1)                             # first on ties
    return Pose(R=take(Rs, best), t=take(ts, best)), take(X, best), take(good, best)
