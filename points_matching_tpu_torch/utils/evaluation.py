"""Trajectory evaluation: ATE/RPE — port of
``points_matching_tpu/utils/evaluation.py``."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor


class ATEResult(NamedTuple):
    rmse: Tensor
    mean: Tensor
    median_like: Tensor  # the lower of the two central order statistics
    scale: Tensor
    aligned: Tensor      # [N, 3] aligned estimated positions


def umeyama_alignment(src: Tensor, dst: Tensor, mask: Optional[Tensor] = None,
                      with_scale: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """Similarity transform (s, R, t) minimizing ‖dst − (s·R·src + t)‖²;
    src/dst [N, 3], mask [N] optional."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device)
    w = mask.to(src.dtype)
    n = w.sum().clamp_min(1.0)
    mu_s = (src * w[:, None]).sum(0) / n
    mu_d = (dst * w[:, None]).sum(0) / n
    xs = (src - mu_s) * w[:, None]
    xd = (dst - mu_d) * w[:, None]
    cov = xd.T @ xs / n
    U, d, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=src.dtype, device=src.device)
    S[2, 2] = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    R = U @ S @ Vt
    var_s = (xs * xs).sum() / n
    s = (torch.trace(torch.diag(d) @ S) / var_s.clamp_min(1e-12) if with_scale
         else torch.ones((), dtype=src.dtype, device=src.device))
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def absolute_trajectory_error(est_positions: Tensor, gt_positions: Tensor,
                              mask: Optional[Tensor] = None,
                              align_scale: bool = True) -> ATEResult:
    """ATE after Umeyama (Sim(3) or SE(3)) alignment — the TUM statistic.
    est/gt: [N, 3] camera centres."""
    if mask is None:
        mask = torch.ones(est_positions.shape[:-1], dtype=torch.bool,
                          device=est_positions.device)
    mask = mask.bool()
    s, R, t = umeyama_alignment(est_positions, gt_positions, mask, align_scale)
    aligned = s * est_positions @ R.T + t
    err = torch.linalg.vector_norm(aligned - gt_positions, dim=-1)
    w = mask.to(err.dtype)
    n = w.sum().clamp_min(1.0)
    rmse = torch.sqrt((w * err ** 2).sum() / n)
    mean = (w * err).sum() / n
    err_sorted = torch.sort(torch.where(mask, err, torch.full_like(err, torch.inf))).values
    k = ((mask.sum() - 1) // 2).clamp_min(0)
    return ATEResult(rmse=rmse, mean=mean, median_like=err_sorted[k], scale=s,
                     aligned=aligned)


def relative_pose_error(est_positions: Tensor, gt_positions: Tensor,
                        delta: int = 1) -> Tensor:
    """RPE-translation RMSE over frame pairs ``delta`` apart."""
    de = est_positions[delta:] - est_positions[:-delta]
    dg = gt_positions[delta:] - gt_positions[:-delta]
    err = torch.linalg.vector_norm(de - dg, dim=-1)
    return torch.sqrt((err ** 2).mean())
