"""Ratio-test matching, plainly: every squared-L2 distance of a pair from
the GEMM identity, the two smallest per query row, Lowe's test on the
distances (sqrt(best) < ratio · sqrt(second), i.e. best < ratio² · second)."""
from __future__ import annotations

from typing import Dict

import torch

from gpu_bench.reference import dtype_of, matmul

Tensor = torch.Tensor
# elements of one block's [pairs, N1, N2] distance matrix
_BLOCK_ELEMENTS = 1 << 27


def l2_top2(q: Tensor, t: Tensor, t_mask: Tensor, precision: str) -> Dict[str, Tensor]:
    """q [B, N1, D], t [B, N2, D], t_mask [B, N2] → the two smallest
    squared-L2 distances of each query row over its pair's valid train rows
    (``best``, ``second``; +inf where too few are valid) and the index of
    the smallest (``idx``), in blocks of pairs."""
    B, N1, _ = q.shape
    N2 = t.shape[1]
    dt = dtype_of(precision)
    block = max(1, _BLOCK_ELEMENTS // max(1, N1 * N2))
    best, second, idx = [], [], []
    for b0 in range(0, B, block):
        qb, tb = q[b0:b0 + block].to(dt), t[b0:b0 + block].to(dt)
        q2 = (qb * qb).sum(-1)
        t2 = (tb * tb).sum(-1)
        d = q2[..., :, None] + t2[..., None, :] - 2.0 * matmul(qb, tb.transpose(-1, -2),
                                                                 precision)
        d = d.clamp_min(0.0).masked_fill(~t_mask[b0:b0 + block, None, :], float("inf"))
        v, i = d.topk(2, dim=-1, largest=False)
        del d
        best.append(v[..., 0])
        second.append(v[..., 1])
        idx.append(i[..., 0])
    return dict(best=torch.cat(best), second=torch.cat(second), idx=torch.cat(idx))


def distance_at(q: Tensor, t: Tensor, idx: Tensor) -> Tensor:
    """Squared-L2 distance in float64 between each query row and the train
    row ``idx`` names ([B, N1] → [B, N1]), summed from the differences."""
    tt = t.gather(1, idx.long()[..., None].expand(*idx.shape, t.shape[-1]))
    return ((q.double() - tt.double()) ** 2).sum(-1)


def ratio_match(q: Tensor, t: Tensor, q_mask: Tensor, t_mask: Tensor, t_points: Tensor,
                ratio: float, precision: str) -> Dict[str, Tensor]:
    """Matches in query order: ``keep`` (the row passes the ratio test),
    ``idx`` (its train row; 0 where not kept), ``pts`` (that train row's
    point), and the top-2 distances they came from."""
    top = l2_top2(q, t, t_mask, precision)
    keep = q_mask & torch.isfinite(top["best"]) & (top["best"] < ratio * ratio * top["second"])
    idx = torch.where(keep, top["idx"], 0)
    pts = t_points.gather(1, idx[..., None].expand(*idx.shape, t_points.shape[-1]))
    return dict(keep=keep, idx=idx, pts=pts, best=top["best"], second=top["second"])
