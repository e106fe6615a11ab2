"""All-pairs scores, plainly: for every ordered pair of images (i, j), the
number of image i's valid rows whose nearest valid row of image j passes
Lowe's ratio test (best < ratio² · second on squared L2)."""
from __future__ import annotations

from typing import Dict

import torch

from gpu_bench.reference import dtype_of, matmul

Tensor = torch.Tensor
# elements of one [train images, query rows, K] block of distances
_BLOCK_ELEMENTS = 1 << 26


def scores(qd: Tensor, qm: Tensor, td: Tensor, tm: Tensor, ratio: float,
           precision: str) -> Dict[str, Tensor]:
    """qd [Q, K, D], qm [Q, K] against td [T, K, D], tm [T, K] →
    ``scores`` [Q, T] and each row's top-2 squared distances ``best``,
    ``second`` [Q, T, K] (+inf where too few train rows are valid), a query
    image at a time in blocks of its rows and of the train images."""
    Q, K, _ = qd.shape
    T, K2, _ = td.shape
    dt = dtype_of(precision)
    tdd = td.to(dt)
    t2 = (tdd * tdd).sum(-1)                                            # [T, K2]
    rows = max(1, min(K, _BLOCK_ELEMENTS // K2))
    imgs = max(1, _BLOCK_ELEMENTS // (rows * K2))
    best = torch.empty(Q, T, K, dtype=dt, device=qd.device)
    second = torch.empty_like(best)
    for i in range(Q):
        q = qd[i].to(dt)
        q2 = (q * q).sum(-1)                                            # [K]
        for r0 in range(0, K, rows):
            r1 = min(K, r0 + rows)
            for j0 in range(0, T, imgs):
                j1 = min(T, j0 + imgs)
                ip = matmul(q[None, r0:r1], tdd[j0:j1].transpose(-1, -2), precision)
                d = (q2[None, r0:r1, None] + t2[j0:j1, None, :] - 2.0 * ip).clamp_min(0.0)
                del ip
                d = d.masked_fill(~tm[j0:j1, None, :], float("inf"))
                v = d.topk(2, dim=-1, largest=False).values                 # [imgs, rows, 2]
                del d
                best[i, j0:j1, r0:r1] = v[..., 0]
                second[i, j0:j1, r0:r1] = v[..., 1]
    ok = qm[:, None, :] & torch.isfinite(best) & (best < ratio * ratio * second)
    return dict(scores=ok.sum(-1), best=best, second=second)
