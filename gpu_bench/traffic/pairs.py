"""The ``pairs`` traffic generator: batches of image pairs with their
correspondences' points and descriptors.

Copied from ``chip_smoke.py``: ``_scenes`` (two-view scenes with an outlier
share) and the ``pairs`` phase's descriptors (train rows are permuted noisy
copies of the query rows).
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor
# a rehearsal's mix on the CPU
TINY = dict(pairs=4, keypoints=256, hypotheses=256, outlier_share=0.3, pool=2, warmup=1)


def scenes(P: int, N: int, gen: torch.Generator, dev, outlier_share: float,
           noise_px: float) -> Dict[str, Tensor]:
    """P random two-view scenes of N correspondences (pixels, 640×480,
    f = 500): points in the first camera's frustum, a small rotation and a
    baseline for the second, Gaussian pixel noise, and the first
    ``outlier_share`` · N rows replaced by uniform points in image 2."""
    def rnd(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    X = torch.stack([rnd(P, N) * 4 - 2, rnd(P, N) * 3 - 1.5, rnd(P, N) * 6 + 4], -1)
    a = (rnd(P) - 0.5) * 0.2
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    R = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                     torch.stack([-s, z, c], -1)], -2)
    t = torch.stack([0.3 + 0.2 * rnd(P), 0.05 * rnd(P), 0.05 * rnd(P)], -1)
    X2 = X @ R.transpose(-1, -2) + t[:, None]
    centre = torch.tensor([320.0, 240.0], device=dev)

    def project(Y):
        return Y[..., :2] / Y[..., 2:] * 500.0 + centre

    p1 = project(X) + noise_px * torch.randn(P, N, 2, generator=gen, device=dev)
    p2 = project(X2) + noise_px * torch.randn(P, N, 2, generator=gen, device=dev)
    n_out = int(outlier_share * N)
    p2[:, :n_out] = torch.stack([rnd(P, n_out) * 640, rnd(P, n_out) * 480], -1)
    return dict(p1=p1.contiguous(), p2=p2.contiguous())


def make(mix: dict, dim: int, gen: torch.Generator, dev) -> Dict[str, Tensor]:
    """One batch of the ``pairs`` generator: ``mix["pairs"]`` image pairs of
    ``mix["keypoints"]`` keypoints each, ``dim``-d unit descriptors.  Query
    row i's descriptor is random; train row j holds query perm[j]'s
    descriptor plus ``mix["descriptor_noise"]`` Gaussian noise a dimension,
    renormalised, and query perm[j]'s point in image 2.  Every row valid."""
    P, N = mix["pairs"], mix["keypoints"]
    sc = scenes(P, N, gen, dev, mix["outlier_share"], mix["noise_px"])
    q = torch.randn(P, N, dim, generator=gen, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    perm = torch.rand(P, N, generator=gen, device=dev).argsort(-1)
    t = q.gather(1, perm[..., None].expand(P, N, dim))
    t = t + mix["descriptor_noise"] * torch.randn(P, N, dim, generator=gen, device=dev)
    t = t / t.norm(dim=-1, keepdim=True)
    p2 = sc["p2"].gather(1, perm[..., None].expand(P, N, 2))
    ones = torch.ones(P, N, dtype=torch.bool, device=dev)
    return dict(q=q.contiguous(), t=t.contiguous(), p1=sc["p1"], p2=p2.contiguous(),
                q_mask=ones, t_mask=ones)
