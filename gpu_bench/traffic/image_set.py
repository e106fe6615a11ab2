"""The ``image_set`` traffic generator: image sets whose neighbours share
points.  It follows ``chip_smoke.py``'s ``_all_pairs_inputs`` (random unit
descriptors) with overlapping neighbours in place of its one planted pair.
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor
# a rehearsal's mix on the CPU
TINY = dict(images=16, keypoints=32, pool=2, warmup=1)


def make(mix: dict, dim: int, gen: torch.Generator, dev) -> Dict[str, Tensor]:
    """One set of the ``image_set`` generator: ``mix["images"]`` images of
    ``mix["keypoints"]`` random unit ``dim``-d descriptors, every row valid.
    Image i's last ``mix["shared_rows"]`` share of rows are noisy copies of
    image i+1's first rows (the next image sees the same points), each
    with its own noise, uniform in ``mix["shared_noise"]`` a dimension, so
    that the true matches run from clear to failing the ratio test."""
    n, k = mix["images"], mix["keypoints"]
    s = int(mix["shared_rows"] * k)
    base = torch.randn(n, k, dim, generator=gen, device=dev)
    base = base / base.norm(dim=-1, keepdim=True)
    lo, hi = mix["shared_noise"]
    sigma = lo + (hi - lo) * torch.rand(n, s, 1, generator=gen, device=dev)
    copies = base.roll(-1, 0)[:, :s] + sigma * torch.randn(n, s, dim, generator=gen, device=dev)
    base[:, k - s:] = copies
    base = base / base.norm(dim=-1, keepdim=True)
    return dict(desc=base.contiguous(), mask=torch.ones(n, k, dtype=torch.bool, device=dev))
