"""Faults planted in RANSAC's search, for the readings that set the
consensus limit (``readings.py --fault``) and the tests that see a run with
one come out not correct.  Each keeps F, its inlier mask and its count
consistent with one another, so that only the consensus against the
reference RANSAC can tell.

* ``few_hypotheses``: a 64th of the cell's hypotheses (a sampler or K3
  that loses most of its minimal sets);
* ``first_hypothesis``: the scorer's counts lost, so every pair keeps its
  first hypothesis (a broken K2 or winner).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch


def _fewer_hypotheses(fn):
    def wrapped(generator, p1, p2, mask, config):
        return fn(generator, p1, p2, mask, dataclasses.replace(
            config, num_hypotheses=max(1, config.num_hypotheses // 64)))
    return wrapped


def _counts_lost(fn):
    def wrapped(F, *args, **kwargs):
        return torch.zeros(F.shape[:-2], dtype=torch.int32, device=F.device)
    return wrapped


SEARCH = {
    "few_hypotheses": [("gpu_bench.drivers.verify", "ransac_fundamental", _fewer_hypotheses)],
    "first_hypothesis": [("points_matching_tpu_torch.geometry.ransac", "ransac_score_hypotheses",
                          _counts_lost)],
}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place while the block runs."""
    saved = []
    try:
        for module, attr, breaker in SEARCH[name]:
            mod = importlib.import_module(module)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, breaker(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
