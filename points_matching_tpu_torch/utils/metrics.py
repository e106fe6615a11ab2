"""Metrics registry and trajectory-error metrics — port of
``points_matching_tpu/utils/metrics.py`` (numpy, host side).

The reference's only quantitative outputs — best/worst match distance
(``main.cpp:58-59``) and mean |p1ᵀFp2| (``main.cpp:123``) — become
first-class metrics here, alongside the headline metrics (pairs/s, BA
iterations/s, ATE, scaling efficiency).  ``utils/evaluation.py`` holds the
same alignment and ATE on tensors.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class Metrics:
    """Tiny in-process metrics registry: scalars + timers."""

    def __init__(self) -> None:
        self.scalars: Dict[str, List[float]] = defaultdict(list)

    def log(self, name: str, value: float) -> None:
        self.scalars[name].append(float(value))

    def last(self, name: str) -> Optional[float]:
        v = self.scalars.get(name)
        return v[-1] if v else None

    def mean(self, name: str) -> Optional[float]:
        v = self.scalars.get(name)
        return float(np.mean(v)) if v else None

    def summary(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.scalars.items()}

    def dump_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


class Timer:
    """Wall-clock timer context manager feeding a Metrics registry.

    It reads the host clock only.  CUDA work is asynchronous, so to time
    work on the card the caller synchronizes (``torch.cuda.synchronize()``)
    before the block ends; ``utils/profiling.roofline`` times with CUDA
    events instead."""

    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.log(self.name, time.perf_counter() - self.t0)
        return False


def align_trajectories(est: np.ndarray, gt: np.ndarray):
    """Umeyama similarity alignment (rotation+translation+scale) of estimated
    camera centers to ground truth — the standard ATE preprocessing.

    Args: est, gt: [N, 3].
    Returns aligned est [N, 3].
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E / len(est))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_e = (E**2).sum() / len(est)
    s = np.trace(np.diag(S) @ D) / max(var_e, 1e-12)
    return (s * (R @ E.T)).T + mu_g


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) — the headline
    accuracy metric (TUM fr1 / KITTI 00)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align:
        est = align_trajectories(est, gt)
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))
