"""The traffic generators, and the seeds every stream of a run is drawn from.

A traffic mix is a data file of parameters (``traffic/<mix>.json``); its
``"generator"`` key names a generator, ``traffic/<generator>.py``, whose
``make(mix, dim, gen, dev)`` makes one batch from the mix and a
``torch.Generator`` on the device, in a few large calls, and whose ``TINY``
gives the sizes a rehearsal on the CPU shrinks its mixes to.  A new
generator is a new file there, found by its name.
"""
from __future__ import annotations

import importlib.util
import os
from types import ModuleType

import numpy as np


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed (any
    non-negative int) and a salt: independent streams for the inputs, the
    program's draws, the reference's draws and the check's samples."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(int(s) for s in salt))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def load(path: str) -> ModuleType:
    """The generator in ``path`` (its ``make`` and ``TINY``)."""
    name = "gpu_bench_traffic_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
