"""Readings of the host and the card that go on the earlier lines of a run:
the process's age, the card's name, power limit and clocks, the host's
eager launch time, and the aten ops a call dispatches."""
from __future__ import annotations

import os
import time

import torch

from gpu_bench.work.peaks import nvidia_smi

_T_IMPORT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (from /proc; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def card() -> dict:
    """The card's name as PyTorch gives it, and what ``nvidia-smi`` reads of
    its power limit and clocks (None where it cannot)."""
    line = nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu")
    return dict(kind=torch.cuda.get_device_name(0), nvidia_smi=line)


def dispatch_us(dev, n: int = 2000) -> float:
    """The host's time per eager launch (µs): ``n`` one-element ``add_``
    calls enqueued back to back, one synchronize at the end (a copy of
    ``chip_smoke.py``'s ``_dispatch_us``).  Host-paced layers follow it."""
    one = torch.zeros(1, device=dev)
    one.add_(1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        one.add_(1)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n * 1e6


def count_ops(fn) -> int:
    """The aten ops ``fn`` dispatches, each an eager launch or a view on the
    host (a copy of ``chip_smoke.py``'s ``_count_ops``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n
