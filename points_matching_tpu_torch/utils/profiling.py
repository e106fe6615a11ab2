"""Tracing, stage markers, device timers and roofline accounting — port of
``points_matching_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (host ops and, on CUDA, the
card's kernels through CUPTI) as a Chrome trace; ``stage`` names a block in
it (and an NVTX range on CUDA); ``roofline`` times a function and sets it
against the device's peaks.  The JAX version's fetch-sync timing existed
for one experimental TPU backend and has no counterpart here: CUDA events
time the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch

from points_matching_tpu_torch.ops.kernels.work import UNIT_RATE, Work, bound

# Peak rates per device, keyed by a lowercased substring of its name.
# flops: fp32 FLOP/s without tensor cores (an FMA is two flops);
# hbm_gbps: device-memory GB/s; instr_per_s: fp32 instructions/s when every
# multiply and add is its own instruction (kernels built with --fmad=false);
# popc_per_s: 32-bit population counts/s; bf16_tc_flops: dense bf16
# tensor-core FLOP/s (a multiply-add is two).
_CHIP_PEAKS = {
    # NVIDIA H100 SXM5 data sheet: 67 TFLOP/s fp32, 3.35 TB/s HBM3, 989
    # TFLOP/s dense bf16 on the tensor cores.  CUDA C++ Programming Guide,
    # arithmetic-instruction throughput for compute capability 9.0: 128
    # fp32 results and 16 population counts per clock per SM, so one
    # instruction per op is half the flop rate and a population count
    # 16/128 of that; 64 fp64 results a clock an SM, half the fp32 rate.
    "h100": dict(flops=67e12, hbm_gbps=3350.0, instr_per_s=33.5e12,
                 popc_per_s=33.5e12 * 16 / 128, bf16_tc_flops=989e12,
                 f64_instr_per_s=33.5e12 / 2),
    # the JAX package's CPU row; its instruction and popcount rates follow
    # the same ratios, and it has no matrix unit beyond its flop rate
    "cpu": dict(flops=1e12, hbm_gbps=100.0, instr_per_s=0.5e12,
                popc_per_s=0.5e12 * 16 / 128, bf16_tc_flops=1e12, f64_instr_per_s=0.25e12),
}


def chip_peaks(device="cuda") -> Dict[str, float]:
    """Peak rates of ``device`` (a CUDA card named in the table, or the
    CPU).  Raises ``ValueError`` for a card the table does not name."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _CHIP_PEAKS["cpu"]
    name = torch.cuda.get_device_name(dev)
    for key, peaks in _CHIP_PEAKS.items():
        if key in name.lower():
            return peaks
    raise ValueError(f"no peak rates known for {name!r}")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a profiler trace of the block into ``<log_dir>/trace.json``
    (Chrome trace format: Perfetto, chrome://tracing).  Host activity
    always, the card's kernels when CUDA is present.  Yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def stage(name: str):
    """Name a pipeline stage: a ``record_function`` range in profiler traces
    and, with CUDA, an NVTX range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def cuda_event_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card: CUDA events around ``iters``
    back-to-back calls (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn: Callable, iters: int = 50, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events.  The host's
    time to enqueue a call (a kernel wrapper's checks and allocations, the
    ctypes call, some 20 µs) is not in it, so a kernel shorter than that is
    not hidden behind it; back-to-back kernels in a graph still cost a few
    µs each.  ``fn`` must not synchronize."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


@dataclasses.dataclass
class RooflineReport:
    """A function's time against the device's roofline.

    ``flops`` counts operations in ``unit`` ("flops": an FMA is two;
    "instr": unfused fp32 instructions; "popc": population counts);
    ``peak_tflops`` is that unit's peak rate (10¹² a second).  ``bound_s``
    is the least time for the work (the larger of bytes over the memory
    rate and operations over their rate) and ``fraction_of_roofline`` is
    ``bound_s / wall_s``."""

    wall_s: float
    flops: Optional[float]
    bytes_accessed: Optional[float]
    achieved_tflops: Optional[float]
    peak_tflops: float
    fraction_of_roofline: Optional[float]
    bandwidth_gbps: Optional[float]
    arithmetic_intensity: Optional[float]
    unit: str = "flops"
    bound_s: Optional[float] = None
    bound_by: Optional[str] = None

    def __str__(self):
        f = lambda v, fmt: (fmt % v) if v is not None else "n/a"
        return (
            f"wall {self.wall_s*1e3:.4f} ms | "
            f"{f(self.achieved_tflops, '%.3f')} T{self.unit}/s of "
            f"{self.peak_tflops:.1f} peak | "
            f"{f(self.bandwidth_gbps, '%.1f')} GB/s | "
            f"bound {f(self.bound_s and self.bound_s * 1e3, '%.4f')} ms by {self.bound_by} "
            f"({f(self.fraction_of_roofline and self.fraction_of_roofline * 100, '%.1f')}% "
            f"of the roofline) | AI {f(self.arithmetic_intensity, '%.1f')} op/byte"
        )


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _device_of(args, kwargs) -> torch.device:
    ts = _tensors((args, kwargs))
    return ts[0].device if ts else torch.device("cpu")


def roofline(fn: Callable, *args, iters: int = 20, timing: str = "events",
             flops: Optional[float] = None, bytes_accessed: Optional[float] = None,
             **kwargs) -> RooflineReport:
    """Time ``fn(*args, **kwargs)`` and set it against the peaks of the
    device its tensors are on.

    Time: on CUDA, CUDA events around ``iters`` calls (``timing="events"``)
    or replays of a CUDA graph of them (``timing="graph"``: the device time
    alone, for kernels shorter than their host-side launch); on the CPU,
    the host clock around ``iters`` calls.

    Counts, first that applies: ``flops=`` / ``bytes_accessed=`` as given
    (flops in fp32 FLOPs); a kernel wrapper's own ``work`` count
    (``ops/kernels/work.py``: the hand-written kernels are invisible to the
    flop counter); else ``torch.utils.flop_counter.FlopCounterMode`` over
    one call (matmuls and convolutions; None when it counts nothing) and
    the bytes of the call's tensor inputs and outputs.
    """
    dev = _device_of(args, kwargs)
    out = fn(*args, **kwargs)                       # warm-up
    if dev.type == "cuda":
        call = lambda: fn(*args, **kwargs)
        if timing == "graph":
            wall = cuda_graph_ms(call, iters=iters) / 1e3
        elif timing == "events":
            wall = cuda_event_ms(call, iters=iters, warmup=1) / 1e3
        else:
            raise ValueError(f"unknown timing {timing!r}")
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        wall = (time.perf_counter() - t0) / iters

    unit = "flops"
    work = getattr(fn, "work", None)
    if flops is None and bytes_accessed is None and work is not None:
        w = work(*args, **kwargs)
        ops, nbytes, unit = w.ops, w.bytes, w.unit
    else:
        w = None
        ops, nbytes = flops, bytes_accessed
        if ops is None:
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False) as counter:
                out = fn(*args, **kwargs)
            ops = float(counter.get_total_flops()) or None
        if nbytes is None:
            nbytes = float(sum(x.numel() * x.element_size()
                               for x in _tensors((args, kwargs)) + _tensors(out))) or None

    peaks = chip_peaks(dev)
    rate = peaks[UNIT_RATE[unit]]
    if w is None:
        w = Work(nbytes or 0.0, ops or 0.0, unit)
    b = bound(w, peaks) if (ops or nbytes) else None
    bound_s = b["bound_ms"] / 1e3 if b else None
    return RooflineReport(
        wall_s=wall,
        flops=ops,
        bytes_accessed=nbytes,
        achieved_tflops=ops / wall / 1e12 if ops else None,
        peak_tflops=rate / 1e12,
        fraction_of_roofline=bound_s / wall if bound_s else None,
        bandwidth_gbps=nbytes / wall / 1e9 if nbytes else None,
        arithmetic_intensity=ops / nbytes if (ops and nbytes) else None,
        unit=unit,
        bound_s=bound_s,
        bound_by=b["bound_by"] if b else None,
    )
