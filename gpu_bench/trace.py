"""The traced window: ``torch.profiler`` over a few whole batches, read from
its Chrome trace into what the per-layer metric readers take.

The benchmark's own spans (``record_function`` ranges named ``bench.*``,
around its calls into each layer of the program) are on the host's
timeline; every device operation (kernel, copy, fill) carries the
correlation id of the runtime or driver call that launched it, so its
device time is charged to the span that call lies in.  ``bench.window``
spans the traced batches; the device's busy time is the union of its
operations inside it.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
from collections import defaultdict
from typing import List, Optional

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# a device gap shorter than this is a launch bubble, not a host stall
SHORT_GAP_US = 20.0


class Profiler:
    """``torch.profiler`` of host and device, started and stopped around the
    traced batches, its trace read once the run's window has closed."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._span = None

    def start(self) -> None:
        import torch

        self._prof.start()
        self._span = torch.autograd.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def read(self, span_names) -> Optional[dict]:
        """The trace's summary (``summarize``), or None where it holds no
        window.  The Chrome trace goes through a temporary file under
        TMPDIR, deleted once read."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return summarize(events, span_names)


def _short(name: str) -> str:
    """A kernel's name without its namespace noise, return type, template
    and argument lists (``l2_top2_kernel``, ``at::native::reduce_kernel``)."""
    out, depth = [], 0
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch not in "<>":
            out.append(ch)
    words = "".join(out).split()
    return (words[-1] if words else name)[:96]


def _union(intervals, lo: float, hi: float):
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict], span_names) -> Optional[dict]:
    """The window's summary (times in seconds):

    * ``window_s``, ``busy_s``: the window's length and the union of device
      operations inside it;
    * ``spans[name]``: ``count``, ``host_s`` (their host durations),
      ``device_s`` (device time of the operations launched inside them),
      ``kernels`` (that device time by kernel name), ``launch_calls`` (the
      runtime/driver calls inside them) and ``launch_wait_s`` (how much
      longer than the window's median call they took: the host waiting on
      a full launch queue);
    * ``device_ops``: device seconds by operation name over the window, and
      ``device_ops_without_launch``: how many had no launching call;
    * ``idle_gaps``: idle device seconds by what the host was doing."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        return None
    w = win[0]
    w0, w1, tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w.get("tid")

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in xs if e.get("cat") == "user_annotation" and e.get("name") in span_names
                   and e.get("tid") == tid and w0 <= float(e["ts"]) <= w1)
    starts = [s[0] for s in spans]

    def span_at(t: float) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None

    launches = [e for e in xs if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid]
    by_corr = {e.get("args", {}).get("correlation"): e for e in launches}
    stats = {n: dict(count=0, host_s=0.0, device_s=0.0, kernels=defaultdict(float),
                     launch_calls=0, launch_wait_s=0.0) for n in span_names}
    for s, e, n in spans:
        stats[n]["count"] += 1
        stats[n]["host_s"] += (e - s) * 1e-6
    in_win = [e for e in launches if w0 <= float(e["ts"]) <= w1]
    launch_median = statistics.median(float(e["dur"]) for e in in_win) if in_win else 0.0
    for e in in_win:
        n = span_at(float(e["ts"]))
        if n:
            stats[n]["launch_calls"] += 1
            stats[n]["launch_wait_s"] += max(0.0, float(e["dur"]) - launch_median) * 1e-6

    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS
                  and float(e["ts"]) + float(e["dur"]) >= w0 and float(e["ts"]) <= w1),
                 key=lambda e: float(e["ts"]))
    # each operation's span through the call that launched it; one whose
    # call the trace lacks takes the span of the next operation on its
    # stream that has one (a stream runs its operations in launch order)
    owner, unmatched = [], 0
    for e in dev:
        src = by_corr.get(e.get("args", {}).get("correlation"))
        owner.append(span_at(float(src["ts"])) if src is not None else False)
    nxt = {}
    for i in range(len(dev) - 1, -1, -1):
        stream = dev[i].get("args", {}).get("stream")
        if owner[i] is False:
            unmatched += 1
            owner[i] = nxt.get(stream)
        else:
            nxt[stream] = owner[i]
    ops = defaultdict(float)
    intervals = []
    for e, n in zip(dev, owner):
        s, d = float(e["ts"]), float(e["dur"])
        intervals.append((s, s + d))
        name = e.get("name", "?")
        name = _short(name) if e.get("cat") == "kernel" else name
        ops[name] += d * 1e-6
        if n:
            stats[n]["device_s"] += d * 1e-6
            stats[n]["kernels"][name] += d * 1e-6
    busy = _union(intervals, w0, w1)
    busy_s = sum(e - s for s, e in busy) * 1e-6

    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW), key=lambda x: x[0])
    host_starts = [h[0] for h in host]

    def host_at(t: float) -> str:
        """The innermost host event at t, under the bench span it lies in."""
        i = bisect.bisect_right(host_starts, t) - 1
        inner = "host outside any op"
        for j in range(i, max(-1, i - 4000), -1):     # the latest start that covers t
            if host[j][0] <= t <= host[j][1]:
                inner = host[j][2]
                break
        outer = span_at(t)
        return f"{outer}/{inner}" if outer and outer != inner else inner

    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s <= 0:
            continue
        label = "launch bubbles (< 20 us)" if e - s < SHORT_GAP_US else host_at((s + e) / 2)
        gaps[label] += (e - s) * 1e-6

    for n in stats:
        stats[n]["kernels"] = dict(stats[n]["kernels"])
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, spans=stats,
                device_ops_without_launch=unmatched,
                device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
                idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))
