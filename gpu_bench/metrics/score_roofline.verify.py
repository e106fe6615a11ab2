"""The RANSAC scorer's share of its roofline: the least time the card could
take to gate a batch's hypotheses under the Sampson distance (the frozen
work in ``gpu_bench/work/arith.sampson_gate``, against the fp32
instruction and HBM peaks) over the device time of the kernels named here
inside the ``bench.ransac`` span.  No span inside ``ransac_fundamental``
isolates the scorer yet, so the reader names its kernel (K2,
``csrc/ransac_score.cu``); a path without it reads nothing."""
from gpu_bench.work.arith import bound_s

KERNELS = ("ransac_score_kernel",)


def read(run):
    s = run.trace and run.trace["spans"].get("bench.ransac")
    if not s or not s["count"] or run.peaks is None or "sampson_gate" not in run.work:
        return None
    device_s = sum(t for name, t in s["kernels"].items() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    return bound_s(run.work["sampson_gate"], run.peaks) / (device_s / s["count"]) * 100.0
