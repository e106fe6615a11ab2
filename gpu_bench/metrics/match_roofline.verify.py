"""The matching layer's share of its roofline: the least time the card
could take for a batch's L2 top-2 (the frozen work in
``gpu_bench/work/arith.l2_top2``, against the card's fp32 FMA and HBM
peaks) over the device time of the ``bench.match`` span, so it counts
whatever implements matching (today kernel K1b,
``csrc/matching_top2.cu``)."""
from gpu_bench.work.arith import bound_s


def read(run):
    s = run.trace and run.trace["spans"].get("bench.match")
    if not s or not s["count"] or s["device_s"] <= 0 or run.peaks is None:
        return None
    return bound_s(run.work["l2_top2"], run.peaks) / (s["device_s"] / s["count"]) * 100.0
