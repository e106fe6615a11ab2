"""The sweep's share of its roofline: the least time the card could take
for one all-pairs sweep (the frozen work in
``gpu_bench/work/arith.all_pairs``: one FMA per query row, train row and
dimension, against the fp32 FMA and HBM peaks) over the device time of the
``bench.sweep`` span (today kernel K1, ``csrc/matching_top2.cu``, and the
counts around it)."""
from gpu_bench.work.arith import bound_s


def read(run):
    s = run.trace and run.trace["spans"].get("bench.sweep")
    if not s or not s["count"] or s["device_s"] <= 0 or run.peaks is None:
        return None
    return bound_s(run.work["all_pairs"], run.peaks) / (s["device_s"] / s["count"]) * 100.0
