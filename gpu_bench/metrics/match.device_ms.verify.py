"""Device milliseconds a batch spends in the matching layer: the device
operations launched inside the benchmark's ``bench.match`` span (around
``match_descriptors_points``), over the traced batches."""


def read(run):
    s = run.trace and run.trace["spans"].get("bench.match")
    if not s or not s["count"] or s["device_s"] <= 0:
        return None
    return s["device_s"] / s["count"] * 1e3
