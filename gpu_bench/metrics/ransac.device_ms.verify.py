"""Device milliseconds a batch spends in the RANSAC layer: the device
operations launched inside the benchmark's ``bench.ransac`` span (around
``ransac_fundamental``: the sampler, the minimal solves, the scorer, the
winner, the refits and the audit), over the traced batches."""


def read(run):
    s = run.trace and run.trace["spans"].get("bench.ransac")
    if not s or not s["count"] or s["device_s"] <= 0:
        return None
    return s["device_s"] / s["count"] * 1e3
