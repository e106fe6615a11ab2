"""Host milliseconds to enqueue one sweep (``all_pairs_scores``): the
``bench.sweep`` span's host duration (no synchronize inside), less the time
its launch calls took beyond the window's median call, which is the host
waiting for room in a full launch queue while the card works."""


def read(run):
    s = run.trace and run.trace["spans"].get("bench.sweep")
    if not s or not s["count"] or s["host_s"] <= 0:
        return None
    return (s["host_s"] - s["launch_wait_s"]) / s["count"] * 1e3
