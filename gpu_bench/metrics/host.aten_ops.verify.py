"""The aten ops one batch dispatches on the host (match and RANSAC), each an
eager launch or a view: what a host-paced batch's time follows.  Counted
under a dispatch mode on one batch after the window."""


def read(run):
    return run.counters.get("aten_ops_per_batch")
