"""The card's idle share of the traced window, in %: 1 − (the union of its
device operations' intervals) / (the window's length)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0
