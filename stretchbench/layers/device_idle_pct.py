"""The share of the traced window in which no operation ran on the card
(the union of its kernels, copies and fills, against the window)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return float(100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"]))
