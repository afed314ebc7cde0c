"""``segment_aggregate``'s share of its roofline: each launch of the
traced window at the least time of one instance's call
(``roofline.segment_aggregate_call``), over those launches' device
time."""

from stretchbench.layers._kernels import time_and_count


def read(run):
    t, n = time_and_count(run, lambda name: "segment_aggregate" in name)
    if not n or t <= 0 or "segment_aggregate_call" not in run.least:
        return None
    return float(100.0 * n * run.least["segment_aggregate_call"] / t)
