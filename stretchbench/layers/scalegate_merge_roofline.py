"""The merge's share of its roofline: each ``scalegate_merge`` launch of
the traced window at the least time of its call (``roofline.merge_call``:
the stash and one tick), over those launches' device time."""

from stretchbench.layers._kernels import MERGE, time_and_count


def read(run):
    t, n = time_and_count(run, lambda name: MERGE in name)
    if not n or t <= 0:
        return None
    return float(100.0 * n * run.least["merge_call"] / t)
