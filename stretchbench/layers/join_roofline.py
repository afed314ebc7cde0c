"""The join tick's share of its roofline: the least time of the traced
ticks' join work (``roofline.join_tick``, from the comparisons the inputs
need), over the device time of every kernel of the traced window but the
merge's.  That time holds the join's tick (``join.tick_fast``, plain
PyTorch operations) with the pipeline's small epoch and gate operations
around it, so the share is a lower bound."""

from stretchbench.layers._kernels import MERGE, is_copy, time_and_count


def read(run):
    t, n = time_and_count(run, lambda name: MERGE not in name
                          and not is_copy(name))
    if not n or t <= 0 or not run.least.get("join"):
        return None
    return float(100.0 * run.least["join"] / t)
