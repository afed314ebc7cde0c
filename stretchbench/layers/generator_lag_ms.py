"""How late the open-loop source handed ticks over against its schedule:
the mean over the window's ticks of (handed over - due)."""

import numpy as np


def read(run):
    if run.traffic["loop"] != "open" or not len(run.due):
        return None
    return float(np.mean(run.taken - run.due) * 1e3)
