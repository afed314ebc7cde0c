"""The 95th percentile, over every tick the window offered (due inside it),
of the time from the tick being due (its last tuple due at the source; in
a closed loop, when the runtime took it) to the sink accepting its
outputs, however late: the runtime drains every tick it took before the
run ends.  A tick never accepted leaves the metric out."""

import numpy as np


def read(run):
    if not len(run.accept) or not np.isfinite(run.accept).all():
        return None
    return float(np.percentile(run.accept - run.due, 95) * 1e3)
