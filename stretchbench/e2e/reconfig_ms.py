"""Over the reconfigurations that completed in the window: the mean time
from the controller's decision to the sink accepting the super-batch whose
tick switched (the first tick at or after the decision's tick with the
switch flag set)."""

import numpy as np


def read(run):
    flags = run.program_flags
    times = []
    for d in run.decisions:
        first = d["tick"]
        hit = np.nonzero(flags[first:])[0]
        if not hit.size:
            continue
        done = run.sink_accepted.get((first + int(hit[0])) // run.k)
        if done is not None and run.t0 <= done <= run.t_end:
            times.append(done - d["t"])
    return float(np.mean(times) * 1e3) if times else None
