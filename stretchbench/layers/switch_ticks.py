"""Ticks from a reconfiguration's injection to its switch, the switching
tick counted: the mean over the reconfigurations that completed in the
window (the sink accepted the switching super-batch inside it), from the
program's per-tick switch flags."""

import numpy as np


def read(run):
    out = []
    for d in run.decisions:
        first = d["tick"]
        hit = np.nonzero(run.program_flags[first:])[0]
        if not hit.size:
            continue
        done = run.sink_accepted.get((first + int(hit[0])) // run.k)
        if done is not None and run.t0 <= done <= run.t_end:
            out.append(int(hit[0]) + 1)
    return float(np.mean(out)) if out else None
