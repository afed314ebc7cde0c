"""Host time of ``VSNPipeline.stage_super`` (stacking K ticks in pinned
memory and starting their copy), the mean over the window's calls, timed
around the call by the benchmark."""

import numpy as np


def read(run):
    s = [b - a for name, a, b in run.spans
         if name == "ingest:stage_super" and run.t0 <= a <= run.t_end]
    return float(np.mean(s) * 1e3) if s else None
