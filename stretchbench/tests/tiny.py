"""The benchmark's cells cut to sizes a CPU test run holds: the same
operators, pipeline, runtime, controller and checks."""

from __future__ import annotations

import time

from stretchbench import run as cli
from stretchbench import spec

SIZES = {
    "q1-wordcount": dict(tick=64, k_virt=512, out_cap=512, stash_cap=64,
                         super_batch=4, n_max=8),
    "q3-scalejoin": dict(tick=16, k_virt=128, ring=16, ws_ms=800,
                         band=500.0, out_cap=512, stash_cap=32, n_max=8),
}
TRAFFIC = dict(pool_ticks=24, sample_superbatches=4, settle_s=0.5,
               reconfig={"first": 2, "every": 3, "n_active": [4, 8]})


def cell(workload: str) -> dict:
    c = spec.cell(workload)
    c["cfg"].update(SIZES[c["config"]["name"]])
    c["traffic"].update(TRAFFIC)
    if c["traffic"]["loop"] == "open":
        c["traffic"]["rate_tuples_per_s"] = 200.0
    return c


def result(workload: str, seconds: float = 2.5, trace: bool = False,
           wrap=None, seed: int = 2**31 + 12345) -> dict:
    return cli.result(cell(workload), seed, seconds, trace, "cpu",
                      t_start=time.perf_counter(), wrap=wrap)
