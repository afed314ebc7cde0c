"""The control: the reference put in the program's place with one of the
deployment's guarantees broken, judged by the numbers a run compares.

    python3 -m stretchbench.control --workload <cell> --seeds 1,2,3 --superbatches <n>

For each seed it follows the cell's stream over set-up and ``n``
super-batches (a run's count at the cell's size), takes the sample a
run's sink would, judges it by a run's check, and prints one JSON line
with the numbers compared and ``correct``.  Q1's control loses, at each switch, what the moved keys
had counted (a shared-nothing switch without state transfer: the VSN
guarantee broken); Q3's decides the band on bfloat16 attributes (the
precision below the deployment's float32).  A control that passes a
limit does not separate the limit's two readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from stretchbench import harness, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m stretchbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--superbatches", type=int, required=True)
    a = p.parse_args(argv)
    c = spec.cell(a.workload)
    kind = spec.kind(c["cfg"]["kind"])
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        nums = harness.run_control(
            c["cfg"], c["traffic"], kind, seed=seed, n_sb=a.superbatches,
            n_sample=int(c["traffic"]["sample_superbatches"]))
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": nums, "limits": c["cfg"]["limits"],
                          "correct": harness.verdict(
                              nums, c["cfg"]["limits"]),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
