"""Sink adapters: where the pipeline's per-tick ``Outputs`` land.

Held against ``src/repro/io/sinks.py``.  ``flatten_outputs`` gives the
sorted-multiset currency of every parity check (``(tau, payload rounded to
4 decimals)`` per valid lane); ``CollectSink`` keeps the tick outputs as
device tensors and materializes the multiset in ``results()``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def flatten_outputs(outs) -> List[Tuple[int, tuple]]:
    """(tau, rounded payload tuple) for every valid lane; flat and
    per-instance stacked Outputs alike (any leading dims)."""
    tau = outs.tau.cpu().numpy().reshape(-1)
    val = outs.valid.cpu().numpy().reshape(-1)
    pay = outs.payload.cpu().numpy()
    pay = pay.reshape(-1, pay.shape[-1])
    return [(int(t), tuple(np.round(p, 4)))
            for t, p, ok in zip(tau, pay, val) if ok]


class CollectSink:
    """Retains every tick's outputs; ``results()`` materializes the sorted
    output multiset, optionally for ``since_tick <= tick_id < before_tick``."""

    def __init__(self):
        self._held = []            # (tick_id, outs_pre, outs_post)
        self.ticks = 0

    def accept(self, tick_id: int, outs_pre, outs_post) -> None:
        self._held.append((tick_id, outs_pre, outs_post))
        self.ticks += 1

    def results(self, *, before_tick: Optional[int] = None,
                since_tick: Optional[int] = None) -> List[Tuple[int, tuple]]:
        res: List[Tuple[int, tuple]] = []
        for tick_id, o1, o2 in self._held:
            if before_tick is not None and tick_id >= before_tick:
                continue
            if since_tick is not None and tick_id < since_tick:
                continue
            res += flatten_outputs(o1) + flatten_outputs(o2)
        return sorted(res)
