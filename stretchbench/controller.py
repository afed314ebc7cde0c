"""The benchmark's scripted elasticity controller.

It stands where the port's controllers (``src/repro_torch/core/
controller.py``) stand in ``AsyncStreamRuntime``: the runtime calls
``observe_live`` once a super-batch (the benchmark's source gives a
``rate_hint``, so the call is made from the first super-batch on) and
injects the ``Reconfiguration`` it returns through the control-tuple path.
The decisions follow the traffic file's schedule instead of the load, so
every run of a cell reconfigures at the same super-batches:
``reconfig.first`` is the first super-batch that reconfigures,
``reconfig.every`` the distance between two, and ``reconfig.n_active`` the
instance counts it alternates between, starting from the second (the
pipeline starts with the first).  ``balanced_fmu`` and ``active_mask``
are frozen copies of the port's.

Each decision is stamped (``decisions``: super-batch, host clock, epoch,
tables), so ``reconfig_ms`` runs from the decision to the sink.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


def balanced_fmu(k_virt: int, n_active: int, n_max: int) -> np.ndarray:
    """controller.py ``balanced_fmu``: keys round-robin over the active
    prefix."""
    del n_max
    return (np.arange(k_virt) % max(n_active, 1)).astype(np.int32)


def active_mask(n_active: int, n_max: int) -> np.ndarray:
    """controller.py ``active_mask``."""
    m = np.zeros((n_max,), bool)
    m[:n_active] = True
    return m


def schedule_at(reconfig: dict, sb: int) -> Optional[int]:
    """The instance count the schedule switches to at super-batch ``sb``,
    or None where it does not reconfigure."""
    first, every = int(reconfig["first"]), int(reconfig["every"])
    if sb < first or (sb - first) % every:
        return None
    counts = reconfig["n_active"]
    return int(counts[(1 + (sb - first) // every) % len(counts)])


class ScriptedController:
    """``make`` builds a decision from its fields: the port's
    ``Reconfiguration`` in a run, any record in the control's, which has
    no program."""

    def __init__(self, reconfig: dict, k_virt: int, n_max: int, make=None):
        if make is None:
            from repro_torch.core.controller import Reconfiguration as make
        self._rc = make
        self.reconfig = reconfig
        self.k_virt, self.n_max = k_virt, n_max
        self.sb = 0                 # super-batches decided so far
        self.epoch = 0
        self.decisions: List[dict] = []

    def observe_live(self, metrics) -> Optional[object]:
        del metrics
        sb, self.sb = self.sb, self.sb + 1
        n = schedule_at(self.reconfig, sb)
        if n is None:
            return None
        self.epoch += 1
        rc = self._rc(epoch=self.epoch, n_active=n,
                      fmu=balanced_fmu(self.k_virt, n, self.n_max),
                      active=active_mask(n, self.n_max))
        self.decisions.append(dict(sb=sb, t=time.perf_counter(),
                                   epoch=self.epoch, n_active=n,
                                   fmu=rc.fmu, active=rc.active))
        return rc
