"""A stream through the ScaleGate merge and the epoch protocol, in NumPy.

The semantics the port implements, from the paper:

* merge (§2.4): each source's tuples arrive sorted by event time; the
  watermark ``W`` is the smallest over the sources of the latest event
  time seen from each; a tick releases every tuple not yet released with
  ``tau <= W``; the rest wait;
* reconfiguration (§5, Alg. 5-6): a decision injected with a tick is one
  control tuple a source, stamped with the latest event time the runtime
  handed the pipeline from that source; once released, the newest
  decision whose epoch is above the operator's is adopted with ``gamma``,
  the largest stamp among its control tuples; the tick whose released data
  reach past ``gamma`` switches to its instance set and key map;
* load (§8.4): an instance's load in a tick is the number of (released
  data tuple, key) entries whose key it owns under the key map in effect
  before that tick's switch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

INF = np.iinfo(np.int32).max


class GateModel:
    """Ticks in, per tick: the released tuples' ids, the switch flag and
    the per-instance load.  ``frontier0`` is the per-source latest event
    time before the first tick; ``fmu0`` the key map in effect;
    ``keys_of(ids)`` the key columns of the tuples ``ids`` (-1 for none)."""

    def __init__(self, n_sources: int, frontier0, fmu0: np.ndarray,
                 n_max: int, keys_of: Callable[[np.ndarray], np.ndarray]):
        self.n_sources = n_sources
        self.frontier = np.asarray(frontier0, np.int64).copy()
        self.fmu = np.asarray(fmu0, np.int64).copy()
        self.n_max = n_max
        self.keys_of = keys_of
        self.e = 0
        self.e_next = 0
        self.fmu_next = self.fmu
        self.gamma = INF
        self.tables: Dict[int, np.ndarray] = {}
        # waiting tuples: ids (-1 - source for a control tuple), taus,
        # epochs
        self.w_ids = np.zeros((0,), np.int64)
        self.w_tau = np.zeros((0,), np.int64)
        self.w_epoch = np.zeros((0,), np.int64)
        self.stash_high = 0
        self.last_switch = None

    def step(self, ids: np.ndarray, tau: np.ndarray, src: np.ndarray,
             inject: Optional[dict] = None):
        """One tick of data tuples ``ids`` (event times ``tau``, sources
        ``src``), with a decision ``inject`` (``epoch``, ``fmu``) riding on
        it.  Returns ``(released ids, switched, load)``."""
        tau = np.asarray(tau, np.int64)
        c_ids, c_tau, c_ep = [], [], []
        if inject is not None:
            self.tables[int(inject["epoch"])] = np.asarray(inject["fmu"],
                                                          np.int64)
            for i in range(self.n_sources):
                c_ids.append(-1 - i)
                c_tau.append(self.frontier[i])
                c_ep.append(int(inject["epoch"]))
        for i in range(self.n_sources):
            sel = src == i
            if sel.any():
                m = int(tau[sel].max())
                self.frontier[i] = max(self.frontier[i], m)
        w = int(self.frontier.min())
        all_ids = np.concatenate([self.w_ids, np.asarray(ids, np.int64),
                                  np.asarray(c_ids, np.int64)])
        all_tau = np.concatenate([self.w_tau, tau,
                                  np.asarray(c_tau, np.int64)])
        all_ep = np.concatenate([self.w_epoch, np.zeros(len(ids), np.int64),
                                 np.asarray(c_ep, np.int64)])
        ready = all_tau <= w
        self.w_ids, self.w_tau, self.w_epoch = (all_ids[~ready],
                                                all_tau[~ready],
                                                all_ep[~ready])
        self.stash_high = max(self.stash_high, len(self.w_ids))
        r_ids, r_tau, r_ep = all_ids[ready], all_tau[ready], all_ep[ready]
        ctrl = r_ids < 0
        if ctrl.any():
            newest = int(r_ep[ctrl].max())
            if newest > self.e:
                self.e_next = newest
                self.fmu_next = self.tables[newest]
                self.gamma = int(r_tau[ctrl & (r_ep == newest)].max())
        data = r_ids[~ctrl]
        keys = self.keys_of(data)
        k = keys[keys >= 0]
        load = np.bincount(self.fmu[k], minlength=self.n_max).astype(
            np.int64)
        w_end = int(r_tau[~ctrl].max()) if data.size else 0
        switched = self.e_next > self.e and w_end > self.gamma
        if switched:
            # what the switch changed, for the control's state loss
            self.last_switch = (self.gamma, self.fmu, self.fmu_next)
            self.e, self.fmu, self.gamma = self.e_next, self.fmu_next, INF
        return data, r_tau[~ctrl], bool(switched), load
