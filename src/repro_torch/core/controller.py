"""Elasticity controllers (paper §8.4-§8.5).

Held against ``src/repro/core/controller.py`` (numpy only).  STRETCH "does
not embed a specific policy ... but defines a generic API for external
modules" (§3): controllers are host-side Python that observe tick metrics
and emit ``Reconfiguration`` requests (new Pi, f_mu, active set).

* ``ThresholdController``: §8.4 upper/target/lower load thresholds
  (0.90 / 0.70 / 0.45).  Provision the smallest number of new instances
  bringing average load below target; decommission the largest number that
  keeps it below target.
* ``PredictiveController``: §8.5 tightens the band to [0.70, 0.80] and
  sizes against pending + predicted work with the stream-join cost model
  of [22]: per-tuple cost grows linearly with the window population
  (rate x WS), so required capacity ~ rate^2 * WS / throughput_per_instance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Reconfiguration:
    epoch: int
    n_active: int
    fmu: np.ndarray       # i32[K]
    active: np.ndarray    # bool[n_max]


@dataclasses.dataclass(frozen=True)
class LiveMetrics:
    """One tick's worth of runtime signals, as sampled by the live loop
    (``io.metrics.MetricsBus`` builds these).  This is the §3 'generic API for
    external modules' made concrete: controllers never see the stream, only
    this snapshot."""
    rate_tps: float                          # offered/measured ingest rate
    inst_load: Optional[np.ndarray] = None   # per-instance work last tick
    n_active_observed: int = 0               # active count inst_load was
    #                                          measured under (the COMMITTED
    #                                          epoch, not a pending decision)
    queue_depth: int = 0                     # staged ticks waiting (backlog)
    queue_cap: int = 0
    backlog_tuples: float = 0.0              # tuples sitting in the queue
    tick_latency_s: float = 0.0
    slo_breaches: tuple = ()                 # new SLO breaches since the
    #                                          last decision (obs.slo
    #                                          SloBreach instances)

    def load_skew(self, n_active: int = None) -> float:
        """max/mean per-instance load (>= 1): a skewed f_mu saturates its
        hottest instance before the average rate says so.  The mean is over
        ``n_active`` instances when given (``inst_load`` spans all n_max
        slots, inactive ones zero); else over the loaded ones."""
        if self.inst_load is None:
            return 1.0
        load = np.asarray(self.inst_load, float)
        total = load.sum()
        if total <= 0:
            return 1.0
        n = n_active if n_active else int((load > 0).sum())
        return float(load.max() * max(n, 1) / total)


def balanced_fmu(k_virt: int, n_active: int, n_max: int) -> np.ndarray:
    """Round-robin key -> instance map over the active prefix."""
    return (np.arange(k_virt) % max(n_active, 1)).astype(np.int32)


def active_mask(n_active: int, n_max: int) -> np.ndarray:
    m = np.zeros((n_max,), bool)
    m[:n_active] = True
    return m


@dataclasses.dataclass
class ThresholdController:
    n_max: int
    k_virt: int
    capacity_per_instance: float          # tuples/s one instance sustains
    upper: float = 0.90
    target: float = 0.70
    lower: float = 0.45
    n_active: int = 1
    epoch: int = 0
    slo_breaches_seen: int = 0

    def observe(self, rate: float) -> Optional[Reconfiguration]:
        load = rate / (self.n_active * self.capacity_per_instance)
        desired = self.n_active
        if load > self.upper:
            # smallest provision bringing load below target (§8.4)
            desired = int(np.ceil(rate / (self.target * self.capacity_per_instance)))
        elif load < self.lower:
            # largest decommission staying below target (§8.4)
            desired = max(1, int(np.ceil(
                rate / (self.target * self.capacity_per_instance))))
        desired = min(self.n_max, max(1, desired))
        if desired == self.n_active:
            return None
        self.n_active = desired
        self.epoch += 1
        return Reconfiguration(
            epoch=self.epoch, n_active=desired,
            fmu=balanced_fmu(self.k_virt, desired, self.n_max),
            active=active_mask(desired, self.n_max))

    def observe_live(self, m: LiveMetrics) -> Optional[Reconfiguration]:
        """Closed-loop entry point: fold the live signals into an effective
        rate, then apply the §8.4 thresholds.  Load skew inflates the rate
        (the hottest instance saturates first) and a filling in-flight
        queue signals the pipeline is already behind the offered rate."""
        pressure = 1.0
        if m.queue_cap > 0:
            pressure += m.queue_depth / m.queue_cap
        # an SLO breach is direct evidence the objective is missed at the
        # current capacity, whatever the raw load says: each fresh breach
        # adds scale-up pressure (bounded — breaches are cooldown-gated)
        if m.slo_breaches:
            self.slo_breaches_seen += len(m.slo_breaches)
            pressure += 0.5 * len(m.slo_breaches)
        # skew must be judged against the active set the load was MEASURED
        # under; self.n_active may already hold a not-yet-committed decision
        # (a pending switch), and mixing the two inflates skew and cascades
        # spurious scale-ups under a steady rate.
        skew = m.load_skew(m.n_active_observed or None)
        rc = self.observe(m.rate_tps * skew * pressure)
        if rc is not None:
            from repro_torch import obs as _obs
            _obs.event("controller_decide", policy="threshold",
                       rate_tps=m.rate_tps, skew=skew, pressure=pressure,
                       queue_depth=m.queue_depth, epoch=int(rc.epoch),
                       n_active=int(rc.n_active))
        return rc


@dataclasses.dataclass
class PredictiveController:
    """§8.5: narrower [lower, upper] band + the [22] join cost model.

    Join work per second ~ rate * (window population) = rate^2 * WS (+ the
    pending backlog), so capacity planning uses the *predicted* comparisons
    rather than the instantaneous CPU load.
    """
    n_max: int
    k_virt: int
    comparisons_per_s_per_instance: float
    ws_seconds: float
    lower: float = 0.70
    upper: float = 0.80
    n_active: int = 1
    epoch: int = 0
    backlog: float = 0.0
    slo_breaches_seen: int = 0

    def observe(self, rate: float) -> Optional[Reconfiguration]:
        work = rate * rate * self.ws_seconds + self.backlog   # comparisons/s
        cap = self.n_active * self.comparisons_per_s_per_instance
        load = work / max(cap, 1e-9)
        desired = self.n_active
        if load > self.upper or load < self.lower:
            mid = 0.5 * (self.lower + self.upper)
            desired = int(np.ceil(
                work / (mid * self.comparisons_per_s_per_instance)))
        desired = min(self.n_max, max(1, desired))
        if desired == self.n_active:
            return None
        self.n_active = desired
        self.epoch += 1
        return Reconfiguration(
            epoch=self.epoch, n_active=desired,
            fmu=balanced_fmu(self.k_virt, desired, self.n_max),
            active=active_mask(desired, self.n_max))

    def observe_live(self, m: LiveMetrics) -> Optional[Reconfiguration]:
        """Closed-loop entry point: queued tuples become pending work in
        the [22] cost model (each backlogged tuple will be compared against
        the window population ~ rate * WS), then the §8.5 band applies."""
        self.backlog = m.backlog_tuples * m.rate_tps * self.ws_seconds
        if m.slo_breaches:
            # breaches mean the cost model under-predicted: inflate the
            # pending-work term so the band recomputes capacity upward
            self.slo_breaches_seen += len(m.slo_breaches)
            self.backlog *= 1.0 + 0.5 * len(m.slo_breaches)
        rc = self.observe(m.rate_tps)
        if rc is not None:
            from repro_torch import obs as _obs
            _obs.event("controller_decide", policy="predictive",
                       rate_tps=m.rate_tps, backlog=self.backlog,
                       queue_depth=m.queue_depth, epoch=int(rc.epoch),
                       n_active=int(rc.n_active))
        return rc
