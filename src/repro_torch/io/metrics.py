"""MetricsBus: the per-tick signal aggregator the control loop reads.

Held against ``src/repro/io/metrics.py`` (the same class, numpy only).

Every tick the runtime records what it actually observed — tuples ingested,
dispatch-to-ready service latency, per-instance load, queue depth — and the
bus turns that into (a) the ``LiveMetrics`` snapshot fed to the elasticity
controllers (§8.4-§8.5: they see *live* signals, not a pre-staged trace)
and (b) the run report quantiles (throughput, tick latency p50/p99,
detection→switch latency) the benchmarks publish.

Retention is bounded: ``records`` keeps only the last ``retain`` full
``TickRecord``s (a long live run no longer accretes one object per tick
forever) while exact totals (``n_ticks``, ``total_tuples``) and a
fixed-memory quantile sketch of tick latency are maintained for the whole
run — so the run report is still full-run accurate.  While nothing has
been evicted the latency quantiles use the exact per-record percentile
path; after eviction they fall back to the sketch (≤~4.5% bucket error).

The bus is also a thin consumer of the ``repro_torch.obs`` registry: when an
``Obs`` is installed, per-tick signals are mirrored into it
(``bus.ticks``/``bus.tuples`` counters, ``bus.tick_latency`` histogram,
queue-depth gauge) so the exported snapshot and the run report agree.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core.controller import LiveMetrics
from repro_torch.obs.registry import Histogram


@dataclasses.dataclass
class TickRecord:
    tick_id: int
    n_tuples: int
    latency_s: float               # dispatch -> results-ready wall time
    inst_load: Optional[np.ndarray]
    n_active: int                  # committed active count the load was
    #                                measured under (pairs with inst_load)
    queue_depth: int
    t_done: float                  # wall clock at drain


class MetricsBus:
    def __init__(self, window: int = 64, queue_cap: int = 0,
                 retain: int = 1024):
        self.window = window
        self.queue_cap = queue_cap
        # rolling retention for derived signals; exact run totals live in
        # n_ticks / total_tuples / the latency sketch below
        self.retain = max(retain, window)
        self.records: Deque[TickRecord] = deque(maxlen=self.retain)
        self.n_ticks = 0
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.total_tuples = 0
        self._lat_sketch = Histogram()         # full-run latency (seconds)
        # detection -> switch accounting: a controller decision is
        # "detected" when its Reconfiguration is injected; "switched" when
        # the runtime first observes switched=True for it (Alg. 4's
        # watermark barrier having passed gamma).  Entries carry the rc so
        # record_switch can hand the caller what the switch committed.
        self._pending_detections: List[tuple] = []  # (epoch, t_wall, tick, rc)
        self.detect_to_switch_ms: List[float] = []
        self.detect_to_switch_ticks: List[int] = []
        # detections whose switch never committed (superseded at shutdown
        # or runtime stopped mid-epoch), flushed here by stop()
        self.unresolved_detections: List[tuple] = []

    # -- recording ----------------------------------------------------------
    def start(self):
        self.t_start = time.perf_counter()

    def stop(self):
        self.t_end = time.perf_counter()
        # flush the pending-detection leak: anything still here never
        # observed its switch — surface it instead of dropping it silently
        if self._pending_detections:
            self.unresolved_detections.extend(self._pending_detections)
            self._pending_detections = []
            _obs.event("unresolved_detections",
                       n=len(self.unresolved_detections),
                       ticks=[d[2] for d in self.unresolved_detections])
            _obs.counter_inc("bus.unresolved_detections",
                             len(self.unresolved_detections))

    def record_tick(self, tick_id: int, n_tuples: int, latency_s: float,
                    inst_load: Optional[np.ndarray], queue_depth: int,
                    n_active: int = 0):
        self.records.append(TickRecord(tick_id, n_tuples, latency_s,
                                       inst_load, n_active, queue_depth,
                                       time.perf_counter()))
        self.n_ticks += 1
        self.total_tuples += int(n_tuples)
        self._lat_sketch.record(latency_s)
        o = _obs.get()
        if o is not None:
            reg = o.registry
            reg.inc("bus.ticks")
            reg.inc("bus.tuples", n_tuples)
            reg.observe("bus.tick_latency_s", latency_s)
            reg.set_gauge("bus.queue_depth", queue_depth)
            reg.set_gauge("bus.n_active", n_active)

    def record_detection(self, epoch: int, tick_id: int, rc=None):
        self._pending_detections.append(
            (epoch, time.perf_counter(), tick_id, rc))
        _obs.counter_inc("bus.detections")

    def record_switch(self, tick_id: int):
        """One observed epoch switch resolves EVERY detection made at or
        before its tick: back-to-back reconfigurations coalesce into a
        single switch (prepare_reconfig keeps the latest, Theorem 4), so
        each superseded decision also completed here.  Returns the resolved
        Reconfigurations, oldest first — the LAST one is what the switch
        committed (latest wins)."""
        now = time.perf_counter()
        resolved = [d for d in self._pending_detections if d[2] <= tick_id]
        self._pending_detections = [d for d in self._pending_detections
                                    if d[2] > tick_id]
        for _, t0, tick0, _rc in resolved:
            self.detect_to_switch_ms.append((now - t0) * 1e3)
            self.detect_to_switch_ticks.append(tick_id - tick0)
            _obs.observe("bus.detect_to_switch_s", now - t0)
        if resolved:
            _obs.counter_inc("bus.switches")
        return [rc for _, _, _, rc in resolved if rc is not None]

    # -- derived ------------------------------------------------------------
    def measured_rate_tps(self) -> float:
        """Ingest rate over the recent window (tuples / wall time)."""
        if len(self.records) < 2:
            return 0.0
        recs = list(self.records)[-self.window:]
        if len(recs) < 2:
            return 0.0
        dt = recs[-1].t_done - recs[0].t_done
        n = sum(r.n_tuples for r in recs[1:])
        return n / max(dt, 1e-9)

    def latency_quantiles_ms(self):
        """Full-run tick-latency (p50, p99) in ms.  Exact while no record
        has been evicted; sketch-approximated (≤~4.5%) afterwards."""
        if self.n_ticks == 0:
            return 0.0, 0.0
        if self.n_ticks <= len(self.records):
            lats = np.asarray([r.latency_s for r in self.records]) * 1e3
            return (float(np.percentile(lats, 50)),
                    float(np.percentile(lats, 99)))
        return (self._lat_sketch.quantile(0.50) * 1e3,
                self._lat_sketch.quantile(0.99) * 1e3)

    def throughput_tps(self) -> float:
        if self.t_start is None:
            return 0.0
        dt = (self.t_end or time.perf_counter()) - self.t_start
        return self.total_tuples / max(dt, 1e-9)

    def snapshot(self, rate_hint: Optional[float] = None,
                 queue_depth: int = 0,
                 backlog_tuples: float = 0.0,
                 slo_breaches: tuple = ()) -> LiveMetrics:
        """The controller-facing view of 'now'.  ``rate_hint`` (the offered
        rate, when the source knows it) takes precedence over the measured
        rate so closed-loop drills are deterministic; live deployments pass
        None and get the measured signal.  ``inst_load`` and
        ``n_active_observed`` come from the same record, so a load sample
        is always judged against the active set it was measured under.
        ``slo_breaches`` — new SLO-engine breaches since the last decision
        (repro_torch.obs.slo.SloBreach) — ride along so policies can react to
        objective violations, not just raw load."""
        last = self.records[-1] if self.records else None
        return LiveMetrics(
            rate_tps=(rate_hint if rate_hint is not None
                      else self.measured_rate_tps()),
            inst_load=None if last is None else last.inst_load,
            n_active_observed=0 if last is None else last.n_active,
            queue_depth=queue_depth,
            queue_cap=self.queue_cap,
            backlog_tuples=backlog_tuples,
            tick_latency_s=0.0 if last is None else last.latency_s,
            slo_breaches=tuple(slo_breaches))
