"""repro_torch.obs — unified observability: tracing, flight recorder,
metrics.

A copy of ``src/repro/obs`` (framework-free: numpy and the standard
library), held against it: snapshots of this registry pass the
reference's ``validate_snapshot``.

One ``Obs`` object bundles the instruments sharing a registry:

- ``obs.registry`` — counters / gauges / quantile-sketch histograms with a
  versioned-schema snapshot (JSON + Prometheus text); see ``registry.py``.
- ``obs.tracer`` — nested spans; per-stage latency quantiles land in
  ``span.*`` histograms; see ``trace.py``.
- ``obs.flight`` — ring buffer of structured events, JSON-dumped on
  crash/chaos failure or on demand; see ``flight.py``.
- ``obs.sampler`` (optional) — adaptive head sampler thinning span/event
  *detail* while counters and histograms stay exact; see ``sample.py``.
- ``obs.timeline`` (optional) — sampled per-tuple exemplar timelines
  (admission → leaf push → root merge → stage → dispatch → drain → emit);
  see ``sample.py``.
- ``obs.slo`` (optional) — threshold/burn-rate rules over registry
  quantiles whose breaches feed ``controller.observe_live`` and trigger
  flight dumps; see ``slo.py``.
- ``obs.server`` (optional) — in-run HTTP scrape endpoint for the
  Prometheus text + JSON snapshot; see ``serve.py``.

A process-global current ``Obs`` is installed with ``install(ObsConfig)``
(or ``set_current`` for an existing instance). Instrumented call sites use
the module-level helpers ``span()`` / ``event()`` / ``counter_inc()`` /
``gauge_set()``: when nothing is installed (the default) they are a single
global load + ``is None`` test, so the off path costs nanoseconds.

Cross-process propagation: a child ingest-leaf process installs its own
``Obs`` (config travels in the worker cfg dict), instruments locally, and
ships ``drain_payload()`` dicts piggybacked on ``LeafOut.obs`` over the
existing channels; the parent folds them in with ``ingest_payload()``.
Payloads carry the child's perf→wall ``clock`` offset so merged timelines
renormalize into one monotone clock domain.  Thread-mode leaves share the
parent's global ``Obs`` directly and must *not* ship payloads (that would
double-count).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .registry import (MetricsRegistry, SCHEMA_VERSION, snapshot_schema,
                       validate_snapshot)
from .trace import Tracer, _NULL_SPAN
from .flight import FlightRecorder
from .sample import ExemplarTimelines, HeadSampler, is_exemplar
from .slo import SloBreach, SloEngine, SloRule

__all__ = [
    "ObsConfig", "Obs", "install", "get", "set_current",
    "span", "event", "counter_inc", "gauge_set", "observe", "exemplars",
    "drain_payload", "ingest_payload",
    "MetricsRegistry", "Tracer", "FlightRecorder",
    "HeadSampler", "ExemplarTimelines", "is_exemplar",
    "SloRule", "SloBreach", "SloEngine",
    "SCHEMA_VERSION", "snapshot_schema", "validate_snapshot",
]


@dataclass
class ObsConfig:
    """Observability knobs carried by ``RuntimeConfig`` (JSON-serializable).

    ``enabled`` turns the layer on (registry + flight recorder); ``trace``
    additionally turns on span timing — the separately-gated cost tier
    (<2% without, <10% with, per the q1 bench row). ``dump_dir`` set makes
    the runtime dump the flight ring there on crash; ``export_dir`` set
    makes ``Runtime.run``/launchers write ``metrics.json`` +
    ``metrics.prom`` there on completion.

    Live-plane knobs (all default-off so the base tiers cost nothing):
    ``serve_port`` starts the in-run scrape endpoint (0 = ephemeral);
    ``event_sample``/``span_sample``/``sample_rates`` thin flight-event /
    finished-span *detail* (counters and histograms stay exact);
    ``event_budget_per_s`` > 0 turns on adaptive backoff under load;
    ``exemplar_rate`` > 0 samples per-tuple end-to-end timelines
    (``exemplar_cap`` bounds the store); ``slo_rules`` is a list of
    ``SloRule.to_dict()`` dicts evaluated live by the runtime.
    """
    enabled: bool = False
    trace: bool = False
    flight: bool = True
    flight_cap: int = 4096
    span_cap: int = 2048
    dump_dir: Optional[str] = None
    export_dir: Optional[str] = None
    serve_port: Optional[int] = None
    event_sample: float = 1.0
    span_sample: float = 1.0
    sample_rates: Optional[Dict[str, float]] = None
    event_budget_per_s: float = 0.0
    exemplar_rate: float = 0.0
    exemplar_cap: int = 64
    slo_rules: Optional[List[Dict]] = None

    def to_dict(self) -> Dict:
        return {
            "enabled": self.enabled, "trace": self.trace,
            "flight": self.flight, "flight_cap": self.flight_cap,
            "span_cap": self.span_cap, "dump_dir": self.dump_dir,
            "export_dir": self.export_dir,
            "serve_port": self.serve_port,
            "event_sample": self.event_sample,
            "span_sample": self.span_sample,
            "sample_rates": self.sample_rates,
            "event_budget_per_s": self.event_budget_per_s,
            "exemplar_rate": self.exemplar_rate,
            "exemplar_cap": self.exemplar_cap,
            "slo_rules": self.slo_rules,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ObsConfig":
        names = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in names})

    def wants_sampler(self) -> bool:
        return (self.event_sample < 1.0 or self.span_sample < 1.0
                or bool(self.sample_rates) or self.event_budget_per_s > 0.0)


class Obs:
    """Bundle of registry + tracer + flight recorder (+ sampler, exemplar
    timelines, SLO engine, scrape server) for one process."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg or ObsConfig(enabled=True)
        self.registry = MetricsRegistry()
        self.flight = FlightRecorder(cap=self.cfg.flight_cap,
                                     enabled=self.cfg.flight)
        self.sampler: Optional[HeadSampler] = None
        if self.cfg.wants_sampler():
            self.sampler = HeadSampler(
                event_sample=self.cfg.event_sample,
                span_sample=self.cfg.span_sample,
                rates=self.cfg.sample_rates,
                budget_per_s=self.cfg.event_budget_per_s)
        self.tracer = Tracer(self.registry, enabled=self.cfg.trace,
                             span_cap=self.cfg.span_cap,
                             sampler=self.sampler)
        self.timeline: Optional[ExemplarTimelines] = None
        if self.cfg.exemplar_rate > 0.0:
            off = self.flight.clock_offset
            self.timeline = ExemplarTimelines(
                self.cfg.exemplar_rate, cap=self.cfg.exemplar_cap,
                clock=lambda: time.perf_counter() + off)
        self.slo: Optional[SloEngine] = None
        if self.cfg.slo_rules:
            self.slo = SloEngine.from_dicts(self.cfg.slo_rules)
        self.server = None

    # -- scrape server -------------------------------------------------------
    def start_server(self, port: Optional[int] = None,
                     host: str = "127.0.0.1"):
        """Start the in-run scrape endpoint (idempotent); returns it."""
        if self.server is None:
            from .serve import ObsServer
            p = self.cfg.serve_port if port is None else port
            self.server = ObsServer(self, port=int(p or 0),
                                    host=host).start()
            self.registry.set_gauge("obs.serve_port", self.server.port)
        return self.server

    def stop_server(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None

    # -- SLO evaluation ------------------------------------------------------
    def evaluate_slo(self, now: Optional[float] = None) -> List[SloBreach]:
        """Run the SLO engine once (no-op without rules).  Breaches are
        recorded as *unsampled* flight events + ``slo.breach.*`` counters
        and trigger a flight dump (when ``dump_dir`` is set); the caller
        (the runtime's drain loop) forwards them to
        ``controller.observe_live`` via ``LiveMetrics.slo_breaches``."""
        if self.slo is None:
            return []
        breaches = self.slo.evaluate(self.registry, now=now)
        for b in breaches:
            # direct ring write: breaches must never be sampled away
            self.flight.record("slo_breach", rule=b.rule, metric=b.metric,
                               slo_kind=b.kind, value=b.value,
                               threshold=b.threshold)
            self.registry.inc("slo.breaches")
            self.registry.inc(f"slo.breach.{b.rule}")
            self.dump_flight(reason=f"slo_breach:{b.rule}")
        return breaches

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict:
        """The schema-v2 snapshot: registry sections + sampling metadata +
        exemplar timelines (lock-consistent against in-flight ticks)."""
        return self.registry.snapshot(
            sampling=(self.sampler.snapshot() if self.sampler else None),
            exemplars=(self.timeline.snapshot() if self.timeline else None))

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus(
            sampling=(self.sampler.snapshot() if self.sampler else None))

    def export(self, out_dir: str) -> Dict[str, str]:
        """Write metrics.json + metrics.prom (+ flight.json when the ring
        has events) under ``out_dir``; returns {artifact: path}."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        snap = self.snapshot()
        jp = os.path.join(out_dir, "metrics.json")
        with open(jp, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
        paths["metrics_json"] = jp
        pp = os.path.join(out_dir, "metrics.prom")
        with open(pp, "w") as f:
            f.write(self.to_prometheus())
        paths["metrics_prom"] = pp
        if self.flight.events:
            paths["flight_json"] = self.flight.dump_json(
                os.path.join(out_dir, "flight.json"), reason="export",
                exemplars=(self.timeline.snapshot()
                           if self.timeline else None))
        return paths

    def dump_flight(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Dump the flight ring (+ exemplar timelines) to ``path`` or
        ``cfg.dump_dir``; returns the written path (None when no
        destination is configured)."""
        if path is None:
            if not self.cfg.dump_dir:
                return None
            name = f"flight-{os.getpid()}.json"
            if reason.startswith("slo_breach"):
                name = f"flight-slo-{os.getpid()}.json"
            path = os.path.join(self.cfg.dump_dir, name)
        return self.flight.dump_json(
            path, reason=reason,
            exemplars=(self.timeline.snapshot() if self.timeline else None))


# ------------------------------------------------ process-global current --

_current: Optional[Obs] = None


def install(cfg: Optional[ObsConfig] = None) -> Obs:
    """Create and install a fresh ``Obs`` as the process-global current
    (regardless of ``cfg.enabled`` — callers gate on that themselves)."""
    global _current
    _current = Obs(cfg)
    return _current


def set_current(obs: Optional[Obs]) -> Optional[Obs]:
    """Install an existing ``Obs`` (or None to disable); returns the
    previous one so callers can restore it (the overhead bench does)."""
    global _current
    prev = _current
    _current = obs
    return prev


def get() -> Optional[Obs]:
    return _current


# ------------------------------------- near-free instrumentation helpers --

def span(name: str):
    """Open a tracing span on the current Obs; no-op singleton if obs or
    tracing is off (one global load + None test on the off path)."""
    o = _current
    if o is None or not o.tracer.enabled:
        return _NULL_SPAN
    return o.tracer.span(name)


def event(kind: str, **fields) -> None:
    o = _current
    if o is None:
        return
    if o.sampler is not None and not o.sampler.admit_event(kind):
        return
    o.flight.record(kind, **fields)


def counter_inc(name: str, n: float = 1.0) -> None:
    o = _current
    if o is None:
        return
    o.registry.inc(name, n)


def gauge_set(name: str, v: float) -> None:
    o = _current
    if o is None:
        return
    o.registry.set_gauge(name, v)


def observe(name: str, v: float) -> None:
    o = _current
    if o is None:
        return
    o.registry.observe(name, v)


def exemplars() -> Optional[ExemplarTimelines]:
    """The current exemplar-timeline store, or None when off — call sites
    hoist this out of per-tuple loops."""
    o = _current
    return None if o is None else o.timeline


# --------------------------------------------- cross-process propagation --

def drain_payload() -> Optional[Dict]:
    """Child-side: pop everything recorded since the last drain into one
    plain-dict payload (None when obs is off or nothing new).  Non-empty
    payloads carry the child's perf→wall ``clock`` offset (the handshake
    ``ingest_payload`` uses to renormalize timelines) and any exemplar
    mark fragments."""
    o = _current
    if o is None:
        return None
    payload = {}
    counters = o.registry.drain_counters()
    if counters:
        payload["counters"] = counters
    spans = o.tracer.drain()
    if spans:
        payload["spans"] = spans
    events = o.flight.drain()
    if events:
        payload["events"] = events
    if o.timeline is not None:
        marks = o.timeline.drain_marks()
        if marks:
            payload["exemplars"] = marks
    if payload:
        payload["clock"] = {"pid": os.getpid(),
                            "offset": o.flight.clock_offset}
    return payload or None


def ingest_payload(payload: Optional[Dict]) -> None:
    """Parent-side: fold a child's drained payload into the current Obs,
    renormalizing child wall stamps through the shipped clock offset so
    merged timelines stay monotone."""
    o = _current
    if o is None or not payload:
        return
    clock = payload.get("clock") or {}
    offset = clock.get("offset")
    if "counters" in payload:
        o.registry.merge_counters(payload["counters"])
    if "spans" in payload:
        spans = payload["spans"]
        if offset is not None:
            for s in spans:
                if "t_end" in s:
                    s["wall_end"] = s["t_end"] + offset
        o.tracer.ingest(spans)
    if "events" in payload:
        o.flight.ingest(payload["events"], clock_offset=offset)
    if "exemplars" in payload and o.timeline is not None:
        o.timeline.ingest_marks(payload["exemplars"])
