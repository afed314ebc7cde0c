"""MetricsRegistry: counters, gauges, and quantile-sketch histograms.

One registry instance backs the whole observability layer: the tracer folds
span durations into it, the flight recorder and ``MetricsBus`` mirror their
counts into it, and the export side renders it as a *versioned-schema*
snapshot — JSON (``snapshot()``, validated by ``validate_snapshot``) and
Prometheus text exposition (``to_prometheus()``).

The histogram is a geometric-bucket sketch (ratio 2^(1/8) ≈ 9% bucket
width, quantile error ≤ ~4.5% after midpoint interpolation): recording is
O(1) (one ``bisect`` over a precomputed bound table), memory is fixed, and
a long run never grows state — the property ``MetricsBus`` leans on to cap
its per-tick retention while keeping exact totals and full-run quantiles.

Cross-process: a child registry ships counter *deltas* (``drain_counters``)
over the ingest channels; the parent folds them in with
``merge_counters`` — see ``repro_torch.obs.__init__.drain_payload``.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 2
# v1: counters/gauges/histograms.  v2 adds "sampling" (head-sampler
# metadata) and "exemplars" (per-tuple timelines); v1 payloads still
# validate (the new sections are optional for schema_version == 1).
_LEGACY_SCHEMA_VERSIONS = (1,)

# geometric bucket bounds: 1e-7 .. ~1.8e5, ratio 2**(1/8)  (~324 buckets)
_RATIO = 2.0 ** 0.125
_N_BUCKETS = 324
BUCKET_BOUNDS: List[float] = [1e-7 * _RATIO ** i for i in range(_N_BUCKETS)]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-memory geometric-bucket quantile sketch over values > 0
    (zero/negative values land in the first bucket).  Unit-agnostic."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * (_N_BUCKETS + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Approximate q-quantile: geometric midpoint of the bucket holding
        rank ceil(q * count), clamped to the observed [min, max]."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if i == 0:
                    mid = BUCKET_BOUNDS[0]
                elif i >= _N_BUCKETS:
                    mid = BUCKET_BOUNDS[-1]
                else:
                    mid = math.sqrt(BUCKET_BOUNDS[i - 1] * BUCKET_BOUNDS[i])
                return min(max(mid, self.min), self.max)
        return self.max                            # pragma: no cover

    def merge(self, other: "Histogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


class MetricsRegistry:
    """Named counters/gauges/histograms with get-or-create accessors.
    Mutators are GIL-atomic on the instrument objects; creation takes a
    lock (instruments are created once, updated hot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._shipped: Dict[str, float] = {}    # drain_counters watermark

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            with self._lock:
                c = self.counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self._lock:
                g = self.gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.setdefault(name, Histogram())
        return h

    # convenience mutators (the instrumented call sites use these)
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).record(v)

    # -- cross-process shipping ---------------------------------------------
    def drain_counters(self) -> Dict[str, float]:
        """Counter deltas since the last drain (child-side shipping)."""
        out = {}
        for name, c in list(self.counters.items()):
            delta = c.value - self._shipped.get(name, 0.0)
            if delta:
                out[name] = delta
                self._shipped[name] = c.value
        return out

    def merge_counters(self, deltas: Dict[str, float]) -> None:
        for name, d in deltas.items():
            self.counter(name).inc(d)

    # -- export --------------------------------------------------------------
    def snapshot(self, sampling: Optional[Dict] = None,
                 exemplars: Optional[List] = None) -> Dict:
        """The versioned-schema metrics snapshot (see ``snapshot_schema``).

        Taken under the registry lock so an in-run scrape never sees a
        torn instrument table; GIL-atomic mutators keep individual values
        coherent and counters monotone across scrapes.  ``sampling`` /
        ``exemplars`` are the v2 sections filled in by ``Obs.snapshot``
        (defaults keep a bare-registry snapshot schema-valid).
        """
        with self._lock:
            hists = {}
            for name, h in sorted(self.histograms.items()):
                hists[name] = {
                    "count": h.count,
                    "sum": h.sum,
                    "min": (0.0 if h.count == 0 else h.min),
                    "max": (0.0 if h.count == 0 else h.max),
                    "p50": h.quantile(0.50),
                    "p90": h.quantile(0.90),
                    "p99": h.quantile(0.99),
                }
            counters = {n: c.value for n, c in sorted(self.counters.items())}
            gauges = {n: g.value for n, g in sorted(self.gauges.items())}
        return {
            "schema_version": SCHEMA_VERSION,
            "generated_unix": time.time(),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "sampling": dict(sampling) if sampling else {},
            "exemplars": list(exemplars) if exemplars else [],
        }

    def to_prometheus(self, sampling: Optional[Dict] = None) -> str:
        """Prometheus text exposition of the same registry state (metric
        names sanitized; HELP strings and label values escaped per the
        text-format spec; every family — including histogram sketches,
        rendered as summaries — carries a ``# TYPE`` line).  ``sampling``
        metadata (from the head sampler) renders as labeled
        ``obs_sampled_total{kind=...,what=...}`` series."""
        lines = []
        with self._lock:
            counters = sorted((n, c.value) for n, c in self.counters.items())
            gauges = sorted((n, g.value) for n, g in self.gauges.items())
            hists = []
            for name, h in sorted(self.histograms.items()):
                hists.append((name, h.count, h.sum,
                              [(q, h.quantile(q)) for q in (0.50, 0.90,
                                                            0.99)]))
        for name, v in counters:
            n = _sane_metric_name(name)
            lines += [f"# HELP {n} {_escape_help(f'counter {name}')}",
                      f"# TYPE {n} counter", f"{n} {v:g}"]
        for name, v in gauges:
            n = _sane_metric_name(name)
            lines += [f"# HELP {n} {_escape_help(f'gauge {name}')}",
                      f"# TYPE {n} gauge", f"{n} {v:g}"]
        for name, count, total, quants in hists:
            n = _sane_metric_name(name)
            lines += [f"# HELP {n} "
                      f"{_escape_help(f'quantile sketch {name}')}",
                      f"# TYPE {n} summary",
                      f"{n}_count {count}", f"{n}_sum {total:g}"]
            for q, qv in quants:
                lines.append(
                    f'{n}{{quantile="{_escape_label_value(str(q))}"}} '
                    f"{qv:g}")
        if sampling:
            lines += ["# HELP obs_sampled_total exact attempt/kept totals "
                      "per sampled kind",
                      "# TYPE obs_sampled_total counter"]
            for what in ("events", "spans"):
                for kind, st in sorted(sampling.get(what, {}).items()):
                    k = _escape_label_value(kind)
                    w = _escape_label_value(what)
                    lines.append(f'obs_sampled_total{{what="{w}",'
                                 f'kind="{k}",outcome="attempted"}} '
                                 f'{st["attempts"]:g}')
                    lines.append(f'obs_sampled_total{{what="{w}",'
                                 f'kind="{k}",outcome="kept"}} '
                                 f'{st["kept"]:g}')
        return "\n".join(lines) + "\n"


def _sane_metric_name(name: str) -> str:
    return "".join(ch if (ch.isalnum() or ch == "_") else "_"
                   for ch in name)


def _escape_help(s: str) -> str:
    """HELP-string escaping per the Prometheus text format: backslash and
    newline only."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    """Label-value escaping per the Prometheus text format: backslash,
    double-quote, and newline."""
    return (s.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


# ------------------------------------------------------- schema contract --

_HIST_KEYS = ("count", "sum", "min", "max", "p50", "p90", "p99")


def snapshot_schema() -> Dict:
    """JSON-Schema document for ``MetricsRegistry.snapshot()`` — committed
    behavior: bump ``SCHEMA_VERSION`` on any breaking change.

    v2 adds ``sampling`` (head-sampler metadata object) and ``exemplars``
    (array of per-tuple timelines).  v1 snapshots — which lack both —
    still validate for cross-process folding of payloads produced by
    older children; see ``validate_snapshot``.
    """
    num = {"type": "number"}
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "title": f"repro.obs metrics snapshot v{SCHEMA_VERSION}",
        "type": "object",
        "required": ["schema_version", "generated_unix", "counters",
                     "gauges", "histograms", "sampling", "exemplars"],
        "properties": {
            "schema_version": {
                "type": "integer",
                "enum": sorted((*_LEGACY_SCHEMA_VERSIONS, SCHEMA_VERSION)),
            },
            "generated_unix": num,
            "counters": {"type": "object", "additionalProperties": num},
            "gauges": {"type": "object", "additionalProperties": num},
            "histograms": {
                "type": "object",
                "additionalProperties": {
                    "type": "object",
                    "required": list(_HIST_KEYS),
                    "properties": {k: num for k in _HIST_KEYS},
                },
            },
            "sampling": {"type": "object"},
            "exemplars": {"type": "array"},
        },
    }


def validate_snapshot(snap: Dict) -> None:
    """Structural validation of a snapshot against the schema contract
    (dependency-free implementation of exactly what ``snapshot_schema``
    declares; raises ``ValueError`` on the first violation).

    Accepts the current version and the legacy v1 layout (for which the
    v2-only ``sampling``/``exemplars`` sections are optional)."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be an object, got {type(snap)}")
    for key in ("schema_version", "generated_unix", "counters", "gauges",
                "histograms"):
        if key not in snap:
            raise ValueError(f"snapshot missing required key {key!r}")
    version = snap["schema_version"]
    if version != SCHEMA_VERSION and version not in _LEGACY_SCHEMA_VERSIONS:
        raise ValueError(f"schema_version {version!r} not in "
                         f"{(*_LEGACY_SCHEMA_VERSIONS, SCHEMA_VERSION)}")
    if not isinstance(snap["generated_unix"], (int, float)):
        raise ValueError("generated_unix must be a number")
    if version >= 2:
        for key in ("sampling", "exemplars"):
            if key not in snap:
                raise ValueError(f"v{version} snapshot missing required "
                                 f"key {key!r}")
    if "sampling" in snap and not isinstance(snap["sampling"], dict):
        raise ValueError("sampling must be an object")
    if "exemplars" in snap and not isinstance(snap["exemplars"], list):
        raise ValueError("exemplars must be an array")
    for section in ("counters", "gauges"):
        if not isinstance(snap[section], dict):
            raise ValueError(f"{section} must be an object")
        for name, v in snap[section].items():
            if not isinstance(v, (int, float)):
                raise ValueError(f"{section}[{name!r}] must be a number, "
                                 f"got {type(v)}")
    if not isinstance(snap["histograms"], dict):
        raise ValueError("histograms must be an object")
    for name, h in snap["histograms"].items():
        if not isinstance(h, dict):
            raise ValueError(f"histograms[{name!r}] must be an object")
        for k in _HIST_KEYS:
            if k not in h:
                raise ValueError(f"histograms[{name!r}] missing {k!r}")
            if not isinstance(h[k], (int, float)):
                raise ValueError(f"histograms[{name!r}][{k!r}] must be a "
                                 f"number")
