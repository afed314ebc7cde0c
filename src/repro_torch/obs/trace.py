"""Span tracer: nested spans, per-stage latency quantiles, cross-process
propagation.

A span is opened with ``Tracer.span(name)`` (context manager). On close it
(1) folds its duration into the registry histogram ``span.<name>`` — the
per-tick stage-latency breakdown the controller/serving tier reads — and
(2) appends a finished-span record to a bounded ring for export/debug.
Nesting is tracked per-thread: the parent name is joined into the record so
a dump reads ``runtime.dispatch/pipeline.step``.

Disabled cost: when the tracer is off, ``span()`` returns a singleton
null context manager — one attribute load + two no-op calls, no
allocation — so instrumented hot paths stay within the <2% gate.

Cross-process: a child tracer's finished spans are shipped as plain dicts
(``drain()``) over the ingest channels and folded into the parent with
``ingest()`` (durations re-observed into the parent registry, records
tagged with the child pid).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import MetricsRegistry


class _NullSpan:
    """Singleton no-op context manager returned when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "path", "t0", "_local")

    def __init__(self, tracer: "Tracer", name: str, local):
        self.tracer = tracer
        self.name = name
        self._local = local
        parent = local.stack[-1].path if local.stack else ""
        self.path = f"{parent}/{name}" if parent else name
        self.t0 = 0.0

    def __enter__(self):
        self._local.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = self._local.stack
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._finish(self, dur)
        return False


class Tracer:
    """Per-process span tracer writing into a shared MetricsRegistry."""

    def __init__(self, registry: MetricsRegistry, enabled: bool = True,
                 span_cap: int = 2048, sampler=None):
        self.registry = registry
        self.enabled = enabled
        self.finished: deque = deque(maxlen=span_cap)
        self._tls = threading.local()
        self._pid = os.getpid()
        # optional HeadSampler: thins the finished-record ring only —
        # the span.* histogram observation below always runs, so stage
        # quantiles stay exact under sampling
        self.sampler = sampler

    def _local(self):
        local = self._tls
        if not hasattr(local, "stack"):
            local.stack = []
        return local

    def span(self, name: str):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, self._local())

    def _finish(self, span: _Span, dur: float) -> None:
        self.registry.observe(f"span.{span.name}", dur)
        if self.sampler is not None and not self.sampler.admit_span(
                span.name):
            return
        self.finished.append({
            "name": span.name,
            "path": span.path,
            "dur_s": dur,
            "t_end": time.perf_counter(),
            "wall_end": time.time(),
            "pid": self._pid,
        })

    # -- cross-process shipping ---------------------------------------------
    def drain(self) -> List[Dict]:
        """Pop all finished-span records (child-side shipping)."""
        out = []
        while self.finished:
            out.append(self.finished.popleft())
        return out

    def ingest(self, spans: List[Dict],
               wall_offset: float = 0.0) -> None:
        """Fold spans shipped from a child process into this tracer:
        re-observe durations into the registry and keep the records.
        ``wall_offset`` (parent_wall - child_wall at handshake) shifts the
        child's ``wall_end`` stamps into the parent clock domain so merged
        timelines sort monotonically."""
        for s in spans:
            self.registry.observe(f"span.{s['name']}", s["dur_s"])
            if wall_offset and "wall_end" in s:
                s["wall_end"] = s["wall_end"] + wall_offset
            self.finished.append(s)

    def stage_latency_ms(self) -> Dict[str, Dict[str, float]]:
        """Per-stage latency breakdown {stage: {p50,p90,p99,mean}} in ms,
        derived from the span.* histograms."""
        out = {}
        for name, h in sorted(self.registry.histograms.items()):
            if not name.startswith("span.") or h.count == 0:
                continue
            out[name[len("span."):]] = {
                "p50": h.quantile(0.50) * 1e3,
                "p90": h.quantile(0.90) * 1e3,
                "p99": h.quantile(0.99) * 1e3,
                "mean": h.sum / h.count * 1e3,
                "count": float(h.count),
            }
        return out
