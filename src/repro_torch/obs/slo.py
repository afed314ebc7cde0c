"""SLO rule engine over registry quantile sketches.

Rules evaluate *windowed* views of a registry histogram (e.g. the p99 of
``span.runtime.drain`` over the last 30s) rather than full-run quantiles,
so a latency regression mid-run breaches promptly instead of being diluted
by a long healthy prefix.  Windowing works on the sketch itself: the engine
keeps a short deque of (timestamp, bucket-counts) snapshots per rule and
evaluates quantiles over the bucket-count *deltas* inside the window —
O(buckets) per evaluation, no per-observation state.

Two rule kinds:

- ``threshold``: windowed q-quantile of the metric > ``threshold``.
- ``burn_rate``: the fraction of windowed observations above ``threshold``
  divided by the error ``budget`` (allowed violating fraction) must stay
  below ``burn_limit`` — the standard burn-rate alert shape (a burn rate
  of 1.0 consumes exactly the budget; >1 burns it faster).

Breaches are recorded as (unsampled) flight events + ``slo.breach.*``
counters, trigger a cooldown-gated flight dump, and are surfaced to the
runtime so ``LiveMetrics.slo_breaches`` reaches
``controller.observe_live`` — closing the signal→reaction loop.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from .registry import BUCKET_BOUNDS, _N_BUCKETS, MetricsRegistry


@dataclass
class SloRule:
    """One SLO rule over a registry histogram (JSON-serializable)."""
    name: str
    metric: str                       # histogram name, e.g. "span.runtime.drain"
    threshold: float                  # seconds (or metric unit)
    kind: str = "threshold"           # "threshold" | "burn_rate"
    quantile: float = 0.99            # threshold rules: windowed quantile
    window_s: float = 30.0
    budget: float = 0.01              # burn_rate: allowed violating fraction
    burn_limit: float = 1.0           # burn_rate: breach when burn >= limit
    min_count: int = 8                # min windowed observations to evaluate
    cooldown_s: float = 5.0           # min seconds between breaches

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "metric": self.metric,
            "threshold": self.threshold, "kind": self.kind,
            "quantile": self.quantile, "window_s": self.window_s,
            "budget": self.budget, "burn_limit": self.burn_limit,
            "min_count": self.min_count, "cooldown_s": self.cooldown_s,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SloRule":
        names = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class SloBreach:
    """One breach observation handed to ``controller.observe_live``."""
    rule: str
    metric: str
    kind: str
    value: float                      # observed quantile / burn rate
    threshold: float                  # breached limit (threshold / burn_limit)
    t: float                          # wall time of detection

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "metric": self.metric, "kind": self.kind,
                "value": self.value, "threshold": self.threshold,
                "t": self.t}


class _RuleState:
    __slots__ = ("rule", "window", "last_breach_t", "breaches")

    def __init__(self, rule: SloRule):
        self.rule = rule
        # (t, counts-copy, count) snapshots bounding the rule's window
        self.window: deque = deque()
        self.last_breach_t = -math.inf
        self.breaches = 0


def _windowed_quantile(deltas: List[int], total: int, q: float) -> float:
    """q-quantile (geometric bucket midpoint) over bucket-count deltas."""
    rank = max(1, math.ceil(q * total))
    acc = 0
    for i, c in enumerate(deltas):
        acc += c
        if acc >= rank:
            if i == 0:
                return BUCKET_BOUNDS[0]
            if i >= _N_BUCKETS:
                return BUCKET_BOUNDS[-1]
            return math.sqrt(BUCKET_BOUNDS[i - 1] * BUCKET_BOUNDS[i])
    return BUCKET_BOUNDS[-1]           # pragma: no cover


def _violating_fraction(deltas: List[int], total: int,
                        threshold: float) -> float:
    """Fraction of windowed observations whose bucket lies above the
    threshold (bucket granularity: the bucket containing the threshold
    counts as violating only above its upper bound)."""
    first_bad = bisect.bisect_right(BUCKET_BOUNDS, threshold)
    bad = sum(deltas[first_bad:])
    return bad / total


class SloEngine:
    """Evaluates a set of ``SloRule``s against one registry."""

    def __init__(self, rules: List[SloRule]):
        self._states = [_RuleState(r) for r in rules]
        self.total_breaches = 0

    @classmethod
    def from_dicts(cls, dicts: List[Dict]) -> "SloEngine":
        return cls([SloRule.from_dict(d) for d in dicts])

    @property
    def rules(self) -> List[SloRule]:
        return [st.rule for st in self._states]

    def evaluate(self, registry: MetricsRegistry,
                 now: Optional[float] = None) -> List[SloBreach]:
        """Evaluate every rule once; returns new breaches (cooldown-gated
        per rule).  Cheap when metrics are absent or under min_count."""
        t = time.time() if now is None else now
        breaches: List[SloBreach] = []
        for st in self._states:
            rule = st.rule
            h = registry.histograms.get(rule.metric)
            if h is None or h.count == 0:
                continue
            # append the current sketch state, expire beyond the window
            st.window.append((t, list(h.counts), h.count))
            while (len(st.window) > 2
                   and t - st.window[1][0] > rule.window_s):
                st.window.popleft()
            base_t, base_counts, base_count = st.window[0]
            n = h.count - base_count
            if len(st.window) == 1 or t - base_t > 4 * rule.window_s:
                # first sight of this metric (no in-window baseline yet):
                # fall back to the full-sketch view so a run shorter than
                # the window still evaluates
                base_counts = [0] * len(h.counts)
                n = h.count
            if n < rule.min_count:
                continue
            deltas = [c - b for c, b in zip(h.counts, base_counts)]
            if rule.kind == "burn_rate":
                frac = _violating_fraction(deltas, n, rule.threshold)
                burn = frac / max(rule.budget, 1e-12)
                breached = burn >= rule.burn_limit
                value, limit = burn, rule.burn_limit
            else:
                value = _windowed_quantile(deltas, n, rule.quantile)
                breached = value > rule.threshold
                limit = rule.threshold
            if breached and t - st.last_breach_t >= rule.cooldown_s:
                st.last_breach_t = t
                st.breaches += 1
                self.total_breaches += 1
                breaches.append(SloBreach(
                    rule=rule.name, metric=rule.metric, kind=rule.kind,
                    value=float(value), threshold=float(limit), t=t))
        return breaches

    def snapshot(self) -> Dict:
        """Per-rule breach totals (mirrored into the registry by Obs)."""
        return {st.rule.name: {"breaches": st.breaches,
                               "metric": st.rule.metric,
                               "kind": st.rule.kind}
                for st in self._states}
