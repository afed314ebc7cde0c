"""Adaptive head-based sampling for span/event detail + exemplar timelines.

Two concerns live here, both feeding the schema-v2 snapshot:

``HeadSampler`` decides, at the *head* of each span/event, whether its
detail record (the flight-ring event dict / the tracer's finished-span
dict) is kept.  Sampling thins **detail only**: registry counters and the
``span.*`` duration histograms are always updated, so exact totals and the
quantiles the SLO engine reads stay bit-identical to an unsampled run.
Admission is a deterministic stride test (`attempt_n % stride == 0`), so
two runs over the same stream keep the same records.  In adaptive mode
(``event_budget_per_s > 0``) the sampler measures the recent attempt rate
per kind and scales each kind's admit rate down when the aggregate rate
exceeds the budget (and back up, capped at the configured rate, when it
falls below) — full tracing survives 10x event rates without the ring and
payload shipping costs growing 10x.

``ExemplarTimelines`` maintains a small set of *exemplar tuples* whose
(src, tau) identity deterministically hashes under ``exemplar_rate``; every
stage that sees a tuple batch (tier admission, leaf push, root merge,
runtime stage/dispatch/drain/emit) independently applies the same predicate
and stamps a wall-clock mark, so the end-to-end timeline needs **no
cross-process coordination** — child marks ship in ``LeafOut.obs`` payloads
and are clock-offset-normalized at ingest (see ``flight.py`` for the
offset handshake).  Completed timelines surface in ``RunReport`` and the
flight dump.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

# exemplar predicate: a tuple (src, tau) is an exemplar iff
#   ((tau * _MIX + src) % stride) == 0    with stride = round(1/rate)
# _MIX is a large odd prime so consecutive taus of one source spread out.
_MIX = 1000003

# stage order used to sort marks inside one timeline (wall clocks across
# processes agree only to offset-normalization precision; the logical
# stage order is authoritative for equal-ish timestamps)
STAGES = ("admit", "leaf_push", "root_merge", "stage", "dispatch",
          "drain", "emit")
_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}

_MIN_RATE = 1.0 / 1024.0      # adaptive floor: never fully blind
_WINDOW = 64                  # attempts between adaptive rate re-checks


def _stride(rate: float) -> int:
    """Admit-1-in-N stride for a rate in (0, 1]; rate<=0 disables."""
    if rate >= 1.0:
        return 1
    if rate <= 0.0:
        return 0                # sentinel: drop everything
    return max(1, int(round(1.0 / rate)))


class _KindState:
    __slots__ = ("attempts", "kept", "rate", "cfg_rate", "stride",
                 "win_t0", "win_n")

    def __init__(self, rate: float):
        self.attempts = 0
        self.kept = 0
        self.cfg_rate = rate          # configured ceiling
        self.rate = rate              # live (adaptively lowered) rate
        self.stride = _stride(rate)
        self.win_t0 = time.perf_counter()
        self.win_n = 0


class HeadSampler:
    """Deterministic per-kind head sampler with an optional rate budget.

    ``event_sample`` / ``span_sample`` are the default keep rates for flight
    events and finished-span records; ``rates`` overrides per kind/name
    (exact match on the event kind or span name).  ``budget_per_s`` > 0
    turns on adaptive mode: whenever a kind's recent attempt rate times its
    live admit rate exceeds its share of the budget, the live rate halves
    (down to 1/1024); when comfortably under, it doubles back toward the
    configured ceiling.
    """

    def __init__(self, event_sample: float = 1.0, span_sample: float = 1.0,
                 rates: Optional[Dict[str, float]] = None,
                 budget_per_s: float = 0.0):
        self.event_sample = float(event_sample)
        self.span_sample = float(span_sample)
        self.rates = dict(rates or {})
        self.budget_per_s = float(budget_per_s)
        self._events: Dict[str, _KindState] = {}
        self._spans: Dict[str, _KindState] = {}

    # -- admission -----------------------------------------------------------
    def _state(self, table: Dict[str, _KindState], kind: str,
               default_rate: float) -> _KindState:
        st = table.get(kind)
        if st is None:
            st = _KindState(self.rates.get(kind, default_rate))
            table[kind] = st
        return st

    def _admit(self, st: _KindState) -> bool:
        n = st.attempts
        st.attempts = n + 1
        if self.budget_per_s > 0.0:
            st.win_n += 1
            if st.win_n >= _WINDOW:
                self._retune(st)
        if st.stride == 0:
            return False
        if (n % st.stride) == 0:
            st.kept += 1
            return True
        return False

    def _retune(self, st: _KindState) -> None:
        now = time.perf_counter()
        dt = now - st.win_t0
        st.win_t0 = now
        st.win_n = 0
        if dt <= 0.0:
            return
        attempt_rate = _WINDOW / dt
        kept_rate = attempt_rate * st.rate
        if kept_rate > self.budget_per_s:
            # back off multiplicatively toward the budget
            st.rate = max(_MIN_RATE,
                          st.rate * (self.budget_per_s / kept_rate))
        elif kept_rate < 0.5 * self.budget_per_s and st.rate < st.cfg_rate:
            st.rate = min(st.cfg_rate, st.rate * 2.0)
        st.stride = _stride(st.rate)

    def admit_event(self, kind: str) -> bool:
        return self._admit(self._state(self._events, kind,
                                       self.event_sample))

    def admit_span(self, name: str) -> bool:
        return self._admit(self._state(self._spans, name,
                                       self.span_sample))

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Sampling metadata for the v2 snapshot: exact attempt/kept
        totals per kind (attempts are exact even when detail is thinned)."""
        def table(t: Dict[str, _KindState]) -> Dict:
            return {k: {"attempts": st.attempts, "kept": st.kept,
                        "rate": st.rate}
                    for k, st in sorted(t.items())}
        return {
            "event_sample": self.event_sample,
            "span_sample": self.span_sample,
            "budget_per_s": self.budget_per_s,
            "adaptive": self.budget_per_s > 0.0,
            "events": table(self._events),
            "spans": table(self._spans),
        }


# ---------------------------------------------------------- exemplars -----


def is_exemplar(src: int, tau: int, stride: int) -> bool:
    """The shared deterministic exemplar predicate (stride from
    ``_stride(exemplar_rate)``); evaluated independently at every stage."""
    return stride > 0 and ((int(tau) * _MIX + int(src)) % stride) == 0


class ExemplarTimelines:
    """Bounded store of per-tuple end-to-end timelines.

    A timeline is keyed by the tuple identity ``(src, tau)`` and holds
    ``{stage: wall_seconds}`` marks.  Stages before runtime staging mark
    by identity (``mark``); the runtime binds the identity to a tick id
    (``bind_tick``) so dispatch/drain/emit — which only know the tick —
    can mark every exemplar staged into it (``mark_tick``).  A timeline
    completes when its ``emit`` mark lands; completed timelines move to a
    bounded done-deque exposed via ``snapshot()``/``drain()``.
    """

    def __init__(self, rate: float, cap: int = 64, clock=None):
        self.rate = float(rate)
        self.stride = _stride(self.rate)
        self.cap = int(cap)
        # wall-clock source; Obs passes perf_counter + flight clock_offset
        # so marks inherit monotonicity (see flight.py clock handshake)
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._open: Dict[tuple, Dict] = {}
        self._by_tick: Dict[int, List[tuple]] = {}
        self._done: deque = deque(maxlen=self.cap)

    def is_exemplar(self, src: int, tau: int) -> bool:
        return is_exemplar(src, tau, self.stride)

    def scan(self, srcs, taus, ok, stage: str,
             tick_id: Optional[int] = None) -> None:
        """Vectorized stage stamp over a tuple batch: applies the exemplar
        predicate to every lane where ``ok`` and marks the (few) hits with
        one shared wall stamp.  ``tick_id`` also binds each hit so later
        tick-granular stages (``mark_tick``) reach it."""
        if self.stride <= 0:
            return
        srcs = np.asarray(srcs, dtype=np.int64)
        taus = np.asarray(taus, dtype=np.int64)
        m = np.asarray(ok, dtype=bool) & (
            ((taus * _MIX + srcs) % self.stride) == 0)
        if not m.any():
            return
        w = self._clock()
        for s, t in zip(srcs[m].tolist(), taus[m].tolist()):
            self.mark(s, t, stage, wall=w)
            if tick_id is not None:
                self.bind_tick(s, t, tick_id)

    def mark(self, src: int, tau: int, stage: str,
             wall: Optional[float] = None) -> None:
        """Stamp ``stage`` on the (src, tau) exemplar (opens it if new;
        silently drops when the open set is at capacity)."""
        key = (int(src), int(tau))
        w = self._clock() if wall is None else wall
        with self._lock:
            tl = self._open.get(key)
            if tl is None:
                if len(self._open) >= self.cap:
                    return
                tl = {"src": key[0], "tau": key[1], "marks": {}}
                self._open[key] = tl
            tl["marks"].setdefault(stage, w)

    def bind_tick(self, src: int, tau: int, tick_id: int) -> None:
        key = (int(src), int(tau))
        with self._lock:
            if key in self._open:
                self._open[key]["tick_id"] = int(tick_id)
                self._by_tick.setdefault(int(tick_id), []).append(key)

    def mark_tick(self, tick_id: int, stage: str,
                  wall: Optional[float] = None) -> None:
        """Stamp ``stage`` on every open exemplar bound to ``tick_id``;
        ``emit`` completes and retires the timeline."""
        w = self._clock() if wall is None else wall
        with self._lock:
            keys = self._by_tick.get(int(tick_id))
            if not keys:
                return
            for key in keys:
                tl = self._open.get(key)
                if tl is None:
                    continue
                tl["marks"].setdefault(stage, w)
                if stage == "emit":
                    self._finish_locked(key, tl)
            if stage == "emit":
                self._by_tick.pop(int(tick_id), None)

    def _finish_locked(self, key: tuple, tl: Dict) -> None:
        self._open.pop(key, None)
        tl["timeline"] = sorted(
            ((s, w) for s, w in tl["marks"].items()),
            key=lambda sw: (sw[1], _STAGE_RANK.get(sw[0], len(STAGES))))
        self._done.append(tl)

    # -- cross-process shipping ---------------------------------------------
    def drain_marks(self) -> List[Dict]:
        """Child-side: ship open-mark fragments ({src, tau, marks}) and
        clear them; the parent folds them with ``ingest_marks``."""
        with self._lock:
            out = [{"src": tl["src"], "tau": tl["tau"],
                    "marks": dict(tl["marks"])}
                   for tl in self._open.values()]
            self._open.clear()
            self._by_tick.clear()
            return out

    def ingest_marks(self, frags: List[Dict],
                     wall_offset: float = 0.0) -> None:
        """Parent-side: fold child mark fragments, shifting child walls by
        ``wall_offset`` (parent_wall - child_wall) so merged timelines are
        monotone in the parent's clock domain."""
        for frag in frags:
            for stage, w in frag.get("marks", {}).items():
                self.mark(frag["src"], frag["tau"], stage,
                          wall=w + wall_offset)

    # -- export --------------------------------------------------------------
    def completed(self) -> List[Dict]:
        with self._lock:
            return list(self._done)

    def snapshot(self) -> List[Dict]:
        """Exemplar section for the v2 snapshot: completed timelines plus
        still-open ones (partial marks), bounded by ``cap``."""
        with self._lock:
            done = list(self._done)
            opens = []
            for tl in list(self._open.values())[: self.cap]:
                opens.append({
                    "src": tl["src"], "tau": tl["tau"],
                    "tick_id": tl.get("tick_id"),
                    "timeline": sorted(
                        ((s, w) for s, w in tl["marks"].items()),
                        key=lambda sw: (sw[1],
                                        _STAGE_RANK.get(sw[0],
                                                        len(STAGES)))),
                    "complete": False,
                })
        for tl in done:
            tl.setdefault("complete", True)
        return done + opens
