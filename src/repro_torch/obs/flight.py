"""Flight recorder: fixed-size ring buffer of structured runtime events.

Every event is a flat dict with a ``kind`` plus caller fields (tick ids,
watermarks, queue high-water marks, reconfig epochs, backpressure stalls,
leaf failures...), stamped with monotonic time ``t`` (perf_counter, for
intra-process ordering), ``wall`` (for cross-process ordering), ``pid`` and
thread name. The ring holds the last ``cap`` events; a crash or chaos-drill
failure dumps it to JSON so failures come with a timeline instead of a
stack trace.

Clock handshake: ``wall`` is *derived* — ``t + clock_offset`` with the
offset (``time.time() - time.perf_counter()``) captured once at recorder
construction — so a process's wall stamps inherit perf_counter's
monotonicity instead of time.time()'s step jitter.  A child process ships
its offset alongside drained events (``repro_torch.obs.drain_payload`` attaches
``{"clock": {"pid", "offset"}}``); ``ingest`` renormalizes each shipped
event's ``wall`` from its raw ``t`` and the shipped offset, so the merged
timeline sorts monotonically across processes.

Dump format (``dump_json``)::

    {"dumped_unix": ..., "reason": "...", "pid": ...,
     "n_events": N, "events": [{"kind": ..., "t": ..., "wall": ...,
                                "pid": ..., "thread": ..., **fields}, ...],
     "exemplars": [...]}        # v2: per-tuple timelines when present
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    def __init__(self, cap: int = 4096, enabled: bool = True):
        self.enabled = enabled
        self.events: deque = deque(maxlen=cap)
        self._pid = os.getpid()
        # one-time perf->wall offset: wall stamps below are t + offset,
        # monotone within the process by construction
        self.clock_offset = time.time() - time.perf_counter()

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        t = time.perf_counter()
        fields["kind"] = kind
        fields["t"] = t
        fields["wall"] = t + self.clock_offset
        fields["pid"] = self._pid
        fields["thread"] = threading.current_thread().name
        self.events.append(fields)

    # -- cross-process shipping ---------------------------------------------
    def drain(self) -> List[Dict]:
        out = []
        while self.events:
            out.append(self.events.popleft())
        return out

    def ingest(self, events: List[Dict],
               clock_offset: Optional[float] = None) -> None:
        """Fold events shipped from a child process.  When the child's
        perf->wall ``clock_offset`` is known (shipped in the payload clock
        handshake), each event's ``wall`` is renormalized from its raw
        ``t`` — idempotent, and a no-op for legacy payloads without it."""
        if not self.enabled:
            return
        if clock_offset is not None:
            for e in events:
                if "t" in e:
                    e["wall"] = e["t"] + clock_offset
        self.events.extend(events)

    # -- export --------------------------------------------------------------
    def timeline(self) -> List[Dict]:
        """Events sorted by wall clock (stable across processes)."""
        return sorted(self.events, key=lambda e: e.get("wall", 0.0))

    def dump(self, reason: str = "on_demand",
             exemplars: Optional[List[Dict]] = None) -> Dict:
        d = {
            "dumped_unix": time.time(),
            "reason": reason,
            "pid": self._pid,
            "n_events": len(self.events),
            "events": self.timeline(),
        }
        if exemplars:
            d["exemplars"] = exemplars
        return d

    def dump_json(self, path: str, reason: str = "on_demand",
                  exemplars: Optional[List[Dict]] = None) -> str:
        """Write the ring to ``path`` (dirs created); returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.dump(reason, exemplars=exemplars), f, indent=1,
                      default=repr)
        return path
