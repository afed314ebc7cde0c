"""The traced run's window: torch.profiler around a few super-batches.

``Tracer.begin`` starts the profiler before the traced segment's runtime
starts (starting it takes long enough to back the paced source up);
``start`` and ``stop`` are called by the instrumented pipeline in the step
loop's thread around the traced super-batches.  Two host markers
(``record_function``) bound the window on the profiler's clock; ``stop``
waits for the card first, so the window ends after the traced work.
``parse`` reads the device activity (kernels, copies, fills) from the
profiler's raw events and returns the busy time (the union of their
intervals inside the window), the device time by name, the idle gaps, and
the offset between the profiler's clock and the host's ``perf_counter``,
which labels each gap with what the host threads were doing (the spans
the benchmark recorded).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

MARK = "stretchbench."


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Tracer:
    def __init__(self):
        self.prof = None
        self.h0 = self.h1 = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def start(self) -> None:
        from torch.profiler import record_function
        with record_function(MARK + "trace_start"):
            self.h0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        from torch.profiler import record_function
        torch.cuda.synchronize()
        with record_function(MARK + "trace_end"):
            self.h1 = time.perf_counter()
        self.prof.stop()

    def parse(self) -> Dict:
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        marks, dev = {}, []
        for ev in events:
            name = ev.name()
            if name.startswith(MARK):
                if ev.device_type() == DeviceType.CPU:
                    marks[name[len(MARK):]] = (_ns(ev, "start"),
                                               _ns(ev, "duration"))
                continue
            if ev.device_type() != DeviceType.CUDA:
                continue
            start = _ns(ev, "start")
            dev.append((name, start, start + _ns(ev, "duration")))
        w0 = marks["trace_start"][0]
        w1 = sum(marks["trace_end"])
        dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
               if b > w0 and a < w1]
        by_name: Dict[str, float] = {}
        for n, a, b in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        busy, gaps = _union(sorted((a, b) for _, a, b in dev), w0, w1)
        return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                    by_name=by_name, kernels=dev, gaps=gaps,
                    # profiler ns at host perf_counter 0
                    offset_ns=w0 - self.h0 * 1e9)


def _union(intervals: List[Tuple[int, int]], w0: int, w1: int):
    """The covered length of sorted intervals and the gaps between them
    inside ``[w0, w1]``."""
    busy, gaps, cur = 0, [], w0
    end = w0
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
            busy += end - cur
            cur = a
        end = max(end, b)
    busy += end - cur
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def label_gaps(parsed: Dict, spans: List[Tuple[str, float, float]],
               top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps, each named by the host spans
    (``(thread:what, start, end)`` on ``perf_counter``) that covered its
    middle."""
    off = parsed["offset_ns"]
    out = []
    for a, b in sorted(parsed["gaps"], key=lambda g: g[0] - g[1])[:top]:
        mid = ((a + b) / 2 - off) / 1e9
        names = sorted({n for n, s, e in spans if s <= mid <= e})
        out.append(["+".join(names) or "runtime", (b - a) / 1e9])
    return out


def top_ops(parsed: Dict, top: int = 10) -> List[list]:
    return [[n[:160], s] for n, s in sorted(parsed["by_name"].items(),
                                            key=lambda kv: -kv[1])[:top]]
