"""Bounded in-flight queue: the backpressure edge between host and device.

Held against ``src/repro/io/queues.py`` (the same class, framework-free).

The ingest thread stages tick T+1 (a copy to the device) while the device runs
tick T; this queue bounds how far ahead it may run.  ``put`` blocks when
the queue is full — a slow consumer therefore stalls the *producer*, never
grows memory (the test contract: depth never exceeds ``cap``), and the
observed depth is itself a load signal the controllers consume (a full
queue means the pipeline is not keeping up with the offered rate).

``get`` disambiguates its three outcomes explicitly:

* an item            — normal delivery (FIFO);
* raises QueueClosed — the queue is closed *and* drained: the stream has
  genuinely ended (items enqueued before ``close`` are always delivered
  first);
* returns TIMEOUT    — the wait timed out with the queue still open: the
  caller may retry, poll something else, or give up.  The sentinel (not
  ``None``, not an exception) keeps "no item yet" distinct from "no item
  ever again" — conflating them made a slow producer look like end-of-
  stream to pollers.

Payloads may be any non-None value (``None`` is reserved to catch
accidental sentinel payloads early).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional


class QueueClosed(Exception):
    """put() after close(), or get() on a closed-and-drained queue."""


class _Timeout:
    """Singleton sentinel: ``get(timeout=...)`` expired, queue still open."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<BoundedQueue.TIMEOUT>"


TIMEOUT = _Timeout()


class BoundedQueue:
    """Thread-safe FIFO with a hard capacity and blocking put/get.

    A consumer loop is::

        try:
            while True:
                item = q.get()
                ...
        except QueueClosed:
            pass            # stream ended, everything was delivered
    """

    def __init__(self, cap: int):
        assert cap >= 1, cap
        self.cap = cap
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        # -- stats (read under no lock: plain ints, monotone) --------------
        self.high_water = 0        # max depth ever observed
        self.total_put = 0
        self.blocked_puts = 0      # puts that had to wait on a full queue

    @property
    def depth(self) -> int:
        return len(self._items)

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Append ``item``, blocking while full.  ``close()`` from another
        thread wakes a blocked put *immediately* (the wait predicate
        includes the closed flag) and ``QueueClosed`` wins over
        ``TimeoutError`` whenever the queue is closed — a producer stuck
        behind a dead consumer unblocks the instant the tier tears the
        queue down, instead of waiting out its timeout."""
        assert item is not None
        with self._cv:
            if len(self._items) >= self.cap:
                self.blocked_puts += 1
                from repro_torch import obs as _obs
                _obs.event("backpressure_stall", transport="queue",
                           depth=len(self._items), cap=self.cap)
                _obs.counter_inc("queue.blocked_puts")
                if not self._cv.wait_for(
                        lambda: self._closed or len(self._items) < self.cap,
                        timeout=timeout):
                    if self._closed:            # closed during the last slice
                        raise QueueClosed
                    raise TimeoutError("BoundedQueue.put timed out")
            if self._closed:
                raise QueueClosed
            self._items.append(item)
            self.total_put += 1
            self.high_water = max(self.high_water, len(self._items))
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next item (FIFO).  Raises ``QueueClosed`` once closed and
        drained; returns the ``TIMEOUT`` sentinel if ``timeout`` elapses
        with the queue still open."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._closed or self._items, timeout=timeout):
                return TIMEOUT
            if self._items:
                item = self._items.popleft()
                self._cv.notify_all()
                return item
            raise QueueClosed      # closed and drained

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
