"""Channels: the bounded, closable edges between tier roles.

Held against ``src/repro/ingest/channels.py`` (the same classes).

One protocol, two transports:

* ``thread`` / ``inline``: ``repro_torch.io.queues.BoundedQueue`` (its
  contract verbatim: blocking ``put`` backpressure, ``QueueClosed`` after
  drain, ``TIMEOUT`` sentinel on a timed-out ``get``);
* ``process``: a ``multiprocessing.Queue`` wrapper that
  re-exposes the same contract (``maxsize`` gives the blocking-put
  backpressure; a ``MP_CLOSE`` marker item plays the close signal, since
  mp queues have no cross-process close).

Backpressure is the point: root→leaf→source stalls propagate purely by
these channels filling up — a slow consumer of the tier's merged stream
eventually blocks the source iterator itself.
"""

from __future__ import annotations

import queue as _stdlib_queue
import threading
import time
from typing import Any, Optional

from repro_torch.io.queues import TIMEOUT, BoundedQueue, QueueClosed

MP_CLOSE = "__ingest_channel_close__"

# granularity of the blocked-put close poll: an mp.Queue has no condition
# variable we can hook close() into, so a blocked put re-checks the local
# closed flag this often (worst-case extra latency on close, not on data)
_PUT_POLL_S = 0.05


class MpChannel:
    """BoundedQueue-contract adapter over ``multiprocessing.Queue``."""

    def __init__(self, ctx, cap: int):
        self._q = ctx.Queue(maxsize=cap)
        self._recv_closed = False
        self._send_closed = False

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Blocking put with the BoundedQueue close contract: ``close()``
        during a blocked put raises ``QueueClosed`` within ``_PUT_POLL_S``
        instead of waiting out ``timeout`` — the router thread stuck
        feeding a SIGKILLed leaf's full queue must unblock as soon as the
        tier starts draining, or restore-after-kill hangs on it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        stalled = False
        while True:
            if self._send_closed:
                raise QueueClosed
            slice_s = _PUT_POLL_S
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("MpChannel.put timed out")
                slice_s = min(slice_s, left)
            try:
                self._q.put(item, timeout=slice_s)
                return
            except _stdlib_queue.Full:
                if not stalled:
                    # one event per stall episode, not per poll slice
                    stalled = True
                    from repro_torch import obs as _obs
                    _obs.event("backpressure_stall", transport="mp")
                    _obs.counter_inc("chan.mp_blocked_puts")
                continue

    def get(self, timeout: Optional[float] = None) -> Any:
        if self._recv_closed:
            raise QueueClosed
        try:
            item = self._q.get(timeout=timeout)
        except _stdlib_queue.Empty:
            return TIMEOUT
        if item == MP_CLOSE:
            self._recv_closed = True
            raise QueueClosed
        return item

    def close(self) -> None:
        # marker, not Queue.close(): the receiver must still drain what the
        # producer enqueued before the close (the BoundedQueue contract).
        # Delivery must not be droppable: on a full queue a background
        # retry keeps trying while the receiver drains (the tier's
        # process-join timeout + terminate() covers a receiver that never
        # will).
        if self._send_closed:
            return
        self._send_closed = True
        try:
            self._q.put_nowait(MP_CLOSE)
        except _stdlib_queue.Full:
            def _retry():
                try:
                    self._q.put(MP_CLOSE, timeout=60)
                except Exception:
                    pass
            threading.Thread(target=_retry, daemon=True).start()


def make_channel(worker: str, cap: int, ctx=None):
    if worker == "process":
        assert ctx is not None
        return MpChannel(ctx, cap)
    return BoundedQueue(cap)
