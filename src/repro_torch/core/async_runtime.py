"""AsyncStreamRuntime: live double-buffered ingest + closed-loop elasticity.

Held against ``src/repro/core/async_runtime.py``.  The runtime makes the
stream live:

* an **ingest thread** pulls ticks from a source (an ``io`` source or an
  ``IngestTier``), computes the host-side tick metadata (per-source
  frontier, tuple count, key histogram), and ``stage``s the batch onto the
  pipeline's device, so the copy of tick T+1 runs while the device
  computes tick T.  A ``BoundedQueue`` between the threads applies
  backpressure: the producer blocks, memory never grows past ``queue_cap``
  ticks;
* the **step loop** dispatches ``VSNPipeline.step_staged`` on the staged
  batch and never blocks on the outputs (sinks keep device tensors).  The
  only host reads are the sampled metrics of the *previous* tick (the
  ``switched`` flag, the general tick's expiry flag and the per-instance
  load vector), fetched while the current tick computes.  A tick's
  outputs reach the sink once its expiry flag is read, so a tick that
  raises ``ExpiryBoundError`` (a graph replay of the general tick whose
  bounded expiry could not be shown exact) delivers nothing;
* the **control loop** closes §8.4-§8.5: each tick a ``MetricsBus``
  snapshot is fed to the controller, and an emitted ``Reconfiguration`` is
  injected mid-stream through the control-tuple path (Alg. 5), stamped
  from the host-tracked per-source frontier.  Detection→switch latency is
  measured per reconfiguration.

With ``super_batch = K > 1`` the ingest thread groups K consecutive
same-shape ticks into one ``StagedSuper`` (a shape change flushes the
group early; a partial group is padded with all-invalid ticks) and the
step loop runs each through the pipeline's persistent driver
(``run_persistent_staged``): one controller decision a super-batch, a
reconfiguration injected at its first tick, and one control-lane read
(``switched.any()``, ``inst_load.sum(0)``) a super-batch.

Fault tolerance: a ``checkpointer`` (``checkpoint.StreamCheckpointer``)
is asked at every dispatch boundary, a single tick's or a
``StagedSuper``'s, before the dispatch that overwrites the pipeline
state.  At a boundary that is saved, the tick before it is drained of its
expiry flag and its outputs first, so a checkpoint never holds a flagged
tick's state or a step whose outputs the sink has not had.  ``tick0``
offsets the tick ids of a resumed run so sink tick ids and checkpoint
steps stay absolute across restarts.

``run_sync`` is the measured baseline: the same semantics as a plain host
loop (generate, step, wait for the outputs).

Spans (with an ``obs`` installed and span timing on; each carries the
first tick id of the super-batch it served).  The ingest thread, named
``ingest``: ``ingest.source`` (each ``next()`` on the source),
``ingest.meta`` (``tick_meta``), ``ingest.stage`` (with the driver's
``stage.pack`` and ``stage.copy``) and ``ingest.put_wait`` (a put that
blocked on a full queue).  The step loop: ``runtime.queue_get``,
``runtime.checkpoint``, ``controller.decide``, ``runtime.dispatch`` (with
the driver's ``driver.*``) and ``runtime.drain`` (``runtime.flag_read``,
the control-lane read; ``runtime.sink``; ``runtime.load_read``).  Each
staged item's ``runtime.queue_residence``, from the put call to the get's
return, is kept on the thread name ``queue``.  A span reads the host clock
only: no device read, no sync.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import tuples as T
from repro_torch.core.controller import Reconfiguration
from repro_torch.core.operator import raise_on_fault
from repro_torch.core.runtime import fold_frontier
from repro_torch.io.metrics import MetricsBus
from repro_torch.io.queues import BoundedQueue, QueueClosed
from repro_torch.io.sinks import CollectSink


_END = object()                    # the source's end, for next()


@dataclasses.dataclass
class TickMeta:
    """Host-side facts about one tick, computed in the ingest thread."""
    tick_id: int
    n_tuples: int                  # valid data lanes
    frontier_before: np.ndarray    # i64[n_inputs] last tau per source BEFORE
    key_hist: Optional[np.ndarray]  # i64[k_virt] (lane, key) routing counts


@dataclasses.dataclass
class StagedTick:
    meta: TickMeta
    staged: T.TupleBatch           # on the pipeline's device
    t_put: Optional[float] = None  # the put call (span timing on only)


@dataclasses.dataclass
class StagedSuper:
    """K consecutive same-shape ticks staged as one ``[K, B]`` super-batch
    for the pipeline's persistent driver.  The last ``n_pad`` ticks are
    all-invalid fillers (a partial tail, or an early flush on a shape
    change, keeps one K)."""
    metas: List[TickMeta]          # one per real tick, in order
    stack: T.TupleBatch            # on the pipeline's device
    n_pad: int
    t_put: Optional[float] = None  # the put call (span timing on only)


@dataclasses.dataclass
class _InFlight:
    """A dispatched tick (or super-batch) whose control lane is not read
    yet."""
    tick_id: int
    meta: TickMeta
    outs: tuple                    # (outs_pre, outs_post), on the device
    switched: Any
    inst_load: Any
    fault: Any                     # the expiry flag, or None
    t_dispatch: float
    settled: bool = False          # flag read, outputs handed to the sink


@dataclasses.dataclass
class RunReport:
    ticks: int
    tuples: int
    wall_s: float
    throughput_tps: float
    p50_ms: float
    p99_ms: float
    queue_high_water: int
    blocked_puts: int
    reconfig_trace: List[Tuple[int, Reconfiguration]]
    switches: int
    detect_to_switch_ms: List[float]
    detect_to_switch_ticks: List[int]
    # detections whose switch never committed (flushed at stop())
    unresolved_detections: int = 0
    # per-stage latency breakdown {stage: {p50,p90,p99,mean,count}} in ms,
    # from span tracing when enabled (empty otherwise)
    stage_latency_ms: dict = dataclasses.field(default_factory=dict)
    # sampled per-tuple end-to-end timelines, when exemplars are on
    exemplar_timelines: list = dataclasses.field(default_factory=list)
    # SLO breaches observed during the run (SloBreach.to_dict() dicts)
    slo_breaches: list = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        d2s = (f"{np.mean(self.detect_to_switch_ms):.1f}ms"
               f"/{np.mean(self.detect_to_switch_ticks):.1f}t"
               if self.detect_to_switch_ms else "n/a")
        return (f"{self.ticks} ticks, {self.tuples} tuples in "
                f"{self.wall_s:.2f}s = {self.throughput_tps:.0f} t/s; "
                f"tick latency p50={self.p50_ms:.2f}ms "
                f"p99={self.p99_ms:.2f}ms; "
                f"{len(self.reconfig_trace)} reconfigs ({self.switches} "
                f"switched, detection->switch {d2s}); queue high-water "
                f"{self.queue_high_water}")


def _np(t) -> np.ndarray:
    """A host copy of a tensor; host arrays (the serving pool's ownership
    tables, its per-instance load) pass through."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _initial_frontier(pipeline, n_inputs: int) -> np.ndarray:
    """Seed the host-tracked frontier from the pipeline's ScaleGate: a
    pipeline stepped before ``run()`` has already forwarded taus, and
    control tuples stamped below them would break the per-source sorted
    stream (Alg. 5).  Runs before the stream starts."""
    if pipeline.sg is not None:
        return _np(pipeline.sg.wmark.frontier).astype(np.int64).copy()
    return np.zeros((n_inputs,), np.int64)


def _wait(pipeline) -> None:
    """Wait for the pipeline's queued device work (the synchronous loop)."""
    if pipeline.device.type == "cuda":
        torch.cuda.synchronize(pipeline.device)


def make_report(metrics: MetricsBus, reconfig_trace, switches: int,
                queue=None, slo_breaches=None) -> RunReport:
    """Assemble the RunReport from a finished run's metrics (shared by the
    async loop and the run_sync baseline)."""
    p50, p99 = metrics.latency_quantiles_ms()
    o = _obs.get()
    return RunReport(
        ticks=metrics.n_ticks,
        tuples=metrics.total_tuples,
        wall_s=(metrics.t_end or 0.0) - (metrics.t_start or 0.0),
        throughput_tps=metrics.throughput_tps(),
        p50_ms=p50, p99_ms=p99,
        queue_high_water=0 if queue is None else queue.high_water,
        blocked_puts=0 if queue is None else queue.blocked_puts,
        reconfig_trace=list(reconfig_trace),
        switches=switches,
        detect_to_switch_ms=list(metrics.detect_to_switch_ms),
        detect_to_switch_ticks=list(metrics.detect_to_switch_ticks),
        unresolved_detections=len(metrics.unresolved_detections),
        stage_latency_ms=({} if o is None or not o.tracer.enabled
                          else o.tracer.stage_latency_ms()),
        exemplar_timelines=([] if o is None or o.timeline is None
                            else o.timeline.completed()),
        slo_breaches=[b.to_dict() for b in (slo_breaches or [])])


def tick_meta(b: T.TupleBatch, tick_id: int, n_inputs: int, k_virt: int,
              frontier: np.ndarray, with_hist: bool = True) -> TickMeta:
    """Compute a tick's metadata and fold its taus into the running
    ``frontier`` (mutated); host arrays only.  ``with_hist=False`` skips
    the key histogram, which only the host-side load fallback reads (for
    pipelines whose step returns no device ``inst_load``)."""
    ok = _np(b.valid) & ~_np(b.is_control)
    before = frontier.copy()
    fold_frontier(frontier, b, n_inputs)
    hist = None
    if with_hist:
        keys = _np(b.keys)
        km = ok[:, None] & (keys >= 0)
        if km.any():
            hist = np.bincount(keys[km].ravel(),
                               minlength=k_virt).astype(np.int64)
        else:
            hist = np.zeros((k_virt,), np.int64)
    return TickMeta(tick_id, int(ok.sum()), before, hist)


class AsyncStreamRuntime:
    """Drive a pipeline from a live source with overlapped ingest and a
    controller in the loop.  ``pipeline`` must expose ``stage`` and
    ``step_staged`` (``VSNPipeline`` does)."""

    def __init__(self, pipeline, source, sink=None, controller=None,
                 queue_cap: int = 4, metrics: Optional[MetricsBus] = None,
                 super_batch: int = 1, checkpointer=None, tick0: int = 0):
        if super_batch < 1:
            raise ValueError(f"super_batch must be >= 1, got {super_batch}")
        self.super_batch = super_batch
        self.pipeline = pipeline
        self.source = source
        self.checkpointer = checkpointer
        self.tick0 = int(tick0)
        self.sink = sink if sink is not None else CollectSink()
        self.controller = controller
        self.queue = BoundedQueue(queue_cap)
        self.metrics = metrics or MetricsBus(queue_cap=queue_cap)
        # a caller-supplied bus must still know the in-flight cap, or the
        # controllers' queue-pressure term never fires
        self.metrics.queue_cap = self.metrics.queue_cap or queue_cap
        self.reconfig_trace: List[Tuple[int, Reconfiguration]] = []
        self.switches = 0
        # host shadows of the COMMITTED epoch tables (the host load
        # fallback + the n_active a load sample is judged under); read once
        # before the stream starts.  Pending reconfigurations live in the
        # MetricsBus, which hands back what a switch committed.
        self._fmu_shadow = _np(pipeline.epoch.fmu).copy()
        self._active_shadow = _np(pipeline.epoch.active).copy()
        self._ingest_error: Optional[BaseException] = None
        # SLO breaches: _pending feeds the NEXT controller decision via
        # LiveMetrics.slo_breaches, _all accumulates for the RunReport
        self._pending_breaches: List = []
        self._all_breaches: List = []

    # -- ingest thread ------------------------------------------------------
    def _ingest(self, max_ticks: Optional[int]):
        n_inputs = self.pipeline.op.n_inputs
        k_virt = self.pipeline.op.k_virt
        with_hist = not getattr(self.pipeline, "device_inst_load", False)
        frontier = _initial_frontier(self.pipeline, n_inputs)
        try:
            if self.super_batch > 1:
                self._ingest_super(max_ticks, n_inputs, k_virt, with_hist,
                                   frontier)
                return
            src = iter(self.source)
            for i in itertools.count():
                with _obs.span("ingest.source", tick=self.tick0 + i):
                    b = next(src, _END)
                if b is _END or (max_ticks is not None and i >= max_ticks):
                    break
                with _obs.span("ingest.stage", tick=self.tick0 + i):
                    meta = tick_meta(b, self.tick0 + i, n_inputs, k_virt,
                                     frontier, with_hist=with_hist)
                    staged = self.pipeline.stage(b)
                tl = _obs.exemplars()
                if tl is not None:
                    ok = _np(b.valid) & ~_np(b.is_control)
                    tl.scan(_np(b.source), _np(b.tau), ok, "stage",
                            tick_id=meta.tick_id)
                self._put(StagedTick(meta, staged), meta.tick_id)
        except BaseException as e:              # surfaced after join()
            self._ingest_error = e
            _obs.event("ingest_error", error=repr(e))
        finally:
            self.queue.close()

    def _ingest_super(self, max_ticks, n_inputs: int, k_virt: int,
                      with_hist: bool, frontier: np.ndarray):
        """Group up to ``super_batch`` consecutive same-shape ticks and
        stage each group as one stack.  A shape change flushes the open
        group early; a partial group is padded with all-invalid ticks, so
        each shape keeps one K (one graph on the card)."""
        k = self.super_batch
        group: List[T.TupleBatch] = []
        metas: List[TickMeta] = []
        gkey = None

        def flush():
            nonlocal group, metas
            if not group:
                return
            n_pad = k - len(group)
            b0 = group[0]
            first = metas[0].tick_id
            with _obs.span("ingest.stage", tick=first):
                ticks = group + [T.empty_batch(b0.batch, b0.kmax,
                                               b0.payload_width,
                                               b0.device)] * n_pad
                stack = self.pipeline.stage_super(ticks)
            self._put(StagedSuper(metas=metas, stack=stack, n_pad=n_pad),
                      first)
            group, metas = [], []

        src = iter(self.source)
        for i in itertools.count():
            # the spans of a tick carry the id of the super-batch it fills
            with _obs.span("ingest.source", tick=(
                    metas[0].tick_id if metas else self.tick0 + i)):
                b = next(src, _END)
            if b is _END or (max_ticks is not None and i >= max_ticks):
                break
            key = (b.batch, b.kmax, b.payload_width)
            if group and key != gkey:
                flush()
            gkey = key
            with _obs.span("ingest.meta", tick=(
                    metas[0].tick_id if metas else self.tick0 + i)):
                metas.append(tick_meta(b, self.tick0 + i, n_inputs, k_virt,
                                       frontier, with_hist=with_hist))
            tl = _obs.exemplars()
            if tl is not None:
                ok = _np(b.valid) & ~_np(b.is_control)
                # bound to the super-batch's decision tick (its first
                # tick id), the id _drain sees
                tl.scan(_np(b.source), _np(b.tau), ok, "stage",
                        tick_id=metas[0].tick_id)
            group.append(b)
            if len(group) == k:
                flush()
        flush()

    def _put(self, item, tick: int) -> None:
        """Hand a staged item to the step loop.  With span timing on, the
        put call is stamped on the item (its queue residence starts there)
        and a put that blocked on a full queue is kept as
        ``ingest.put_wait``."""
        tr = _obs.tracer()
        if tr is None:
            self.queue.put(item)
            return
        blocked = self.queue.blocked_puts
        item.t_put = time.perf_counter()
        self.queue.put(item)
        if self.queue.blocked_puts != blocked:
            tr.record("ingest.put_wait", item.t_put, time.perf_counter(),
                      tick=tick)

    @staticmethod
    def _combine_meta(metas: List[TickMeta]) -> TickMeta:
        """One decision's view of a super-batch: tuple counts and key
        histograms sum; the frontier stamp is the one before the first
        tick (where a reconfiguration is injected)."""
        hist = (None if metas[0].key_hist is None
                else np.sum([m.key_hist for m in metas], axis=0))
        return TickMeta(tick_id=metas[0].tick_id,
                        n_tuples=sum(m.n_tuples for m in metas),
                        frontier_before=metas[0].frontier_before,
                        key_hist=hist)

    # -- metric sampling ----------------------------------------------------
    def _host_inst_load(self, key_hist) -> Optional[np.ndarray]:
        if key_hist is None:
            return None
        n_max = self._active_shadow.shape[0]
        return np.bincount(self._fmu_shadow, weights=key_hist,
                           minlength=n_max).astype(np.int64)

    def _settle(self, p: Optional[_InFlight]) -> None:
        """Read ``p``'s expiry flag (raising ``ExpiryBoundError``), then
        hand its outputs to the sink; once."""
        if p is None or p.settled:
            return
        raise_on_fault(p.fault)
        self.sink.accept(p.tick_id, *p.outs)
        p.settled = True

    def _drain(self, p: _InFlight, idle_s: float = 0.0):
        """Fetch the sampled metrics of a completed tick (reads only the
        ``switched`` flag, the expiry flag and the per-instance load
        vector) and settle it.  ``idle_s``, the time the loop waited on
        the source for the NEXT tick, is subtracted so a starved source
        does not inflate tick latency."""
        tick_id, meta = p.tick_id, p.meta
        with _obs.span("runtime.drain", tick=tick_id):
            # the control-lane read: waits for the stream, which holds the
            # super-batch dispatched after this one
            with _obs.span("runtime.flag_read"):
                sw = bool(p.switched)
            with _obs.span("runtime.sink"):
                self._settle(p)
            with _obs.span("runtime.load_read"):
                load = (_np(p.inst_load) if p.inst_load is not None
                        else self._host_inst_load(meta.key_hist))
            self._record_tick(p, sw, load,
                         max(time.perf_counter() - p.t_dispatch - idle_s,
                             0.0))

    def _record_tick(self, p: _InFlight, sw: bool, load,
                     latency: float) -> None:
        """Fold a drained tick's metrics into the bus (and the ``obs``
        event ring, timelines and SLO rules when installed), and commit a
        switch to the host shadows."""
        tick_id, meta = p.tick_id, p.meta
        o = _obs.get()
        if o is not None:       # the off path builds no event fields
            _obs.event("tick", tick_id=tick_id, n_tuples=meta.n_tuples,
                       latency_ms=latency * 1e3,
                       queue_depth=self.queue.depth,
                       queue_high_water=self.queue.high_water, switched=sw,
                       wmark_frontier=meta.frontier_before.tolist())
        # record BEFORE updating the shadows: this tick's load was measured
        # under the pre-switch tables
        self.metrics.record_tick(tick_id, meta.n_tuples, latency, load,
                                 self.queue.depth,
                                 n_active=int(self._active_shadow.sum()))
        if o is not None:
            if o.timeline is not None:
                o.timeline.mark_tick(tick_id, "drain")
                o.timeline.mark_tick(tick_id, "emit")
            if o.slo is not None:
                new = o.evaluate_slo()
                if new:
                    self._pending_breaches.extend(new)
                    self._all_breaches.extend(new)
        if sw:
            self.switches += 1
            # the switch commits the LATEST rc injected by this tick
            resolved = self.metrics.record_switch(tick_id)
            if resolved:
                rc = resolved[-1]
                self._fmu_shadow = np.asarray(rc.fmu).copy()
                self._active_shadow = np.asarray(rc.active).copy()
                _obs.event("switch", tick_id=tick_id, epoch=int(rc.epoch),
                           n_active=int(self._active_shadow.sum()))

    def _decide(self, meta: TickMeta) -> Optional[Reconfiguration]:
        if self.controller is None:
            return None
        with _obs.span("controller.decide", tick=meta.tick_id):
            hint = None
            if hasattr(self.source, "rate_hint"):
                hint = self.source.rate_hint(meta.tick_id)
            if hint is None and len(self.metrics.records) < 2:
                return None    # no rate signal yet: a measured rate of 0.0
                # at stream start would read as idle and trigger a bogus
                # scale-down
            breaches = tuple(self._pending_breaches)
            self._pending_breaches.clear()
            snap = self.metrics.snapshot(
                rate_hint=hint, queue_depth=self.queue.depth,
                backlog_tuples=float(self.queue.depth * meta.n_tuples),
                slo_breaches=breaches)
            return self.controller.observe_live(snap)

    # -- the loop -----------------------------------------------------------
    def run(self, max_ticks: Optional[int] = None) -> RunReport:
        th = threading.Thread(target=self._ingest, args=(max_ticks,),
                              name="ingest", daemon=True)
        self.metrics.start()
        th.start()
        pending = None
        try:
            while True:
                t_wait = time.perf_counter()
                with _obs.span("runtime.queue_get") as span:
                    try:
                        item = self.queue.get()
                    except QueueClosed:  # ingest done, every tick drained
                        break
                    t_got = time.perf_counter()
                    idle_s = t_got - t_wait
                    sup = isinstance(item, StagedSuper)
                    meta = (self._combine_meta(item.metas) if sup
                            else item.meta)
                    span.tick = meta.tick_id
                    if item.t_put is not None:
                        tr = _obs.tracer()
                        if tr is not None:
                            tr.record("runtime.queue_residence", item.t_put,
                                      t_got, tick=meta.tick_id,
                                      thread="queue")
                if self.checkpointer is not None:
                    # the boundary BEFORE this dispatch: the pipeline state
                    # covers every tick < meta.tick_id; if it is saved, the
                    # tick in flight is settled first, then the capture
                    # copies the state to the host; the disk write is
                    # asynchronous
                    with _obs.span("runtime.checkpoint", tick=meta.tick_id):
                        self.checkpointer.maybe_save(
                            meta.tick_id, meta.frontier_before,
                            before=lambda: self._settle(pending))
                rc = self._decide(meta)
                t0 = time.perf_counter()
                with _obs.span("runtime.dispatch", tick=meta.tick_id):
                    if sup:
                        out = self.pipeline.run_persistent_staged(
                            item.stack, reconfig=rc, reconfig_at=0,
                            frontier=meta.frontier_before)
                        o1, o2 = out.outs_pre, out.outs_post
                        switched = out.switched.any()
                        inst_load = (None if out.inst_load is None
                                     else out.inst_load.sum(dim=0))
                    else:
                        o1, o2, switched, inst_load = \
                            self.pipeline.step_staged(
                                item.staged, reconfig=rc,
                                frontier=meta.frontier_before)
                tl = _obs.exemplars()
                if tl is not None:
                    tl.mark_tick(meta.tick_id, "dispatch")
                if rc is not None:
                    self.reconfig_trace.append((meta.tick_id, rc))
                    self.metrics.record_detection(rc.epoch,
                                                  meta.tick_id, rc)
                    _obs.event("reconfig", tick_id=meta.tick_id,
                               epoch=int(rc.epoch),
                               n_active=int(np.asarray(rc.active).sum()))
                if pending is not None:
                    # tick T-1 is read while T computes; the wait for T's
                    # arrival was source idle time, not T-1's latency
                    self._drain(pending, idle_s=idle_s)
                pending = _InFlight(meta.tick_id, meta, (o1, o2), switched,
                                    inst_load,
                                    getattr(self.pipeline, "fault", None), t0)
            if pending is not None:
                self._drain(pending)
        except BaseException as e:
            # failures come with a timeline: stamp the crash into the ring
            # and dump it (when a dump_dir is configured) before unwinding
            _obs.event("runtime_crash", error=repr(e))
            o = _obs.get()
            if o is not None:
                o.dump_flight(reason=f"runtime_crash: {e!r}")
            raise
        finally:
            # on error the ingest thread may be parked in put(); closing
            # the queue releases it so nothing outlives the run
            self.queue.close()
            self.metrics.stop()
            th.join(timeout=30)
            if self.checkpointer is not None:
                self.checkpointer.wait()   # never exit with a torn save
        if self._ingest_error is not None:
            o = _obs.get()
            if o is not None:
                o.dump_flight(
                    reason=f"ingest_error: {self._ingest_error!r}")
            raise self._ingest_error
        return make_report(self.metrics, self.reconfig_trace, self.switches,
                           queue=self.queue, slo_breaches=self._all_breaches)


def run_sync(pipeline, source, sink=None, controller=None,
             max_ticks: Optional[int] = None,
             reconfig_trace=None) -> Tuple[RunReport, Any]:
    """The synchronous host-loop baseline: take a tick, step, wait for the
    outputs, repeat.  Same semantics as the async loop (same control
    tuples, same frontier stamps) minus every overlap.

    ``reconfig_trace`` replays a recorded ``[(tick_id, Reconfiguration)]``
    (e.g. from an async run) instead of consulting ``controller``, so a
    parity check can hold the reconfiguration sequence fixed.
    """
    sink = sink if sink is not None else CollectSink()
    metrics = MetricsBus(queue_cap=0)
    n_inputs = pipeline.op.n_inputs
    k_virt = pipeline.op.k_virt
    frontier = _initial_frontier(pipeline, n_inputs)
    replay = dict(reconfig_trace) if reconfig_trace is not None else None
    trace: List[Tuple[int, Reconfiguration]] = []
    switches = 0
    active_shadow = _np(pipeline.epoch.active).copy()
    metrics.start()
    for tick_id, b in enumerate(source):
        if max_ticks is not None and tick_id >= max_ticks:
            break
        meta = tick_meta(b, tick_id, n_inputs, k_virt, frontier,
                         with_hist=False)
        if replay is not None:
            rc = replay.get(tick_id)
        elif controller is not None:
            hint = (source.rate_hint(tick_id)
                    if hasattr(source, "rate_hint") else None)
            if hint is None and len(metrics.records) < 2:
                rc = None     # no rate signal yet (see _decide)
            else:
                rc = controller.observe_live(
                    metrics.snapshot(rate_hint=hint))
        else:
            rc = None
        t0 = time.perf_counter()
        o1, o2, switched, inst_load = pipeline.step_staged(
            b, reconfig=rc, frontier=meta.frontier_before)
        if rc is not None:
            trace.append((tick_id, rc))
            metrics.record_detection(rc.epoch, tick_id, rc)
        _wait(pipeline)                        # the synchronous host loop
        sw = bool(switched)
        raise_on_fault(getattr(pipeline, "fault", None))
        load = None if inst_load is None else _np(inst_load)
        metrics.record_tick(tick_id, meta.n_tuples,
                            time.perf_counter() - t0, load, 0,
                            n_active=int(active_shadow.sum()))
        if sw:
            switches += 1
            resolved = metrics.record_switch(tick_id)
            if resolved:
                active_shadow = np.asarray(resolved[-1].active).copy()
        sink.accept(tick_id, o1, o2)
    metrics.stop()
    return make_report(metrics, trace, switches), sink
