"""One run of one cell: set-up, the measured window, the check, the line.

The window drives the port's live runtime as its users run it:
``AsyncStreamRuntime.run`` with ``super_batch = K`` over the cell's
``VSNPipeline`` (so each super-batch is one persistent call, a CUDA graph
replay on the card), fed by the benchmark's ``Source`` and observed by its
``Sink`` and its ``ScriptedController``.  Set-up builds the stream and the
pipeline; one runtime then runs set-up's ``warmup_superbatches`` (the
graph's capture, a reconfiguration included), in a closed loop for
``settle_s`` more under full load, and the window of ``seconds`` that
follows on the same stream, pipeline and threads.
The instrumented pipeline keeps each call's per-tick switch flags and
per-instance loads, and the sink keeps a seeded sample of super-batches'
outputs; once the window has closed and the pipeline is freed, the plain
reference follows the same stream and the numbers compared are counted.
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from stretchbench import trace as tracing
from stretchbench.controller import ScriptedController, balanced_fmu
from stretchbench.reference.gate import GateModel


class Window:
    """The measured window, fixed by the source while the runtime runs:
    it opens at ``t0`` with tick ``first`` (a super-batch's first) and
    closes ``seconds`` later; the source hands over no tick due after
    ``t_end``."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = self.t_end = self.first = None

    def open(self, first: int, t0: float) -> None:
        self.first, self.t0, self.t_end = first, t0, t0 + self.seconds


class Source:
    """The stream as one runtime pulls it, from tick 0: set-up's ticks,
    then the window's.  The window opens at a super-batch's first tick
    once ``n_warm`` ticks are handed over, ``ready()`` has returned (the
    set-up super-batches dispatched: the graphs captured) and, in a closed
    loop, ``settle_s`` have passed since the first tick.  Closed loop
    (``period`` None): a tick is handed over as soon as it is asked for,
    until ``t_end``; the window opens on a full queue.  Open loop: set-up's
    ticks are handed over at once, the window opens once they are done on
    the device, and tick ``first + j`` is due at ``t0 + (j + 1) * period``
    (its last tuple due), a schedule that does not wait for the runtime;
    the source stops before the first tick due after ``t_end``.  ``stamps``
    holds (tick, due, handed over) for every tick; in a closed loop a tick
    is due when handed over."""

    def __init__(self, stream, rate: float, window: Window, *, k: int,
                 n_warm: int, ready, settle_s: float = 0.0, period=None,
                 spans=None):
        self.stream, self.rate, self.window = stream, rate, window
        self.k, self.n_warm, self.ready = k, n_warm, ready
        self.settle_s, self.period = settle_s, period
        self.stamps: List[tuple] = []
        self.spans = spans if spans is not None else []

    def rate_hint(self, tick_id: int) -> float:
        return self.rate

    def batch(self, i: int):
        from repro_torch.core import tuples as T
        t = self.stream.tick(i)
        return T.make_batch(t["tau"], t["payload"], keys=t["keys"],
                            source=t["src"], kmax=t["keys"].shape[1],
                            device="cpu")

    def _maybe_open(self, i: int, t_first: float) -> None:
        w = self.window
        if w.t0 is not None or i < self.n_warm or i % self.k:
            return
        if self.period is None:
            if time.perf_counter() < t_first + self.settle_s:
                return
            if not self.ready(wait=False):
                return
        else:
            self.ready(wait=True)
        w.open(i, time.perf_counter())

    def __iter__(self):
        w, i, t_first = self.window, 0, time.perf_counter()
        while True:
            self._maybe_open(i, t_first)
            due = None
            if w.t0 is not None and self.period is not None:
                due = w.t0 + (i - w.first + 1) * self.period
                if due > w.t_end:
                    return
                now = time.perf_counter()
                if now < due:
                    time.sleep(due - now)
                    self.spans.append(("ingest:source_wait", now,
                                       time.perf_counter()))
            elif w.t0 is not None and time.perf_counter() >= w.t_end:
                return
            t = time.perf_counter()
            b = self.batch(i)
            taken = time.perf_counter()
            self.spans.append(("ingest:source", t, taken))
            self.stamps.append((i, taken if due is None else due, taken))
            yield b
            i += 1


class Sink:
    """Stamps each super-batch's acceptance (``accepted``: super-batch →
    host clock, super-batch ``s`` holding ticks ``s * k ..``), and keeps
    the outputs of a sample of the window's super-batches drawn from the
    seed: the first ``always`` that reconfigure, and a reservoir of ``n``
    others."""

    def __init__(self, k: int, seed: int, n: int, always: int, controller,
                 window: Window):
        self.k, self.window = k, window
        self.accepted: Dict[int, float] = {}
        self.kept: Dict[int, tuple] = {}
        self.rng = np.random.default_rng([seed, 7])
        self.n, self.always, self.controller = n, always, controller
        self.reservoir: List[int] = []
        self.seen = 0

    def accept(self, tick_id: int, outs_pre, outs_post) -> None:
        now = time.perf_counter()
        sb = tick_id // self.k
        self.accepted[sb] = now
        if self.window.first is None or sb < self.window.first // self.k:
            return
        first_sb = self.window.first // self.k
        mine = [d["sb"] for d in self.controller.decisions
                if d["sb"] >= first_sb][:self.always]
        if sb in mine:
            self.kept[sb] = (outs_pre, outs_post)
            return
        self.seen += 1
        if len(self.reservoir) < self.n:
            self.reservoir.append(sb)
            self.kept[sb] = (outs_pre, outs_post)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.n:
            del self.kept[self.reservoir[j]]
            self.reservoir[j] = sb
            self.kept[sb] = (outs_pre, outs_post)


class _Drop:
    """The traced segment's sink."""

    def accept(self, tick_id, outs_pre, outs_post) -> None:
        pass


class Recorder:
    """What the instrumented pipeline keeps: each persistent call's switch
    flags and loads (device tensors), the host spans of the step loop's
    calls and of ``stage_super``, and the tracer's window."""

    def __init__(self):
        self.flags, self.loads = [], []
        self.spans: List[tuple] = []
        self.tracer = None
        self.trace_from = self.trace_n = 0

    def instrument(self, pipe) -> None:
        run0, stage0 = pipe.run_persistent_staged, pipe.stage_super

        def run(stack, reconfig=None, reconfig_at=0, frontier=None):
            c = len(self.flags)
            if self.tracer is not None and c == self.trace_from:
                self.tracer.start()
            t = time.perf_counter()
            out = run0(stack, reconfig=reconfig, reconfig_at=reconfig_at,
                       frontier=frontier)
            self.spans.append(("main:dispatch", t, time.perf_counter()))
            self.flags.append(out.switched)
            self.loads.append(out.inst_load)
            if (self.tracer is not None
                    and c == self.trace_from + self.trace_n - 1):
                self.tracer.stop()
            return out

        def stage(batches):
            t = time.perf_counter()
            s = stage0(batches)
            self.spans.append(("ingest:stage_super", t, time.perf_counter()))
            return s

        pipe.run_persistent_staged = run
        pipe.stage_super = stage


class Run:
    """The record of one run that the metric readers read."""


def _host(outs) -> Dict[str, np.ndarray]:
    return {f: getattr(outs, f).cpu().numpy()
            for f in ("tau", "payload", "valid")}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Segment:
    """The traced segment's stream: ``n`` ticks from ``first``, at once or
    (``period``) due on a schedule from its start."""

    def __init__(self, source: Source, first: int, n: int):
        self.source, self.first, self.n = source, first, n

    def rate_hint(self, tick_id: int) -> float:
        return self.source.rate

    def __iter__(self):
        period, t0 = self.source.period, time.perf_counter()
        for j in range(self.n):
            if period is not None:
                wait = t0 + (j + 1) * period - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            yield self.source.batch(self.first + j)


def run_cell(cfg: dict, traffic: dict, kind, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, wrap=None) -> Run:
    """Set-up, the window and the check; returns the run's record.  One
    runtime runs set-up's super-batches and the window (``Source``).  With
    ``trace`` (on the card) a traced segment follows the window: the same
    traffic, ``trace_from`` super-batches to fill the runtime's queue, then
    ``trace_superbatches`` under the profiler, so the window itself runs
    as in an untraced run."""
    import torch
    from repro_torch.core.async_runtime import AsyncStreamRuntime

    device = torch.device(device)
    k = int(cfg["super_batch"])
    # set-up's parts, seconds from the start of the process
    phases = {"imports": time.perf_counter() - t_start}
    stream = kind.make_stream(cfg, traffic, seed)
    phases["stream"] = time.perf_counter() - t_start
    pipe = kind.make_pipeline(cfg, stream, device, wrap)
    _sync(device)
    phases["pipeline"] = time.perf_counter() - t_start
    fmu0 = pipe.epoch.fmu.cpu().numpy()
    ctrl = ScriptedController(traffic["reconfig"], cfg["k_virt"],
                              cfg["n_max"])
    rec = Recorder()
    rec.instrument(pipe)
    # the offered rate a closed loop has not fixed: the hint the runtime
    # asks for, which the scripted controller does not read
    rate = float(traffic.get("rate_tuples_per_s", 1.0))
    period = (cfg["tick"] / float(traffic["rate_tuples_per_s"])
              if traffic["loop"] == "open" else None)
    n_warm = int(traffic["warmup_superbatches"]) * k

    def ready(wait: bool) -> bool:
        """Set-up's super-batches dispatched (their graphs captured); with
        ``wait``, once they are, done on the device."""
        while len(rec.flags) < n_warm // k:
            if not wait:
                return False
            time.sleep(0.001)
        if wait:
            _sync(device)
        return True

    def runtime(source, sink, tick0):
        return AsyncStreamRuntime(pipe, source, sink=sink, controller=ctrl,
                                  queue_cap=cfg["queue_cap"], super_batch=k,
                                  tick0=tick0)

    win = Window(seconds)
    source = Source(stream, rate, win, k=k, n_warm=n_warm, ready=ready,
                    settle_s=float(traffic.get("settle_s", 0.0)),
                    period=period, spans=rec.spans)
    sink = Sink(k, seed, int(traffic["sample_superbatches"]),
                int(traffic["sample_reconfigs"]), ctrl, win)
    report = runtime(source, sink, 0).run()
    _sync(device)
    if win.t0 is None:
        raise RuntimeError("the window never opened: set-up did not end")
    n_run = len(source.stamps)
    # each persistent call's first tick and real ticks (the window's last
    # call may be padded)
    calls = [(j, min(k, n_run - j)) for j in range(0, n_run, k)]
    phases["first_superbatch"] = next(
        b for n, _, b in rec.spans if n == "main:dispatch") - t_start
    phases["window"] = win.t0 - t_start
    run = Run()
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)

    run.trace = None
    if trace:
        # the profiler reads the card; on the CPU the segment runs alone
        if device.type == "cuda":
            rec.tracer = tracing.Tracer()
        rec.trace_from = len(rec.flags) + int(traffic["trace_from"])
        rec.trace_n = int(traffic["trace_superbatches"])
        n_seg = (int(traffic["trace_from"]) + rec.trace_n) * k
        if rec.tracer is not None:
            rec.tracer.begin()
        runtime(Segment(source, n_run, n_seg), _Drop(), n_run).run()
        _sync(device)
        calls += [(n_run + j, k) for j in range(0, n_seg, k)]
        if rec.tracer is not None:
            run.trace = rec.tracer.parse()
        run.traced_ticks = [t for c in range(rec.trace_from,
                                             rec.trace_from + rec.trace_n)
                            for t in range(calls[c][0], calls[c][0] + k)]

    run.cfg, run.traffic, run.seconds, run.k = cfg, traffic, seconds, k
    run.t0, run.t_end = win.t0, win.t_end
    run.setup_s = win.t0 - t_start
    run.setup_phases = phases
    run.report = report
    run.graphs = pipe.persistent_graphs()
    run.switch_bytes = pipe.switch_bytes()
    run.spans = list(rec.spans)
    for d in ctrl.decisions:
        d["tick"] = calls[d["sb"]][0]
    run.decisions = [d for d in ctrl.decisions if d["tick"] < n_run]
    stamps = np.array(source.stamps, dtype=np.float64).reshape(-1, 3)
    stamps = stamps[stamps[:, 0] >= win.first]
    run.tick_ids = stamps[:, 0].astype(np.int64)
    run.due, run.taken = stamps[:, 1], stamps[:, 2]
    run.accept = np.array([sink.accepted.get(int(i) // k, np.inf)
                           for i in run.tick_ids])
    run.sink_accepted = dict(sink.accepted)
    run.sb_tuples = {c // k: n * cfg["tick"] for c, n in calls if c < n_run}
    flags = np.concatenate([f.cpu().numpy()[:n] for f, (_, n)
                            in zip(rec.flags, calls)])
    loads = np.concatenate([x.cpu().numpy()[:n] for x, (_, n)
                            in zip(rec.loads, calls)])
    got = _counts(kind, {sb: (_host(o1), _host(o2))
                         for sb, (o1, o2) in sink.kept.items()}, k, n_run)
    run.program_flags = flags
    del pipe, sink, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref, exp_flags, exp_loads = reference_run(cfg, kind, stream, fmu0,
                                              ctrl.decisions, len(flags))
    _check(run, ref, exp_flags, exp_loads, flags, loads, got)
    return run


def _counts(kind, kept: dict, k: int, n_ticks: int) -> Dict[int, Counter]:
    """The kept super-batches' outputs, tick by tick (the real ticks of
    ``0 .. n_ticks - 1``), as multisets of the kind's output lanes."""
    got = {}
    for sb, (o1, o2) in kept.items():
        for j in range(min(k, n_ticks - sb * k)):
            c = Counter()
            for o in (o1, o2):
                v = o["valid"][j]
                for tau, pay in zip(o["tau"][j][v], o["payload"][j][v]):
                    c[kind.canon(int(tau), pay)] += 1
            got[sb * k + j] = c
    return got


def _check(run: Run, ref, exp_flags, exp_loads, flags, loads,
           got: Dict[int, Counter]) -> None:
    """Counts what differs from the reference: every tick's switch flag
    and loads, and the outputs of the sampled ticks ``got``."""
    bad_flags = np.nonzero(flags != exp_flags)[0]
    bad_loads = np.nonzero((loads != exp_loads).any(axis=1))[0]
    out_wrong, out_checked, bad_out = 0, 0, set()
    for i, c in sorted(got.items()):
        want = ref.expected(i)
        wrong = sum((c - want).values()) + sum((want - c).values())
        out_wrong += wrong
        out_checked += sum(want.values())
        if wrong:
            bad_out.add(i)
    run.ref = ref
    run.checks = {"outputs_wrong": out_wrong, "flags_wrong": len(bad_flags),
                  "loads_wrong": len(bad_loads)}
    run.checked = {"outputs": out_checked, "ticks": len(flags),
                   "sampled_ticks": len(got)}
    window = set(int(i) for i in run.tick_ids)
    run.failed = len(window & (set(bad_flags.tolist())
                               | set(bad_loads.tolist()) | bad_out))
    run.switches = int(exp_flags[run.tick_ids].sum())


def verdict(checks: Dict[str, int], limits: Dict[str, int]) -> bool:
    """``correct``: every number compared within its limit."""
    return all(v <= limits[n] for n, v in checks.items())


def reference_run(cfg, kind, stream, fmu0, decisions, n_total: int):
    """The gate model and the kind's reference over ticks ``0 ..
    n_total - 1`` with the controller's decisions injected at their tick
    (the first of their super-batch).  -> (ref, switch flags, loads)."""
    inject = {d["tick"]: d for d in decisions}
    model = GateModel(stream.n_sources, stream.frontier0, fmu0,
                      cfg["n_max"], stream.keys_of)
    ref = kind.Ref(cfg, stream, n_total)
    flags = np.zeros(n_total, bool)
    loads = np.zeros((n_total, cfg["n_max"]), np.int64)
    for i in range(n_total):
        t = stream.tick(i)
        ids, taus, sw, load = model.step(stream.ids(i), t["tau"], t["src"],
                                         inject.get(i))
        ref.on_tick(i, ids, taus, model.last_switch if sw else None)
        flags[i], loads[i] = sw, load
    ref.finish()
    return ref, flags, loads


def run_control(cfg: dict, traffic: dict, kind, *, seed: int, n_sb: int,
                n_sample: int) -> Dict[str, int]:
    """The control: the reference put in the program's place with one
    guarantee broken (the kind's ``expected(i, control=True)``), driven as
    a run is: the scripted controller decides set-up's and ``n_sb``
    window super-batches, the run's ``Sink`` draws the sample from the
    seed, and ``_check`` compares it, flags and loads the reference's.
    -> the numbers compared."""
    k = int(cfg["super_batch"])
    n_warm = int(traffic["warmup_superbatches"]) * k
    n_total = n_warm + n_sb * k
    stream = kind.make_stream(cfg, traffic, seed)
    ctrl = ScriptedController(traffic["reconfig"], cfg["k_virt"],
                              cfg["n_max"], make=SimpleNamespace)
    for _ in range(n_total // k):
        ctrl.observe_live(None)
    for d in ctrl.decisions:
        d["tick"] = d["sb"] * k
    fmu0 = balanced_fmu(cfg["k_virt"], cfg["n_active"], cfg["n_max"])
    ref, flags, loads = reference_run(cfg, kind, stream, fmu0,
                                      ctrl.decisions, n_total)
    win = Window(0.0)
    win.open(n_warm, 0.0)
    sink = Sink(k, seed, n_sample, int(traffic["sample_reconfigs"]), ctrl,
                win)
    for sb in range(n_total // k):
        sink.accept(sb * k, None, None)
    got = {sb * k + j: ref.expected(sb * k + j, control=True)
           for sb in sink.kept for j in range(k)}
    run = Run()
    run.tick_ids = np.arange(n_warm, n_total)
    _check(run, ref, flags, loads, flags, loads, got)
    return run.checks
