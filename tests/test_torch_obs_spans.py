"""The port's spans inside the live runtime and the persistent driver, on
the CPU: a tiny ``VSNPipeline`` run by ``AsyncStreamRuntime`` in
super-batches of 2.  Each span of a super-batch is recorded once with its
thread, nesting path and the super-batch's first tick id; each staged
item's queue residence runs from its put to its get; every record lies
inside the clock reads around it; with no ``Obs`` nothing is recorded;
tracing changes no output, flag or load; a full ring counts its drops."""

import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.core import aggregate as PA
from repro_torch.core.async_runtime import AsyncStreamRuntime
from repro_torch.core.controller import (Reconfiguration, active_mask,
                                         balanced_fmu)
from repro_torch.core.runtime import VSNPipeline
from repro_torch.core.vsn import merge_fast_state
from repro_torch.core.windows import WindowSpec
from repro_torch.data import datagen
from repro_torch.io import SyntheticSource
from repro_torch.obs.trace import _NULL_SPAN, Tracer

K_VIRT, N_TICKS, SB = 64, 6, 2
FIRSTS = (0, 2, 4)              # the three super-batches' first tick ids


def _pipe():
    op = PA.count_aggregate(WindowSpec(wa=50, ws=100, wt="multi"), K_VIRT,
                            out_cap=512, extra_slots=2)
    return VSNPipeline(op, n_max=8, n_active=4, stash_cap=64,
                       tick_fn=lambda o, s, r, m, explicit_w=None:
                       PA.tick_fast(o, "count", s, r, m),
                       merge_fn=merge_fast_state,
                       init_sigma=lambda d: PA.fast_init(op.resolved(), d),
                       device="cpu")


def _batches():
    return list(datagen.tweets(np.random.default_rng(0), n_ticks=N_TICKS,
                               tick=16, words_per_tweet=3, vocab=500,
                               k_virt=K_VIRT, rate_per_tick=30,
                               device="cpu"))


class _Hinted(SyntheticSource):
    def rate_hint(self, tick_id):
        return 1000.0


class _SlowOnce:
    """Decides a reconfiguration at its second call; each decision takes
    ``sleep`` seconds, so the ingest thread fills the queue and blocks."""

    def __init__(self, sleep=0.0):
        self.calls, self.sleep = 0, sleep

    def observe_live(self, snap):
        time.sleep(self.sleep)
        self.calls += 1
        if self.calls == 2:
            return Reconfiguration(epoch=1, n_active=3,
                                   fmu=balanced_fmu(K_VIRT, 3, 8),
                                   active=active_mask(3, 8))
        return None


def _run(sleep=0.0):
    """One run of the three super-batches; -> (runtime, per-call switch
    flags and loads)."""
    pipe = _pipe()
    calls = []
    run0 = pipe.run_persistent_staged

    def run(*a, **kw):
        out = run0(*a, **kw)
        calls.append((out.switched.clone(), out.inst_load.clone()))
        return out

    pipe.run_persistent_staged = run
    rt = AsyncStreamRuntime(pipe, _Hinted(iter(_batches())),
                            controller=_SlowOnce(sleep), queue_cap=1,
                            super_batch=SB)
    rt.run()
    return rt, calls


@pytest.fixture
def traced():
    """A run with span timing on: its records, the clock read before and
    after it, and the tracer."""
    o = obs.install(obs.ObsConfig(enabled=True, trace=True, flight=False,
                                  span_cap=4096))
    try:
        t_before = time.perf_counter()
        _run(sleep=0.05)
        t_after = time.perf_counter()
    finally:
        obs.set_current(None)
    return list(o.tracer.finished), t_before, t_after, o.tracer


def test_each_span_once_a_super_batch_with_thread_path_and_tick(traced):
    recs, _, _, tracer = traced
    main = threading.current_thread().name
    seen = Counter((r["thread"], r["path"], r["tick"]) for r in recs)
    per_super = {
        ("ingest", "ingest.source"): SB, ("ingest", "ingest.meta"): SB,
        ("ingest", "ingest.stage"): 1,
        ("ingest", "ingest.stage/stage.pack"): 1,
        ("ingest", "ingest.stage/stage.copy"): 1,
        ("queue", "runtime.queue_residence"): 1,
        (main, "runtime.queue_get"): 1, (main, "controller.decide"): 1,
        (main, "runtime.dispatch"): 1,
        (main, "runtime.dispatch/driver.operands"): 1,
        (main, "runtime.dispatch/driver.load"): 1,
        (main, "runtime.drain"): 1,
        (main, "runtime.drain/runtime.flag_read"): 1,
        (main, "runtime.drain/runtime.sink"): 1,
        (main, "runtime.drain/runtime.load_read"): 1,
    }
    for (thread, path), n in per_super.items():
        for first in FIRSTS:
            assert seen.pop((thread, path, first)) == n, (thread, path,
                                                          first)
    # the source's end (asked for once all three were staged) and the
    # step loop's last get, which meets the closed queue
    assert seen.pop(("ingest", "ingest.source", N_TICKS)) == 1
    assert seen.pop((main, "runtime.queue_get", None)) == 1
    # the decisions took 50 ms and the queue holds one item: the ingest
    # thread blocked at least once, and only there
    waits = [k for k in seen if k[1] == "ingest.put_wait"]
    assert waits and all(k[0] == "ingest" and k[2] in FIRSTS for k in waits)
    assert not {k: n for k, n in seen.items() if k not in waits}
    assert tracer.dropped == 0


def test_queue_residence_runs_from_put_to_get(traced):
    recs = traced[0]
    res = {r["tick"]: r for r in recs
           if r["name"] == "runtime.queue_residence"}
    gets = {r["tick"]: r for r in recs if r["name"] == "runtime.queue_get"}
    stages = {r["tick"]: r for r in recs if r["name"] == "ingest.stage"}
    assert sorted(res) == list(FIRSTS)
    for first, r in res.items():
        assert r["t0"] <= r["t_end"]
        # put after its staging, the get's return inside the step loop's
        # queue_get
        assert stages[first]["t_end"] <= r["t0"]
        assert gets[first]["t0"] <= r["t_end"] <= gets[first]["t_end"]


def test_records_lie_inside_the_clock_reads_around_them(traced):
    recs, t_before, t_after, _ = traced
    for r in recs:
        assert t_before <= r["t0"] <= r["t_end"] <= t_after, r
        assert r["dur_s"] == r["t_end"] - r["t0"]
    # a child inside its parent: the same thread and tick, the path's
    # prefix
    by_key = {(r["thread"], r["path"], r["tick"]): r for r in recs}
    for r in recs:
        if "/" not in r["path"]:
            continue
        parent = by_key[(r["thread"], r["path"].rsplit("/", 1)[0],
                         r["tick"])]
        assert parent["t0"] <= r["t0"] <= r["t_end"] <= parent["t_end"]


def test_no_obs_records_nothing():
    assert obs.get() is None
    assert obs.span("runtime.drain") is _NULL_SPAN
    assert obs.span("runtime.drain", tick=3) is _NULL_SPAN
    assert obs.tracer() is None
    with obs.span("runtime.queue_get") as s:
        s.tick = 4                       # a late id on the null span
    assert s.tick is None
    # an Obs with span timing off: the null span too
    o = obs.install(obs.ObsConfig(enabled=True, trace=False, flight=False))
    try:
        assert obs.span("x") is _NULL_SPAN and obs.tracer() is None
        _run()
        assert not o.tracer.finished and not o.registry.histograms.get(
            "span.runtime.drain")
    finally:
        obs.set_current(None)
    # a tracer that was installed records nothing once it is not
    o = obs.install(obs.ObsConfig(enabled=True, trace=True))
    obs.set_current(None)
    _run()
    assert not o.tracer.finished and o.tracer.dropped == 0


def test_outputs_flags_and_loads_identical_with_tracing_on_and_off():
    off, calls_off = _run()
    obs.install(obs.ObsConfig(enabled=True, trace=True, flight=False))
    try:
        on, calls_on = _run()
    finally:
        obs.set_current(None)
    assert on.sink.results() == off.sink.results()
    assert on.sink.results()
    assert len(calls_on) == len(calls_off) == len(FIRSTS)
    for (sw_on, il_on), (sw_off, il_off) in zip(calls_on, calls_off):
        assert torch.equal(sw_on, sw_off) and torch.equal(il_on, il_off)
    assert on.switches == off.switches == 1
    assert [t for t, _ in on.reconfig_trace] == \
        [t for t, _ in off.reconfig_trace] == [2]


def test_full_ring_counts_its_drops():
    tr = Tracer(obs.MetricsRegistry(), span_cap=3)
    for i in range(4):
        with tr.span("a", tick=i):
            pass
    tr.record("b", 1.0, 2.0, tick=9, thread="queue")
    assert tr.dropped == 2
    assert [(r["name"], r["tick"]) for r in tr.finished] == [
        ("a", 2), ("a", 3), ("b", 9)]
    assert tr.registry.histograms["span.a"].count == 4
    assert tr.finished[-1]["thread"] == "queue"
    assert tr.finished[-1]["dur_s"] == 1.0
    tr.drain()
    with tr.span("a"):
        pass
    assert tr.dropped == 2 and len(tr.finished) == 1


def test_a_child_takes_its_parents_tick_and_record_nests():
    tr = Tracer(obs.MetricsRegistry())
    with tr.span("outer") as outer:
        with tr.span("inner"):
            pass
        tr.record("kept", 0.5, 0.75)
        tr.record("lane", 0.5, 0.75, thread="queue")
        outer.tick = 7                   # known only once inside
    inner, kept, lane, outer_r = tr.finished
    assert (inner["path"], inner["tick"]) == ("outer/inner", None)
    assert (kept["path"], kept["thread"]) == (
        "outer/kept", threading.current_thread().name)
    assert (lane["path"], lane["thread"]) == ("lane", "queue")
    assert (outer_r["path"], outer_r["tick"]) == ("outer", 7)
    with tr.span("outer", tick=3):
        with tr.span("inner"):
            pass
    assert tr.finished[-2]["tick"] == 3
