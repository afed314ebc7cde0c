"""The port's live runtime on the CPU against the JAX reference: the bounded
queue, sources, metrics bus and controllers, ``AsyncStreamRuntime`` over
an ``IngestTier`` (outputs and switch ticks under the same replayed
reconfiguration trace), and the port's ``obs`` snapshots, which must pass
the reference's ``validate_snapshot``."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_bridge import to_port
from repro import obs as jobs
from repro.core import aggregate as JA
from repro.core import controller as JC
from repro.core.async_runtime import run_sync as j_run_sync
from repro.core.async_runtime import tick_meta as j_tick_meta
from repro.core.controller import Reconfiguration as JRc
from repro.core.runtime import VSNPipeline as JVSN
from repro.core.vsn import merge_fast_state as j_merge
from repro.core.windows import WindowSpec as JWS
from repro.data import datagen as jdg
from repro.ingest import IngestTier as JTier
from repro.io import ReplaySource as JReplay
from repro.io import load_stream as j_load
from repro.io import save_stream as j_save
from repro_torch import obs as pobs
from repro_torch.core import aggregate as PA
from repro_torch.core import controller as PC
from repro_torch.core.async_runtime import (AsyncStreamRuntime, run_sync,
                                            tick_meta)
from repro_torch.core.runtime import VSNPipeline as PVSN
from repro_torch.core.vsn import merge_fast_state as p_merge
from repro_torch.core.windows import WindowSpec as PWS
from repro_torch.ingest import IngestTier as PTier
from repro_torch.io.metrics import MetricsBus
from repro_torch.io.queues import TIMEOUT, BoundedQueue, QueueClosed
from repro_torch.io.sources import (RateSchedule, ReplaySource,
                                    SyntheticSource, load_stream,
                                    save_stream)

K, N_SRC = 64, 4


def _stream(n_ticks=8, seed=0):
    return list(jdg.tweets(np.random.default_rng(seed), n_ticks=n_ticks,
                           tick=16, words_per_tweet=3, vocab=300, k_virt=K,
                           rate_per_tick=30, n_sources=N_SRC))


def _pipes(n_active=2, n_max=8):
    ws = dict(wa=50, ws=100, wt="multi")
    kw = dict(out_cap=512, extra_slots=2, n_inputs=N_SRC)
    jop = JA.count_aggregate(JWS(**ws), K, **kw)
    pop = PA.count_aggregate(PWS(**ws), K, **kw)
    jp = JVSN(jop, n_max=n_max, n_active=n_active, stash_cap=64,
              tick_fn=lambda op, st, r, resp, explicit_w=None:
              JA.tick_fast(op, "count", st, r, resp),
              merge_fn=j_merge,
              init_sigma=lambda: JA.fast_init(jop.resolved()))
    pp = PVSN(pop, n_max=n_max, n_active=n_active, stash_cap=64,
              tick_fn=lambda op, st, r, resp, explicit_w=None:
              PA.tick_fast(op, "count", st, r, resp, explicit_w=explicit_w),
              merge_fn=p_merge,
              init_sigma=lambda d: PA.fast_init(pop.resolved(), d),
              device="cpu")
    return jp, pp


# ------------------------------------------------ runtime over the tier --

def _tier_kw(schedule=None):
    return dict(worker="thread", leaf_cap=16, root_cap=32, out_pad=32,
                root_device=True, schedule=schedule)


def test_async_runtime_over_tier_matches_reference():
    """A controller switches the port's live run over a tier with churn;
    the reference's synchronous loop over the reference tier, replaying the
    same reconfiguration trace, gives the same outputs, switch count and
    detection->switch ticks, and so does the port's own ``run_sync``."""
    batches = _stream()
    sched = RateSchedule(((3, 1500.0), (20, 9000.0)))

    def churn(tier):
        tier.add_host(at_tick=2)
        tier.remove_host(0, at_tick=5)
        return tier

    _, pp = _pipes()
    ctl = PC.ThresholdController(n_max=8, k_virt=K,
                                 capacity_per_instance=2000.0, n_active=2)
    tier = churn(PTier([to_port(b) for b in batches], N_SRC, 2, device="cpu",
                       **_tier_kw(sched)))
    rt = AsyncStreamRuntime(pp, tier, controller=ctl, queue_cap=3)
    rep = rt.run()
    assert rep.reconfig_trace and rep.switches >= 1
    assert rep.ticks == 8 + 2 + 1                  # ticks, 2 reconfigs, flush
    assert rep.queue_high_water <= 3
    outs = rt.sink.results()
    assert outs

    jp, _ = _pipes()
    jtrace = [(t, JRc(epoch=rc.epoch, n_active=rc.n_active, fmu=rc.fmu,
                      active=rc.active)) for t, rc in rep.reconfig_trace]
    jrep, jsink = j_run_sync(jp, churn(JTier(batches, N_SRC, 2, backend="xla",
                                             **_tier_kw())),
                             reconfig_trace=jtrace)
    assert outs == jsink.results()
    assert rep.switches == jrep.switches
    assert rep.detect_to_switch_ticks == jrep.detect_to_switch_ticks

    _, pp2 = _pipes()
    srep, ssink = run_sync(pp2, churn(PTier([to_port(b) for b in batches],
                                            N_SRC, 2, device="cpu",
                                            **_tier_kw())),
                           reconfig_trace=rep.reconfig_trace)
    assert ssink.results() == outs
    assert srep.detect_to_switch_ticks == rep.detect_to_switch_ticks


def test_run_sync_controller_matches_reference():
    """The closed loop through ``run_sync`` makes the reference's
    decisions on the same rate schedule, with the same outputs."""
    batches = _stream()
    sched = RateSchedule(((2, 1500.0), (3, 9000.0), (3, 400.0)))
    mk = dict(n_max=8, k_virt=K, capacity_per_instance=2000.0, n_active=2)
    jp, pp = _pipes()
    jrep, jsink = j_run_sync(jp, JReplay(batches, n_inputs=N_SRC,
                                         schedule=sched),
                             controller=JC.ThresholdController(**mk))
    prep, psink = run_sync(pp, ReplaySource([to_port(b) for b in batches],
                                            n_inputs=N_SRC, schedule=sched),
                           controller=PC.ThresholdController(**mk))
    assert [t for t, _ in jrep.reconfig_trace] == \
        [t for t, _ in prep.reconfig_trace]
    for (_, a), (_, b) in zip(jrep.reconfig_trace, prep.reconfig_trace):
        assert (a.epoch, a.n_active) == (b.epoch, b.n_active)
        np.testing.assert_array_equal(np.asarray(a.fmu), b.fmu)
    assert jrep.switches == prep.switches and jsink.results() == \
        psink.results()


def test_tick_meta_matches_reference():
    b = _stream(n_ticks=1)[0]
    jf, pf = np.zeros((N_SRC,), np.int64), np.zeros((N_SRC,), np.int64)
    jm = j_tick_meta(b, 3, N_SRC, K, jf)
    pm = tick_meta(to_port(b), 3, N_SRC, K, pf)
    assert (jm.tick_id, jm.n_tuples) == (pm.tick_id, pm.n_tuples)
    for a, c in ((jm.frontier_before, pm.frontier_before),
                 (jm.key_hist, pm.key_hist), (jf, pf)):
        np.testing.assert_array_equal(a, c)


def test_launcher_pipeline_matches_reference_general_run():
    """``--pipeline`` runs the count aggregate's fast path over the tier;
    the reference launcher's ``--pipeline`` runs the general O+ tick over
    its own tier.  Both give the same outputs over the same ticks."""
    import argparse

    from repro.core.async_runtime import AsyncStreamRuntime as JAsync
    from repro.launch import ingest_tier as jl
    from repro_torch.launch import ingest_tier as pl
    args = pl.parse_args(["--ticks", "12", "--tick", "32", "--leaves", "2",
                          "--sources", "4", "--worker", "inline",
                          "--device", "cpu"])
    batches = jl.make_stream(argparse.Namespace(
        seed=args.seed, ticks=args.ticks, tick=args.tick,
        sources=args.sources))
    prep, psink = pl.run_pipeline(args, [to_port(b) for b in batches], "cpu")

    op = JA.count_aggregate(JWS(wa=500, ws=1000, wt="multi"),
                            k_virt=jl.K_VIRT, out_cap=1024, extra_slots=2,
                            n_inputs=args.sources)
    pipe = JVSN(op, n_max=8, n_active=4,
                stash_cap=args.root_cap + args.leaf_cap)
    tier = JTier(batches, args.sources, args.leaves, worker=args.worker,
                 leaf_cap=args.leaf_cap, root_cap=args.root_cap,
                 out_pad=2 * args.tick, backend="xla")
    jrt = JAsync(pipe, tier, queue_cap=4)
    jrep = jrt.run()
    assert prep.ticks == jrep.ticks == args.ticks + 1
    assert psink.results() and psink.results() == jrt.sink.results()


def test_super_batch_is_not_ported_yet():
    _, pp = _pipes()
    with pytest.raises(NotImplementedError, match="run_persistent"):
        AsyncStreamRuntime(pp, [], super_batch=4)


# ------------------------------------------------ controllers + metrics --

@pytest.mark.parametrize("kind", ["threshold", "predictive"])
def test_controllers_decide_like_the_reference(kind):
    rng = np.random.default_rng(9)
    if kind == "threshold":
        kw = dict(n_max=16, k_virt=K, capacity_per_instance=1000.0)
        jc, pc = JC.ThresholdController(**kw), PC.ThresholdController(**kw)
    else:
        kw = dict(n_max=16, k_virt=K, comparisons_per_s_per_instance=5e6,
                  ws_seconds=2.0)
        jc, pc = JC.PredictiveController(**kw), PC.PredictiveController(**kw)
    for _ in range(30):
        load = rng.integers(0, 50, 16).astype(np.int64)
        m = dict(rate_tps=float(rng.uniform(100, 12000)), inst_load=load,
                 n_active_observed=int(rng.integers(0, 16)),
                 queue_depth=int(rng.integers(0, 4)), queue_cap=4,
                 backlog_tuples=float(rng.uniform(0, 500)))
        a = jc.observe_live(JC.LiveMetrics(**m))
        b = pc.observe_live(PC.LiveMetrics(**m))
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.epoch, a.n_active) == (b.epoch, b.n_active)
            np.testing.assert_array_equal(np.asarray(a.fmu), b.fmu)
            np.testing.assert_array_equal(np.asarray(a.active), b.active)
        assert JC.LiveMetrics(**m).load_skew(5) == \
            PC.LiveMetrics(**m).load_skew(5)


def test_metrics_bus_pairs_load_with_observed_active():
    m = MetricsBus()
    m.start()
    m.record_tick(0, 10, 0.01, np.array([5.0, 5.0, 0.0, 0.0]), 0,
                  n_active=2)
    m.record_tick(1, 30, 0.03, np.array([9.0, 3.0, 0.0, 0.0]), 1,
                  n_active=2)
    snap = m.snapshot(rate_hint=100.0)
    assert snap.n_active_observed == 2 and snap.rate_tps == 100.0
    assert snap.load_skew(snap.n_active_observed) == 1.5
    p50, p99 = m.latency_quantiles_ms()
    assert p50 == pytest.approx(20.0) and p99 == pytest.approx(29.8)
    m.record_detection(1, 1)
    m.stop()
    assert len(m.unresolved_detections) == 1


# ---------------------------------------------------- queues + sources --

def test_bounded_queue_backpressure_slow_consumer():
    """Depth never exceeds the cap while a fast producer feeds a slow
    consumer; the producer blocks instead."""
    q = BoundedQueue(3)
    seen, depths = [], []

    def produce():
        for i in range(20):
            q.put(i)
        q.close()

    t = threading.Thread(target=produce)
    t.start()
    try:
        while True:
            depths.append(q.depth)
            item = q.get(timeout=5)
            if item is TIMEOUT:
                pytest.fail("starved: producer made no progress in 5s")
            seen.append(item)
            time.sleep(0.002)       # slow consumer
    except QueueClosed:
        pass
    t.join()
    assert seen == list(range(20))  # FIFO, nothing lost
    assert q.high_water <= 3 and max(depths) <= 3
    assert q.blocked_puts > 0       # the producer actually blocked


def test_bounded_queue_put_after_close_raises():
    q = BoundedQueue(2)
    q.close()
    with pytest.raises(QueueClosed):
        q.put(1)
    with pytest.raises(QueueClosed):
        q.get()


def test_bounded_queue_get_disambiguates_timeout_from_close():
    q = BoundedQueue(2)
    assert q.get(timeout=0.01) is TIMEOUT      # open + empty: not an end
    q.put("a")
    q.put("b")
    q.close()
    assert q.get(timeout=0.01) == "a"          # close never loses items
    assert q.get() == "b"
    with pytest.raises(QueueClosed):           # ...and only then ends
        q.get(timeout=0.01)


def test_streams_saved_by_either_package_load_in_the_other(tmp_path):
    batches = _stream(n_ticks=3)
    j_save(str(tmp_path / "j.npz"), batches, n_inputs=N_SRC)
    save_stream(str(tmp_path / "p.npz"), [to_port(b) for b in batches],
                n_inputs=N_SRC)
    got = load_stream(str(tmp_path / "j.npz"), from_tick=1, device="cpu")
    back = j_load(str(tmp_path / "p.npz"))
    assert got.n_inputs == back.n_inputs == N_SRC and len(got) == 2
    for a, p, q in zip(batches[1:], got, list(back)[1:]):
        for f in ("tau", "keys", "payload", "source", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(p, f).numpy())
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(q, f)))


def test_rate_schedule_and_paced_source():
    s = RateSchedule(((2, 100.0), (3, 900.0)))
    assert [s.rate_at(i) for i in range(7)] == [100., 100., 900., 900.,
                                                900., 900., 900.]
    assert s.total_ticks == 5
    batches = [to_port(b) for b in _stream(n_ticks=3)]
    src = SyntheticSource(batches, schedule=RateSchedule(((3, 3200.0),)),
                          pace=True, tick_size=16)
    t0 = time.perf_counter()
    assert len(list(src)) == 3
    assert time.perf_counter() - t0 >= 2 * 16 / 3200.0
    assert src.rate_hint(1) == 3200.0
    assert len(ReplaySource(batches).from_tick(1)) == 2


# ------------------------------------------------------------------ obs --

def test_obs_snapshot_passes_reference_validation():
    """The port's obs package (a framework-free copy) instruments the tier
    and the runtime; its snapshot passes the reference's validator."""
    o = pobs.install(pobs.ObsConfig(enabled=True, trace=True))
    try:
        _, pp = _pipes()
        tier = PTier([to_port(b) for b in _stream(n_ticks=4)], N_SRC, 2,
                     device="cpu", worker="inline", leaf_cap=16, root_cap=32,
                     out_pad=32)
        rep = AsyncStreamRuntime(pp, tier, queue_cap=2).run()
        snap = o.snapshot()
    finally:
        pobs.set_current(None)
    jobs.validate_snapshot(snap)
    assert snap["counters"]["root.rounds"] == rep.ticks == 5
    assert snap["counters"]["bus.ticks"] == 5
    assert "span.root.merge" in snap["histograms"]
    assert rep.stage_latency_ms
