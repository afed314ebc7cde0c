"""Elasticity / fault drill (§8.4-§8.5 at the runtime level + serving pool).

Held against ``src/repro/launch/elastic_drill.py``.  Demonstrates, end to
end, on one host and on ``--device`` (default: the card):

  1. a straggler instance is drained by an f_mu epoch switch (work remap,
     zero state transfer) and the stream's outputs stay exactly correct;
  2. the serving slot pool scales replicas with zero KV movement while the
     SN baseline ships KV (a reduced qwen3-14b);
  3. a crash between checkpoints resumes from the last manifest
     (storage-substrate level);
  4. the full kill-and-restore loop: a checkpointing run dies mid-stream,
     is rebuilt from the manifest-carried ``RuntimeConfig``, restores the
     latest complete snapshot (a planted torn save is invisible), replays
     the recorded stream from the snapshot frontier, and the merged output
     multiset equals the uninterrupted oracle tuple for tuple;
     detection→recovered latency is measured
     (``repro_torch.launch.recovery``).

    PYTHONPATH=src python -m repro_torch.launch.elastic_drill

Pipelines, tiers, and runtimes are built through ``repro_torch.api``
(``RuntimeConfig`` + ``build_runtime``), the same path the checkpoint
manifests serialize.

``--mesh N`` additionally (or with ``--drills mesh``, exclusively) runs
drill 1 on an N-shard stream mesh (default 8 shards; on one card they
time-share it): the epoch switch happens mid-stream, the outputs equal the
single-device run's, and the steps copy no state between shards' devices
(``MeshPipeline.collective_bytes``).

``--live`` (or ``--drills live``) runs the closed loop end to end: the
async runtime streams a rate trace whose spike makes the
``ThresholdController`` provision mid-stream, the ``Reconfiguration`` is
injected live through the control-tuple path, detection→switch latency is
measured, and the output set must exactly match the static max-width
oracle.

``--drills ingest`` drills the hierarchical multi-host ScaleGate: an
ingest host joins mid-stream and another leaves, both with zero
tuple-state transfer, attach/detach latency is measured, and the tier's
merged output must exactly equal the single-ScaleGate oracle.

``--drills recovery-kill`` runs drill 4 with real process-worker ingest
leaves and a SIGKILL (unplanned host loss; slower: each leaf is a spawned
process that initializes its own torch, and on the card its own CUDA
context).
"""

import argparse
import dataclasses
import sys
import tempfile

import numpy as np
import torch

from repro_torch import api
from repro_torch import device as _device
from repro_torch.core.controller import (Reconfiguration, active_mask,
                                         balanced_fmu)
from repro_torch.core.elastic import vsn_switch_bytes
from repro_torch.tree import tree_leaves


def collect(outs):
    res = []
    tau, pay, val = (outs.tau.cpu().numpy(), outs.payload.cpu().numpy(),
                     outs.valid.cpu().numpy())
    for j in range(tau.shape[0]):
        res += [(int(t), tuple(np.round(p, 3))) for t, p, ok in
                zip(tau[j], pay[j], val[j]) if ok]
    return sorted(res)


def base_cfg(k: int, device=None) -> api.RuntimeConfig:
    return api.RuntimeConfig(op="count", wa=50, ws=100, wt="multi",
                             k_virt=k, out_cap=512, n_max=8, n_active=4,
                             stash_cap=64, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=0,
                    help="also run the straggler drill on an N-shard mesh")
    ap.add_argument("--live", action="store_true",
                    help="also run the closed-loop live-runtime drill")
    ap.add_argument("--drills", default="straggler,serving,crash,recovery",
                    help="comma list of straggler,mesh,live,ingest,"
                         "serving,crash,recovery,recovery-kill")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--obs-dump", default=None, metavar="DIR",
                    help="install the observability layer and dump the "
                         "flight-recorder ring + metrics snapshot into DIR "
                         "on drill failure AND at clean exit")
    args = ap.parse_args(argv)
    drills = {d.strip() for d in args.drills.split(",")}
    if args.mesh:
        drills.add("mesh")
    if args.live:
        drills.add("live")

    if not args.obs_dump:
        return run_drills(args, drills)

    from repro_torch import obs as _obs
    # fully-instrumented drills: tracing, sampled exemplar tuple timelines,
    # and a deliberately-unmeetable tick-latency SLO (threshold 1 us) so
    # the breach -> controller.observe_live -> flight-dump loop is
    # exercised (and asserted) on every run of the live drill
    o = _obs.install(_obs.ObsConfig(
        enabled=True, trace=True, dump_dir=args.obs_dump,
        exemplar_rate=1.0 / 8.0,
        slo_rules=[dict(name="tick_p99", metric="bus.tick_latency_s",
                        threshold=1e-6, quantile=0.99, window_s=30.0,
                        min_count=4, cooldown_s=0.5)]))
    try:
        rc = run_drills(args, drills)
    except BaseException as e:
        # the runtime layers may have dumped already (runtime_crash /
        # ingest_error paths); this catches failures outside them,
        # drill-level assertion failures included, and re-raises
        o.dump_flight(reason=f"drill_failure: {e!r}")
        o.export(args.obs_dump)
        raise
    o.export(args.obs_dump)
    path = o.dump_flight(reason="drill_complete")
    print(f"[obs] metrics + flight ring dumped to {args.obs_dump} "
          f"({path})")
    return rc


def run_drills(args, drills):
    k = 64
    dev = _device.resolve(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    print(f"# device {dev} ({name})")
    from repro_torch.data import datagen

    def drain_reconfig():
        # instance 2 is slow: remap its keys to the others.  No
        # sigma row moves; only the f_mu table changes.
        fmu = balanced_fmu(k, 3, 8)
        fmu = np.where(fmu >= 2, fmu + 1, fmu).astype(np.int32)
        active = active_mask(4, 8)
        active[2] = False
        return Reconfiguration(epoch=1, n_active=3, fmu=fmu, active=active)

    def stream():
        rng = np.random.default_rng(0)
        return datagen.tweets(rng, n_ticks=6, tick=32, words_per_tweet=3,
                              vocab=500, k_virt=k, rate_per_tick=30,
                              device="cpu")

    def run(drain_straggler: bool):
        pipe = api.make_pipeline(base_cfg(k, args.device))
        outs = []
        for i, b in enumerate(stream()):
            rc = drain_reconfig() if drain_straggler and i == 2 else None
            o1, o2, sw = pipe.step(b, reconfig=rc)
            outs += collect(o1) + collect(o2)
        return outs, pipe

    base = None
    if "straggler" in drills or "mesh" in drills:
        base, _ = run(False)
    if "straggler" in drills:
        drained, pipe = run(True)
        same = base == drained
        sigma_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(pipe.sigma))
        print(f"[1] straggler drain: outputs identical={same}, "
              f"switch bytes={vsn_switch_bytes(pipe.epoch)} "
              f"(vs sigma = {sigma_bytes} bytes that SN would reshard)")
        assert same

    if "mesh" in drills:
        n = args.mesh or 8
        # same config, mesh execution: the api picks MeshPipeline
        pipe = api.make_pipeline(dataclasses.replace(base_cfg(k, args.device),
                                                     mesh_devices=n))
        outs = []
        for i, b in enumerate(stream()):
            rc = drain_reconfig() if i == 2 else None
            o1, o2, sw = pipe.step(b, reconfig=rc)
            outs += collect(o1) + collect(o2)
        same = sorted(outs) == sorted(base)
        coll = pipe.collective_bytes()
        sigma_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(pipe.sigma))
        print(f"[1m] mesh straggler drain on {n} shards: outputs "
              f"identical={same}, reconfigs={int(pipe.epoch.reconfigs)}, "
              f"cross-shard state transfer={sum(coll.values())} B "
              f"(copies between devices: {coll or 'none'}), switch "
              f"bytes={pipe.switch_bytes()} (tables) vs {sigma_bytes} B "
              f"of sigma that SN would reshard")
        assert same, "mesh run diverged from single-device oracle"
        assert int(pipe.epoch.reconfigs) == 1
        assert sum(coll.values()) == 0, "state moved between devices"

    # --- live closed loop --------------------------------------------------
    if "live" in drills:
        from repro_torch.core.async_runtime import run_sync
        from repro_torch.io import RateSchedule, ReplaySource

        live_batches = list(datagen.tweets(
            np.random.default_rng(1), n_ticks=8, tick=64,
            words_per_tweet=3, vocab=500, k_virt=k, rate_per_tick=30,
            device="cpu"))
        # offered-rate spike at tick 3 pushes load past the §8.4 upper
        # threshold: 2 instances x 2000 t/s capacity, 9000 t/s offered.
        sched = RateSchedule(((3, 1500.0), (5, 9000.0)))
        live_cfg = dataclasses.replace(
            base_cfg(k, args.device), n_active=2, stash_cap=128,
            queue_cap=3, controller="threshold",
            capacity_per_instance=2000.0)
        rt = api.build_runtime(live_cfg,
                               ReplaySource(live_batches, schedule=sched))
        rep = rt.run()
        static = api.make_pipeline(
            dataclasses.replace(live_cfg, n_active=8))
        _, oracle_sink = run_sync(static, ReplaySource(live_batches))
        same = rt.sink.results() == oracle_sink.results()
        d2s = (f"{np.mean(rep.detect_to_switch_ms):.1f} ms / "
               f"{np.mean(rep.detect_to_switch_ticks):.1f} ticks"
               if rep.detect_to_switch_ms else "n/a")
        print(f"[4] live loop: {len(rep.reconfig_trace)} controller "
              f"reconfigs ({rep.switches} switched) injected mid-stream, "
              f"outputs match static oracle={same}, detection->switch "
              f"latency {d2s}, queue high-water {rep.queue_high_water}")
        assert rep.switches >= 1, "the rate spike never triggered a switch"
        assert same, "live elastic run diverged from the static oracle"
        from repro_torch import obs as _obs
        o = _obs.get()
        if o is not None and o.slo is not None:
            # the SLO loop must demonstrably close: breach events reach
            # the controller, land in the report, and trigger a dump
            ctrl = rt.runtime.controller
            n_seen = getattr(ctrl, "slo_breaches_seen", 0)
            assert n_seen >= 1, "SLO breach never reached observe_live"
            assert rep.slo_breaches, "SLO breaches missing from RunReport"
            if o.cfg.dump_dir:
                import glob
                import os
                dumps = glob.glob(os.path.join(o.cfg.dump_dir,
                                               "flight-slo-*.json"))
                assert dumps, "SLO breach produced no flight dump"
            print(f"[4] SLO loop: {len(rep.slo_breaches)} breach(es) of "
                  f"{rep.slo_breaches[0]['rule']} fed observe_live "
                  f"(controller saw {n_seen}) and triggered a flight dump")
        if o is not None and o.timeline is not None:
            tls = rep.exemplar_timelines
            assert tls, "exemplar sampling produced no completed timelines"
            for tl in tls:
                walls = [w for _, w in tl["timeline"]]
                assert walls == sorted(walls), \
                    f"exemplar timeline not monotone: {tl}"
            print(f"[4] exemplars: {len(tls)} completed tuple timelines, "
                  f"all stage orders monotone")

    # --- hierarchical multi-host ingest ------------------------------------
    if "ingest" in drills:
        from repro_torch.ingest import (collect_tuples, emitted_taus,
                                        single_gate_stream)

        n_src, n_leaves = 6, 2
        ingest_batches = list(datagen.tweets(
            np.random.default_rng(5), n_ticks=10, tick=64,
            words_per_tweet=3, vocab=500, k_virt=k, rate_per_tick=40,
            n_sources=n_src, device="cpu"))
        tier_cfg = dataclasses.replace(
            base_cfg(k, args.device), n_sources=n_src, ingest_hosts=n_leaves,
            leaf_cap=64, root_cap=128)

        def ingest_run():
            tier = api.make_tier(tier_cfg, ingest_batches)
            new_leaf = tier.add_host(at_tick=3)  # host joins mid-stream
            tier.remove_host(0, at_tick=7)       # ...and one leaves
            return tier, new_leaf, list(tier)

        # two identical runs: the first warms every kernel and allocator
        # shape, so the second's attach/detach latency is the membership
        # handshake itself (gammas + table swaps)
        ingest_run()
        tier, new_leaf, outs = ingest_run()
        st = tier.stats()
        taus = emitted_taus(outs)
        ordered = bool((np.diff(taus) >= 0).all())
        oracle = single_gate_stream(ingest_batches, n_src, cap=192,
                                    device=dev)
        same = collect_tuples(outs) == collect_tuples(oracle)
        att = f"{st.attach_ms[0]:.1f}" if st.attach_ms else "n/a"
        det = f"{st.detach_ms[0]:.1f}" if st.detach_ms else "n/a"
        print(f"[5] ingest tier: leaf {new_leaf} joined @t3, leaf 0 left "
              f"@t7 (zero tuple-state transfer); outputs == single-gate "
              f"oracle: {same}, totally ordered: {ordered}, "
              f"W monotone (checked/round), attach {att} ms, detach "
              f"{det} ms (warm), overflow root={st.root_overflow} "
              f"leaves={sum(st.leaf_overflow.values())}")
        assert same, "ingest tier diverged from the single-gate oracle"
        assert ordered, "ingest tier lost total order"
        assert st.attach_ms and st.detach_ms, "membership latency missing"

    # --- serving pool ------------------------------------------------------
    if "serving" in drills:
        from repro_torch.configs import get_config, reduced
        from repro_torch.models import transformer
        from repro_torch.serving.kv_pool import Request, ServingEngine
        cfg = reduced(get_config("qwen3_14b"))
        params = transformer.init_params(cfg, seed=0, device=dev)
        eng = ServingEngine(cfg, params, n_slots=4, max_seq=64,
                            n_instances=4, device=dev)
        eng.submit(Request(uid=0, prompt=np.asarray([5, 6, 7]), max_new=4,
                           arrived=0))
        eng.tick()
        v = eng.pool.reconfigure_vsn(2)
        s = eng.pool.reconfigure_sn(4)
        print(f"[2] serving scale 4->2->4: VSN moved {v} B (tables), "
              f"SN baseline moved {s} B of KV")
        assert s > 10 * v

    # --- crash/resume (storage substrate) ----------------------------------
    if "crash" in drills:
        import os
        from repro_torch.checkpoint import checkpoint as C
        with tempfile.TemporaryDirectory() as d:
            C.save(d, 10, {"w": np.ones(4)}, async_=False)
            os.makedirs(os.path.join(d, "step_00000011"))   # crashed save
            step = C.latest_step(d)
            print(f"[3] crash drill: latest complete step = {step} (11 is "
                  f"invisible)")
            assert step == 10

    # --- kill-and-restore (full stack) --------------------------------------
    if "recovery" in drills or "recovery-kill" in drills:
        from repro_torch.launch.recovery import kill_restore_drill

        n_src = 4
        rng = np.random.default_rng(7)
        rec_batches = []
        tau_base = 0
        for _ in range(12):
            (b,) = datagen.tweets(rng, n_ticks=1, tick=64,
                                  words_per_tweet=3, vocab=500, k_virt=k,
                                  rate_per_tick=30, n_sources=n_src,
                                  device="cpu")
            b = dataclasses.replace(b, tau=b.tau + tau_base)
            tau_base = int(b.tau.max()) + 1
            rec_batches.append(b)

        if "recovery" in drills:
            with tempfile.TemporaryDirectory() as d:
                cfg = dataclasses.replace(
                    base_cfg(k, args.device), n_active=2, stash_cap=256,
                    n_sources=n_src, ingest_hosts=2, leaf_cap=128,
                    root_cap=256, checkpoint_dir=d, checkpoint_every=4)
                rep = kill_restore_drill(cfg, rec_batches, mode="stop",
                                         crash_after=7,
                                         crash_mid_save=True)
                print(f"[6] kill-and-restore ({rep.summary()}); torn save "
                      f"was invisible, outputs exactly-once")
                assert rep.parity, "recovery drill lost exactly-once parity"
                assert rep.restored_step >= cfg.checkpoint_every

        if "recovery-kill" in drills:
            with tempfile.TemporaryDirectory() as d:
                cfg = dataclasses.replace(
                    base_cfg(k, args.device), n_active=2, stash_cap=256,
                    n_sources=n_src, ingest_hosts=2,
                    ingest_worker="process", chan_cap=2, leaf_cap=128,
                    root_cap=256, checkpoint_dir=d, checkpoint_every=4)
                rep = kill_restore_drill(cfg, rec_batches, mode="sigkill",
                                         crash_after=6)
                print(f"[6k] SIGKILL leaf restore ({rep.summary()})")
                assert rep.parity, "sigkill drill lost exactly-once parity"

    print("elastic drill OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
