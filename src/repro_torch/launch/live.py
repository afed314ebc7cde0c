"""Live streaming driver: async double-buffered ingest + controller loop.

Held against ``src/repro/launch/live.py``.

    PYTHONPATH=src python -m repro_torch.launch.live --ticks 24 --tick 256 \\
        --controller threshold --compare-sync --oracle

Streams a Q1-style wordcount workload through ``AsyncStreamRuntime`` under
an abruptly-changing offered-rate trace (the Q5 shape), on ``--device``
(default: the card; ``cpu`` runs the kernels' plain versions).  The whole
stack (operator, pipeline, optional multi-host ingest tier, controller,
checkpointing) is assembled by ``repro_torch.api``: the flags below
populate one ``RuntimeConfig`` and ``build_runtime`` does the rest.
Prints throughput, tick latency p50/p99, the reconfiguration trace, and
detection→switch latency.  The pipeline runs the general O+ tick, or
with ``--mesh`` the fast count path, as the reference's
``make_pipeline`` builds them.

* ``--compare-sync``  also runs the synchronous host-loop baseline on the
  same stream (replaying the async run's reconfiguration trace) and
  reports the overlap gain;
* ``--oracle``        checks the live run's output set exactly matches a
  static max-width run (the paper's correctness contract under
  elasticity);
* ``--pace``          paces the source to the schedule in wall-clock;
* ``--mesh N``        runs the pipeline on an N-shard stream mesh
  (``MeshPipeline``, the fast count path; on one card the N shards
  time-share it);
* ``--record F.npz`` / ``--replay F.npz`` save / replay the exact tick
  stream (event times intact) via ``io.sources``; a recording either
  package wrote replays in the other;
* ``--super-batch K``  stages K consecutive ticks as one stack and runs
  the persistent K-tick driver (one CUDA graph a shape on the card, the
  general O+ tick included);
* ``--fused-root``     (with ``--ingest-hosts``) runs the root merge as
  one ``scalegate_merge_stacked`` round (the default on the card);
* ``--ingest-hosts N``  spreads the workload over N physical sources and
  merges them through the hierarchical multi-host ScaleGate upstream of
  the runtime; the tier's output set is asserted against the
  single-ScaleGate oracle after the run;
* ``--checkpoint-dir D --checkpoint-every K``  takes an epoch-consistent
  snapshot of the whole stack (pipeline sigma + ScaleGate + ingest tier)
  every K ticks, asynchronously, with an atomic-manifest commit;
* ``--resume``         (with ``--checkpoint-dir`` and ``--replay``)
  restores the stack from the latest complete checkpoint (one the
  reference wrote too) and replays the recorded stream from the
  snapshot's frontier: the kill-and-restore loop
  ``repro_torch.launch.recovery`` drills and measures.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import api
from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.core.async_runtime import run_sync
from repro_torch.data import datagen
from repro_torch.io import (CollectSink, NullSink, RateSchedule, ReplaySource,
                            SyntheticSource, load_stream, save_stream)
from repro_torch.obs import ObsConfig

K_VIRT = 256
# Q5-style abrupt phases (tuples/s offered), cycled over the tick budget
PHASES = (2000.0, 16000.0, 4000.0, 24000.0, 2500.0)


def make_stream(args):
    """The host-side tick stream (the pipeline stages each tick onto its
    device), generated from ``--seed`` or loaded from ``--replay``."""
    phase_len = max(args.ticks // len(PHASES), 1)
    sched = RateSchedule(tuple((phase_len, r) for r in PHASES))
    if args.replay:
        src = load_stream(args.replay, device="cpu")
        src.schedule = sched
        return src
    rng = np.random.default_rng(args.seed)
    batches = []
    tau_base = 0
    for i in range(args.ticks):
        rate = sched.rate_at(i)
        (b,) = datagen.tweets(
            rng, n_ticks=1, tick=args.tick, words_per_tweet=3, vocab=2000,
            k_virt=K_VIRT, rate_per_tick=max(int(rate) // 10, 1),
            n_sources=max(args.ingest_hosts, 1), device="cpu")
        # each tweets() call restarts event time at 0; shift so the stream
        # stays timestamp-sorted end to end (the ScaleGate source contract)
        b = dataclasses.replace(b, tau=b.tau + tau_base)
        tau_base = int(b.tau.max()) + 1
        batches.append(b)
    if args.record:
        save_stream(args.record, batches)
        print(f"# recorded {len(batches)} ticks -> {args.record}")
    if args.pace:
        return SyntheticSource(batches, schedule=sched, pace=True,
                               tick_size=args.tick)
    return ReplaySource(batches, schedule=sched)


def make_obs_cfg(args) -> ObsConfig:
    on = bool(args.trace or args.obs_export or args.flight_dump
              or args.obs_port is not None)
    return ObsConfig(enabled=on, trace=bool(args.trace),
                     export_dir=args.obs_export,
                     serve_port=args.obs_port,
                     exemplar_rate=args.exemplar_rate,
                     event_sample=args.event_sample,
                     span_sample=args.span_sample,
                     event_budget_per_s=args.event_budget)


def finish_obs(args, report) -> None:
    """Post-run observability outputs: per-stage latency breakdown
    (--trace), metrics export (--obs-export handled by Runtime.run, also
    here for the resume path), flight-ring dump (--flight-dump)."""
    o = _obs.get()
    if o is None:
        return
    if args.trace and getattr(report, "stage_latency_ms", None):
        print("[live/trace] per-stage latency (ms):")
        for stage, q in sorted(report.stage_latency_ms.items()):
            print(f"    {stage:<20} p50={q['p50']:8.3f} "
                  f"p90={q['p90']:8.3f} p99={q['p99']:8.3f} "
                  f"n={int(q['count'])}")
    if getattr(report, "exemplar_timelines", None):
        print(f"[live/obs  ] {len(report.exemplar_timelines)} exemplar "
              f"tuple timelines completed")
    if args.obs_export:
        paths = o.export(args.obs_export)
        print(f"[live/obs  ] exported {sorted(paths.values())}")
    if args.flight_dump:
        p = o.dump_flight("on_demand", path=args.flight_dump)
        print(f"[live/obs  ] flight ring ({len(o.flight.events)} events) "
              f"-> {p}")


def make_cfg(args, n_sources: int) -> api.RuntimeConfig:
    """One declarative description of the run: every launcher knob lands
    in the same ``RuntimeConfig`` the checkpoint manifest carries."""
    return api.RuntimeConfig(
        obs=make_obs_cfg(args),
        op="count", wa=500, ws=1000, wt="multi", k_virt=K_VIRT,
        out_cap=1024, extra_slots=2,
        n_max=args.n_max, n_active=2,
        stash_cap=args.tick * 4 if args.ingest_hosts else args.tick,
        mesh_devices=args.mesh, device=args.device,
        n_sources=n_sources, ingest_hosts=args.ingest_hosts,
        leaf_cap=args.tick, root_cap=2 * args.tick, out_pad=2 * args.tick,
        root_device=args.fused_root,
        queue_cap=args.queue_cap, super_batch=args.super_batch,
        controller=args.controller,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)


class _Recording:
    """Lazily tee the source (a --pace source must pace the *router*, not
    a startup materialization) while keeping the raw ticks for the
    post-run single-gate-oracle check."""

    def __init__(self, src):
        self.src = src
        self.schedule = getattr(src, "schedule", None)
        self.raw = []

    def __iter__(self):
        for b in self.src:
            self.raw.append(b)
            yield b


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--tick", type=int, default=256, help="tuples per tick")
    ap.add_argument("--controller", default="threshold",
                    choices=["threshold", "predictive", "none"])
    ap.add_argument("--n-max", type=int, default=16)
    ap.add_argument("--queue-cap", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--pace", action="store_true")
    ap.add_argument("--compare-sync", action="store_true")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--record", default=None)
    ap.add_argument("--replay", default=None)
    ap.add_argument("--ingest-hosts", type=int, default=0,
                    help="merge the stream through a hierarchical "
                         "multi-host ScaleGate with N leaf gates")
    ap.add_argument("--super-batch", type=int, default=1,
                    help="stage K consecutive ticks as one stack and run "
                         "the persistent K-tick driver")
    ap.add_argument("--fused-root", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="with --ingest-hosts: merge each root round with "
                         "one scalegate_merge_stacked call (default: on "
                         "the card only)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="take epoch-consistent snapshots into this dir")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="pipeline ticks between snapshots (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="restore from the latest complete checkpoint in "
                         "--checkpoint-dir and replay --replay from the "
                         "snapshot's frontier")
    ap.add_argument("--trace", action="store_true",
                    help="enable span tracing (per-stage latency "
                         "breakdown printed after the run)")
    ap.add_argument("--obs-export", default=None, metavar="DIR",
                    help="write metrics.json/metrics.prom (+ flight.json) "
                         "to DIR after the run; implies obs on")
    ap.add_argument("--flight-dump", default=None, metavar="FILE",
                    help="dump the flight-recorder ring to FILE after the "
                         "run (and on crash); implies obs on")
    ap.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics (Prometheus text) and /snapshot "
                         "(schema-v2 JSON) live during the run on this "
                         "port (0 = ephemeral); implies obs on")
    ap.add_argument("--exemplar-rate", type=float, default=0.0,
                    metavar="RATE",
                    help="sample ~RATE of tuples as end-to-end exemplar "
                         "timelines (admission -> ... -> emit)")
    ap.add_argument("--event-sample", type=float, default=1.0,
                    metavar="RATE",
                    help="keep ~RATE of flight-event detail records "
                         "(counters stay exact; 1.0 = keep all)")
    ap.add_argument("--span-sample", type=float, default=1.0,
                    metavar="RATE",
                    help="keep ~RATE of finished-span detail records "
                         "(span histograms stay exact; 1.0 = keep all)")
    ap.add_argument("--event-budget", type=float, default=0.0,
                    metavar="PER_S",
                    help="adaptive sampling: back detail rates off to stay "
                         "under PER_S kept records/s per kind (0 = off)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = _device.resolve(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    print(f"# device {dev} ({name})")

    if args.resume:
        if not (args.checkpoint_dir and args.replay):
            raise SystemExit("--resume needs --checkpoint-dir and the "
                             "--replay record to replay")
        ocfg = make_obs_cfg(args)
        if ocfg.enabled:
            # the manifest's config wins inside resume_runtime; the resume
            # flags install obs explicitly so a restored run can be traced
            _obs.install(ocfg)
        rt = api.resume_runtime(args.checkpoint_dir, args.replay,
                                device=args.device)
        report = rt.run()
        print(f"[live/resume] restored step {rt.restored_step} from "
              f"{args.checkpoint_dir}; {report.summary()}")
        print(f"[live/resume] {len(rt.sink.results())} output tuples "
              f"replayed")
        finish_obs(args, report)
        print("live resume OK")
        return 0

    src = make_stream(args)
    if args.ingest_hosts:
        if args.replay:
            # the recording fixes the source-id space; the tier must merge
            # whatever was recorded, not what --ingest-hosts assumes
            n_sources = 1 + max((int(b.source.max()) for b in src.batches),
                                default=0)
        else:
            n_sources = args.ingest_hosts
        src = _Recording(src)
    else:
        n_sources = 1
    cfg = make_cfg(args, n_sources)
    # CollectSink retains every tick's device outputs for the parity
    # checks; a pure throughput run must not grow memory with the stream
    need_outputs = args.compare_sync or args.oracle
    sink = CollectSink() if need_outputs else NullSink()
    rt = api.build_runtime(cfg, src, sink=sink,
                           record_tier=bool(args.ingest_hosts))
    o = _obs.get()
    if o is not None and o.server is not None:
        print(f"[live/obs  ] scrape endpoint live at {o.server.url}"
              f"/metrics (+ /snapshot)", flush=True)
    report = rt.run()
    print(f"[live/async] {report.summary()}")
    finish_obs(args, report)
    if rt.checkpointer is not None:
        print(f"[live/ckpt ] saved steps {rt.checkpointer.saved_steps} "
              f"-> {cfg.checkpoint_dir} (resume with --resume)")
    if rt.tier is not None:
        from repro_torch.ingest import collect_tuples, single_gate_stream
        st = rt.tier.stats()
        print(f"[live/ingest] {st.summary()}")
        oracle = single_gate_stream(src.raw, cfg.n_sources,
                                    cap=3 * args.tick, device=dev)
        assert (collect_tuples(rt.tier.emitted) == collect_tuples(oracle)), \
            "ingest tier diverged from the single-gate oracle"
        print(f"[live/ingest] tier output == single-ScaleGate oracle over "
              f"{st.tuples_out} tuples")
    if report.reconfig_trace:
        trace = ", ".join(f"t{t}->pi{rc.n_active}"
                          for t, rc in report.reconfig_trace)
        print(f"[live/async] reconfig trace: {trace}")
    if need_outputs:
        outs = rt.sink.results()
        if rt.tier is not None:
            batches = list(rt.tier.emitted)  # the merged stream the
            #                                  runtime saw
        elif isinstance(src, ReplaySource):
            batches = list(src.batches)
        else:
            batches = list(make_stream(argparse.Namespace(
                **{**vars(args), "pace": False, "record": None})))

    if args.compare_sync:
        sync_pipe = api.make_pipeline(cfg)
        sync_rep, sync_sink = run_sync(
            sync_pipe, ReplaySource(batches),
            reconfig_trace=report.reconfig_trace)
        gain = report.throughput_tps / max(sync_rep.throughput_tps, 1e-9)
        print(f"[live/sync ] {sync_rep.summary()}")
        print(f"[live] overlap gain async/sync = {gain:.2f}x; "
              f"outputs identical = {outs == sync_sink.results()}")
        assert outs == sync_sink.results(), "async diverged from sync replay"

    if args.oracle:
        static = api.make_pipeline(
            dataclasses.replace(cfg, n_active=args.n_max))
        _, oracle_sink = run_sync(static, ReplaySource(batches))
        ok = outs == oracle_sink.results()
        print(f"[live] outputs match static oracle = {ok} "
              f"({len(outs)} output tuples, "
              f"{len(report.reconfig_trace)} live reconfigs)")
        assert ok, "live elastic run diverged from the static oracle"
    print("live run OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
