"""Serving driver: the elastic continuous-batching tier on the facade.

Held against ``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --ticks 40 --rate 40 --spike 160 --controller slo

runs on the card at the model's published widths and depth (``--reduced``
shrinks it; ``--device cpu`` runs the same path on the CPU with the
kernels' plain versions).  One ``RuntimeConfig`` describes the whole
stack: requests arrive as stream tuples from a diurnal-spike
``RateSchedule`` arrival process (optionally through the multi-host
ingest tier with ``--ingest-hosts``), decode runs as the tick of an
``AsyncStreamRuntime``, and the SLO-aware controller provisions replicas
from the observed p99 decode latency.  Scale-up under ``--mode vsn`` is
the paper's f_mu rewrite (zero KV moved); ``--mode sn`` materializes the
shared-nothing migration baseline.  Parameters are random, drawn on the
device from ``--seed``.
"""

import argparse
import sys

from repro_torch.api import RuntimeConfig, build_runtime
from repro_torch.io.sources import RateSchedule
from repro_torch.serving import RequestSource, ServingConfig


def traffic(ticks: int, rate: float, spike: float):
    """``RateSchedule`` phases, ``(n_ticks, requests/s)``, as the reference
    launcher builds them: ``[(0, rate)]``, or with ``spike > 0`` ``[(0,
    rate), (ticks // 3, spike), (2 * ticks // 3, rate)]``.  The entries
    are durations, so the first is empty and the spike covers the first
    third of the run (the reference's comment says the middle one); the
    rate then holds to the end."""
    if spike <= 0:
        return ((0, rate),)
    return ((0, rate), (ticks // 3, spike), (2 * ticks // 3, rate))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--n-active", type=int, default=1)
    ap.add_argument("--mode", choices=("vsn", "sn"), default="vsn")
    # traffic: piecewise-constant req/s with a spike (the reference's list)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="baseline arrival rate, requests/s")
    ap.add_argument("--spike", type=float, default=0.0,
                    help="spike rate over the first third (0 = flat traffic)")
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--tick-ms", type=int, default=50)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--pace", action="store_true",
                    help="pace ticks in wall-clock time")
    # stack
    ap.add_argument("--sources", type=int, default=2)
    ap.add_argument("--ingest-hosts", type=int, default=0)
    ap.add_argument("--controller", default="slo",
                    choices=("none", "slo"))
    ap.add_argument("--slo-target-ms", type=float, default=50.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--export-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    schedule = RateSchedule(traffic(args.ticks, args.rate, args.spike))

    scfg = ServingConfig(arch=args.arch, reduced=args.reduced,
                         n_slots=args.slots, max_seq=args.max_seq,
                         n_instances=args.instances, mode=args.mode,
                         seed=args.seed)
    cfg = RuntimeConfig(
        serving=scfg, n_sources=args.sources, device=args.device,
        ingest_hosts=args.ingest_hosts, n_active=args.n_active,
        controller=args.controller,
        slo_target_p99_ms=args.slo_target_ms,
        obs={"enabled": True, "trace": args.trace,
             "export_dir": args.export_dir,
             "slo_rules": [{"name": "decode_p99",
                            "metric": "span.serve.decode",
                            "threshold": args.slo_target_ms / 1e3,
                            "quantile": 0.99}]})

    source = RequestSource(
        schedule=schedule, ticks=args.ticks, lanes=args.lanes,
        prompt_len=args.prompt_len, max_new=args.max_new,
        seed=args.seed, n_inputs=args.sources, k_virt=args.slots,
        tick_ms=args.tick_ms, pace=args.pace,
        # worst-case drain: every lane full every tick, n_slots requests
        # retiring per (max_new-1) decode rounds
        drain_ticks=(args.ticks * args.lanes * args.max_new
                     // args.slots + 16))

    rt = build_runtime(cfg, source)
    report = rt.run()
    pipe = rt.pipeline
    eng = pipe.engine

    print(report.summary())
    toks = sum(len(r.out) for r in pipe.finished)
    print(f"served {len(pipe.finished)}/{source.total_requests} requests, "
          f"{toks} tokens over {eng.steps} decode rounds "
          f"({args.mode} mode, {eng.pool.n_active}/{args.instances} "
          f"replicas at end, on {eng.device})")
    if eng.cfg.kind == "moe":
        print(f"MoE tokens dropped by expert capacity: {int(eng.dropped)}")
    for ev in pipe.reconfig_events:
        print(f"  reconfig -> n_active={ev['n_active']} "
              f"kv_bytes_moved={ev['kv_bytes_moved']} "
              f"({ev['ms']:.2f} ms)")
    if not pipe.reconfig_events:
        print("  (no reconfigurations)")
    return 0 if len(pipe.finished) == source.total_requests else 1


if __name__ == "__main__":
    sys.exit(main())
