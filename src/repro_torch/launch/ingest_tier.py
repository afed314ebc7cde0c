"""Ingest-tier driver: the hierarchical multi-host ScaleGate, standalone.

Held against ``src/repro/launch/ingest_tier.py``.

    PYTHONPATH=src python -m repro_torch.launch.ingest_tier --leaves 3 \\
        --sources 6 --ticks 24 --join-at 6 --leave-at 14

Streams a multi-source Q1-style workload through ``IngestTier`` (N leaf
ScaleGates, each an ingest worker merging a disjoint source subset,
feeding the root merge) on ``--device`` (default: the card; ``cpu`` runs
the plain PyTorch path) and verifies, live:

* exact output-set parity with the single-ScaleGate oracle, including
  across a mid-stream ``add_host`` (``--join-at``) and ``remove_host``
  (``--leave-at``);
* the merged ready stream is totally ordered and the root watermark never
  regresses;
* membership changes move zero tuple state (only Lemma-3 gammas), with
  measured attach/detach latency;
* stash overflow at either level is surfaced, never silent.

``--worker`` selects the leaf execution vehicle (thread | process |
inline).  The root merges each round with one ``scalegate_merge_stacked``
call on the card; on the CPU it takes the host path, the reference's
default, against which the tests hold it (``--fused-root`` /
``--no-fused-root`` choose either way).  ``--pipeline`` also drives the
merged stream through a ``VSNPipeline`` via ``AsyncStreamRuntime``
(``run_pipeline``), over a tier with the same root.  Its count aggregate
runs the fast path (``agg.tick_fast``) where the reference runs the
general O+ tick, which takes tens of seconds per tick on the CPU; the
tests hold its outputs against the reference's general run.
"""

import argparse
import sys
import time

import numpy as np

from repro_torch import device as _device
from repro_torch.data import datagen
from repro_torch.ingest import (IngestTier, collect_tuples, emitted_taus,
                                single_gate_stream)

K_VIRT = 128


def make_stream(args, device):
    rng = np.random.default_rng(args.seed)
    return list(datagen.tweets(
        rng, n_ticks=args.ticks, tick=args.tick, words_per_tweet=3,
        vocab=2000, k_virt=K_VIRT, rate_per_tick=50,
        n_sources=args.sources, device=device))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaves", type=int, default=3)
    ap.add_argument("--sources", type=int, default=6)
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--tick", type=int, default=64, help="tuples per tick")
    ap.add_argument("--worker", default="thread",
                    choices=["thread", "process", "inline"])
    ap.add_argument("--leaf-cap", type=int, default=128)
    ap.add_argument("--root-cap", type=int, default=256)
    ap.add_argument("--join-at", type=int, default=None,
                    help="add an ingest host before this data tick")
    ap.add_argument("--leave-at", type=int, default=None,
                    help="remove leaf 0 before this data tick")
    ap.add_argument("--pipeline", action="store_true",
                    help="also drive the merged stream through a "
                         "VSNPipeline via AsyncStreamRuntime")
    ap.add_argument("--fused-root", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="merge each root round with one "
                         "scalegate_merge_stacked call (default: on the "
                         "card only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=11)
    return ap.parse_args(argv)


def run_pipeline(args, batches, device):
    """The merged stream through a ``VSNPipeline`` via
    ``AsyncStreamRuntime``; returns the ``RunReport`` and the sink."""
    import functools

    from repro_torch.core import aggregate as agg
    from repro_torch.core.async_runtime import AsyncStreamRuntime
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec

    op = agg.count_aggregate(WindowSpec(wa=500, ws=1000, wt="multi"),
                             k_virt=K_VIRT, out_cap=1024, extra_slots=2,
                             n_inputs=args.sources)
    pipe = VSNPipeline(
        op, n_max=8, n_active=4, stash_cap=args.root_cap + args.leaf_cap,
        tick_fn=lambda o, s, r, m, explicit_w=None: agg.tick_fast(
            o, "count", s, r, m, explicit_w=explicit_w),
        merge_fn=merge_fast_state,
        init_sigma=functools.partial(agg.fast_init, op), device=device)
    tier = IngestTier(batches, args.sources, args.leaves,
                      out_pad=2 * args.tick, **_tier_kw(args, device))
    rt = AsyncStreamRuntime(pipe, tier, queue_cap=4)
    return rt.run(), rt.sink


def _tier_kw(args, device):
    return dict(worker=args.worker, leaf_cap=args.leaf_cap,
                root_cap=args.root_cap, root_device=args.fused_root,
                device=device)


def main(argv=None):
    args = parse_args(argv)
    dev = _device.resolve(args.device)
    batches = make_stream(args, dev)
    tier = IngestTier(batches, args.sources, args.leaves,
                      **_tier_kw(args, dev))
    if args.join_at is not None:
        new_leaf = tier.add_host(at_tick=args.join_at)
        print(f"# scheduled add_host -> leaf {new_leaf} at tick "
              f"{args.join_at}")
    if args.leave_at is not None:
        tier.remove_host(0, at_tick=args.leave_at)
        print(f"# scheduled remove_host(0) at tick {args.leave_at}")

    t0 = time.perf_counter()
    outs = list(tier)
    dt = time.perf_counter() - t0
    st = tier.stats()
    print(f"[ingest] {st.summary()}")
    print(f"[ingest] root-merge throughput "
          f"{st.tuples_out / max(dt, 1e-9):.0f} t/s over {dt:.2f}s "
          f"({args.worker} workers, {dev}, "
          f"{'fused' if tier.root.device else 'host'} root)")

    taus = emitted_taus(outs)
    assert (np.diff(taus) >= 0).all(), "ready stream lost total order"
    oracle = single_gate_stream(batches, args.sources,
                                cap=args.root_cap + args.leaf_cap,
                                device=dev)
    same = collect_tuples(outs) == collect_tuples(oracle)
    print(f"[ingest] output set == single-ScaleGate oracle: {same} "
          f"({st.tuples_out} tuples, watermark monotone, "
          f"{len(st.attach_ms)} joins / {len(st.detach_ms)} leaves)")
    assert same, "hierarchical ingest diverged from the flat oracle"

    if args.pipeline:
        rep, _ = run_pipeline(args, batches, dev)
        print(f"[ingest->pipeline] {rep.summary()}")
    print("ingest tier OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
