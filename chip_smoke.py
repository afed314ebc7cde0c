#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits nonzero:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/
                 kernels/csrc`` (one ``nvcc`` per source, in parallel) and
                 print the card's name and power limit.
2. ``kernels`` — hold each of the four kernels against its plain PyTorch
                 version on the card, exactly, at the main path's shapes and
                 on edge cases, and time kernel, plain version, one library
                 call where one computes the same function, and the card's
                 bound; the two merge entries also at a multi-tile size of
                 the ingest tier's rounds.
3. ``q1_wordcount`` — the Q1 wordcount VSN pipeline with a mid-stream
                 reconfiguration (4 -> 16 instances), equal to the same run
                 on the CPU (outputs, switch flags, instance loads), with 0
                 sigma bytes moved; an SN run on the card over a prefix with
                 the switch equals VSN and moves bytes.
4. ``q3_scalejoin`` — the ScaleJoin fast path in ``VSNPipeline`` plus the
                 ``window_join`` counting path each tick, equal to the CPU
                 run as unordered output pairs, in total comparisons, and
                 in matches per incoming tuple (the card merges equal-tau
                 tuples in arrival order, the CPU by source first, so the
                 round-robin ring layout, and with it the per-key-row
                 counts, may differ).
5. ``q1_ingest_tier`` — the Q1 stream over 8 sources through the ingest
                 tier (4 thread leaves, the fused root merge, one host
                 joining and one leaving) into ``AsyncStreamRuntime`` over
                 ``VSNPipeline`` with a threshold controller: every round
                 totally ordered, the tier's tuples equal to one flat
                 gate's, the outputs equal to a CPU ``run_sync`` replaying
                 the card run's reconfigurations, 0 sigma bytes moved, and
                 one stacked-merge launch per root round.

Phases 3, 4 and 5 are the main path: each zeroes the launch counts right
before its card run and reads them right after, and the ``{"kernels":
[...]}`` line reports their sum with phase 2's times.  The last line is
``{"ok": true, "device": {...}}``.  Times are medians of CUDA-event
timings over 20 runs after warm-up.
"""

import functools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks: HBM3 at 3.35 TB/s and 67 TFLOP/s float32 outside the
# tensor cores (NVIDIA data sheet); 32-bit integer: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost clock (Hopper architecture white paper unit counts).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, setup=None, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn(*setup())``; ``setup`` runs outside
    the timed region (fresh in-place targets)."""
    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(n_bytes: float, int_ops: float = 0.0, fp_ops: float = 0.0):
    """Least time for the work on this card: the larger of bytes over the
    memory rate and operations over their peak rate.  -> (ms, bound_by)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_scalegate_merge(dev):
    from repro_torch.kernels.scalegate_merge.ops import scalegate_merge_op
    from repro_torch.kernels.scalegate_merge.ref import scalegate_merge_ref
    INF = torch.iinfo(torch.int32).max
    rng = np.random.default_rng(11)
    cases = []
    # 22,536 = the pipeline's buffer in a q1_ingest_tier round of 8 leaf
    # rows (2048 + 20,480 + 8 lanes), past one shared-memory tile
    for n in (2, 127, 128, 386, 513, 4097, 8192, 16384, 22536, 2 ** 20):
        tau = np.sort(rng.integers(0, 5 * n, n)).astype(np.int32)
        src = rng.integers(0, 3, n).astype(np.int32)
        cases.append((f"random_n{n}", tau, src, rng.random(n) < 0.9, 3))
    n = 1000
    cases += [
        ("duplicate_tau", np.full(n, 7, np.int32),
         rng.integers(0, 2, n).astype(np.int32), rng.random(n) < 0.8, 2),
        ("all_inf", np.full(n, INF, np.int32), np.zeros(n, np.int32),
         np.ones(n, bool), 1),
        ("all_invalid", rng.integers(0, 99, n).astype(np.int32),
         np.zeros(n, np.int32), np.zeros(n, bool), 1),
        ("single_source", rng.integers(0, 50, n).astype(np.int32),
         np.zeros(n, np.int32), rng.random(n) < 0.9, 1),
        ("negative_tau", rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                                      dtype=np.int64).astype(np.int32),
         rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.9, 4),
    ]
    for name, tau, src, valid, ns in cases:
        args = [torch.as_tensor(a, device=dev) for a in (tau, src, valid)]
        got = scalegate_merge_op(*args, n_sources=ns)
        want = scalegate_merge_ref(*args, n_sources=ns)
        for g, w_, what in zip(got, want, ("order", "ready", "wmark")):
            if not torch.equal(g, w_):
                raise AssertionError(f"scalegate_merge {name}: {what} differs")
    def timed(n):
        """Kernel, plain version, library sort and bound at ``n`` lanes of
        one source, the last lane invalid (the control lane)."""
        tau = torch.as_tensor(np.sort(rng.integers(0, 5 * n, n))
                              .astype(np.int32), device=dev)
        src = torch.zeros(n, dtype=torch.int32, device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[-1] = False
        key = ((torch.where(valid, tau, INF).to(torch.int64) + 2 ** 31)
               << 32) | torch.arange(n, device=dev)
        ms, by = bound(n * (4 + 4 + 1) + n * 8 + 4,
                       int_ops=n * math.ceil(math.log2(n)))
        return dict(
            shape=f"N={n}, n_sources=1",
            ms=median_ms(lambda: scalegate_merge_op(tau, src, valid,
                                                    n_sources=1)),
            plain_ms=median_ms(lambda: scalegate_merge_ref(tau, src, valid,
                                                           n_sources=1)),
            library_ms=median_ms(lambda: torch.argsort(key, stable=True)),
            bound_ms=ms, bound_by=by)

    # the q1 main-path shape (stash 2048 + tick 2048 + 1 ctrl lane, one
    # tile), and the multi-tile shape of a q1_ingest_tier round of 8 rows
    return dict(name="scalegate_merge", cases=len(cases), max_abs_err=0.0,
                **timed(4097), multi_tile=timed(22536))


def check_scalegate_merge_stacked(dev):
    from repro_torch.kernels.scalegate_merge.ops import \
        scalegate_merge_stacked_op
    from repro_torch.kernels.scalegate_merge.ref import \
        scalegate_merge_stacked_ref
    INF = np.iinfo(np.int32).max
    rng = np.random.default_rng(13)
    C = 2048

    def root_round(rows, n_reports=8, active=5):
        """Stash rows then leaf chunk rows: each a sorted run whose first
        lanes are valid (a chunk padded with invalid lanes)."""
        tau = np.sort(rng.integers(0, 40_000, (rows, C)), axis=1)
        valid = np.arange(C)[None, :] < rng.integers(0, C + 1, (rows, 1))
        reports = np.full(n_reports, INF, np.int64)
        reports[:active] = rng.integers(10_000, 30_000, active)
        return (tau.astype(np.int32), rng.integers(0, 8, (rows, C)), valid,
                reports)

    def fuzz(rows, c):                 # the reference test's rounds
        tau = rng.integers(0, 40, (rows, c))
        valid = rng.random((rows, c)) < 0.7
        valid[rng.integers(rows)] = False
        return tau, rng.integers(0, 4, (rows, c)), valid, \
            rng.integers(5, 35, (rows,))

    cases = {"root_12288": root_round(6), "root_20480": root_round(10),
             "lanes_2^20": root_round(512)}
    for rows, c in ((2, 32), (3, 32), (4, 48), (6, 96)):
        cases[f"ref_{rows}x{c}"] = fuzz(rows, c)
    tau, src, valid, reports = root_round(6)
    cases["all_invalid"] = (tau, src, np.zeros_like(valid), reports)
    cases["equal_tau"] = (np.full_like(tau, 7), src, valid,
                          np.full(8, 7, np.int64))
    cases["negative_tau"] = (
        rng.integers(-2 ** 31, 2 ** 31 - 1, tau.shape, dtype=np.int64),
        src, valid, reports)
    cases["inf_reports"] = (tau, src, valid, np.full(8, INF, np.int64))
    cases["reports_128"] = (tau, src, valid,
                            rng.integers(0, 40_000, 128))
    for name, (tau, src, valid, reports) in cases.items():
        args = [torch.as_tensor(np.asarray(a, dtype), device=dev)
                for a, dtype in ((tau, np.int32), (src, np.int32),
                                 (valid, bool), (reports, np.int32))]
        got = scalegate_merge_stacked_op(*args)
        want = scalegate_merge_stacked_ref(*args)
        for g, w_, what in zip(got, want, ("order", "ready", "wmark")):
            if not torch.equal(g, w_):
                raise AssertionError(f"scalegate_merge_stacked {name}: "
                                     f"{what} differs")
    def timed(rows):
        """Kernel, plain version, library sort and bound on one root round
        of ``rows`` rows of ``C`` lanes."""
        tau, src, valid, reports = (
            torch.as_tensor(np.asarray(a, dtype), device=dev)
            for a, dtype in zip(root_round(rows), (np.int32, np.int32, bool,
                                                   np.int32)))
        n, n_rep = tau.numel(), reports.numel()
        key = ((torch.where(valid, tau, INF).to(torch.int64) + 2 ** 31)
               << 32) | torch.arange(n, device=dev).reshape(tau.shape)
        ms, by = bound(n * (4 + 1) + n * 8 + 4 * n_rep,
                       int_ops=n * math.ceil(math.log2(n)))
        return dict(
            shape=f"[{rows}, {C}] = {n} lanes, {n_rep} reports",
            ms=median_ms(lambda: scalegate_merge_stacked_op(tau, src, valid,
                                                            reports)),
            plain_ms=median_ms(lambda: scalegate_merge_stacked_ref(
                tau, src, valid, reports)),
            library_ms=median_ms(lambda: torch.argsort(key.reshape(-1),
                                                       stable=True)),
            bound_ms=ms, bound_by=by)

    # the root's steady round (4096 stash + 4 leaf rows of 2048, one tile)
    # and a round with a doubled row bucket (20,480 lanes, two tiles)
    return dict(name="scalegate_merge_stacked", cases=len(cases),
                max_abs_err=0.0, **timed(6), multi_tile=timed(10))


def check_segment_aggregate(dev):
    from repro_torch.kernels.segment_aggregate.ops import segment_aggregate_op
    from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref
    rng = np.random.default_rng(12)
    k, s = 4096, 4

    def make(n, w, integer=True):
        keys = rng.integers(-1, k + 64, n).astype(np.int32)   # -1 and >= K
        slots = rng.integers(0, s, n).astype(np.int32)
        vals = (rng.integers(0, 100, (n, w)) if integer
                else rng.random((n, w))).astype(np.float32)
        acc = rng.integers(0, 50, (k, s, w)).astype(np.float32)
        return [torch.as_tensor(a, device=dev) for a in (keys, slots, vals,
                                                         acc)]

    ones = lambda n: torch.ones((n, 1), dtype=torch.float32, device=dev)
    cases = {}
    for n in (2048 * 6 * 2, 4097 * 6 * 2):       # one tick; the main path
        kk, ss, _, acc = make(n, 1)
        cases[f"count_n{n}"] = (kk, ss, ones(n), acc)
    cases["int_sum_w2"] = tuple(make(24576, 2))
    max_err = 0.0
    for name, (kk, ss, vv, acc) in cases.items():
        got = segment_aggregate_op(kk, ss, vv, acc.clone())
        want = segment_aggregate_ref(kk, ss, vv, acc.clone())
        if not torch.equal(got, want):
            raise AssertionError(f"segment_aggregate {name} differs")
    # float sums: atomics reorder the adds; a few per cell, rtol 1e-6
    kk, ss, vv, acc = make(2048, 1, integer=False)
    got = segment_aggregate_op(kk, ss, vv, acc.clone())
    want = segment_aggregate_ref(kk, ss, vv, acc.clone())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    max_err = float((got - want).abs().max())

    n = 4097 * 6 * 2
    kk, ss, vv, acc = cases[f"count_n{n}"]
    clone = lambda: (acc.clone(),)
    kernel_ms = median_ms(lambda a: segment_aggregate_op(kk, ss, vv, a), clone)
    plain_ms = median_ms(lambda a: segment_aggregate_ref(kk, ss, vv, a), clone)
    ok = (kk >= 0) & (kk < k)
    flat = torch.where(ok, kk.long() * s + ss.long(), k * s)
    flat_acc = lambda: (torch.zeros(k * s + 1, 1, device=dev),)
    library_ms = median_ms(
        lambda a: a.index_put_((flat,), vv, accumulate=True), flat_acc)
    hits = int(ok.sum())
    ms, by = bound(n * (4 + 4 + 4) + 2 * k * s * 4, fp_ops=hits)
    return dict(name="segment_aggregate", cases=len(cases) + 1,
                max_abs_err=max_err, shape=f"N={n} into acc[{k},{s},1]",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=ms, bound_by=by)


def fill_join_state(k, ring, tick, n_ticks, dev):
    """Rings filled by the Q3 counting path (band_join_counts, then the join
    fast path with every key responsible, no outputs)."""
    from repro_torch.core import join
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    ws = WindowSpec(wa=1, ws=300_000, wt="single")
    fj = join.band_predicate(10.0, 2)
    st = join.fast_join_init(k, ring, 4, dev)
    resp = torch.ones(k, dtype=torch.bool, device=dev)
    gen = datagen.scalejoin(np.random.default_rng(3), n_ticks=n_ticks + 1,
                            tick=tick, k_virt=1, device=dev)
    for _ in range(n_ticks):
        b = next(gen)
        join.band_join_counts(st, b, ws, band=10.0, n_attrs=2)
        st, _ = join.tick_fast(ws, fj, st, b, resp, out_cap=64, emit=False)
    return st, next(gen), ws


def check_window_join(dev):
    from repro_torch.kernels.window_join.ops import window_join_op
    from repro_torch.kernels.window_join.ref import window_join_ref
    INF = torch.iinfo(torch.int32).max
    kw = dict(band=10.0, n_attrs=2)

    def compare(name, args, ws):
        got = window_join_op(*args, ws=ws, **kw)
        want = window_join_ref(*args, ws=ws, **kw)
        if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
            raise AssertionError(f"window_join {name} differs")

    # q3 pipeline shape: K=512, ring 16, incoming tick 256
    st, b, ws = fill_join_state(512, 16, 256, 12, dev)
    tau = torch.where(b.valid, b.tau, INF)
    compare("q3_pipeline", (tau, b.source, b.payload, st.tau, st.stream,
                            st.pay), ws.ws)
    # bench shape: K=1024, R=256, B=512 (256 ms of 2000 t/s), rings filled
    # by 512 ticks = 262,144 stored tuples (~2.2 min of the 5 min window)
    st, b, ws = fill_join_state(1024, 256, 512, 512, dev)
    stored = int((st.tau >= 0).sum())
    args = (b.tau, b.source, b.payload, st.tau, st.stream, st.pay)
    compare("bench", args, ws.ws)
    for nb in (500, 37):                           # B not a multiple of 32
        compare(f"b{nb}", tuple(a[:nb] for a in args[:3]) + args[3:], ws.ws)
    compare("k1000", args[:3] + tuple(a[:1000] for a in args[3:]), ws.ws)
    kernel_ms = median_ms(lambda: window_join_op(*args, ws=ws.ws, **kw))
    plain_ms = median_ms(lambda: window_join_ref(*args, ws=ws.ws, **kw))
    _, comps = window_join_op(*args, ws=ws.ws, **kw)
    bsz, (k, r) = b.tau.shape[0], st.tau.shape
    pairs = bsz * k * r
    # bytes: incoming tau/src/first 2 payload columns, the same of the
    # stored rings, counts out; ops: an add and 3 compares per pair (int),
    # a subtract, abs and compare per attribute of each opposite pair (fp)
    ms, by = bound(bsz * 16 + k * r * 16 + bsz * k * 4 + 8,
                   int_ops=4 * pairs, fp_ops=3 * 2 * int(comps))
    return dict(name="window_join", cases=5, max_abs_err=0.0,
                shape=f"B={bsz}, K={k}, R={r}, P=4, n_attrs=2, "
                      f"stored={stored}, comps={int(comps)}",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=ms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 3: Q1 wordcount through VSNPipeline (and SN on a prefix)
# ---------------------------------------------------------------------------

def q1_wordcount(dev):
    from repro_torch.core import aggregate as agg
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import SNPipeline, VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.kernels import dispatch

    K, N_MAX, TICK, N_TICKS, RC_AT = 4096, 16, 2048, 40, 16
    op = agg.count_aggregate(WindowSpec(wa=1000, ws=2000, wt="multi"), K,
                             out_cap=4096, extra_slots=2)
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=N_TICKS, tick=TICK,
        words_per_tweet=6, vocab=50000, k_virt=K, rate_per_tick=200,
        device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=16,
                         fmu=balanced_fmu(K, 16, N_MAX),
                         active=active_mask(16, N_MAX))

    def run(cls, device, n_ticks, **kw):
        collisions = []

        def count_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = agg.tick_fast(op_, "count", st, ready, resp,
                                     explicit_w=explicit_w)
            collisions.append(st.collisions)
            return st, outs

        pipe = cls(op, n_max=N_MAX, n_active=4, stash_cap=TICK,
                   tick_fn=count_tick,
                   init_sigma=functools.partial(agg.fast_init, op), **kw,
                   device=device)
        ticks = []
        for i, b in enumerate(batches[:n_ticks]):
            t0 = time.perf_counter()
            if cls is VSNPipeline:
                o1, o2, sw, load = pipe.step_staged(
                    b, reconfig=rc if i == RC_AT else None)
                load = load.tolist()
            else:
                o1, o2, sw = pipe.step(b, reconfig=rc if i == RC_AT else None)
                load = None
            if pipe.device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ticks.append(dict(
                outs=sorted(flatten_outputs(o1) + flatten_outputs(o2)),
                switched=bool(sw), load=load, seconds=dt,
                overflow=int(o1.overflow.sum() + o2.overflow.sum()),
                collisions=int(torch.stack(collisions).sum())))
            collisions.clear()
        return pipe, ticks

    dispatch.reset_launches()
    pipe, gpu = run(VSNPipeline, dev, N_TICKS, merge_fn=merge_fast_state)
    launches = {k: v.launches for k, v in dispatch.registered().items()}
    t0 = time.perf_counter()
    _, cpu = run(VSNPipeline, "cpu", N_TICKS, merge_fn=merge_fast_state)
    cpu_seconds = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        for key in ("outs", "switched", "load"):
            if g[key] != c[key]:
                raise AssertionError(f"q1 tick {i}: {key} differs from CPU")
    sw_ticks = [i for i, g in enumerate(gpu) if g["switched"]]
    assert len(sw_ticks) == 1, sw_ticks
    assert all(g["overflow"] == 0 and g["collisions"] == 0 for g in gpu)
    assert int(pipe.sg.overflow) == 0
    expiries = sum(1 for g in gpu if g["outs"])
    assert expiries >= 2, expiries
    assert pipe.bytes_transferred == 0
    assert launches["scalegate_merge"] > 0 and \
        launches["segment_aggregate"] > 0, launches

    n_sn = sw_ticks[0] + 2
    sn_pipe, sn = run(SNPipeline, dev, n_sn)
    for i in range(n_sn):
        if sn[i]["outs"] != gpu[i]["outs"]:
            raise AssertionError(f"q1 tick {i}: SN outputs differ from VSN")
    assert sn_pipe.bytes_transferred > 0

    # A separate run, so the profiler does not touch the timed ticks above:
    # ticks 24-27 (16 active instances) under torch.profiler.
    prof_pipe = VSNPipeline(op, n_max=N_MAX, n_active=4, stash_cap=TICK,
                            tick_fn=lambda o, s, r, m, explicit_w=None:
                            agg.tick_fast(o, "count", s, r, m),
                            merge_fn=merge_fast_state,
                            init_sigma=functools.partial(agg.fast_init, op),
                            device=dev)
    for i in range(24):
        prof_pipe.step(batches[i], reconfig=rc if i == RC_AT else None)
    torch.cuda.synchronize()
    profile = device_profile(lambda i: prof_pipe.step(batches[24 + i]), 4)

    steady = [g["seconds"] for i, g in enumerate(gpu) if i not in (0, *sw_ticks)]
    return dict(
        phase="q1_wordcount", ticks=N_TICKS, tick_tuples=TICK, k_virt=K,
        outputs=sum(len(g["outs"]) for g in gpu), ticks_with_outputs=expiries,
        switch_tick=sw_ticks[0], equal_to_cpu=True,
        tuples_per_s=TICK * len(steady) / sum(steady),
        steady_tick_ms=statistics.median(steady) * 1e3,
        reconfig_tick_ms=gpu[sw_ticks[0]]["seconds"] * 1e3,
        vsn_sigma_bytes_moved=pipe.bytes_transferred,
        vsn_switch_table_bytes=pipe.switch_bytes(),
        sn_prefix_ticks=n_sn, sn_equal_to_vsn=True,
        sn_bytes_transferred=sn_pipe.bytes_transferred,
        cpu_run_seconds=cpu_seconds, profile=profile, launches=launches)


def device_profile(step, n: int) -> dict:
    """``step(i)`` for i < n under torch.profiler: host wall time per tick,
    the share of it the device spent in kernels and copies, device
    operations per tick, host synchronizations per tick and the host time
    blocked in them, and the kernels that took the most device time.  Device numbers are None when the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    sync_ev = [e for e in events if "Synchronize" in e.name]
    by_name = {}
    for e in dev_ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        ticks=n, wall_ms_per_tick=wall_us / n / 1e3,
        device_busy_share=(busy_us / wall_us) if dev_ev else None,
        device_ops_per_tick=len(dev_ev) / n if dev_ev else None,
        host_syncs_per_tick=len(sync_ev) / n,
        host_sync_ms_per_tick=sum(e.time_range.elapsed_us()
                                  for e in sync_ev) / n / 1e3,
        top_device_ms_per_tick=[(name[:60], us / n / 1e3) for name, us in top])


# ---------------------------------------------------------------------------
# phase 4: Q3 ScaleJoin through VSNPipeline + the window_join counting path
# ---------------------------------------------------------------------------

def q3_scalejoin(dev):
    from repro_torch.core import join
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.kernels import dispatch

    K, RING, TICK, N_TICKS, RC_AT, P = 512, 16, 256, 12, 6, 4
    ws = WindowSpec(wa=1, ws=300_000, wt="single")
    fj = join.band_predicate(10.0, 2)
    op = join.scalejoin_def(ws, K, fj, payload_width=P, ring=RING,
                            out_cap=1024)
    batches = list(datagen.scalejoin(np.random.default_rng(3),
                                     n_ticks=N_TICKS, tick=TICK, k_virt=1,
                                     rate_t_per_s=2000.0, device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=4, fmu=balanced_fmu(K, 4, 4),
                         active=active_mask(4, 4))

    def run(device):
        comps = []

        def join_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = join.tick_fast(ws, fj, st, ready, resp, out_cap=1024)
            comps.append(st.comparisons)
            return st, outs

        pipe = VSNPipeline(op, n_max=4, n_active=2, stash_cap=128,
                           tick_fn=join_tick, merge_fn=merge_fast_state,
                           init_sigma=lambda d: join.fast_join_init(K, RING,
                                                                    P, d),
                           device=device)
        ticks = []
        for i, b in enumerate(batches):
            b = pipe.stage(b)
            counts, cmp = join.band_join_counts(pipe.sigma, b, ws, band=10.0,
                                                n_attrs=2)
            o1, o2, sw, load = pipe.step_staged(
                b, reconfig=rc if i == RC_AT else None)
            pairs = []
            for tau, pay in flatten_outputs(o1) + flatten_outputs(o2):
                half = len(pay) // 2
                pairs.append((tau, tuple(sorted([pay[:half], pay[half:]]))))
            ticks.append(dict(
                pairs=sorted(pairs), switched=bool(sw),
                row_matches=counts.sum(dim=1).tolist(), band_comps=int(cmp),
                overflow=int(o1.overflow.sum() + o2.overflow.sum())))
        total = float(torch.stack(comps).sum())
        return pipe, ticks, total

    dispatch.reset_launches()
    pipe, gpu, gpu_comps = run(dev)
    launches = {k: v.launches for k, v in dispatch.registered().items()}
    _, cpu, cpu_comps = run("cpu")
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        for key in ("pairs", "switched", "row_matches", "band_comps"):
            if g[key] != c[key]:
                raise AssertionError(f"q3 tick {i}: {key} differs from CPU")
    assert gpu_comps == cpu_comps, (gpu_comps, cpu_comps)
    assert sum(g["switched"] for g in gpu) == 1
    assert all(g["overflow"] == 0 for g in gpu)
    assert int((pipe.sigma.n > RING).sum()) == 0     # no ring slot reused
    assert launches["scalegate_merge"] > 0 and launches["window_join"] > 0
    return dict(
        phase="q3_scalejoin", ticks=N_TICKS, k_virt=K, ring=RING,
        output_pairs=sum(len(g["pairs"]) for g in gpu),
        comparisons=gpu_comps,
        band_join_comparisons=sum(g["band_comps"] for g in gpu),
        band_join_matches=sum(sum(g["row_matches"]) for g in gpu),
        equal_to_cpu_as_unordered_pairs=True, launches=launches)


# ---------------------------------------------------------------------------
# phase 5: Q1 over the ingest tier (fused root) into AsyncStreamRuntime
# ---------------------------------------------------------------------------

def q1_ingest_tier(dev, n_ticks=40, tick=2048, join_at=12, leave_at=24):
    """The defaults are the card's run; smaller arguments rehearse the same
    phase on the CPU (``dev="cpu"``), where no kernel launches."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.async_runtime import AsyncStreamRuntime, run_sync
    from repro_torch.core.controller import ThresholdController
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    from repro_torch.ingest import (IngestTier, collect_tuples, emitted_taus,
                                    single_gate_stream)
    from repro_torch.io.sinks import CollectSink
    from repro_torch.io.sources import RateSchedule
    from repro_torch.kernels import dispatch

    K, N_MAX, N_SRC, N_LEAVES = 4096, 16, 8, 4
    TICK, N_TICKS, LEAF_CAP, ROOT_CAP = tick, n_ticks, tick, 2 * tick
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    op = agg.count_aggregate(WindowSpec(wa=1000, ws=2000, wt="multi"), K,
                             out_cap=4096, extra_slots=2, n_inputs=N_SRC)
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=N_TICKS, tick=TICK,
        words_per_tweet=6, vocab=50000, k_virt=K, rate_per_tick=200,
        n_sources=N_SRC, device="cpu"))
    # A declared rate hint (the tier is not paced): 6,000 t/s, then 60,000
    # from the join tick.  The controller reads hint x load skew x (1 +
    # queue depth / cap) against 4 instances of 2,500 t/s.  The values are
    # set only so that some switch happens: on the card the host-bound
    # pipeline fills its queue, so the scale-out comes from that pressure,
    # often before the burst, and the switch sequence varies by run.  The
    # check is >= 1 switch; the CPU twin replays whichever trace it took.
    sched = RateSchedule(((join_at, 6000.0), (N_TICKS, 60000.0)))

    def tier(device, **kw):
        t = IngestTier(batches, N_SRC, N_LEAVES, worker="thread",
                       leaf_cap=LEAF_CAP, root_cap=ROOT_CAP, out_pad=TICK,
                       root_device=True, schedule=sched, device=device, **kw)
        t.add_host(at_tick=join_at)
        t.remove_host(0, at_tick=leave_at)
        return t

    class Sink(CollectSink):
        """Keeps the outputs' overflow counts on the device."""
        def __init__(self):
            super().__init__()
            self.overflow = []

        def accept(self, tick_id, o1, o2):
            super().accept(tick_id, o1, o2)
            self.overflow.append(o1.overflow.sum() + o2.overflow.sum())

    def pipeline(device):
        collisions = []

        def count_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = agg.tick_fast(op_, "count", st, ready, resp,
                                     explicit_w=explicit_w)
            collisions.append(st.collisions)
            return st, outs

        pipe = VSNPipeline(op, n_max=N_MAX, n_active=4, stash_cap=TICK,
                           tick_fn=count_tick, merge_fn=merge_fast_state,
                           init_sigma=functools.partial(agg.fast_init, op),
                           device=device)
        return pipe, collisions

    # (a) the tier alone: every round checked, against one flat gate
    t = tier(dev, record=True, root_check_every=1)
    t0 = time.perf_counter()
    rounds = list(t)
    sync()
    tier_s = time.perf_counter() - t0
    st = t.stats()
    taus = emitted_taus(rounds)
    assert (np.diff(taus) >= 0).all(), "the tier's stream lost total order"
    oracle = single_gate_stream(batches, N_SRC, cap=ROOT_CAP + LEAF_CAP,
                                device=dev)
    if collect_tuples(rounds) != collect_tuples(oracle):
        raise AssertionError("the tier's tuples differ from one flat gate's")
    assert st.tuples_in == st.tuples_out == N_TICKS * TICK
    assert st.total_overflow == 0 and len(st.leaves) == N_LEAVES
    assert len(st.attach_ms) == len(st.detach_ms) == 1
    lanes = sorted({r.batch for r in rounds})

    # (b) the main path: the tier into the live runtime, controller on
    ctl = ThresholdController(n_max=N_MAX, k_virt=K,
                              capacity_per_instance=2500.0, n_active=4)
    pipe, collisions = pipeline(dev)
    sink = Sink()
    t2 = tier(dev)
    dispatch.reset_launches()
    rt = AsyncStreamRuntime(pipe, t2, sink=sink, controller=ctl, queue_cap=4)
    rep = rt.run()
    sync()
    launches = {k: v.launches for k, v in dispatch.registered().items()}
    assert rep.switches >= 1, rep.summary()
    assert t2.root.rounds == N_TICKS + 3     # ticks, join, leave, flush
    if dev.type == "cuda":
        assert launches["scalegate_merge_stacked"] == t2.root.rounds, \
            (launches, t2.root.rounds)
        assert launches["scalegate_merge"] > 0 and \
            launches["segment_aggregate"] > 0, launches
    assert pipe.bytes_transferred == 0
    assert int(pipe.sg.overflow) == 0
    assert int(torch.stack(sink.overflow).sum()) == 0
    assert int(torch.stack(collisions).sum()) == 0
    outs = sink.results()

    # (c) the CPU twin: the same tier on the CPU, the card's trace replayed
    t0 = time.perf_counter()
    cpu_pipe, _ = pipeline("cpu")
    cpu_rep, cpu_sink = run_sync(cpu_pipe, tier("cpu"),
                                 reconfig_trace=rep.reconfig_trace)
    cpu_seconds = time.perf_counter() - t0
    if cpu_sink.results() != outs:
        raise AssertionError("q1_ingest_tier: outputs differ from the CPU "
                             "run")
    assert cpu_rep.switches == rep.switches
    assert cpu_rep.detect_to_switch_ticks == rep.detect_to_switch_ticks

    # (d) where a round's time goes: the 4 rounds after the leave, tier
    # and pipeline stepped in this thread under torch.profiler
    prof_pipe, _ = pipeline(dev)
    it = iter(tier(dev))
    trace = dict(rep.reconfig_trace)
    step = lambda i: prof_pipe.step_staged(next(it), reconfig=trace.get(i))
    first = leave_at + 2                     # the leave's round is leave_at+1
    for i in range(first):
        step(i)
    sync()
    profile = device_profile(lambda i: step(first + i), 4)
    for _ in it:                    # drain the tier so its threads stop
        pass

    return dict(
        phase="q1_ingest_tier", ticks=N_TICKS, tick_tuples=TICK,
        sources=N_SRC, leaves=N_LEAVES, root_rounds=t2.root.rounds,
        root_lanes_per_round=lanes, tier_tuples=st.tuples_out,
        tier_seconds=tier_s, tier_tuples_per_s=st.tuples_out / tier_s,
        attach_ms=st.attach_ms, detach_ms=st.detach_ms,
        tier_equal_to_flat_gate=True, outputs=len(outs),
        runtime=dict(ticks=rep.ticks, tuples_per_s=rep.throughput_tps,
                     p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
                     wall_s=rep.wall_s, queue_high_water=rep.queue_high_water,
                     reconfigs=[(tk, int(rc.n_active))
                                for tk, rc in rep.reconfig_trace],
                     switches=rep.switches,
                     detect_to_switch_ticks=rep.detect_to_switch_ticks),
        equal_to_cpu=True, cpu_run_seconds=cpu_seconds,
        vsn_sigma_bytes_moved=pipe.bytes_transferred, profile=profile,
        launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, dispatch
    import repro_torch.kernels.scalegate_merge.ops      # noqa: F401
    import repro_torch.kernels.segment_aggregate.ops    # noqa: F401
    import repro_torch.kernels.window_join.ops          # noqa: F401

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log = (lib.parent / "build.log").read_text()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=str(lib.relative_to(ROOT)),
              ptxas=[ln.strip() for ln in log.splitlines()
                     if "Used" in ln or "spill" in ln]))
    print(card_line(), flush=True)

    rows = [check_scalegate_merge(dev), check_scalegate_merge_stacked(dev),
            check_segment_aggregate(dev), check_window_join(dev)]
    emit(dict(phase="kernels", kernels=rows))

    # The main path: each pipeline phase zeroes the counts right before its
    # card run and reads them right after it.
    phases = [q1_wordcount(dev), q3_scalejoin(dev), q1_ingest_tier(dev)]
    for ph in phases:
        emit(ph)
    launches = {name: sum(ph["launches"][name] for ph in phases)
                for name in dispatch.registered()}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")

    reg = dispatch.registered()
    emit({"kernels": [dict(
        name=r["name"], route="cuda", source=reg[r["name"]].source,
        replaces=reg[r["name"]].replaces, launches=launches[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], shape=r["shape"],
        **({"multi_tile": r["multi_tile"]} if "multi_tile" in r else {}))
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
