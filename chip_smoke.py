#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits nonzero:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/
                 kernels/csrc`` (one ``nvcc`` per source, in parallel) and
                 print the card's name and power limit.
2. ``kernels`` — hold each of the six kernels against its plain PyTorch
                 version on the card at the main path's shapes and on edge
                 cases (the four stream kernels exactly; flash_attention
                 within 2e-5 in float32 and an elementwise bfloat16 limit,
                 both bfloat16 bodies at every dense head size; linear_scan
                 within 1e-4), and time kernel, plain version, one library
                 call where one computes the same function, and the card's
                 bound; the two merge entries also at the ingest tier's
                 round sizes (all lanes valid and the root's valid share),
                 on every cluster-size boundary, past 2^20 lanes, at 0 and
                 2,000 sources, with a sweep over the cluster size, and
                 ScaleGate ``push`` at 2,000 sources and 2^20 + 1 lanes equal
                 to its CPU run; segment_aggregate at Q1's Zipf-skewed hits
                 as ``_scatter_reduce`` issues them, past one cluster, with
                 ``acc`` left unchanged, and a sweep over the cluster size;
                 window_join at the Q3 and bench shapes, n_attrs 12,
                 524,289 key rows and ``join_edge_cases``;
                 flash_attention at 65,544 (lane, KV head) pairs; the
                 two model kernels at their decode and prefill shapes
                 (linear_scan also at T 1024, strong and zero decays, the
                 chunk's edges, and a sweep over the chunk length).
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
6-7. ``serve_qwen3_14b``, ``serve_rwkv6_7b`` — each model at its published
                 width and depth in bfloat16 (random parameters drawn on the
                 card), one after the other, through ``build_runtime`` ->
                 ``AsyncStreamRuntime`` -> ``ServingPipeline`` ->
                 ``ServingEngine`` with the SLO controller: every request
                 served, first tokens equal to ``reference_decode``, one
                 kernel launch per layer per forward, a mid-decode VSN
                 switch moving 0 bytes and an SN switch moving more, both
                 token-invisible, and a float32 copy cut to 4 layers
                 token-identical to ``reference_decode`` (see
                 ``serve_full_width``).

Phases 3 to 7 are the main path: each zeroes the launch counts right
before its card run and reads them right after, and the ``{"kernels":
[...]}`` line reports their sum with phase 2's times.  The last line is
``{"ok": true, "device": {...}}``.  A kernel's ``ms`` is the median over
20 CUDA-event pairs of the mean of 20 back-to-back launches after
warm-up, ``single_ms`` the median of 20 single launches (which also spans
a wrapper's host time), ``device_ms`` the profiler's device time of one
call, and the same for the plain version and the library call.

    python3 chip_smoke.py --scan-turns <parent checkout>

times, in another checkout and in this one, in turns (parent, this, this,
parent) on one card: linear_scan's rows (decode, prefill T 128 and T
1024), segment_aggregate as ``aggregate._scatter_reduce`` issues it at
Q1's Zipf shape, and window_join as ``join.band_join_counts`` issues it
at the Q3 and bench shapes (``turn_rows``).
"""

import dataclasses
import functools
import json
import math
import pathlib
import re
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
# bfloat16 dense tensor-core peak, without sparsity (NVIDIA H100 SXM data
# sheet): the bound for work whose inputs are bfloat16.
BF16_OPS_PER_S = 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, setup=None, reps: int = 20, warmup: int = 3,
              inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event pairs of the mean time of ``inner``
    back-to-back ``fn(*setup())`` calls (one pair around all of them);
    ``setup`` runs before the timed region (fresh in-place targets).
    With ``inner=1`` it is the single-launch time, which also spans the
    host time of a Python wrapper."""
    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        args = [setup() if setup else () for _ in range(inner)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in args:
            fn(*a)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in pairs)


def single_ms(fn, setup=None) -> float:
    """Median CUDA-event time of one launch alone (``median_ms`` with
    ``inner=1``)."""
    return median_ms(fn, setup, inner=1)


def device_events(fn, setup=None, reps: int = 20):
    """[(name, device µs)] of every CUDA kernel, copy and fill that
    ``reps`` calls of ``fn(*setup())`` start (torch.profiler), without the
    host time of a Python wrapper."""
    from torch.profiler import ProfilerActivity, profile
    fn(*(setup() if setup else ()))
    # now and then a profiling session records no device activity at all;
    # such a session is taken again, up to three times
    for _ in range(3):
        args = [setup() if setup else () for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(*a)
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    raise AssertionError("the profiler saw no CUDA activity")


def device_ms(fn, setup=None, kernel=None, reps: int = 20) -> float:
    """Mean device time of one ``fn(*setup())``: the CUDA kernels whose
    name contains ``kernel``, or with ``kernel=None`` every kernel, copy
    and fill the call starts (a library call's own kernels)."""
    us = [t for name, t in device_events(fn, setup, reps)
          if kernel is None or kernel in name]
    if not us:
        raise AssertionError(f"the profiler saw no {kernel} activity")
    return sum(us) / reps / 1e3


def timings(kernel, plain, library=None, setup=None, plain_reps=20):
    """The columns of a kernel's row: ``ms`` (back-to-back mean),
    ``single_ms`` (one launch alone), ``device_ms`` (profiler), the plain
    version's ``plain_ms`` (``plain_reps`` pairs of ``plain_reps`` calls),
    and the library call's ``library_ms`` and ``library_device_ms`` (None
    without one)."""
    return dict(
        ms=median_ms(kernel, setup), single_ms=single_ms(kernel, setup),
        device_ms=device_ms(kernel, setup),
        plain_ms=median_ms(plain, setup, reps=plain_reps, inner=plain_reps),
        library_ms=None if library is None else median_ms(library, setup),
        library_device_ms=(None if library is None
                           else device_ms(library, setup)))


def bound(n_bytes: float, int_ops: float = 0.0, fp_ops: float = 0.0,
          bf16_ops: float = 0.0):
    """Least time for the work on this card: the larger of bytes over the
    memory rate and operations over their peak rate.  -> (ms, bound_by)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S,
                bf16_ops / BF16_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_name(mangled: str) -> str:
    """``<name>_kernel<args>`` from a mangled kernel symbol: the
    identifier ending in ``_kernel`` whose length prefixes it, then its
    integer template arguments."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), end):
        if mangled[:end - n].endswith(str(n)):
            args = re.findall(r"L[ib](\d+)E", mangled[end:].split("EE")[0]
                              + "E")
            name = mangled[end - n:end]
            return f"{name}<{', '.join(args)}>" if args else name
    return mangled


def ptxas_summary(log: str):
    """[kernel, registers and shared memory, spills] for every kernel in
    the build log (``-Xptxas -v``)."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = kernel_name(ln.split("for", 1)[1].strip())
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            rows.append([name, ln.split(":", 1)[1].strip(), spill])
            name = None
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# a substring of every merge kernel's symbol (csrc/scalegate_merge.cu), for
# the merges' device time per tick or round in a phase's profile
MERGE_KERNEL_SYMBOL = "scalegate_"

# the cluster merge's boundaries: each cluster size's largest N and one
# lane more (1, 2, 4, 8, 16 blocks of 4096 lanes), its capacity 65,536,
# and one lane past it (the multi-block path)
MERGE_BOUNDARIES = (4096, 4097, 8192, 8193, 16384, 16385, 32768, 32769,
                    65536, 65537)


def kernels_per_call(fn, reps: int = 5) -> float:
    """Device operations (kernels, copies, fills) one ``fn()`` starts."""
    return len(device_events(fn, reps=reps)) / reps


def inf_mix(rng, n, n_sources, w_inf):
    """Unsorted taus over ``n`` lanes with invalid lanes and valid lanes at
    tau INT_MAX scattered over every block; with ``w_inf`` every source
    has a valid INT_MAX lane (W = INT_MAX), else the last source has
    none (W below it)."""
    INF = np.iinfo(np.int32).max
    tau = rng.integers(0, 5 * n, n).astype(np.int32)
    src = rng.integers(0, n_sources, n).astype(np.int32)
    valid = rng.random(n) < 0.6
    at_inf = rng.random(n) < 0.2
    tau[at_inf] = INF
    valid[at_inf & (rng.random(n) < 0.5)] = True
    for s in range(n_sources):
        lanes = np.flatnonzero(src == s)
        if w_inf or s < n_sources - 1:
            tau[lanes[0]], valid[lanes[0]] = INF, True
        else:
            tau[lanes[tau[lanes] == INF]] = 7
    return tau, src, valid


def check_scalegate_merge(dev):
    from repro_torch.kernels.scalegate_merge import ops
    from repro_torch.kernels.scalegate_merge.ref import scalegate_merge_ref
    scalegate_merge_op = ops.scalegate_merge_op
    INF = torch.iinfo(torch.int32).max
    rng = np.random.default_rng(11)
    cases = []
    # 22,536 = the pipeline's buffer in a q1_ingest_tier round of 8 leaf
    # rows (2048 + 20,480 + 8 lanes)
    for n in sorted({2, 127, 128, 386, 513, 4097, 8192, 16384, 22536,
                     2 ** 20, *MERGE_BOUNDARIES}):
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
    # any n_sources: 0 (no fold, what push asks for), past the shared-memory
    # fold (1024) on the cluster path and on the multi-block path, and N
    # past 2^20 lanes
    for n, ns in ((8000, 0), (8000, 2000), (70000, 2000), (70000, 0),
                  (2 ** 20 + 1, 3), (2 ** 20 + 1, 0)):
        cases.append((f"n{n}_sources{ns}",
                      rng.integers(0, 5 * n, n).astype(np.int32),
                      rng.integers(0, max(ns, 1), n).astype(np.int32),
                      rng.random(n) < 0.9, ns))
    n = 22536
    cases += [
        ("unsorted_22536", rng.integers(0, 5 * n, n).astype(np.int32),
         rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.9, 3),
        ("inf_mix_w_inf_22536", *inf_mix(rng, n, 3, True), 3),
        ("inf_mix_w_below_22536", *inf_mix(rng, n, 3, False), 3),
        ("all_invalid_22536", rng.integers(0, 99, n).astype(np.int32),
         np.zeros(n, np.int32), np.zeros(n, bool), 1),
        ("duplicates_across_blocks_22536",
         np.sort(rng.integers(0, 4, n)).astype(np.int32),
         rng.integers(0, 2, n).astype(np.int32), rng.random(n) < 0.9, 2),
        ("unsorted_duplicates_22536", rng.integers(0, 4, n).astype(np.int32),
         rng.integers(0, 2, n).astype(np.int32), rng.random(n) < 0.9, 2),
    ]

    def compare(name, args, ns, cluster=None):
        got = ops._cuda(*args, n_sources=ns, cluster=cluster)
        want = scalegate_merge_ref(*args, n_sources=ns)
        for g, w_, what in zip(got, want, ("order", "ready", "wmark")):
            if not torch.equal(g, w_):
                raise AssertionError(f"scalegate_merge {name}: {what} differs")

    for name, tau, src, valid, ns in cases:
        compare(name, [torch.as_tensor(a, device=dev)
                       for a in (tau, src, valid)], ns)

    def timed(n, valid_share=None):
        """Kernel, plain version, library sort and bound at ``n`` lanes of
        one source, sorted taus; the last lane invalid (the control lane),
        or with ``valid_share`` that share of the lanes valid."""
        trng = np.random.default_rng(n)     # the same data in every run
        tau = torch.as_tensor(np.sort(trng.integers(0, 5 * n, n))
                              .astype(np.int32), device=dev)
        src = torch.zeros(n, dtype=torch.int32, device=dev)
        if valid_share is None:
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            valid[-1] = False
        else:
            valid = torch.as_tensor(trng.random(n) < valid_share, device=dev)
        key = ((torch.where(valid, tau, INF).to(torch.int64) + 2 ** 31)
               << 32) | torch.arange(n, device=dev)
        ms, by = bound(n * (4 + 4 + 1) + n * 8 + 4,
                       int_ops=n * math.ceil(math.log2(n)))
        run = lambda: scalegate_merge_op(tau, src, valid, n_sources=1)
        return dict(
            shape=f"N={n}, n_sources=1, {int(valid.sum())} valid",
            cluster=ops.plan(n).cluster, kernels_per_call=kernels_per_call(run),
            **timings(run,
                      lambda: scalegate_merge_ref(tau, src, valid,
                                                  n_sources=1),
                      lambda: torch.argsort(key, stable=True)),
            bound_ms=ms, bound_by=by)

    def cluster_sweep(n=22536):
        """Device ms at ``n`` unsorted lanes for every cluster size that
        holds them, each held against the plain version first."""
        args = [torch.as_tensor(a, device=dev) for a in (
            rng.integers(0, 5 * n, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.9)]
        out = {}
        for c in range(-(-n // ops.SHARE), ops.MAX_CLUSTER + 1):
            compare(f"sweep_cluster{c}", args, 3, cluster=c)
            out[c] = device_ms(lambda: ops._cuda(*args, n_sources=3,
                                                 cluster=c))
        return out

    # the q1 main-path shape (stash 2048 + tick 2048 + 1 ctrl lane), the
    # pipeline's buffer in a q1_ingest_tier round of 8 rows, and that
    # buffer with the ingest root's valid share (~2,048 of 22,536)
    return dict(name="scalegate_merge", cases=len(cases), max_abs_err=0.0,
                push_cases=check_push_limits(dev),
                **timed(4097), multi_tile=timed(22536),
                tier_valid=timed(22536, 2048 / 22536),
                cluster_sweep_ms=cluster_sweep(),
                max_active_clusters={c: ops.max_clusters(c)
                                     for c in (1, 2, 4, 8, 16)})


def check_push_limits(dev):
    """ScaleGate ``push`` on the card against the CPU run of the same two
    pushes, where the card took less before: 2,000 sources, and a merge
    buffer of 2^20 + 1 lanes (stash capacity 2^19 plus 2^19 + 1 tuples).
    Each source's tuples arrive sorted, and no two tuples share a tau, so
    the card's (tau, arrival) order and the CPU's (tau, source, arrival)
    are one order over the valid lanes: each emitted batch's ready mask
    and its ready prefix (every field, in order), the stash's kept prefix,
    the frontiers and the overflow must be equal exactly.  (Invalid lanes
    sort last in arrival order on the card and by source on the CPU; they
    carry nothing.)"""
    from repro_torch.core import scalegate as sg
    from repro_torch.core import tuples as T
    out = {}
    for name, n_sources, cap, b in (("sources_2000", 2000, 8192, 8000),
                                    ("lanes_2^20+1", 8, 2 ** 19,
                                     2 ** 19 + 1)):
        g = np.random.default_rng(n_sources)
        ticks = []
        for i in range(2):
            src = np.sort(np.arange(b) % n_sources).astype(np.int32)
            tau = (g.permutation(b) * 2 + i * 2 * b).astype(np.int32)
            tau = tau[np.lexsort((tau, src))]      # sorted within a source
            ticks.append(dict(tau=tau, payload=g.random((b, 2), np.float32),
                              keys=g.integers(0, 64, (b, 2)).astype(np.int32),
                              source=src, valid=g.random(b) < 0.95))
        runs = []
        for device in (dev, torch.device("cpu")):
            st = sg.init_scalegate(n_sources, cap, 2, 2, device=device)
            emitted = []
            for tick in ticks:
                st, ready = sg.push(st, T.make_batch(device=device, **tick))
                emitted.append(ready)
            runs.append((emitted, st))
        (got, st_got), (want, st_want) = runs

        def prefix_equal(what, a, b_):
            """The valid masks are equal and a prefix, and the lanes of the
            prefix are equal in every field."""
            n_valid = int(b_.valid.sum())
            if not (torch.equal(a.valid.cpu(), b_.valid)
                    and bool(b_.valid[:n_valid].all())
                    and all(torch.equal(getattr(a, f)[:n_valid].cpu(),
                                        getattr(b_, f)[:n_valid])
                            for f in T.FIELDS)):
                raise AssertionError(f"push {name}: {what} differs")

        for i, (a, b_) in enumerate(zip(got, want)):
            prefix_equal(f"the ready prefix of tick {i}", a, b_)
        prefix_equal("the stash", st_got.stash, st_want.stash)
        if not (torch.equal(st_got.wmark.frontier.cpu(),
                            st_want.wmark.frontier)
                and int(st_got.overflow) == int(st_want.overflow)):
            raise AssertionError(f"push {name}: gate differs")
        out[name] = dict(lanes=cap + b, n_sources=n_sources,
                         ready=[int(r.valid.sum()) for r in want],
                         stash=int(st_want.stash.valid.sum()))
    return out


def check_scalegate_merge_stacked(dev):
    from repro_torch.kernels.scalegate_merge.ops import \
        scalegate_merge_stacked_op, plan
    from repro_torch.kernels.scalegate_merge.ref import \
        scalegate_merge_stacked_ref
    INF = np.iinfo(np.int32).max
    rng = np.random.default_rng(13)
    C = 2048

    def root_round(rows, n_reports=8, active=5, c=C, valid_per_row=None,
                   g=rng):
        """Stash rows then leaf chunk rows: each a sorted run whose first
        lanes are valid (a chunk padded with invalid lanes)."""
        tau = np.sort(g.integers(0, 40_000, (rows, c)), axis=1)
        n_valid = (g.integers(0, c + 1, (rows, 1)) if valid_per_row is None
                   else g.integers(valid_per_row // 2,
                                   3 * valid_per_row // 2 + 1, (rows, 1)))
        valid = np.arange(c)[None, :] < n_valid
        reports = np.full(n_reports, INF, np.int64)
        reports[:active] = g.integers(10_000, 30_000, active)
        return (tau.astype(np.int32), g.integers(0, 8, (rows, c)), valid,
                reports)

    def fuzz(rows, c):                 # the reference test's rounds
        tau = rng.integers(0, 40, (rows, c))
        valid = rng.random((rows, c)) < 0.7
        valid[rng.integers(rows)] = False
        return tau, rng.integers(0, 4, (rows, c)), valid, \
            rng.integers(5, 35, (rows,))

    cases = {"root_12288": root_round(6), "root_20480": root_round(10),
             "lanes_2^20": root_round(512)}
    for n in MERGE_BOUNDARIES:
        cases[f"boundary_1x{n}"] = root_round(1, c=n)
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
    # 22,536 lanes as [3, 7512]
    tau, src, valid, reports = root_round(3, c=7512)
    shape = tau.shape
    cases["unsorted_22536"] = (rng.integers(0, 40_000, shape), src,
                               rng.random(shape) < 0.9, reports)
    for w_inf in (True, False):
        t, _, v = inf_mix(rng, tau.size, 1, True)
        cases[f"inf_mix_w_{'inf' if w_inf else 'below'}_22536"] = (
            t.reshape(shape), src, v.reshape(shape),
            np.full(8, INF, np.int64) if w_inf else reports)
    cases["all_invalid_22536"] = (tau, src, np.zeros(shape, bool), reports)
    cases["duplicates_across_blocks_22536"] = (
        np.sort(rng.integers(0, 4, shape), axis=1), src,
        rng.random(shape) < 0.9, np.full(8, 2, np.int64))
    cases["unsorted_duplicates_22536"] = (
        rng.integers(0, 4, shape), src, rng.random(shape) < 0.9,
        np.full(8, 2, np.int64))
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

    def timed(rows, valid_per_row=None):
        """Kernel, plain version, library sort and bound on one root round
        of ``rows`` rows of ``C`` lanes."""
        tau, src, valid, reports = (
            torch.as_tensor(np.asarray(a, dtype), device=dev)
            for a, dtype in zip(root_round(   # the same data in every run
                rows, valid_per_row=valid_per_row,
                g=np.random.default_rng(rows)),
                                (np.int32, np.int32, bool, np.int32)))
        n, n_rep = tau.numel(), reports.numel()
        key = ((torch.where(valid, tau, INF).to(torch.int64) + 2 ** 31)
               << 32) | torch.arange(n, device=dev).reshape(tau.shape)
        ms, by = bound(n * (4 + 1) + n * 8 + 4 * n_rep,
                       int_ops=n * math.ceil(math.log2(n)))
        run = lambda: scalegate_merge_stacked_op(tau, src, valid, reports)
        return dict(
            shape=f"[{rows}, {C}] = {n} lanes, {int(valid.sum())} valid, "
                  f"{n_rep} reports",
            cluster=plan(n).cluster, kernels_per_call=kernels_per_call(run),
            **timings(run,
                      lambda: scalegate_merge_stacked_ref(tau, src, valid,
                                                          reports),
                      lambda: torch.argsort(key.reshape(-1), stable=True)),
            bound_ms=ms, bound_by=by)

    # the root's steady round (4096 stash + 4 leaf rows of 2048), a round
    # with a doubled row bucket (20,480 lanes), and the steady round with
    # the root's valid share (~2,048 of 12,288)
    return dict(name="scalegate_merge_stacked", cases=len(cases),
                max_abs_err=0.0, **timed(6), multi_tile=timed(10),
                tier_valid=timed(6, valid_per_row=2048 // 6))


def q1_zipf_call(dev):
    """Q1's aggregate update as the main path issues it: one
    ``datagen.tweets`` tick (seed 7, Zipf(1.3) over 50,000 words, 4096
    virtual keys, 2048 tweets of 6 words) through
    ``aggregate._scatter_reduce`` for the instance that owns the tick's
    hottest key at 16 instances.  -> ``call()`` running that once (the
    same API in every tree of the port, so ``--scan-turns`` times it
    where the main path pays it)."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    k_virt, n_inst = 4096, 16
    op = agg.count_aggregate(WindowSpec(wa=1000, ws=2000, wt="multi"),
                             k_virt, out_cap=4096, extra_slots=2).resolved()
    ready = next(datagen.tweets(
        np.random.default_rng(7), n_ticks=1, tick=2048, words_per_tweet=6,
        vocab=50000, k_virt=k_virt, rate_per_tick=200, device=dev))
    acc = agg.fast_init(op, dev).op_state.zeta["acc"]
    next_l = op.window.earliest_win_l(ready.tau.min())
    # a key repeated in one tweet counts once (the fast path's dedup)
    keys = ready.keys.sort(dim=1).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    hot = int(torch.bincount(keys[first & (keys >= 0)].long()).argmax())
    owner = torch.arange(k_virt, device=dev) % n_inst == hot % n_inst
    return lambda: agg._scatter_reduce(op, "count", acc, ready, owner,
                                       next_l)


def kernel_inputs(call, module, name):
    """The arguments ``call()`` hands ``module.name`` (its one launch)."""
    seen = []
    kernel = getattr(module, name)
    setattr(module, name, lambda *a, **kw: seen.append(a) or kernel(*a, **kw))
    try:
        call()
    finally:
        setattr(module, name, kernel)
    return seen[0]


def check_segment_aggregate(dev):
    """The kernel against its plain version on the card: exactly on
    integer-valued contributions, within ``rtol=1e-6`` on float sums, and
    ``acc`` untouched (out-of-place).  Cases: Q1's Zipf call as
    ``_scatter_reduce`` issues it (W 1, and W 2 with integer values),
    even keys over [-1, K + 64) with slots outside [0, S), every
    cluster size, the cluster body's last accumulator and the first one
    past it, [2^18, 4, 1] (the global body), K below the cluster, N not
    a multiple of 4, no hits, and unaligned inputs.  Timed at the Zipf
    shape (the headline row) and at the even shape, with a sweep over the
    cluster size."""
    from repro_torch.core import aggregate as agg
    from repro_torch.kernels.segment_aggregate import ops
    from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref
    op = ops.segment_aggregate_op
    rng = np.random.default_rng(12)
    dev_t = lambda a: torch.as_tensor(a, device=dev)

    def make(n, k, s, w, integer=True):
        keys = rng.integers(-1, k + 64, n).astype(np.int32)   # -1 and >= K
        slots = rng.integers(-1, s + 1, n).astype(np.int32)   # -1 and S too
        vals = (rng.integers(0, 100, (n, w)) if integer
                else rng.random((n, w))).astype(np.float32)
        acc = rng.integers(0, 50, (k, s, w)).astype(np.float32)
        return tuple(map(dev_t, (keys, slots, vals, acc)))

    zipf = kernel_inputs(q1_zipf_call(dev), agg, "segment_aggregate_op")
    kk, ss, _, acc = zipf
    n = kk.shape[0]
    live = kk >= 0
    hot_cell_hits = int(torch.bincount(
        (kk[live] * acc.shape[1] + ss[live]).long()).max())
    assert hot_cell_hits >= 100, hot_cell_hits
    cases = {"zipf_w1": zipf,
             "zipf_w2": (kk, ss, dev_t(rng.integers(
                 0, 100, (n, 2)).astype(np.float32)), dev_t(rng.integers(
                     0, 50, (*acc.shape[:2], 2)).astype(np.float32))),
             "even_n49164": make(49164, 4096, 4, 1),
             "int_sum_w2": make(24576, 4096, 4, 2),
             "cluster_last_k65536": make(49164, 65536, 4, 1),
             "global_k65537": make(49164, 65537, 4, 1),
             "global_k262144": make(49164, 2 ** 18, 4, 1),
             "k5": make(3001, 5, 3, 2),
             "n24579": make(24579, 4096, 4, 1),
             "n0": make(0, 4096, 4, 1)}
    kk, ss, vv, acc = make(24581, 4096, 4, 1)
    cases["unaligned"] = (kk[1:], ss[1:], vv[1:], acc)

    def compare(name, args, kernel=op, float_sums=False):
        before = args[3].clone()
        got = kernel(*args)
        want = segment_aggregate_ref(*args)
        if not torch.equal(args[3], before):
            raise AssertionError(f"segment_aggregate {name}: acc changed")
        if float_sums:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        elif not torch.equal(got, want):
            raise AssertionError(f"segment_aggregate {name} differs")
        return float((got - want).abs().max())

    for name, args in cases.items():
        compare(name, args)
    for name in ("zipf_w1", "even_n49164"):
        for c in (1, 2, 4, 8, 16):
            compare(f"{name}_cluster{c}", cases[name],
                    functools.partial(ops._cuda, cluster=c))
    # float sums: the adds land in another order; a few per cell, rtol 1e-6
    max_err = max(compare("float_even", make(2048, 4096, 4, 1, False),
                          float_sums=True),
                  compare("float_global", make(2048, 2 ** 18, 4, 1, False),
                          float_sums=True))

    def timed(args):
        kk, ss, vv, acc = args
        n, w = vv.shape
        k, s, _ = acc.shape
        ok = (kk >= 0) & (kk < k) & (ss >= 0) & (ss < s)
        flat = torch.where(ok, kk.long() * s + ss.long(), k * s)
        padded = torch.cat([acc.reshape(-1, w), acc.new_zeros(1, w)])
        put = lambda: padded.index_put((flat,), vv, accumulate=True)
        # keys, slots and vals read once, acc read once, out written once
        ms, by = bound(n * (8 + 4 * w) + 2 * k * s * w * 4,
                       fp_ops=int(ok.sum()) * w)
        return dict(shape=f"N={n} into acc[{k},{s},{w}], "
                          f"{int(ok.sum())} live hits",
                    kernels_per_call=kernels_per_call(lambda: op(*args)),
                    **timings(lambda: op(*args),
                              lambda: segment_aggregate_ref(*args),
                              library=put),
                    bound_ms=ms, bound_by=by)

    # 0: the copy and the global kernel (two device operations)
    sweep = {c: device_ms(lambda: ops._cuda(*zipf, cluster=c))
             for c in (0, 1, 2, 4, 8, 16)}
    return dict(name="segment_aggregate", cases=len(cases) + 12,
                max_abs_err=max_err, hot_cell_hits=hot_cell_hits,
                **timed(zipf), even=timed(cases["even_n49164"]),
                cluster_sweep_ms=sweep,
                no_hits_device_ms=device_ms(lambda: op(*cases["n0"])))


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


def join_edge_cases(rng):
    """window_join's edge cases, as numpy inputs with their ``ws``:
    R of 1, 17 and 33 (not a multiple of a staged chunk of 32); rotated
    rings (round-robin from a head, every other row's first chunk all
    stale) with one chunk all empty; stored taus whose ``tau + ws`` wraps
    past INT_MAX as int32, against incoming taus down to INT_MIN; and
    incoming taus of INT_MAX, 0 and negative."""
    INF, MIN = 2 ** 31 - 1, -2 ** 31
    cases = {}

    def rand(b, k, r, p=4):
        return [np.sort(rng.integers(100, 300, b)).astype(np.int32),
                rng.integers(0, 2, b).astype(np.int32),
                rng.uniform(0, 40, (b, p)).astype(np.float32),
                np.where(rng.random((k, r)) < 0.3, -1,
                         rng.integers(0, 280, (k, r))).astype(np.int32),
                rng.integers(0, 2, (k, r)).astype(np.int32),
                rng.uniform(0, 40, (k, r, p)).astype(np.float32)]

    for r in (1, 17, 33):
        cases[f"r{r}"] = (rand(300, 24, r), 60)
    a = rand(300, 24, 130)
    head = rng.integers(0, 130, 24)
    head[::2] = 0
    age = (np.arange(130)[None] - head[:, None]) % 130     # 0: the oldest
    a[3] = (1000 + 10 * age).astype(np.int32)
    a[3][:, 64:96] = -1
    # the oldest 40 of every row are older than the window (tau + 500 <
    # 1900 <= every incoming tau): rows with head 0 hold a stale chunk
    a[0] = np.sort(rng.integers(1900, 2400, 300)).astype(np.int32)
    cases["rotated_stale_and_empty"] = (a, 500)
    a = rand(300, 24, 40)
    a[3] = np.where(rng.random((24, 40)) < 0.5,
                    rng.integers(INF - 1000, INF, (24, 40), dtype=np.int64),
                    rng.integers(INF - 3000, INF - 1000, (24, 40),
                                 dtype=np.int64)).astype(np.int32)
    a[3][rng.random((24, 40)) < 0.2] = -1
    a[3][0, :5] = MIN                                     # empty too
    a[0] = np.sort(np.concatenate([
        [MIN, MIN, MIN + 1, MIN + 500, MIN + 1500, -1, 0, 1, INF - 2500,
         INF - 1500, INF - 1, INF, INF],
        rng.integers(MIN, MIN + 2000, 100),
        rng.integers(INF - 4000, INF, 187)]).astype(np.int32))
    cases["horizon_wraps"] = (a, 2000)
    a = rand(300, 24, 40)
    a[0][:40] = INF
    a[0][40:60] = 0
    a[0][60:80] = -rng.integers(1, 2 ** 31, 20)
    a[0][80] = MIN
    cases["incoming_inf_zero_negative"] = (a, 60)
    return cases


def check_window_join(dev):
    """The kernel against its plain version on the card, counts and comps
    exactly: the Q3 pipeline's shape (B 256, K 512, R 16) and the bench
    shape (B 512, K 1024, R 256) from rings the Q3 counting path filled,
    B and K not multiples of a tile, n_attrs 12 (past the unrolled 8),
    524,289 key rows, and ``join_edge_cases``.  Timed at the bench shape
    (the headline row) and the Q3 shape."""
    from repro_torch.kernels.window_join.ops import window_join_op
    from repro_torch.kernels.window_join.ref import window_join_ref
    INF = torch.iinfo(torch.int32).max
    kw = dict(band=10.0, n_attrs=2)
    n_cases = 0

    def compare(name, args, ws, **kw_):
        nonlocal n_cases
        kw_ = kw_ or kw
        got = window_join_op(*args, ws=ws, **kw_)
        want = window_join_ref(*args, ws=ws, **kw_)
        if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
            raise AssertionError(f"window_join {name} differs")
        n_cases += 1
        return want

    def timed(args, ws, stored):
        row = timings(lambda: window_join_op(*args, ws=ws, **kw),
                      lambda: window_join_ref(*args, ws=ws, **kw))
        _, comps = window_join_op(*args, ws=ws, **kw)
        bsz, (k, r) = args[0].shape[0], args[3].shape
        pairs = bsz * k * r
        # bytes: incoming tau/src/first 2 payload columns, the same of the
        # stored rings, counts out; ops: an add and 3 compares per pair
        # (int), a subtract, abs and compare per attribute of each opposite
        # pair (fp)
        ms, by = bound(bsz * 16 + k * r * 16 + bsz * k * 4 + 8,
                       int_ops=4 * pairs, fp_ops=3 * 2 * int(comps))
        return dict(shape=f"B={bsz}, K={k}, R={r}, P=4, n_attrs=2, "
                          f"stored={stored}, comps={int(comps)}",
                    **row, bound_ms=ms, bound_by=by)

    # q3 pipeline shape: K=512, ring 16, incoming tick 256
    st, b, ws = fill_join_state(512, 16, 256, 12, dev)
    q3 = (torch.where(b.valid, b.tau, INF), b.source, b.payload, st.tau,
          st.stream, st.pay)
    compare("q3_pipeline", q3, ws.ws)
    q3_row = timed(q3, ws.ws, int((st.tau >= 0).sum()))
    # bench shape: K=1024, R=256, B=512 (256 ms of 2000 t/s), rings filled
    # by 512 ticks = 262,144 stored tuples (~2.2 min of the 5 min window)
    st, b, ws = fill_join_state(1024, 256, 512, 512, dev)
    args = (b.tau, b.source, b.payload, st.tau, st.stream, st.pay)
    compare("bench", args, ws.ws)
    for nb in (500, 37):                           # B not a multiple of 32
        compare(f"b{nb}", tuple(a[:nb] for a in args[:3]) + args[3:], ws.ws)
    compare("k1000", args[:3] + tuple(a[:1000] for a in args[3:]), ws.ws)
    # n_attrs = P = 12, past the 8 unrolled columns (the reference kernel
    # unrolls any n_attrs <= P), and 524,289 key rows: 65,537 tiles of 8,
    # past grid axis y's limit, which bound the kernel before
    g = np.random.default_rng(21)
    for name, (nb, k, r, p, n_attrs) in (
            ("n_attrs12", (300, 200, 16, 12, 12)),
            ("k524289", (40, 524_289, 1, 2, 2))):
        wide = [torch.as_tensor(a, device=dev) for a in (
            np.sort(g.integers(100, 300, nb)).astype(np.int32),
            g.integers(0, 2, nb).astype(np.int32),
            g.uniform(0, 40, (nb, p)).astype(np.float32),
            np.where(g.random((k, r)) < 0.3, -1,
                     g.integers(0, 280, (k, r))).astype(np.int32),
            g.integers(0, 2, (k, r)).astype(np.int32),
            g.uniform(0, 40, (k, r, p)).astype(np.float32))]
        want = compare(name, wide, 60, band=25.0, n_attrs=n_attrs)
        assert int(want[0].sum()) > 0, name
    for name, (a, ws_) in join_edge_cases(np.random.default_rng(22)).items():
        want = compare(name, [torch.as_tensor(x, device=dev) for x in a], ws_)
        assert int(want[1]) > 0, name
    return dict(name="window_join", cases=n_cases, max_abs_err=0.0,
                **timed(args, ws.ws, int((st.tau >= 0).sum())), q3=q3_row)


def check_flash_attention(dev):
    """The kernel against its plain version, both bfloat16 bodies and the
    float32 one: the qwen3-14b prefill and decode shapes (40 query heads
    over 8 KV heads, D 128), stablelm-12b's D 160 (n_rep 4), gemma3's
    D 256 (n_rep 2) with its 1024 window at decode and prefill, decode
    depths at the 32-key chunk edges (0, 31, 32, 33, 1023) over a
    permuted slot pool, rows that see no key (a whole lane, one head of a
    lane, the first queries of a prefill), a prefill into the pool with
    q_offset, n_rep 1/2/5, ragged Sq/Skv, both q_offset forms ([B] and
    [B * H_q]) and the TPU kernel's own signature (3-D, offset Skv - Sq).
    Tolerance: 2e-5 in float32 (the reference's).  In bfloat16,
    elementwise 1e-5 + 2^-8 * attn(|v|) + |want| / 64, from where the two
    differ: each rounds p to bfloat16, the kernel against a chunk's or
    the running max and the plain version against the row max, so a
    weight may differ by 2^-8 of itself and the output by 2^-8 of sum_i
    p_i |v_i| / l, which is the plain version run on |v|; and each rounds
    its output to bfloat16, one ulp being at most |x| / 128 (the last
    term allows two)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_op, flash_attention_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ints(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    def cache(slots, seq, heads, d, dtype):
        """A slot-pool cache [slots, seq, heads, d] seen as [slots, heads,
        seq, d], as the model hands it over."""
        return rnd(slots, seq, heads, d, dtype=dtype).transpose(1, 2)

    def decode_q(b, heads, d, dtype):
        return rnd(b, 1, heads, d, dtype=dtype).transpose(1, 2)

    errs, used = {}, {}

    def compare(name, q, k, v, **kw):
        got = flash_attention_op(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        if got.shape != want.shape:
            raise AssertionError(f"flash_attention {name}: shape "
                                 f"{tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        if q.dtype == bf16:
            weighted = flash_attention_plain(q, k, v.abs(), **kw).float()
            limit = 1e-5 + weighted / 256 + want.float().abs() / 64
        else:
            limit = torch.full_like(diff, 2e-5)
        errs[name] = float(diff.max())
        # the largest share of its limit any element used
        used[name] = float((diff / limit).max())
        if not used[name] <= 1.0:
            raise AssertionError(f"flash_attention {name}: max error "
                                 f"{errs[name]}, {used[name]:.3g} of the "
                                 f"limit")

    pos = [0, 1, 31, 32, 127, 128, 500, 1023]
    for dt in (f32, bf16):
        tag = "f32" if dt is f32 else "bf16"
        compare(f"prefill_8x40_{tag}", rnd(320, 128, 128, dtype=dt),
                rnd(64, 1024, 128, dtype=dt), rnd(64, 1024, 128, dtype=dt),
                n_rep=5, q_offset=ints(np.zeros(320)))
        compare(f"decode_mixed_{tag}", decode_q(8, 40, 128, dt),
                cache(16, 1024, 8, 128, dt), cache(16, 1024, 8, 128, dt),
                n_rep=5, q_offset=ints(np.repeat(pos, 40)),
                kv_index=ints([3, 0, 15, 7, 8, 1, 12, 5]))
        for window, off in ((1024, 1400), (5, 70)):
            compare(f"window{window}_d256_{tag}", rnd(2, 8, 64, 256, dtype=dt),
                    rnd(2, 4, 1500, 256, dtype=dt),
                    rnd(2, 4, 1500, 256, dtype=dt), n_rep=2, window=window,
                    q_offset=ints(np.full(16, off)))
        compare(f"n_rep1_d64_{tag}", rnd(4, 77, 64, dtype=dt),
                rnd(4, 1000, 64, dtype=dt), rnd(4, 1000, 64, dtype=dt))
        compare(f"ragged_d16_{tag}", rnd(6, 5, 16, dtype=dt),
                rnd(3, 37, 16, dtype=dt), rnd(3, 37, 16, dtype=dt), n_rep=2)
        compare(f"noncausal_d32_{tag}", rnd(2, 33, 32, dtype=dt),
                rnd(2, 45, 32, dtype=dt), rnd(2, 45, 32, dtype=dt),
                causal=False, window=9)
        compare(f"sees_no_key_{tag}", rnd(2, 40, 16, dtype=dt),
                rnd(2, 24, 16, dtype=dt), rnd(2, 24, 16, dtype=dt))
        # stablelm-12b: D 160, 32 heads over 8; decode over a pool, and a
        # prefill of 128 queries
        compare(f"decode_d160_{tag}", decode_q(4, 32, 160, dt),
                cache(6, 1024, 8, 160, dt), cache(6, 1024, 8, 160, dt),
                n_rep=4, q_offset=ints([0, 200, 31, 1023]),
                kv_index=ints([5, 1, 0, 3]))
        compare(f"prefill_d160_{tag}", rnd(1, 32, 128, 160, dtype=dt),
                rnd(1, 8, 128, 160, dtype=dt), rnd(1, 8, 128, 160, dtype=dt),
                n_rep=4)
    compare("tpu_signature_f32", rnd(4, 128, 128), rnd(4, 128, 128),
            rnd(4, 128, 128))
    # bfloat16 only: the split-KV decode's chunk edges over a permuted pool
    # (q_offset per lane, [B]), the same per (lane, head) ([B * H_q])
    depths = [0, 31, 32, 33, 1023, 144, 64, 500]
    pool = [cache(8, 1024, 8, 128, bf16) for _ in range(2)]
    perm = ints([6, 2, 7, 0, 5, 3, 1, 4])
    compare("decode_chunk_edges_bf16", decode_q(8, 40, 128, bf16), *pool,
            n_rep=5, q_offset=ints(depths), kv_index=perm)
    compare("decode_chunk_edges_per_head_bf16", decode_q(8, 40, 128, bf16),
            *pool, n_rep=5, q_offset=ints(np.repeat(depths, 40)),
            kv_index=perm)
    # gemma3: D 256, 16 heads over 8, the 1024 window, depths past it
    compare("decode_window1024_d256_bf16", decode_q(4, 16, 256, bf16),
            cache(4, 2048, 8, 256, bf16), cache(4, 2048, 8, 256, bf16),
            n_rep=2, window=1024, q_offset=ints([5, 1023, 1024, 2047]),
            kv_index=ints([2, 3, 0, 1]))
    # rows that see no key: a whole lane (its window lies past the cache:
    # every chunk works and the merge takes the mean of v), and one head
    # of a lane beside heads that see keys
    off = np.repeat([144, 5000, 33, 0], 40)
    off[2 * 40 + 7] = 5000
    compare("decode_sees_no_key_bf16", decode_q(4, 40, 128, bf16),
            cache(4, 1024, 8, 128, bf16), cache(4, 1024, 8, 128, bf16),
            n_rep=5, window=16, q_offset=ints(off))
    # a prefill of 128 queries into the pool at each lane's depth
    compare("prefill_into_pool_bf16",
            rnd(2, 128, 40, 128, dtype=bf16).transpose(1, 2), *pool,
            n_rep=5, q_offset=ints([0, 300]), kv_index=ints([5, 2]))
    # 8,193 lanes x 8 KV heads = 65,544 (batch row, KV head) pairs, past
    # grid axis y's 65,535, which bound the kernel before: the split-KV
    # decode (bf16), the SIMT body (f32) and the wgmma prefill (bf16, 4
    # queries x 5 heads = 20 rows), over a shallow cache, lanes at mixed
    # depths
    lanes = 8193
    depth = ints(np.arange(lanes) % 12)
    for sq, dt, tag in ((1, bf16, "decode_bf16"), (1, f32, "decode_f32"),
                        (4, bf16, "prefill_bf16")):
        q = rnd(lanes, sq, 40, 128, dtype=dt).transpose(1, 2)
        kc, vc = (cache(lanes, 16, 8, 128, dt) for _ in range(2))
        compare(f"lanes8193_kv_heads8_{tag}", q, kc, vc, n_rep=5,
                q_offset=depth)
        del q, kc, vc

    def timed(b, sq, at):
        """bf16 kernel, plain version, SDPA and bound for ``b`` lanes of
        ``sq`` queries of qwen3-14b (40 heads over 8, D 128) at depth ``at``
        of a 1024-slot cache, q_offset per lane as the model passes it;
        SDPA gets the visible keys with the KV heads repeated (outside the
        timing) and is_causal for the prefill."""
        q = rnd(b, sq, 40, 128, dtype=bf16).transpose(1, 2)
        kc, vc = (cache(b, 1024, 8, 128, bf16) for _ in range(2))
        off = ints(np.full(b, at))
        run = lambda f: f(q, kc, vc, n_rep=5, q_offset=off)
        n_vis = at + sq
        ke, ve = (x[:, :, :n_vis].repeat_interleave(5, dim=1).contiguous()
                  for x in (kc, vc))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        visible = b * 40 * (sq * at + sq * (sq + 1) // 2)  # (query, key)
        ms, by = bound(2 * (2 * b * 40 * sq * 128)          # q in, out
                       + 2 * (2 * b * 8 * n_vis * 128)      # visible K, V
                       + 4 * b, bf16_ops=4 * visible * 128)
        return dict(
            shape=f"q [{b}, 40, {sq}, 128] bf16 at depth {at} of a "
                  f"[{b}, 1024, 8, 128] cache, n_rep 5",
            **timings(lambda: run(flash_attention_op),
                      lambda: run(flash_attention_plain),
                      lambda: sdpa(q, ke, ve, is_causal=at == 0)),
            bound_ms=ms, bound_by=by)

    def split_sweep():
        """Decode device ms at the serve shape (8 lanes of qwen3-14b, 1024
        pool) at depths 144 and 1000 for every cluster size n_split the
        wrapper may pick (1 to 8), each held against the plain version."""
        q = decode_q(8, 40, 128, bf16)
        kc, vc = (cache(8, 1024, 8, 128, bf16) for _ in range(2))
        saved = flash_ops.MAX_SPLIT, dict(flash_ops._SMS)
        out = {}
        try:
            flash_ops._SMS[dev] = 1 << 30      # n_split = MAX_SPLIT
            for at in (144, 1000):
                off = ints(np.full(8, at))
                for n in range(1, flash_ops.MAX_SPLIT + 1):
                    flash_ops.MAX_SPLIT = n
                    compare(f"decode_split{n}_depth{at}_bf16", q, kc, vc,
                            n_rep=5, q_offset=off)
                    out[f"depth{at}_split{n}"] = device_ms(
                        lambda: flash_attention_op(q, kc, vc, n_rep=5,
                                                   q_offset=off))
        finally:
            flash_ops.MAX_SPLIT, flash_ops._SMS = saved
        return out

    # the serve phase's decode round (8 lanes at depth ~144) and its
    # batch-1 prefill of a 128-token prompt
    sweep = split_sweep()
    return dict(name="flash_attention", cases=len(errs),
                max_abs_err=max(v for k, v in errs.items() if "f32" in k),
                max_abs_err_bf16=max(v for k, v in errs.items()
                                     if "bf16" in k),
                errors=errs, limit_used=max(used.values()),
                limit_used_by_case=used,
                **timed(8, 1, 144), prefill=timed(1, 128, 0),
                decode_split_ms=sweep)


def scan_inputs(dev, gen, bh, t, dk, dv, u_rows=None, s0=False, w=None):
    """linear_scan's inputs, drawn on the card from ``gen``: r, k, v and u
    normal, decays ``w`` uniform on [0.5, 0.99] unless given."""
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    if w is None:
        w = 0.5 + 0.49 * torch.rand((bh, t, dk), generator=gen, device=dev)
    return dict(r=rnd(bh, t, dk), k=rnd(bh, t, dk), v=rnd(bh, t, dv), w=w,
                u=None if u_rows is None else rnd(u_rows, dk),
                s0=rnd(bh, dk, dv) if s0 else None)


def scan_call(f, a, **kw):
    return f(a["r"], a["k"], a["v"], a["w"], a["u"], a["s0"], **kw)


def scan_timed(a):
    """linear_scan's row at the inputs ``a`` (whichever ``repro_torch`` is
    imported): kernel, plain version and the card's bound."""
    from repro_torch.kernels.linear_scan.ops import linear_scan_op
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    bh, t, dk = a["r"].shape
    dv = a["v"].shape[-1]
    # r, k, w, v in; o out; S_T out (and s0 in when given); u in
    n_bytes = 4 * (3 * bh * t * dk + 2 * bh * t * dv + bh * dk * dv
                   + (bh * dk * dv if a["s0"] is not None else 0)
                   + a["u"].numel())
    # per step and (i, j): w s, k v, + (the update) and r s, + (the
    # output); the bonus diag(u) k^T v has rank 1, so per step it is
    # a = sum_i r_i u_i k_i (3 per i) and y_j += a v_j (2 per j)
    fp_ops = 5 * bh * t * dk * dv
    if a["u"] is not None:
        fp_ops += bh * t * (3 * dk + 2 * dv)
    ms, by = bound(n_bytes, fp_ops=fp_ops)
    return dict(shape=f"BH {bh}, T {t}, Dk {dk}, Dv {dv}, u, "
                      f"s0 {a['s0'] is not None}",
                **timings(lambda: scan_call(linear_scan_op, a),
                          lambda: scan_call(linear_scan_ref, a),
                          plain_reps=20 if t <= 128 else 3),
                bound_ms=ms, bound_by=by)


# linear_scan's timed shapes: the serve phase's decode tick (8 lanes x 64
# heads of rwkv6-7b, from a carried state), its prefill (128 tokens) and a
# prefill as deep as the serve configs' slots (1024)
SCAN_TIMED = {"decode": (512, 1, True), "prefill": (64, 128, False),
              "prefill_t1024": (64, 1024, False)}


def scan_timed_rows(dev):
    """linear_scan's timed rows on the same data in every run (seed 16)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    return {name: scan_timed(scan_inputs(dev, gen, bh, t, 64, 64, u_rows=64,
                                         s0=s0))
            for name, (bh, t, s0) in SCAN_TIMED.items()}


# window_join's timed shapes through ``join.band_join_counts``: (K, ring,
# tick, ticks that fill the rings), the Q3 pipeline's and the bench's
JOIN_TIMED = {"q3": (512, 16, 256, 12), "bench": (1024, 256, 512, 512)}


def call_row(call, kernel: str) -> dict:
    """``call()`` as the main path issues it: mean and lone times (CUDA
    events), and per call from the profiler the device operations, their
    device time, the time of the kernels whose symbol contains ``kernel``
    and that of device-to-device copies (a clone)."""
    events = device_events(call)
    per_call = lambda pick: sum(t for name, t in events if pick(name)) / 20e3
    return dict(ms=median_ms(call), single_ms=single_ms(call),
                ops_per_call=len(events) / 20,
                device_ms=per_call(lambda name: True),
                kernel_device_ms=per_call(lambda name: kernel in name),
                copy_device_ms=per_call(lambda name: "Memcpy DtoD" in name))


def turn_rows(dev) -> dict:
    """The rows ``--scan-turns`` times in each tree, on the same data in
    every run: linear_scan's three, segment_aggregate through
    ``aggregate._scatter_reduce`` at Q1's Zipf shape, and window_join
    through ``join.band_join_counts`` at ``JOIN_TIMED``'s shapes (the
    same API in both trees, so each is timed where the main path pays
    it)."""
    from repro_torch.core import join
    rows = dict(linear_scan=scan_timed_rows(dev),
                segment_aggregate=call_row(q1_zipf_call(dev),
                                           "segment_aggregate"))
    rows["window_join"] = {}
    for name, shape in JOIN_TIMED.items():
        st, b, ws = fill_join_state(*shape, dev)
        rows["window_join"][name] = call_row(
            lambda: join.band_join_counts(st, b, ws, band=10.0, n_attrs=2),
            "window_join")
    return rows


def scan_turns(parent: str) -> None:
    """``turn_rows`` of the checkout at ``parent`` and of this one, in
    turns (parent, this, this, parent), each turn a process of its own
    that builds and imports its checkout's ``repro_torch``; one JSON line
    a turn.

        python3 chip_smoke.py --scan-turns <root of the parent checkout>
    """
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import torch, chip_smoke; "
            "from repro_torch.kernels import build; build.library(); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "print(json.dumps(chip_smoke.turn_rows("
            "torch.device('cuda', 0))))")
    trees = {"parent": pathlib.Path(parent).resolve(), "change": ROOT}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run(
            [sys.executable, "-c", code, str(trees[name] / "src"), str(ROOT)],
            capture_output=True, text=True, check=True)
        emit(dict(phase="scan_turns", turn=turn, tree=name,
                  rows=json.loads(out.stdout.strip().splitlines()[-1])))


def check_linear_scan(dev):
    """The kernel against its plain version within 1e-4 (the reference's
    tolerance), on both of its bodies: the rwkv6-7b prefill (64 heads, 128
    tokens, 64 x 64 state) with and without u, its T = 1 decode over 8
    lanes from a nonzero carried state with u per head, the reference
    sweep's shapes; the chunk's edges (T = C - 1, C, C + 1) and ragged T;
    decays that reach 0 (RWKV6's exp(-exp(x)) over x in [-6, 8], and
    mixed from {0, 1e-30, 1e-6, 0.5, 1}), with nothing NaN; T 1024; and
    the sweep's chunk lengths (8 and 16), each timed (``chunk_sweep_ms``)."""
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.linear_scan.ops import linear_scan_op
    from repro_torch.kernels.linear_scan.ref import CHUNK, linear_scan_ref
    gen = torch.Generator(device=dev).manual_seed(6)
    inputs = functools.partial(scan_inputs, dev, gen)
    mixed = lambda *s: torch.tensor([0, 1e-30, 1e-6, 0.5, 1], device=dev)[
        torch.randint(0, 5, s, generator=gen, device=dev)]
    rwkv = lambda *s: torch.exp(-torch.exp(
        -6 + 14 * torch.rand(s, generator=gen, device=dev)))

    cases = {"prefill_u": inputs(64, 128, 64, 64, u_rows=64),
             "prefill_no_u": inputs(64, 128, 64, 64),
             "decode_s0_u": inputs(512, 1, 64, 64, u_rows=64, s0=True),
             "ref_2x64x8x8_u": inputs(2, 64, 8, 8, u_rows=2),
             "ref_3x128x16x24_u": inputs(3, 128, 16, 24, u_rows=3),
             "ref_2x64x8x8": inputs(2, 64, 8, 8),
             "ref_1x256x32x32": inputs(1, 256, 32, 32),
             "reduced_16_s0": inputs(8, 9, 16, 16, u_rows=4, s0=True),
             "rwkv_decays_prefill": inputs(64, 128, 64, 64, u_rows=64,
                                           s0=True, w=rwkv(64, 128, 64)),
             "mixed_decays_t53": inputs(16, 53, 64, 64, u_rows=16, s0=True,
                                        w=mixed(16, 53, 64)),
             "ragged_t130_dv40_dk128": inputs(4, 130, 128, 40, u_rows=2,
                                              s0=True),
             "t1024": inputs(64, 1024, 64, 64, u_rows=64, s0=True)}
    for t in (CHUNK - 1, CHUNK, CHUNK + 1):
        cases[f"t{t}_mixed_decays"] = inputs(64, t, 64, 64, u_rows=64,
                                             s0=True, w=mixed(64, t, 64))
    errs = {}

    def compare(name, a, kernel=linear_scan_op):
        got = scan_call(kernel, a)
        want = scan_call(linear_scan_ref, a)
        errs[name] = max(float((g - w_).abs().max())
                         for g, w_ in zip(got, want))
        if not errs[name] <= 1e-4:       # NaN fails too
            raise AssertionError(f"linear_scan {name}: max error "
                                 f"{errs[name]}")

    for name, a in cases.items():
        compare(name, a)
    sweep = {}
    for chunk in scan_ops.SWEEP_CHUNKS:
        kernel = functools.partial(scan_ops._cuda, chunk=chunk)
        for name in ("prefill_u", "mixed_decays_t53", "t1024"):
            compare(f"{name}_chunk{chunk}", cases[name], kernel)
        sweep[chunk] = device_ms(lambda: scan_call(kernel,
                                                   cases["prefill_u"]))
    rows = scan_timed_rows(dev)
    return dict(name="linear_scan", cases=len(errs),
                max_abs_err=max(errs.values()), errors=errs,
                **rows["decode"], prefill=rows["prefill"],
                prefill_t1024=rows["prefill_t1024"],
                chunk_sweep_ms=sweep)


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
    profile = device_profile(lambda i: prof_pipe.step(batches[24 + i]), 4,
                             kernel=MERGE_KERNEL_SYMBOL)

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


def device_profile(step, n: int, kernel=None) -> dict:
    """``step(i)`` for i < n under torch.profiler: host wall time per tick,
    the share of it the device spent in kernels and copies, device
    operations per tick, host synchronizations per tick and the host time
    blocked in them, the kernels that took the most device time, and
    with ``kernel`` the device time per tick of the kernels whose name
    contains it.  Device numbers are None when the profiler recorded no
    device activity."""
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
        top_device_ms_per_tick=[(name[:60], us / n / 1e3) for name, us in top],
        kernel_ms_per_tick=None if kernel is None else sum(
            us for name, us in by_name.items() if kernel in name) / n / 1e3)


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
    profile = device_profile(lambda i: step(first + i), 4,
                             kernel=MERGE_KERNEL_SYMBOL)
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


# ---------------------------------------------------------------------------
# phases 6-7: the elastic serving tier at full width (qwen3-14b, rwkv6-7b)
# ---------------------------------------------------------------------------

SERVE_KERNEL = {"dense": "flash_attention", "rwkv": "linear_scan"}
# a substring of the CUDA kernels' symbols, for the profile
SERVE_KERNEL_SYMBOL = {"dense": "flash_", "rwkv": "linear_scan_"}


def _engine_tokens(eng, prompts, max_new, at=None, mode="vsn",
                   arrive=None):
    """Serve ``prompts`` on ``eng`` from an idle pool (every slot free);
    request i takes ``max_new`` (or ``max_new[i]``) tokens and is
    submitted before round ``arrive[i]`` (default all before the first);
    with ``at``, switch 1 -> 4 replicas in ``mode`` after that many
    rounds.  -> ({uid: tokens}, kv bytes moved)."""
    from repro_torch.serving import Request
    eng.pool.reconfigure_vsn(1)
    n = len(prompts)
    news = [max_new] * n if isinstance(max_new, int) else max_new
    arrive = [0] * n if arrive is None else arrive
    done, moved, start = [], 0, eng.steps
    while len(done) < n:
        for i, p in enumerate(prompts):
            if arrive[i] == eng.steps - start:
                eng.submit(Request(uid=i, prompt=p, max_new=news[i]))
        done += eng.tick()
        if at is not None and eng.steps - start == at:
            moved, _ = eng.reconfigure(4, mode=mode)
    return {r.uid: list(r.out) for r in done}, moved


def serve_full_width(dev, arch, *, n_slots=8, max_seq=1024, prompt_len=128,
                     max_new=32, lanes=4, ticks=24, check_layers=4,
                     reduced=False):
    """``arch`` at its published width and depth in bfloat16, parameters
    drawn on the card from seed 0, through the serving entry points
    (``build_runtime`` over a ``RequestSource`` -> ``AsyncStreamRuntime``
    -> ``ServingPipeline`` -> ``ServingEngine``, ``SloServingController``).
    Traffic: 2 sources, ``lanes`` request lanes per 50 ms tick, ``ticks``
    arrival ticks at 40 requests/s with 160 in the middle third, prompts
    of ``prompt_len`` tokens, ``max_new`` tokens each, 8 slots of
    ``max_seq`` over 4 instances with 1 active at start.  Checks: every
    request served; first tokens equal the port's ``reference_decode``
    (batch 1 on both sides), and the share of equal tokens over the
    first ``n_slots`` requests' whole outputs; the model's
    kernel launched once per layer per forward; a mid-decode VSN switch
    moves 0 bytes and SN more, both token-invisible; and a float32 copy
    cut to ``check_layers`` layers (full width), serving prompts of mixed
    lengths and budgets that arrive over several rounds, is
    token-identical to ``reference_decode``.  The defaults are the card's
    run; ``reduced=True`` with smaller arguments rehearses the phase on
    the CPU (``dev="cpu"``)."""
    from repro_torch import obs as _obs
    from repro_torch.api import RuntimeConfig, build_runtime
    from repro_torch.configs import canon, get_config
    from repro_torch.io.sources import RateSchedule
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.serving import (RequestSource, ServingConfig,
                                     ServingEngine, reference_decode)

    from repro_torch.configs import reduced as reduce_cfg
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    mcfg = get_config(canon(arch))
    if reduced:
        mcfg = reduce_cfg(mcfg)
    kernel = SERVE_KERNEL[mcfg.kind]
    prev_obs = _obs.get()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = RuntimeConfig(
        serving=ServingConfig(arch=arch, reduced=reduced, n_slots=n_slots,
                              max_seq=max_seq, n_instances=4, seed=0),
        n_sources=2, n_active=1, controller="slo", slo_target_p99_ms=50.0,
        device=str(dev),
        obs={"enabled": True, "trace": True,
             "slo_rules": [{"name": "decode_p99",
                            "metric": "span.serve.decode",
                            "threshold": 0.05, "quantile": 0.99}]})
    # the middle third spiked, as in this phase's earlier runs (the
    # launcher's traffic, the reference's, spikes the first third)
    third = ticks // 3
    source = RequestSource(
        schedule=RateSchedule(((third, 40.0), (third, 160.0),
                               (ticks - 2 * third, 40.0))), ticks=ticks,
        lanes=lanes, prompt_len=prompt_len, max_new=max_new,
        vocab=mcfg.vocab, seed=1, n_inputs=2, k_virt=n_slots, tick_ms=50,
        drain_ticks=ticks * lanes * max_new // n_slots + 16)
    rt = build_runtime(cfg, source)
    sync()
    init_s = time.perf_counter() - t0
    pipe, eng = rt.pipeline, rt.pipeline.engine

    # the main path: the kernel counts cover exactly this run
    dispatch.reset_launches()
    try:
        rep = rt.run()
    finally:
        _obs.set_current(prev_obs)
    launches = {k: v.launches for k, v in dispatch.registered().items()}
    prefills, rounds = eng.prefills, eng.decode_rounds
    forwards = prefills + rounds
    assert len(pipe.finished) == source.total_requests > 0, \
        (len(pipe.finished), source.total_requests)
    if cuda:
        assert launches[kernel] == mcfg.n_layers * forwards > 0, \
            (launches, mcfg.n_layers, forwards)
    assert all(n == 0 for k, n in launches.items() if k != kernel), launches
    tokens = sum(len(r.out) for r in pipe.finished)
    assert tokens == source.total_requests * max_new
    for ev in pipe.reconfig_events:
        assert ev["kv_bytes_moved"] == 0, ev

    # tokens against the straight-line batch-1 reference on the card: the
    # first token of every request (a batch-1 prefill on both sides, so
    # equal), and every token of the first n_slots requests (the engine's
    # batched decode rounds differently from batch 1 in bfloat16: a share)
    t1 = time.perf_counter()
    first_same = sum(
        reference_decode(mcfg, eng.params, r.prompt, 1, max_seq)[0]
        == r.out[0] for r in pipe.finished)
    assert first_same == len(pipe.finished), (first_same, len(pipe.finished))
    same = 0
    for r in pipe.finished[:n_slots]:
        ref = reference_decode(mcfg, eng.params, r.prompt, max_new, max_seq)
        assert ref[0] == r.out[0] and len(ref) == len(r.out) == max_new
        same += sum(a == b for a, b in zip(ref, r.out))
    ref_s = time.perf_counter() - t1

    # a manual reconfiguration mid-decode: token-invisible, 0 bytes (VSN),
    # more than 0 bytes (SN)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, mcfg.vocab, prompt_len) for _ in range(n_slots)]
    base, _ = _engine_tokens(eng, prompts, 16)
    vsn, vsn_moved = _engine_tokens(eng, prompts, 16, at=4, mode="vsn")
    sn, sn_moved = _engine_tokens(eng, prompts, 16, at=4, mode="sn")
    assert vsn == base and vsn_moved == 0, vsn_moved
    assert sn == base and sn_moved > 0, sn_moved

    # where a decode round's time goes: 8 lanes, 4 rounds under the profiler
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=1000 + i, prompt=p, max_new=8))
    eng.tick()                                     # admit all + one round
    sync()
    profile = device_profile(lambda i: eng.tick(), 4,
                             kernel=SERVE_KERNEL_SYMBOL[mcfg.kind])
    while eng.running:
        eng.tick()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    lat = rep.stage_latency_ms
    out = dict(
        phase=f"serve_{canon(arch)}", arch=arch, layers=mcfg.n_layers,
        d_model=mcfg.d_model, params_billion=mcfg.param_count() / 1e9,
        dtype=mcfg.dtype, slots=n_slots, max_seq=max_seq,
        prompt_len=prompt_len, max_new=max_new, init_s=init_s,
        requests=len(pipe.finished), tokens=tokens,
        prefills=prefills, decode_rounds=rounds,
        kernel_calls=mcfg.n_layers * forwards,
        first_tokens_equal_reference=first_same,
        token_share_equal_reference=same / (n_slots * max_new),
        reference_s=ref_s,
        runtime=dict(ticks=rep.ticks, wall_s=rep.wall_s,
                     tokens_per_s=tokens / rep.wall_s,
                     p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
                     queue_high_water=rep.queue_high_water,
                     switches=rep.switches,
                     reconfigs=[(ev["n_active"], ev["kv_bytes_moved"])
                                for ev in pipe.reconfig_events],
                     slo_breaches=len(rep.slo_breaches)),
        decode_round_ms=lat.get("serve.decode"),
        prefill_ms=lat.get("serve.prefill"),
        manual_reconfig=dict(vsn_bytes=vsn_moved, sn_bytes=sn_moved,
                             tokens_unchanged=True),
        profile=profile, peak_gb=peak_gb, launches=launches)
    del rt, pipe, eng
    if cuda:
        torch.cuda.empty_cache()

    # float32, full width, cut to check_layers layers: token identity with
    # lanes at mixed depths: 12 prompts of 9 lengths and 4 budgets over
    # the 8 slots, half arriving 3 rounds late, so decode rounds batch
    # lanes at different positions and freed slots are reused mid-run
    cfg32 = dataclasses.replace(mcfg, dtype="float32", n_layers=check_layers)
    params = transformer.init_params(cfg32, seed=3, device=dev)
    eng = ServingEngine(cfg32, params, n_slots=n_slots, max_seq=max_seq,
                        n_instances=4, device=dev)
    n32 = n_slots + n_slots // 2
    lens = [max(prompt_len - 9 * (i % 9), 2) for i in range(n32)]
    news = [max(max_new - 5 * (i % 4), 1) for i in range(n32)]
    prompts32 = [rng.integers(1, mcfg.vocab, n) for n in lens]
    got, _ = _engine_tokens(eng, prompts32, news,
                            arrive=[3 * (i % 2) for i in range(n32)])
    f32_same = sum(got[i] == reference_decode(cfg32, params, p, news[i],
                                              max_seq)
                   for i, p in enumerate(prompts32))
    assert f32_same == n32, (f32_same, n32)
    out["float32_copy"] = dict(layers=check_layers, requests=n32,
                               prompt_lens=sorted(set(lens)),
                               tokens_per_request=sorted(set(news)),
                               requests_token_identical=f32_same)
    del eng, params
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if argv[:1] == ["--scan-turns"]:
        print(card_line(), flush=True)
        scan_turns(argv[1])
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, dispatch
    import repro_torch.kernels.scalegate_merge.ops      # noqa: F401
    import repro_torch.kernels.segment_aggregate.ops    # noqa: F401
    import repro_torch.kernels.window_join.ops          # noqa: F401
    import repro_torch.kernels.flash_attention.ops      # noqa: F401
    import repro_torch.kernels.linear_scan.ops          # noqa: F401

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log = (lib.parent / "build.log").read_text()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=str(lib.relative_to(ROOT)),
              ptxas=ptxas_summary(log)))
    print(card_line(), flush=True)

    rows = [check_scalegate_merge(dev), check_scalegate_merge_stacked(dev),
            check_segment_aggregate(dev), check_window_join(dev),
            check_flash_attention(dev), check_linear_scan(dev)]
    emit(dict(phase="kernels", kernels=rows))

    # The main path: each pipeline phase zeroes the counts right before its
    # card run and reads them right after it.
    phases = []
    for run in (q1_wordcount, q3_scalejoin, q1_ingest_tier,
                functools.partial(serve_full_width, arch="qwen3-14b"),
                functools.partial(serve_full_width, arch="rwkv6-7b")):
        phases.append(run(dev))
        emit(phases[-1])
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
        **{k: r[k] for k in ("single_ms", "device_ms", "library_device_ms",
                             "multi_tile", "tier_valid", "cluster_sweep_ms",
                             "max_active_clusters", "prefill",
                             "prefill_t1024", "chunk_sweep_ms",
                             "decode_split_ms", "push_cases",
                             "max_abs_err_bf16", "kernels_per_call",
                             "hot_cell_hits", "even", "q3",
                             "no_hits_device_ms") if k in r})
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
