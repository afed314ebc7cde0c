#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits nonzero:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/
                 kernels/csrc`` (one ``nvcc`` per source, in parallel) and
                 print the card's name and power limit.
2. ``kernels`` — hold each of the eight kernels against its plain PyTorch
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
                 window_join_emit (the fast join's phase 1) at Q3's shape
                 for all key rows, one instance's and none, and with
                 ``out_cap`` 8 against more hits;
                 flash_attention at 65,544 (lane, KV head) pairs and
                 at the shapes phases 20-22 serve (``served_attention``:
                 gemma3-12b's local and global decode at depth 1300 and
                 its 1280-token windowed prefill, stablelm-12b's D 160,
                 qwen3-moe-30b-a3b's n_rep 8), each beside SDPA; the
                 two model kernels at their decode and prefill shapes,
                 hymba-1.5b's among them (linear_scan also at T 1024,
                 strong and zero decays, the chunk's edges, and a sweep
                 over the chunk length); the backward kernels
                 flash_attention_bwd (hymba-1.5b's, qwen3-14b's,
                 deepseek-moe-16b's and gemma3's training shapes, D 16,
                 32 and 160, rows that see no key, the wgmma body's
                 64-row tile edges, n_rep 8, a window across tiles,
                 batch 2, the model's strided views through the
                 autograd Function; with and without the forward's
                 log-sum-exp) and linear_scan_bwd (hymba-1.5b's SSM also
                 at T 129 and 1000, rwkv6-7b's at T 128 and 1024, strong
                 and zero decays, every key size, Dv 128, a ragged last
                 chunk), each also against autograd of the plain forward
                 and twice bit for bit.
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
5. ``q1_persistent`` — Q1 as in phase 3 through the persistent K-tick
                 driver (``VSNPipeline.run_persistent``, 5 super-batches
                 of 8, one CUDA graph captured at the first and replayed
                 by the rest), the reconfiguration at tick 16
                 (``reconfig_at`` 0) and at tick 19 (``reconfig_at`` 3):
                 each run equal tick for tick to the eager card run and
                 to the CPU's plain loop, one graph with no host copy,
                 the replays run under ``set_sync_debug_mode("error")``
                 but for one control-lane read a super-batch; eager
                 against persistent under torch.profiler.
6. ``q3_persistent`` — the Q3 fast join path in 3 super-batches of 4,
                 the reconfiguration at tick 6: equal to the eager card
                 run and, as unordered pairs with equal comparisons, to
                 the CPU; then the general O+ tick (``api.make_pipeline``
                 at ``live``'s shape, 65 lanes x 16 instances) captured
                 in one graph and replayed, equal tick for tick to its
                 eager card run and to the CPU, eager against the graph.
7. ``q1_ingest_tier`` — the Q1 stream over 8 sources through the ingest
                 tier (4 thread leaves, the fused root merge, one host
                 joining and one leaving) into ``AsyncStreamRuntime`` over
                 ``VSNPipeline`` with a threshold controller: every round
                 totally ordered, the tier's tuples equal to one flat
                 gate's, the outputs equal to a CPU ``run_sync`` replaying
                 the card run's reconfigurations, 0 sigma bytes moved, and
                 one stacked-merge launch per root round; then a second
                 pass with ``super_batch`` 8 (one graph a round shape),
                 equal to a CPU ``run_sync`` replaying its own trace.
8. ``q1_recovery`` — the same Q1 stream over the tier (join at tick 9,
                 leave at 32) through ``build_runtime`` with the fast
                 count tick, ``super_batch`` 8 and a checkpoint every 8
                 ticks: an uninterrupted oracle; a victim stopped after
                 28 ticks with a torn newer save planted; then
                 ``resume_runtime``'s steps (``latest_step``,
                 ``like_tree``, ``Checkpointer.restore``,
                 ``tier_restore_dict``, ``build_runtime(restore=...)``) on
                 a fresh fast pipeline over the replay suffix, the leave
                 re-issued.  The restored step is 25 (source tick 24),
                 the torn step invisible, and the victim's committed plus
                 the replayed outputs equal the oracle's exactly; bytes,
                 capture, write and restore ms, detect→first output.
9. ``q1_mesh`` — Q1 as in phase 3 on a 4-shard ``MeshPipeline`` (sigma in
                 fixed key blocks, the fast count path; the four shards
                 time-share the card): tick for tick the single-device
                 ``VSNPipeline`` on the card and the mesh on the CPU, one
                 switch moving the tables' bytes, no copy between devices,
                 each block's storage unchanged; ms a tick and a profile
                 beside ``VSNPipeline``'s.
10. ``q1_mesh_persistent`` — the same through ``run_persistent`` (5
                 super-batches of 8, the reconfiguration mid-scan at tick
                 19): equal to the eager mesh run, one graph a device and
                 shape, replays free of host syncs, no host copy.
11. ``general_mesh`` — the general O+ tick at ``live``'s shape on 4
                 shards, eager (== ``VSNPipeline`` and the CPU mesh) and
                 in graphs (== eager).
12. ``q3_mesh`` — ScaleJoin through ``vsn.shard_tick`` + ``join_local_tick``
                 at 1 and 4 shards: equal pairs, equal total comparisons,
                 every shard a share.
13. ``q1_mesh_recovery`` — ``kill_restore_drill`` at ``q1_recovery``'s
                 configuration on a 4-shard mesh with a torn save (exact
                 parity), the restored step restored once more onto 2
                 shards (its replay == the oracle's).
14. ``launchers`` — ``repro_torch.launch.elastic_drill`` (straggler,
                 live, ingest, serving, crash, recovery, recovery-kill)
                 and ``live`` at 24 ticks of 256 with its oracle,
                 checkpoints and a recording followed by ``live
                 --resume``, each a process of its own on the card, and
                 the same ``live`` run on the CPU with an equal output
                 count; ``live --mesh 4`` with its oracle and the mesh
                 drill (``--drills mesh --mesh 4``).  Phase 23's two
                 training processes run beside these.
15-18. ``serve_qwen3_14b``, ``serve_rwkv6_7b``, ``serve_deepseek_moe_16b``
                 (the MoE's one-shard ``vsn`` dispatch, each decode lane
                 routed alone; its dropped tokens counted, none in
                 decode), ``serve_hymba_1_5b`` (attention and SSM heads
                 side by side: flash_attention at D 64, n_rep 5, and
                 linear_scan at Dk 16) — each model at its published
                 width and depth in bfloat16 (random parameters drawn on the
                 card), one after the other, through ``build_runtime`` ->
                 ``AsyncStreamRuntime`` -> ``ServingPipeline`` ->
                 ``ServingEngine`` with the SLO controller, the engine
                 replaying one CUDA graph per decode bucket and prompt
                 length: every request served, first tokens equal to
                 ``reference_decode``, each model kernel launched once per
                 layer per forward and per graph, the eager engine
                 (``graphs=False``) handed the same requests at the same
                 rounds giving the same tokens (decode and prefill
                 latency and a profiled round, graph against eager), a
                 mid-decode VSN switch moving 0 bytes and an SN switch
                 moving more, both token-invisible, and a float32 copy
                 cut to 4 layers token-identical to ``reference_decode``
                 (see ``serve_full_width``); 12 arrival ticks, 64 rounds
                 replayed eagerly (``SERVE_ARGS``).
19. ``moe_mesh`` — right after ``serve_deepseek_moe_16b``, over the
                 weights it drew: deepseek-moe-16b at full width and
                 depth in bf16, 8 prompts of 128 tokens and 16 decode
                 steps through ``prefill_with_cache`` and ``decode_step``
                 with no mesh, then under ``use_rules(make_host_mesh(1,
                 4))`` (the ``vsn`` MoE over 4 expert shards of 16
                 experts, time-sharing the card) fed the same tokens:
                 in the counted mesh run every MoE layer's ``dropped``
                 equal to the one-shard dispatch's on the same input and
                 its output within 4 bfloat16 roundings,
                 ``flash_attention`` launched once a layer a forward, no
                 byte between devices, first tokens equal but at near
                 ties, the logits' median relative gap within a stated
                 limit; a float32 4-layer copy card against CPU, each
                 MoE layer and the logits within bfloat16 limits; decode-step
                 ms p50, device operations a step, peak GB; then the
                 dry-run cell ``deepseek_moe_16b decode_32k`` on the
                 single-pod placeholder mesh (see ``moe_mesh``).
20-22. ``serve_gemma3_12b``, ``serve_stablelm_12b``,
                 ``serve_qwen3_moe_30b_a3b`` — phases 15-18's path and
                 checks (``serve_full_width``) on the remaining token
                 models at published width and depth (``SERVE_ARGS``):
                 gemma3-12b (48 layers, five local of window 1024 to each
                 global, D 256) with prompts of 1280 tokens in slots of
                 2048, so every decode step and the prefill rows past
                 1024 mask keys by the window, its float32 copy cut to 6
                 layers so that the global sixth is in it, and the
                 highest decode position reported; stablelm-12b (D 160);
                 qwen3-moe-30b-a3b (128 experts top-8, 61 GB of bfloat16
                 weights on the card; ``peak_gb`` and each part's memory
                 reported, no decode token dropped).  Like phases 15-18,
                 each takes 12 arrival ticks and replays 64 rounds
                 eagerly; 8 new tokens a request (``SERVE_ARGS``).
23. ``train_hymba_1_5b`` — ``repro_torch.launch.train`` on hymba-1.5b at
                 full width and depth in bf16 (batch 8 of 128 tokens, 8
                 microbatches), 10 steps then a resume to 20, each a
                 process of its own (run beside phase 14): finite printed losses, the last
                 below the first, each kernel's launches a step (the
                 model kernels twice a block with the recompute, the
                 backward kernels once), a bit-exact save and restore,
                 the restored step's forward loss as printed, a float32
                 4-layer copy's step on the card against the CPU, the
                 bf16 gradients through the kernels against the plain
                 versions at 4, 8, 16 and 32 layers with two controls that
                 must fail; timed and profiled steps (see
                 ``train_hymba_1_5b``).

Phases 3 to 23 are the main path: each zeroes the launch counts right
before its card run and reads them right after (``launchers`` and
``train_hymba_1_5b`` read each of their processes' counts), and the
``{"kernels": [...]}`` line reports their sum with phase 2's times.
Each phase's line holds its ``seconds``.  A graph replay counts the
launches its capture tallied (``dispatch.add_launches``).  The last line
is ``{"ok": true, "device": {...}}``.  A kernel's ``ms`` is the median over
20 CUDA-event pairs of the mean of 20 back-to-back launches after
warm-up, ``single_ms`` the median of 20 single launches (which also spans
a wrapper's host time), ``device_ms`` the profiler's device time of one
call, and the same for the plain version and the library call.

    python3 chip_smoke.py --scan-turns <parent checkout>

times, in another checkout and in this one, in turns (parent, this, this,
parent) on one card: linear_scan's rows (decode, prefill T 128 and T
1024), segment_aggregate as ``aggregate._scatter_reduce`` issues it at
Q1's Zipf shape, window_join as ``join.band_join_counts`` issues it at
the Q3 and bench shapes, Q1's eager tick and the general O+ tick's, the
two backward kernels at hymba-1.5b's (and linear_scan_bwd at rwkv6-7b's)
training shapes, and one forward and backward through each model
kernel's autograd Function as the train step pays it (``turn_rows``);
names after the checkout pick some of these rows.

    python3 chip_smoke.py --drill-times

times each drill of ``elastic_drill`` alone on the card (``drill_times``):
why the ``launchers`` phase runs the drills it runs.

    python3 chip_smoke.py --moe-mesh

runs the ``moe_mesh`` phase alone (its weights drawn from seed 0), the
shards round-robin over the visible cards: one a card on four.

    python3 chip_smoke.py --serve ARCH

runs one serve phase alone at the default run's arguments for ``ARCH``
(``SERVE_ALONE``): any served model, or gemma3-4b (gemma3-12b's path at
smaller widths, which the default run leaves out), the kernels built
first.

    python3 chip_smoke.py --join-emit

runs the fast join's phase-1 kernel check (``check_window_join_emit``)
and the ``q3_persistent`` phase alone, the kernels built first.
"""

import dataclasses
import functools
import json
import math
import os
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
    # now and then a profiling session records no device activity at all
    # (three in a row once, NVIDIA H100 80GB HBM3); such a session is taken
    # again after a pause, up to six times
    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
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


# window_join_emit's shape: Q3's tick against its full window (B 32, K
# 4,096, R 160, P 7, n_attrs 2, out_cap 1,024, WS 300 s)
EMIT_SHAPE = dict(b=32, k=4096, r=160, p=7, ws=300_000, out_cap=1024)


def emit_inputs(dev, resp: str, seed: int = 30):
    """One instance's phase-1 call at ``EMIT_SHAPE``: a full window of
    uniform [1, 10000] rows (ScaleJoin's), every slot live and fresh, and
    ``resp`` all rows ("all"), balanced_fmu's instance 1 of 4
    ("round_robin", the main path's call at 4 instances) or none ("none",
    an inactive instance)."""
    s = EMIT_SHAPE
    g = np.random.default_rng(seed)
    b, k, r, p = s["b"], s["k"], s["r"], s["p"]
    now = 10 * s["ws"]
    rows = {"all": np.ones(k, bool), "round_robin": np.arange(k) % 4 == 1,
            "none": np.zeros(k, bool)}[resp]
    return [torch.as_tensor(a, device=dev) for a in (
        np.sort(g.integers(now, now + 16, b)).astype(np.int32),
        g.integers(0, 2, b).astype(np.int32),
        g.integers(1, 10_001, (b, p)).astype(np.float32),
        np.ones(b, bool),
        g.integers(now - s["ws"], now, (k, r)).astype(np.int32),
        g.integers(0, 2, (k, r)).astype(np.int32),
        g.integers(1, 10_001, (k, r, p)).astype(np.float32), rows)]


def check_window_join_emit(dev):
    """``window_join_emit`` (the fast join tick's phase 1) against its
    plain version on the card, rows, count and comparisons exactly, at
    Q3's shape for all rows, an instance's round-robin rows and none, and
    with ``out_cap`` 8 against more hits.  Timed at each (the headline row
    is the round-robin call, the main path's); the bound counts what the
    work needs: the resp rows' tau, stream and the two compared columns
    read once, the incoming block, the rows written; an add and 3
    compares a pair, a subtract, abs and compare a column of each
    opposite pair."""
    from repro_torch.kernels.window_join.ops import window_join_emit_op
    from repro_torch.kernels.window_join.ref import window_join_emit_ref
    kw = dict(ws=EMIT_SHAPE["ws"], band=10.0, n_attrs=2,
              out_cap=EMIT_SHAPE["out_cap"])
    n_cases = 0

    def compare(args, **kw_):
        nonlocal n_cases
        got = window_join_emit_op(*args, **kw_)
        want = window_join_emit_ref(*args, **kw_)
        if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
                and int(got[2]) == int(want[2])):
            raise AssertionError(f"window_join_emit differs: {kw_}")
        n_cases += 1
        return want

    def timed(resp):
        args = emit_inputs(dev, resp)
        _, n1, comps = compare(args, **kw)
        row = timings(lambda: window_join_emit_op(*args, **kw),
                      lambda: window_join_emit_ref(*args, **kw))
        b, (k, r) = args[0].shape[0], args[4].shape
        rows = int(args[7].sum())
        ms, by = bound(b * 17 + k + rows * r * 16 + kw["out_cap"] * 8 + 12,
                       int_ops=4 * b * rows * r, fp_ops=3 * 2 * int(comps))
        return dict(shape=f"B={b}, K={k}, R={r}, P=7, n_attrs=2, "
                          f"resp rows={rows}, hits={int(n1)}, "
                          f"comps={int(comps)}",
                    **row, bound_ms=ms, bound_by=by,
                    kernels_per_call=kernels_per_call(
                        lambda: window_join_emit_op(*args, **kw)))

    rows = {resp: timed(resp) for resp in ("round_robin", "all", "none")}
    args = emit_inputs(dev, "all")
    args[6][..., :2] = args[6][..., :2] % 40   # dense hits, past out_cap
    args[2][:, :2] = args[2][:, :2] % 40
    want = compare(args, **dict(kw, out_cap=8))
    assert int(want[1]) > 8
    return dict(name="window_join_emit", cases=n_cases, max_abs_err=0.0,
                **rows["round_robin"], all_rows=rows["all"],
                no_rows=rows["none"])


def check_flash_attention(dev):
    """The kernel against its plain version, both bfloat16 bodies and the
    float32 one: the qwen3-14b prefill and decode shapes (40 query heads
    over 8 KV heads, D 128), deepseek-moe-16b's 16 over 16 (n_rep 1) at
    decode over a pool and a prefill into it, stablelm-12b's D 160 (n_rep
    4), gemma3's
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
        # deepseek-moe-16b: 16 query heads over 16 KV heads (n_rep 1), D
        # 128; a decode round over a permuted pool at mixed depths, and a
        # 128-token prefill into a slot of it (the SIMT body in float32)
        ds_pool = [cache(8, 1024, 16, 128, dt) for _ in range(2)]
        compare(f"deepseek_decode_{tag}", decode_q(8, 16, 128, dt), *ds_pool,
                q_offset=ints([144, 0, 31, 32, 1023, 500, 159, 7]),
                kv_index=ints([3, 0, 7, 6, 1, 5, 2, 4]))
        compare(f"deepseek_prefill_{tag}",
                rnd(1, 128, 16, 128, dtype=dt).transpose(1, 2), *ds_pool,
                q_offset=ints([0]), kv_index=ints([6]))
        # hymba-1.5b: 25 query heads over 5 KV heads of 64 (n_rep 5); a
        # decode round over its 9-row pool (8 slots and the pad lanes'
        # scratch row, which the pad lanes read) and a prefill into a slot
        hy_pool = [cache(9, 1024, 5, 64, dt) for _ in range(2)]
        compare(f"hymba_decode_{tag}", decode_q(8, 25, 64, dt), *hy_pool,
                n_rep=5, q_offset=ints([144, 0, 31, 32, 1023, 0, 159, 7]),
                kv_index=ints([3, 0, 7, 6, 1, 8, 2, 4]))
        compare(f"hymba_prefill_{tag}",
                rnd(1, 128, 25, 64, dtype=dt).transpose(1, 2), *hy_pool,
                n_rep=5, q_offset=ints([0]), kv_index=ints([5]))
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

    def timed(b, sq, at, hq=40, hkv=8, d=128, seq=1024, window=None,
              check=None):
        """bf16 kernel, plain version, SDPA and bound for ``b`` lanes of
        ``sq`` queries (qwen3-14b's 40 heads over 8 by default, D 128) at
        depth ``at`` of a ``seq``-slot cache, q_offset per lane as the
        model passes it, under ``window`` (a local layer) or none; SDPA
        gets the keys up to the last query with the KV heads repeated
        (outside the timing), is_causal for a prefill of a global layer
        and a boolean mask of the window for a local one.  The bound
        counts the keys the window leaves visible.  ``check`` names a
        case that also holds the kernel against its plain version on
        these inputs."""
        rep = hq // hkv
        q = rnd(b, sq, hq, d, dtype=bf16).transpose(1, 2)
        kc, vc = (cache(b, seq, hkv, d, bf16) for _ in range(2))
        off = ints(np.full(b, at))
        kw = dict(n_rep=rep, q_offset=off, window=window)
        run = lambda f: f(q, kc, vc, **kw)
        if check:
            compare(check, q, kc, vc, **kw)
        n_vis = at + sq
        ke, ve = (x[:, :, :n_vis].repeat_interleave(rep, dim=1).contiguous()
                  for x in (kc, vc))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q_pos = at + np.arange(sq)
        w = window or (1 << 30)
        pairs = int(np.minimum(q_pos + 1, w).sum())      # a (lane, head)
        keys = n_vis - max(at - w + 1, 0)                # read at least once
        ms, by = bound(2 * (2 * b * hq * sq * d)            # q in, out
                       + 2 * (2 * b * hkv * keys * d)       # visible K, V
                       + 4 * b, bf16_ops=4 * b * hq * pairs * d)
        if window is None:
            library = lambda: sdpa(q, ke, ve, is_causal=at == 0)
        else:
            k_pos = torch.arange(n_vis, device=dev)
            qp = torch.as_tensor(q_pos, device=dev)[:, None]
            mask = (k_pos <= qp) & (qp - k_pos < window)
            library = lambda: sdpa(q, ke, ve, attn_mask=mask)
        return dict(
            shape=f"q [{b}, {hq}, {sq}, {d}] bf16 at depth {at} of a "
                  f"[{b}, {seq}, {hkv}, {d}] cache, n_rep {rep}"
                  + ("" if window is None else f", window {window}"),
            **timings(lambda: run(flash_attention_op),
                      lambda: run(flash_attention_plain), library),
            bound_ms=ms, bound_by=by, visible_keys=keys)

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
    served = served_attention(timed)
    return dict(name="flash_attention", cases=len(errs),
                max_abs_err=max(v for k, v in errs.items() if "f32" in k),
                max_abs_err_bf16=max(v for k, v in errs.items()
                                     if "bf16" in k),
                errors=errs, limit_used=max(used.values()),
                limit_used_by_case=used,
                **timed(8, 1, 144), prefill=timed(1, 128, 0),
                deepseek=dict(decode=timed(8, 1, 144, 16, 16),
                              prefill=timed(1, 128, 0, 16, 16)),
                hymba=dict(decode=timed(8, 1, 144, 25, 5, 64),
                           prefill=timed(1, 128, 0, 25, 5, 64)),
                served=served,
                decode_split_ms=sweep)


def served_attention(timed):
    """The serve phases' attention shapes past the first four models (see
    ``SERVE_ARGS``), each held against the plain version and timed by
    ``check_flash_attention``'s ``timed``: gemma3-12b's decode round (8
    lanes, 16 query heads over 8 of 256, a 2048-slot pool at depth 1300)
    in a local layer (window 1024) and a global one, and its batch-1
    prefill of 1280 tokens in a local layer; stablelm-12b's decode round
    (32 over 8 of 160); qwen3-moe-30b-a3b's (32 over 4 of 128, n_rep
    8)."""
    gemma = dict(hq=16, hkv=8, d=256, seq=2048)
    return dict(
        gemma3_12b=dict(
            decode_local=timed(8, 1, 1300, window=1024, **gemma,
                               check="served_gemma3_decode_local_bf16"),
            decode_global=timed(8, 1, 1300, **gemma,
                                check="served_gemma3_decode_global_bf16"),
            prefill_local=timed(1, 1280, 0, window=1024, **gemma,
                                check="served_gemma3_prefill_local_bf16")),
        stablelm_12b=dict(decode=timed(8, 1, 144, 32, 8, 160,
                                       check="served_stablelm_decode_bf16")),
        qwen3_moe_30b_a3b=dict(decode=timed(
            8, 1, 144, 32, 4, 128, check="served_qwen3_moe_decode_bf16")))


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
                   + (a["u"].numel() if a["u"] is not None else 0))
    # per step and (i, j): w s, k v, + (the update) and r s, + (the
    # output); the bonus diag(u) k^T v has rank 1, so per step it is
    # a = sum_i r_i u_i k_i (3 per i) and y_j += a v_j (2 per j)
    fp_ops = 5 * bh * t * dk * dv
    if a["u"] is not None:
        fp_ops += bh * t * (3 * dk + 2 * dv)
    ms, by = bound(n_bytes, fp_ops=fp_ops)
    return dict(shape=f"BH {bh}, T {t}, Dk {dk}, Dv {dv}, "
                      f"u {a['u'] is not None}, s0 {a['s0'] is not None}",
                **timings(lambda: scan_call(linear_scan_op, a),
                          lambda: scan_call(linear_scan_ref, a),
                          plain_reps=20 if t <= 128 else 3),
                bound_ms=ms, bound_by=by)


# linear_scan's timed shapes: the serve phase's decode tick (8 lanes x 64
# heads of rwkv6-7b, from a carried state), its prefill (128 tokens) and a
# prefill as deep as the serve configs' slots (1024)
SCAN_TIMED = {"decode": (512, 1, True), "prefill": (64, 128, False),
              "prefill_t1024": (64, 1024, False)}


def ssm_scan_inputs(dev, gen, bh, t):
    """hymba-1.5b's SSM call (``models/ssm.py``): r = C, k = B (Dk 16),
    v = x (Dv 64), one decay a head and step broadcast over Dk, from a
    carried state, no u."""
    w = 0.5 + 0.49 * torch.rand((bh, t, 1), generator=gen, device=dev)
    return scan_inputs(dev, gen, bh, t, 16, 64, s0=True,
                       w=w.expand(bh, t, 16).contiguous())


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


def q1_tick_row(dev) -> dict:
    """Q1's eager tick as ``q1_wordcount`` profiles it (ticks 24-27 of the
    same stream, 16 instances after the switch at tick 16) through the
    tree's ``VSNPipeline.step`` and ``aggregate.tick_fast``:
    ``device_profile``'s wall, device busy share, device operations and
    host syncs a tick."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    op = agg.count_aggregate(WindowSpec(wa=1000, ws=2000, wt="multi"), 4096,
                             out_cap=4096, extra_slots=2)
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=28, tick=2048, words_per_tweet=6,
        vocab=50000, k_virt=4096, rate_per_tick=200, device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=16, fmu=balanced_fmu(4096, 16, 16),
                         active=active_mask(16, 16))
    pipe = VSNPipeline(op, n_max=16, n_active=4, stash_cap=2048,
                       tick_fn=lambda o, s, r, m, explicit_w=None:
                       agg.tick_fast(o, "count", s, r, m),
                       merge_fn=merge_fast_state,
                       init_sigma=functools.partial(agg.fast_init, op),
                       device=dev)
    for i in range(24):
        pipe.step(batches[i], reconfig=rc if i == 16 else None)
    torch.cuda.synchronize()
    return device_profile(lambda i: pipe.step(batches[24 + i]), 4,
                          kernel=MERGE_KERNEL_SYMBOL)


def general_tick_row(dev) -> dict:
    """The general O+ tick's eager step at ``live``'s cut shape (65 lanes x
    16 instances, ``general_pipeline``), after two warm-up ticks:
    ``device_profile``'s wall, device operations and host syncs a tick
    over two ticks."""
    batches = general_batches(4, 32)
    pipe = general_pipeline(dev)
    for b in batches[:2]:
        pipe.step(b)
    torch.cuda.synchronize()
    return device_profile(lambda i: pipe.step(batches[2 + i]), 2,
                          kernel=MERGE_KERNEL_SYMBOL)


def backward_rows(dev) -> dict:
    """The two backward kernels as the train step calls them, on the same
    data in every tree (seed 24): ``flash_attention_bwd_op`` at hymba-1.5b's
    bf16 training shape (q [1, 25, 128, 64], n_rep 5, causal; without the
    forward's log-sum-exp, which only the newer tree takes),
    ``linear_scan_bwd_op`` at hymba's SSM (BH 25, T 128, Dk 16, Dv 64, s0)
    and rwkv6-7b's (BH 64, T 128, 64 x 64, u, s0, dS_T), and one forward
    and backward through ``ops.flash_attention`` (the model's transposed
    [B, S, H, D] views) and ``ops.linear_scan`` under
    ``torch.autograd.grad``, wrapper copies included."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.linear_scan import ops as ls
    gen = torch.Generator(device=dev).manual_seed(24)
    bf16 = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    qs, ks, vs, dos = (rnd(1, 128, h, 64).to(bf16) for h in (25, 5, 5, 25))
    q, k, v, do = (x.transpose(1, 2) for x in (qs, ks, vs, dos))
    kw = dict(causal=True, window=None, n_rep=5)
    # the kernel alone on contiguous tensors (the older tree takes no other)
    qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
    o = fa.flash_attention_op(qc, kc, vc, **kw)
    leaves = [x.detach().clone().requires_grad_() for x in (qs, ks, vs)]

    def attn_fwd_bwd():
        out = fa.flash_attention(*(x.transpose(1, 2) for x in leaves), **kw)
        return torch.autograd.grad(out, leaves, do)

    hymba = ssm_scan_inputs(dev, gen, 25, 128)
    hymba.update(do=rnd(25, 128, 64), ds_t=None)
    rwkv = scan_bwd_inputs(dev, gen, 64, 128, 64, 64, u_rows=64, s0=True)
    scan_in = [hymba[x].clone().requires_grad_()
               for x in ("r", "k", "v", "w", "s0")]

    def scan_fwd_bwd():
        out, _ = ls.linear_scan(*scan_in[:4], None, scan_in[4])
        return torch.autograd.grad(out, scan_in, hymba["do"])

    return dict(
        flash_attention_bwd=call_row(
            lambda: fa.flash_attention_bwd_op(qc, kc, vc, o, doc, **kw),
            "_bwd"),
        linear_scan_bwd=dict(
            hymba=call_row(lambda: scan_bwd_call(ls.linear_scan_bwd_op,
                                                 hymba), "linear_scan_bwd"),
            rwkv6=call_row(lambda: scan_bwd_call(ls.linear_scan_bwd_op,
                                                 rwkv), "linear_scan_bwd")),
        attention_fwd_bwd=call_row(attn_fwd_bwd, "flash"),
        scan_fwd_bwd=call_row(scan_fwd_bwd, "linear_scan"))


def turn_rows(dev, names=None) -> dict:
    """The rows ``--scan-turns`` times in each tree, on the same data in
    every run: linear_scan's three, segment_aggregate through
    ``aggregate._scatter_reduce`` at Q1's Zipf shape, window_join
    through ``join.band_join_counts`` at ``JOIN_TIMED``'s shapes, Q1's
    eager tick (``q1_tick_row``), the general O+ tick's
    (``general_tick_row``) and the backward kernels' (``backward_rows``);
    the same API in both trees, so each is timed where the main path pays
    it.  ``names`` (None: all) picks some of them."""
    from repro_torch.core import join

    def window_join():
        out = {}
        for name, shape in JOIN_TIMED.items():
            st, b, ws = fill_join_state(*shape, dev)
            out[name] = call_row(
                lambda: join.band_join_counts(st, b, ws, band=10.0,
                                              n_attrs=2), "window_join")
        return out

    makers = dict(linear_scan=lambda: scan_timed_rows(dev),
                  segment_aggregate=lambda: call_row(
                      q1_zipf_call(dev), "segment_aggregate"),
                  q1_tick=lambda: q1_tick_row(dev),
                  general_tick=lambda: general_tick_row(dev),
                  window_join=window_join,
                  backward=lambda: backward_rows(dev))
    return {name: make() for name, make in makers.items()
            if names is None or name in names}


def scan_turns(parent: str, names=()) -> None:
    """``turn_rows`` of the checkout at ``parent`` and of this one, in
    turns (parent, this, this, parent), each turn a process of its own
    that builds and imports its checkout's ``repro_torch``; one JSON line
    a turn.  ``names`` (none: all) picks rows of ``turn_rows``.

        python3 chip_smoke.py --scan-turns <root of the parent checkout> \
            [backward linear_scan ...]
    """
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import torch, chip_smoke; "
            "from repro_torch.kernels import build; build.library(); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "print(json.dumps(chip_smoke.turn_rows("
            "torch.device('cuda', 0), sys.argv[3:] or None)))")
    trees = {"parent": pathlib.Path(parent).resolve(), "change": ROOT}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run(
            [sys.executable, "-c", code, str(trees[name] / "src"), str(ROOT),
             *names], capture_output=True, text=True, check=True)
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
             "t1024": inputs(64, 1024, 64, 64, u_rows=64, s0=True),
             # hymba-1.5b's SSM: 8 lanes x 25 heads, Dk 16, Dv 64
             "hymba_decode": ssm_scan_inputs(dev, gen, 200, 1),
             "hymba_prefill": ssm_scan_inputs(dev, gen, 25, 128),
             "hymba_prefill_t130": ssm_scan_inputs(dev, gen, 25, 130)}
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
                hymba=dict(decode=scan_timed(cases["hymba_decode"]),
                           prefill=scan_timed(cases["hymba_prefill"])),
                chunk_sweep_ms=sweep)


def bwd_close(name, got, want, errs, used, f32_rtol, bf16=False):
    """Each gradient of ``got`` against ``want``: float32 within
    ``f32_rtol`` of the gradient's largest magnitude (at least 1);
    bfloat16 elementwise within |want| / 64 + 2^-7 of its largest.
    Records the largest error and share of the limit; raises past it."""
    worst_err, worst_used = 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} gradient {i}: {tuple(g.shape)} "
                                 f"{g.dtype} != {tuple(w.shape)} {w.dtype}")
        diff = (g.float() - w.float()).abs()
        top = float(w.float().abs().max()) if w.numel() else 0.0
        if bf16:
            limit = w.float().abs() / 64 + 2 ** -7 * top + 1e-30
        else:
            limit = torch.full_like(diff, f32_rtol * max(top, 1.0))
        if diff.numel():
            worst_err = max(worst_err, float(diff.max()))
            worst_used = max(worst_used, float((diff / limit).max()))
    errs[name], used[name] = worst_err, worst_used
    if not worst_used <= 1.0:               # NaN fails too
        raise AssertionError(f"{name}: max error {worst_err}, "
                             f"{worst_used:.3g} of the limit")


def bitwise_repeat(name, call):
    """Two calls of a backward kernel give the same bits."""
    first, second = call(), call()
    for a, b in zip(first, second):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"{name}: two calls differ")


# attention backward's cases: (B, Hq, Hkv, Sq, Skv, D, causal, window);
# bfloat16 at D 64 and 128 takes the wgmma body (64-row tiles), the rest
# the SIMT body
ATTN_BWD_CASES = {
    "hymba": (1, 25, 5, 128, 128, 64, True, None),
    "qwen3_14b": (1, 40, 8, 128, 128, 128, True, None),
    "deepseek": (1, 16, 16, 128, 128, 128, True, None),
    "gemma3_window": (1, 8, 4, 1100, 1100, 256, True, 1024),
    "d16_ragged": (2, 4, 2, 37, 37, 16, True, 5),
    "d32_no_key_rows": (1, 2, 1, 40, 24, 32, True, None),
    "d160_non_causal": (1, 4, 1, 20, 33, 160, False, None),
    "d64_s63": (1, 10, 2, 63, 63, 64, True, None),
    "d64_s65": (1, 10, 2, 65, 65, 64, True, None),
    "d64_s129": (1, 10, 2, 129, 129, 64, True, None),
    "d128_n_rep8": (1, 32, 4, 128, 128, 128, True, None),
    "d64_window64": (1, 10, 2, 200, 200, 64, True, 64),
    "d128_window64_no_key_rows": (1, 10, 2, 150, 100, 128, True, 64),
    "d64_non_causal": (1, 10, 2, 70, 130, 64, False, None),
    "hymba_batch2": (2, 25, 5, 128, 128, 64, True, None),
}
# cases whose q, k, v and dO are the model's transposed [B, S, H, D] views,
# run through the autograd Function (the forward's log-sum-exp, no copy)
ATTN_BWD_STRIDED = ("hymba", "d64_s65", "d128_n_rep8")


def check_flash_attention_bwd(dev):
    """``flash_attention_bwd`` against its plain version on the card, at
    hymba-1.5b's training shape (q [1, 25, 128, 64], n_rep 5, causal),
    qwen3-14b's (D 128, n_rep 5), deepseek-moe-16b's (D 128, n_rep 1),
    gemma3's (D 256, n_rep 2, window 1024 over 1,100 tokens), and D 16,
    32 and 160 with a window, rows that see no key and no causal mask;
    the wgmma body's 64-row tile edges (63, 65 and 129 tokens at D 64,
    n_rep 5), n_rep 8 at D 128, windows of 64 across tiles (at D 128 with
    rows that see no key), non-causal, batch 2; each in float32 and
    bfloat16.  Limits: float32 within 1e-4 of each gradient's largest
    magnitude (its sums over keys and heads run in another order than the
    plain version's); bfloat16 elementwise within |want| / 64 + 2^-7 of
    the largest (both round the outputs to bfloat16; the kernel rounds
    P and dS to bfloat16 as wgmma operands, the plain version p before
    dividing by l).  The bfloat16 cases run with the forward's
    log-sum-exp (``return_lse``) and without it (the backward takes its
    own); each float32 case also against autograd of the plain forward,
    and every case twice, bit for bit.  ``ATTN_BWD_STRIDED`` cases also
    through ``ops.flash_attention``'s autograd Function on the model's
    transposed views.  Timed at hymba's bfloat16 shape against SDPA's
    backward with the KV heads repeated."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd_op, flash_attention_op)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    errs, used, timed = {}, {}, {}
    for name, (b, hq, hkv, sq, skv, d, causal, window) in \
            ATTN_BWD_CASES.items():
        rep = hq // hkv
        kw = dict(causal=causal, window=window, n_rep=rep)
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
        base = [rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d),
                rnd(b, hq, sq, d)]
        for dt in (f32, bf16):
            tag = f"{name}_{'f32' if dt is f32 else 'bf16'}"
            q, k, v, do = (x.to(dt) for x in base)
            o, lse = flash_attention_op(q, k, v, return_lse=True, **kw)
            want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
            call = lambda: flash_attention_bwd_op(q, k, v, o, do, **kw)
            got = call()
            bwd_close(tag, got, want, errs, used, 1e-4, bf16=dt is bf16)
            bitwise_repeat(tag, call)
            if lse is not None:
                call = lambda: flash_attention_bwd_op(q, k, v, o, do,
                                                      lse=lse, **kw)
                bwd_close(f"{tag}_lse", call(), want, errs, used, 1e-4,
                          bf16=True)
                bitwise_repeat(f"{tag}_lse", call)
            if dt is f32:
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                grads = torch.autograd.grad(
                    (flash_attention_ref(*leaves, **kw) * do).sum(), leaves)
                bwd_close(f"{tag}_autograd", got, grads, errs, used, 1e-4)
            if name in ATTN_BWD_STRIDED:
                views = [x.transpose(1, 2).contiguous().requires_grad_()
                         for x in (q, k, v)]
                out = flash_attention(*(x.transpose(1, 2) for x in views),
                                      **kw)
                dov = do.transpose(1, 2).contiguous().transpose(1, 2)
                grads = torch.autograd.grad(out, views, dov)
                bwd_close(f"{tag}_strided",
                          [g.transpose(1, 2) for g in grads], want, errs,
                          used, 1e-4, bf16=dt is bf16)
            if name == "hymba" and dt is bf16:
                timed = attn_bwd_timed(q, k, v, o, do, kw, lse)
            del q, k, v, do, o, got
    return dict(name="flash_attention_bwd", cases=len(errs),
                max_abs_err=max(v for k, v in errs.items() if "f32" in k),
                max_abs_err_bf16=max(v for k, v in errs.items()
                                     if "bf16" in k),
                errors=errs, limit_used=max(used.values()),
                limit_used_by_case=used, bitwise_repeat=True, **timed)


def attn_bwd_timed(q, k, v, o, do, kw, lse):
    """The backward's row at one shape: kernel (with the forward's
    log-sum-exp ``lse``, as the train step calls it), plain version,
    SDPA's backward (KV heads repeated, leaves of their own, so the timed
    graph is SDPA's backward alone) and the card's bound; beside them the
    two ways to each row's statistics: ``no_lse`` (the backward takes
    them itself, a first launch) and ``forward`` (the forward's device
    time without and with writing ``lse``)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_op, flash_attention_op)
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = kw["n_rep"]
    qs, ke, ve = (x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)))
    out = torch.nn.functional.scaled_dot_product_attention(
        qs, ke, ve, is_causal=kw["causal"])
    library = lambda: torch.autograd.grad(out, (qs, ke, ve), do,
                                          retain_graph=True)
    # visible (query, key) pairs; per pair s = q.k (2D), dP = dO.v (2D),
    # dV += p dO (2D), dQ += dS k (2D), dK += dS q (2D)
    off = skv - sq
    pairs = b * hq * sum(min(skv, max(0, off + i + 1)) for i in range(sq))
    el = q.element_size()
    ms, by = bound(el * (3 * b * hq * sq * d + 2 * b * hkv * skv * d)
                   + el * (b * hq * sq * d + 2 * b * hkv * skv * d),
                   bf16_ops=10 * d * pairs)
    no_lse = lambda: flash_attention_bwd_op(q, k, v, o, do, **kw)
    return dict(shape=f"q [{b}, {hq}, {sq}, {d}] {str(q.dtype)[6:]}, "
                      f"n_rep {rep}, causal",
                **timings(lambda: flash_attention_bwd_op(q, k, v, o, do,
                                                         lse=lse, **kw),
                          lambda: flash_attention_bwd_ref(q, k, v, o, do,
                                                          **kw),
                          library),
                bound_ms=ms, bound_by=by,
                no_lse=dict(ms=median_ms(no_lse), device_ms=device_ms(no_lse),
                            kernels_per_call=kernels_per_call(no_lse)),
                forward=dict(
                    device_ms=device_ms(
                        lambda: flash_attention_op(q, k, v, **kw),
                        kernel="flash"),
                    with_lse_device_ms=device_ms(
                        lambda: flash_attention_op(q, k, v, return_lse=True,
                                                   **kw),
                        kernel="flash")))


def scan_bwd_inputs(dev, gen, bh, t, dk, dv, u_rows=None, s0=False, w=None,
                    ds_t=True):
    """linear_scan's inputs (``scan_inputs``) with ``do`` and, unless
    ``ds_t`` is False, a ``dS_T``."""
    a = scan_inputs(dev, gen, bh, t, dk, dv, u_rows=u_rows, s0=s0, w=w)
    a["do"] = torch.randn((bh, t, dv), generator=gen, device=dev)
    a["ds_t"] = (torch.randn((bh, dk, dv), generator=gen, device=dev)
                 if ds_t else None)
    return a


def scan_bwd_call(f, a):
    return f(a["r"], a["k"], a["v"], a["w"], a["u"], a["s0"], a["do"],
             a["ds_t"])


def check_linear_scan_bwd(dev):
    """``linear_scan_bwd`` against its plain version on the card, within
    1e-4 of each gradient's largest magnitude (the forward's tolerance;
    sums over columns, tiles and steps run in another order): hymba-1.5b's
    training call (BH 25, T 128, Dk 16, Dv 64, no u, s0 zeros, dS_T
    unused), rwkv6-7b's (BH 64, T 128, Dk 64, u [64, 64], s0, dS_T) and at
    T 1024, RWKV6's strong decays exp(-exp(x)) up to x = 8 and decays
    mixed from {0, 1e-30, 1e-6, 0.5, 1} (nothing NaN), every key size
    (8 to 128), u one row a bh and one a head over two lanes, ragged Dv
    and T, T 1; hymba's SSM at T 129 and 1000, Dv 128 (at Dk 16 and 64),
    Dv 30 (rows the kernel copies 4 bytes at a time) and a last chunk cut
    short at Dk 64 (T 127 against chunks of ``ops.bwd_chunk(64, 64)`` =
    18 steps).  hymba's and rwkv6's also against autograd of the plain
    forward, and every case twice, bit for bit.  Timed at hymba's
    shape."""
    from repro_torch.kernels.linear_scan.ops import linear_scan_bwd_op
    from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                     linear_scan_ref)
    gen = torch.Generator(device=dev).manual_seed(24)
    inputs = functools.partial(scan_bwd_inputs, dev, gen)
    rwkv = lambda *s: torch.exp(-torch.exp(
        -6 + 14 * torch.rand(s, generator=gen, device=dev)))
    mixed = lambda *s: torch.tensor([0, 1e-30, 1e-6, 0.5, 1], device=dev)[
        torch.randint(0, 5, s, generator=gen, device=dev)]
    def ssm(t):
        a = ssm_scan_inputs(dev, gen, 25, t)
        a.update(s0=torch.zeros_like(a["s0"]), ds_t=None,
                 do=torch.randn((25, t, 64), generator=gen, device=dev))
        return a

    hymba = ssm(128)
    cases = {
        "hymba": hymba,
        "rwkv6": inputs(64, 128, 64, 64, u_rows=64, s0=True),
        "rwkv6_t1024": inputs(64, 1024, 64, 64, u_rows=64, s0=True),
        "rwkv6_strong_decays": inputs(64, 128, 64, 64, u_rows=64, s0=True,
                                      w=rwkv(64, 128, 64)),
        "zero_decays": inputs(16, 53, 64, 64, u_rows=16, s0=True,
                              w=mixed(16, 53, 64)),
        "dk8_u_per_bh": inputs(6, 70, 8, 8, u_rows=6, s0=True),
        "dk32_two_lanes": inputs(8, 33, 32, 32, u_rows=4, s0=True),
        "dk128_dv40": inputs(4, 130, 128, 40, u_rows=2, s0=True),
        "t1_no_ds_t": inputs(512, 1, 64, 64, u_rows=64, s0=True,
                             ds_t=False),
        "hymba_t129": ssm(129),
        "hymba_t1000": ssm(1000),
        "dk16_dv128": inputs(8, 70, 16, 128, u_rows=4, s0=True),
        "dk64_dv128": inputs(8, 33, 64, 128, u_rows=8, s0=True),
        "dk64_t127_ragged_chunk": inputs(16, 127, 64, 64, u_rows=16,
                                         s0=True),
        # Dv not a multiple of 4: the kernel's 4-byte copies
        "dk16_dv30": inputs(4, 45, 16, 30, u_rows=2, s0=True),
    }
    errs, used = {}, {}
    for name, a in cases.items():
        call = lambda: scan_bwd_call(linear_scan_bwd_op, a)
        got = call()
        bwd_close(name, got, scan_bwd_call(linear_scan_bwd_ref, a), errs,
                  used, 1e-4)
        bitwise_repeat(name, call)
        if name in ("hymba", "rwkv6"):
            ins = [None if a[x] is None else a[x].clone().requires_grad_()
                   for x in ("r", "k", "v", "w", "u", "s0")]
            o, s_t = linear_scan_ref(*ins)
            obj = (o * a["do"]).sum() + (0 if a["ds_t"] is None
                                         else (s_t * a["ds_t"]).sum())
            want = torch.autograd.grad(obj, [x for x in ins if x is not None])
            bwd_close(f"{name}_autograd",
                      [g for g, x in zip(got, ins) if x is not None], want,
                      errs, used, 1e-4)
    return dict(name="linear_scan_bwd", cases=len(errs),
                max_abs_err=max(errs.values()), errors=errs,
                limit_used=max(used.values()), limit_used_by_case=used,
                bitwise_repeat=True, **scan_bwd_timed(hymba),
                rwkv6=scan_bwd_timed(cases["rwkv6"]))


def scan_bwd_timed(a):
    """linear_scan_bwd's row at the inputs ``a``: kernel, plain version
    and the card's bound.  Bytes: r, k, w, v, do in, and s0, dS_T, u when
    given; dr, dk, dw, dv, ds0 out, and du.  Operations per step and
    state element: the state before the step rebuilt (3: w s + k v), the
    gradient's G update (3), dr, dk, dv and dw (2 each); the bonus's rank-1
    terms per step add 3 Dk + 2 Dv for its dot products and 6 Dk + 2 Dv
    for the u terms of dr, dk, dv and du."""
    from repro_torch.kernels.linear_scan.ops import linear_scan_bwd_op
    from repro_torch.kernels.linear_scan.ref import linear_scan_bwd_ref
    bh, t, dk = a["r"].shape
    dv = a["v"].shape[-1]
    opt = lambda x, n: 0 if a[x] is None else n
    n_bytes = 4 * (6 * bh * t * dk + 3 * bh * t * dv
                   + opt("s0", bh * dk * dv) + opt("ds_t", bh * dk * dv)
                   + bh * dk * dv
                   + (0 if a["u"] is None else 2 * a["u"].numel()))
    fp_ops = 14 * bh * t * dk * dv + opt("u", bh * t * (9 * dk + 4 * dv))
    ms, by = bound(n_bytes, fp_ops=fp_ops)
    return dict(shape=f"BH {bh}, T {t}, Dk {dk}, Dv {dv}, "
                      f"u {a['u'] is not None}, s0 {a['s0'] is not None}, "
                      f"dS_T {a['ds_t'] is not None}",
                **timings(lambda: scan_bwd_call(linear_scan_bwd_op, a),
                          lambda: scan_bwd_call(linear_scan_bwd_ref, a),
                          plain_reps=3),
                bound_ms=ms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 3: Q1 wordcount through VSNPipeline (and SN on a prefix)
# ---------------------------------------------------------------------------

def q1_setup(k_virt, n_ticks, tick):
    """Q1: the count operator (WA 1 s, WS 2 s), the stream (seed 7,
    Zipf(1.3) over 50,000 words) and the 4 -> 16 reconfiguration."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    op = agg.count_aggregate(WindowSpec(wa=1000, ws=2000, wt="multi"), k_virt,
                             out_cap=4096, extra_slots=2)
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=n_ticks, tick=tick,
        words_per_tweet=6, vocab=50000, k_virt=k_virt, rate_per_tick=200,
        device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=16,
                         fmu=balanced_fmu(k_virt, 16, 16),
                         active=active_mask(16, 16))
    return op, batches, rc


def q1_wordcount(dev):
    from repro_torch.core import aggregate as agg
    from repro_torch.core.runtime import SNPipeline, VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.kernels import dispatch

    K, N_MAX, TICK, N_TICKS, RC_AT = 4096, 16, 2048, 40, 16
    op, batches, rc = q1_setup(K, N_TICKS, TICK)

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


# a substring of each of the port's kernel symbols (csrc/*.cu)
PORT_KERNEL_SYMBOLS = ("scalegate_", "segment_aggregate", "window_join",
                       "flash_", "linear_scan_")


def device_profile(step, n: int, kernel=None, cpu_ops=True) -> dict:
    """``step(i)`` for i < n under torch.profiler: host wall time per tick,
    the share of it the device spent in kernels and copies, device
    operations per tick, host synchronizations per tick and the host time
    blocked in them, the kernels that took the most device time, with
    ``kernel`` the device time per tick of the kernels whose name
    contains it, and that of each of the port's kernels the ticks ran.
    Device numbers are None when the profiler recorded no device
    activity.  ``cpu_ops=False`` records the CUDA activity alone (kernels,
    copies and the CUDA runtime's calls, its synchronizations among them):
    for a train step of ~118,000 kernels the CPU operators' events took
    ~60 s to parse (NVIDIA H100 80GB HBM3 host)."""
    from torch.profiler import ProfilerActivity, profile
    cpu = cpu_ops or not torch.cuda.is_available()    # a CPU rehearsal
    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
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
            us for name, us in by_name.items() if kernel in name) / n / 1e3,
        port_kernel_ms_per_tick={sym: sum(
            us for name, us in by_name.items() if sym in name) / n / 1e3
            for sym in PORT_KERNEL_SYMBOLS
            if any(sym in name for name in by_name)})


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
# phases 5-6: the persistent K-tick driver (one CUDA graph a shape)
# ---------------------------------------------------------------------------

def tick_rows(out):
    """[(sorted outputs, switched, instance loads)] per tick of a
    ``PersistentOut``."""
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.tree import tree_map
    rows = []
    for i in range(out.switched.shape[0]):
        o = [tree_map(lambda a: a[i], x) for x in (out.outs_pre,
                                                   out.outs_post)]
        rows.append((sorted(flatten_outputs(o[0]) + flatten_outputs(o[1])),
                     bool(out.switched[i]),
                     None if out.inst_load is None
                     else out.inst_load[i].tolist()))
    return rows


def persistent_run(pipe, batches, k, rc, rc_tick, sync_free=False):
    """``batches`` through ``pipe.run_persistent`` in super-batches of
    ``k``, the reconfiguration at tick ``rc_tick``.  With ``sync_free``
    every call after the first (a replay) runs under
    ``set_sync_debug_mode("error")``; its one host read, the control lane,
    follows.  -> (per-tick rows, seconds per super-batch, overflow)."""
    from repro_torch.core.runtime import fold_frontier
    n_in = pipe.op.n_inputs
    frontier = np.zeros((n_in,), np.int64)
    rows, seconds, overflow = [], [], 0
    for j in range(0, len(batches), k):
        group = batches[j:j + k]
        at = rc_tick - j if j <= rc_tick < j + k else None
        checked = sync_free and j > 0
        t0 = time.perf_counter()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipe.run_persistent(
                group, reconfig=None if at is None else rc,
                reconfig_at=at or 0, frontier0=frontier)
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode(0)
        bool(out.switched.any())                # the control-lane read
        seconds.append(time.perf_counter() - t0)
        for b in group:
            fold_frontier(frontier, b, n_in)
        rows += tick_rows(out)
        overflow += int(out.outs_pre.overflow.sum()
                        + out.outs_post.overflow.sum())
    return rows, seconds, overflow


def graph_summary(pipe) -> dict:
    """``persistent_graphs()`` by shape, kernel names cut to the port's
    (the rest counted together)."""
    out = {}
    for key, g in pipe.persistent_graphs().items():
        nodes = g["nodes"] or {}
        ours = {}
        for name, n in (nodes.get("by_kernel") or {}).items():
            short = (kernel_name(name) if any(sym in name for sym in
                                              PORT_KERNEL_SYMBOLS)
                     else "torch and other")
            ours[short] = ours.get(short, 0) + n
        out["x".join(map(str, key))] = dict(
            launches_per_replay=g["launches"], capture_s=g["capture_s"],
            instantiate_s=g["instantiate_s"], replays=g["replays"],
            nodes=nodes.get("nodes"), by_type=nodes.get("by_type"),
            host_copies=nodes.get("host_copies"), kernels=ours)
    return out


def q1_persistent(dev, n_ticks=40, tick=2048, k_virt=4096, k=8,
                  rc_ticks=(16, 19)):
    """Q1 (as ``q1_wordcount``) through ``VSNPipeline.run_persistent`` in
    super-batches of ``k``: run (a) reconfigures at tick 16
    (``reconfig_at`` 0 of the third super-batch), run (b) at tick 19
    (``reconfig_at`` 3).  Each equals, tick for tick, the eager card run
    and the CPU's persistent loop with the same reconfiguration tick.
    The defaults are the card's run; smaller arguments rehearse it on the
    CPU, where there is no graph to check."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.kernels import dispatch

    N_MAX = 16
    dev = torch.device(dev)
    card = dev.type == "cuda"
    op, batches, rc = q1_setup(k_virt, n_ticks, tick)

    def pipeline(device):
        """The pipeline and its device-side ring-overrun total: the tick
        function adds each tick's count into it in place (a graph replays
        that add), so collisions are read from the device once."""
        total = torch.zeros((), dtype=torch.int32, device=device)

        def count_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = agg.tick_fast(op_, "count", st, ready, resp,
                                     explicit_w=explicit_w)
            total.add_(st.collisions)
            return st, outs

        pipe = VSNPipeline(op, n_max=N_MAX, n_active=4, stash_cap=tick,
                           tick_fn=count_tick, merge_fn=merge_fast_state,
                           init_sigma=functools.partial(agg.fast_init, op),
                           device=device)
        return pipe, total

    def eager(rc_tick):
        pipe, _ = pipeline(dev)
        rows, seconds = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            o1, o2, sw, load = pipe.step_staged(
                b, reconfig=rc if i == rc_tick else None)
            rows.append((sorted(flatten_outputs(o1) + flatten_outputs(o2)),
                         bool(sw), load.tolist()))
            seconds.append(time.perf_counter() - t0)
        return rows, seconds

    eager_rows = {t: eager(t) for t in rc_ticks}
    t0 = time.perf_counter()
    cpu_rows = {t: persistent_run(pipeline("cpu")[0], batches, k, rc, t)[0]
                for t in rc_ticks}
    cpu_seconds = time.perf_counter() - t0

    dispatch.reset_launches()
    runs = {}
    for t in rc_ticks:
        pipe, total = pipeline(dev)
        rows, seconds, overflow = persistent_run(pipe, batches, k, rc, t,
                                                 sync_free=card)
        runs[t] = (pipe, total, rows, seconds, overflow)
    launches = {n: v.launches for n, v in dispatch.registered().items()}

    for t, (pipe, total, rows, _, overflow) in runs.items():
        for i, (got, want, cpu) in enumerate(zip(rows, eager_rows[t][0],
                                                 cpu_rows[t])):
            if got != want:
                raise AssertionError(f"q1_persistent (reconfig at {t}) tick "
                                     f"{i}: differs from the eager run")
            if got != cpu:
                raise AssertionError(f"q1_persistent (reconfig at {t}) tick "
                                     f"{i}: differs from the CPU run")
        assert [i for i, r in enumerate(rows) if r[1]] == \
            [i for i, r in enumerate(eager_rows[t][0]) if r[1]]
        assert sum(r[1] for r in rows) == 1, t
        assert overflow == 0 and int(pipe.sg.overflow) == 0
        assert int(total) == 0 and int(pipe.sigma.collisions) == 0
        assert pipe.bytes_transferred == 0
        if card:
            graphs = pipe.persistent_graphs()
            assert len(graphs) == 1, list(graphs)
            (g,) = graphs.values()
            assert g["replays"] == n_ticks // k - 1, g["replays"]
            if g["nodes"] is not None:
                assert g["nodes"]["host_copies"] == 0, g["nodes"]
    if not card:
        return dict(phase="q1_persistent", equal_to_eager=True,
                    equal_to_cpu=True)
    assert launches["scalegate_merge"] > 0 and \
        launches["segment_aggregate"] > 0, launches

    # Eager against persistent on fresh pipelines: two super-batches of
    # ticks 24-39 (16 instances), under torch.profiler.
    first = 24
    prof_eager, _ = pipeline(dev)
    for i in range(first):
        prof_eager.step(batches[i], reconfig=rc if i == rc_ticks[0] else None)
    torch.cuda.synchronize()
    eager_prof = device_profile(lambda i: prof_eager.step(batches[first + i]),
                                2 * k, kernel=MERGE_KERNEL_SYMBOL)
    prof_pers, _ = pipeline(dev)
    persistent_run(prof_pers, batches[:first], k, rc, rc_ticks[0])
    torch.cuda.synchronize()

    def replay(i):
        out = prof_pers.run_persistent(batches[first + i * k:
                                               first + (i + 1) * k])
        bool(out.switched.any())
    pers_prof = device_profile(replay, 2, kernel=MERGE_KERNEL_SYMBOL)
    per_tick = {key: (v / k if isinstance(v, float) and key != "ticks"
                      and "share" not in key else v)
                for key, v in pers_prof.items()}
    per_tick["ticks"] = 2 * k
    per_tick["top_device_ms_per_tick"] = [
        (n, ms / k) for n, ms in pers_prof["top_device_ms_per_tick"]]
    per_tick["port_kernel_ms_per_tick"] = {
        sym: ms / k for sym, ms in pers_prof["port_kernel_ms_per_tick"].items()}

    pipe_a, _, rows_a, sec_a, _ = runs[rc_ticks[0]]
    steady_p = [x for j, x in enumerate(sec_a) if j not in (0, 2)]
    steady_e = [x for i, x in enumerate(eager_rows[rc_ticks[0]][1])
                if i not in (0, rc_ticks[0])]
    return dict(
        phase="q1_persistent", ticks=n_ticks, super_batch=k,
        reconfig_ticks=list(rc_ticks), equal_to_eager=True,
        equal_to_cpu=True, outputs=sum(len(r[0]) for r in rows_a),
        cpu_run_seconds=cpu_seconds,
        persistent=dict(steady_tick_ms=statistics.median(steady_p) / k * 1e3,
                        tuples_per_s=tick * k * len(steady_p) / sum(steady_p),
                        first_super_batch_s=sec_a[0],
                        reconfig_super_batch_ms=sec_a[2] * 1e3,
                        profile=per_tick, graphs=graph_summary(pipe_a)),
        eager=dict(steady_tick_ms=statistics.median(steady_e) * 1e3,
                   tuples_per_s=tick * len(steady_e) / sum(steady_e),
                   profile=eager_prof),
        sync_free_replays=True, launches=launches)


def q3_persistent(dev, k=4):
    """Q3's fast join path (as ``q3_scalejoin``, without the counting
    path) through ``run_persistent`` in super-batches of ``k``, the
    reconfiguration at tick 6 (``reconfig_at`` 2 of the second): equal to
    the eager card run tick for tick, and to the CPU's persistent loop as
    unordered pairs, with equal total comparisons.  Ends with the general
    O+ tick captured and replayed as well (``general_persistent``)."""
    from repro_torch.core import join
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    from repro_torch.kernels import dispatch

    K, RING, TICK, N_TICKS, RC_AT, P = 512, 16, 256, 12, 6, 4
    dev = torch.device(dev)
    ws = WindowSpec(wa=1, ws=300_000, wt="single")
    fj = join.band_predicate(10.0, 2)
    dense0 = join.DENSE_PHASE1_CALLS
    op = join.scalejoin_def(ws, K, fj, payload_width=P, ring=RING,
                            out_cap=1024)
    batches = list(datagen.scalejoin(np.random.default_rng(3),
                                     n_ticks=N_TICKS, tick=TICK, k_virt=1,
                                     rate_t_per_s=2000.0, device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=4, fmu=balanced_fmu(K, 4, 4),
                         active=active_mask(4, 4))

    def pipeline(device):
        comps = torch.zeros((), dtype=torch.float32, device=device)

        def join_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = join.tick_fast(ws, fj, st, ready, resp, out_cap=1024)
            comps.add_(st.comparisons)
            return st, outs

        pipe = VSNPipeline(op, n_max=4, n_active=2, stash_cap=128,
                           tick_fn=join_tick, merge_fn=merge_fast_state,
                           init_sigma=lambda d: join.fast_join_init(K, RING,
                                                                    P, d),
                           device=device)
        return pipe, comps

    def pairs(rows):
        """Per tick: outputs as sorted unordered pairs, the switch flag."""
        out = []
        for outs, sw, _ in rows:
            half = len(outs[0][1]) // 2 if outs else 0
            out.append((sorted((tau, tuple(sorted([pay[:half], pay[half:]])))
                               for tau, pay in outs), sw))
        return out

    from repro_torch.io.sinks import flatten_outputs
    eager, e_comps = pipeline(dev)
    eager_rows = []
    for i, b in enumerate(batches):
        o1, o2, sw, load = eager.step_staged(
            b, reconfig=rc if i == RC_AT else None)
        eager_rows.append((sorted(flatten_outputs(o1) + flatten_outputs(o2)),
                           bool(sw), load.tolist()))
    cpu, c_comps = pipeline("cpu")
    cpu_rows = persistent_run(cpu, batches, k, rc, RC_AT)[0]

    dispatch.reset_launches()
    pipe, p_comps = pipeline(dev)
    rows, _, overflow = persistent_run(pipe, batches, k, rc, RC_AT,
                                       sync_free=dev.type == "cuda")
    launches = {n: v.launches for n, v in dispatch.registered().items()}
    for i, (got, want) in enumerate(zip(rows, eager_rows)):
        if got != want:
            raise AssertionError(f"q3_persistent tick {i}: differs from the "
                                 "eager run")
    if pairs(rows) != pairs(cpu_rows):
        raise AssertionError("q3_persistent: pairs differ from the CPU run")
    total = float(p_comps)
    assert total == float(e_comps) == float(c_comps), \
        (total, float(e_comps), float(c_comps))
    assert sum(r[1] for r in rows) == 1 and overflow == 0
    out = dict(phase="q3_persistent", ticks=N_TICKS, super_batch=k,
               reconfig_tick=RC_AT, equal_to_eager=True,
               equal_to_cpu_as_unordered_pairs=True, comparisons=total,
               output_pairs=sum(len(r[0]) for r in rows), launches=launches)
    # a BandPredicate's phase 1 never takes the dense masks
    assert join.DENSE_PHASE1_CALLS == dense0, join.DENSE_PHASE1_CALLS
    if dev.type != "cuda":
        return out
    assert launches["scalegate_merge"] > 0, launches
    # one call an instance and epoch phase a tick, graph replays included
    assert launches["window_join_emit"] == 2 * 4 * N_TICKS, launches
    graphs = pipe.persistent_graphs()
    assert len(graphs) == 1 and \
        next(iter(graphs.values()))["replays"] == N_TICKS // k - 1, graphs
    out["graphs"] = graph_summary(pipe)

    out["general_tick"] = general_persistent(dev)
    return out


def general_batches(n_ticks, tick, seed=11):
    """``launch/live.py``'s stream at ``tick`` tuples a tick: tweets over
    256 keys, each tick shifted so the stream stays sorted."""
    from repro_torch.data import datagen
    rng = np.random.default_rng(seed)
    out, base = [], 0
    for _ in range(n_ticks):
        (b,) = datagen.tweets(rng, n_ticks=1, tick=tick, words_per_tweet=3,
                              vocab=2000, k_virt=256, rate_per_tick=150,
                              device="cpu")
        b = dataclasses.replace(b, tau=b.tau + base)
        base = int(b.tau.max()) + 1
        out.append(b)
    return out


def general_pipeline(device, tick=32):
    """``api.make_pipeline`` at ``live``'s configuration (count, WA 500,
    WS 1000, K 256, 16 instances, a stash of ``tick``): the general O+
    tick over ``2 * tick + 1`` lanes (65 at ``live``'s cut size)."""
    from repro_torch import api
    return api.make_pipeline(api.RuntimeConfig(
        op="count", wa=500, ws=1000, wt="multi", k_virt=256, out_cap=1024,
        extra_slots=2, n_max=16, n_active=2, stash_cap=tick,
        device=str(device)))


def general_persistent(dev, k=4, n_ticks=12, rc_at=6):
    """The general O+ tick (``general_pipeline``) through
    ``run_persistent`` in super-batches of ``k``, 2 -> 16 instances at
    tick ``rc_at``: one graph captured and replayed (the replays under
    ``set_sync_debug_mode("error")``), equal tick for tick to the eager
    card run and to the CPU's plain loop; eager against the graph, ms a
    tick and ``device_profile``'s device operations and host syncs a
    tick."""
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.io.sinks import flatten_outputs
    dev = torch.device(dev)
    batches = general_batches(n_ticks, 32)
    rc = Reconfiguration(epoch=1, n_active=16, fmu=balanced_fmu(256, 16, 16),
                         active=active_mask(16, 16))
    eager = general_pipeline(dev)
    eager_rows, eager_s = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        o1, o2, sw, load = eager.step_staged(
            b, reconfig=rc if i == rc_at else None)
        eager_rows.append((sorted(flatten_outputs(o1) + flatten_outputs(o2)),
                           bool(sw), load.tolist()))
        eager_s.append(time.perf_counter() - t0)
    cpu_rows = persistent_run(general_pipeline("cpu"), batches, k, rc,
                              rc_at)[0]
    pipe = general_pipeline(dev)
    rows, seconds, overflow = persistent_run(pipe, batches, k, rc, rc_at,
                                             sync_free=dev.type == "cuda")
    for i, (got, want, cpu) in enumerate(zip(rows, eager_rows, cpu_rows)):
        if not got == want == cpu:
            raise AssertionError(f"general tick {i}: the graph, the eager "
                                 f"card run and the CPU differ")
    assert sum(r[1] for r in rows) == 1 and overflow == 0
    assert sum(len(r[0]) for r in rows) > 0
    out = dict(lanes=2 * 32 + 1, instances=16, ticks=n_ticks,
               super_batch=k, reconfig_tick=rc_at, equal_to_eager=True,
               equal_to_cpu=True, outputs=sum(len(r[0]) for r in rows),
               eager_ms_per_tick=1e3 * statistics.median(eager_s[2:]),
               persistent_ms_per_tick=1e3 * statistics.median(seconds[1:])
               / k, first_call_s=seconds[0])
    if dev.type != "cuda":
        return out
    graphs = pipe.persistent_graphs()
    assert len(graphs) == 1 and \
        next(iter(graphs.values()))["replays"] == n_ticks // k - 1, graphs
    out["graphs"] = graph_summary(pipe)
    more = general_batches(n_ticks + 8, 32)[n_ticks:]
    out["eager_profile"] = device_profile(
        lambda i: eager.step_staged(more[i]), 4)
    out["persistent_profile"] = device_profile(
        lambda i: pipe.run_persistent(more[4 * i:4 * i + 4]), 1)
    return out


# ---------------------------------------------------------------------------
# phase 7: Q1 over the ingest tier (fused root) into AsyncStreamRuntime
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
        """The pipeline and its ring-overrun total, which the tick function
        adds into on the device (so a graph replay adds as well)."""
        collisions = torch.zeros((), dtype=torch.int32, device=device)

        def count_tick(op_, st, ready, resp, explicit_w=None):
            st, outs = agg.tick_fast(op_, "count", st, ready, resp,
                                     explicit_w=explicit_w)
            collisions.add_(st.collisions)
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
    assert int(collisions) == 0
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

    # (e) the second pass: the same tier into AsyncStreamRuntime with
    # super_batch 8, the persistent driver (one graph a round shape; a
    # shape change flushes a group early), against a CPU run_sync that
    # replays this pass's reconfigurations
    ctl8 = ThresholdController(n_max=N_MAX, k_virt=K,
                               capacity_per_instance=2500.0, n_active=4)
    pipe8, coll8 = pipeline(dev)
    sink8 = Sink()
    t3 = tier(dev)
    dispatch.reset_launches()
    rt8 = AsyncStreamRuntime(pipe8, t3, sink=sink8, controller=ctl8,
                             queue_cap=4, super_batch=8)
    rep8 = rt8.run()
    sync()
    launches8 = {k: v.launches for k, v in dispatch.registered().items()}
    if dev.type == "cuda":
        assert launches8["scalegate_merge_stacked"] == t3.root.rounds, \
            (launches8, t3.root.rounds)
        assert launches8["scalegate_merge"] > 0 and \
            launches8["segment_aggregate"] > 0, launches8
    assert pipe8.bytes_transferred == 0 and int(pipe8.sg.overflow) == 0
    assert int(torch.stack(sink8.overflow).sum()) == 0 and int(coll8) == 0
    cpu8, _ = pipeline("cpu")
    cpu_rep8, cpu_sink8 = run_sync(cpu8, tier("cpu"),
                                   reconfig_trace=rep8.reconfig_trace)
    if cpu_sink8.results() != sink8.results():
        raise AssertionError("q1_ingest_tier (super_batch 8): outputs differ "
                             "from the CPU run")
    assert cpu_rep8.switches == rep8.switches
    graphs8 = pipe8.persistent_graphs()
    super_batch = dict(
        super_batch=8, dispatches=rep8.ticks, outputs=len(sink8.results()),
        tuples_per_s=rep8.throughput_tps, p50_ms=rep8.p50_ms,
        p99_ms=rep8.p99_ms, wall_s=rep8.wall_s,
        reconfigs=[(tk, int(rc.n_active)) for tk, rc in rep8.reconfig_trace],
        switches=rep8.switches, graphs=len(graphs8),
        shapes=["x".join(map(str, key)) for key in graphs8],
        replays=sum(g["replays"] for g in graphs8.values()),
        capture_s=[g["capture_s"] for g in graphs8.values()],
        equal_to_cpu=True)

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
        super_batch_pass=super_batch,
        launches={k: launches[k] + launches8[k] for k in launches})


# ---------------------------------------------------------------------------
# phase 8: checkpoint and exactly-once recovery (Q1 over the ingest tier)
# ---------------------------------------------------------------------------

def dispatch_ms(rt) -> dict:
    """A run's dispatch latencies by first tick id (ms)."""
    return {r.tick_id: r.latency_s * 1e3 for r in rt.runtime.metrics.records}


def span_ms(o, name: str) -> list:
    """Every finished ``name`` span's milliseconds, in order."""
    return [s["dur_s"] * 1e3 for s in o.tracer.finished if s["name"] == name]


def q1_recovery(dev, n_ticks=40, tick=2048, k_virt=4096, k=8, join_at=9,
                leave_at=32, crash_after=28, want_step=25):
    """Q1 over the ingest tier as ``q1_ingest_tier`` runs it, the fast count
    tick in super-batches of ``k`` with a checkpoint every ``k`` ticks: an
    uninterrupted oracle run, a victim stopped after ``crash_after`` ticks
    with a torn newer save planted, and ``resume_runtime``'s steps on a
    fresh fast pipeline over the replay suffix (``remove_host`` re-issued:
    tier commands are intents, not state).  The restored step must be
    ``want_step`` and the victim's committed outputs plus the replayed ones
    the oracle's, exactly.  The defaults are the card's run; smaller
    arguments rehearse it on the CPU (``dev="cpu"``), where no kernel
    launches.

    A snapshot's step counts merged tier rounds: a membership command
    before the cut adds its own round, so the cut at source tick 24 is
    step 25, and the runtime captures a step only where a super-batch
    starts.  A join at tick 9 flushes the open group there (the round
    width changes with the leaf count), which puts every later group start
    on a cut."""
    import tempfile

    from repro_torch import api
    from repro_torch import obs as _obs
    from repro_torch.checkpoint import stream as ckstream
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core import aggregate as agg
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.data import datagen
    from repro_torch.io.sources import RateSchedule, ReplaySource
    from repro_torch.kernels import dispatch
    from repro_torch.launch.recovery import StampedSink

    N_SRC, N_LEAVES = 8, 4
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=n_ticks, tick=tick,
        words_per_tweet=6, vocab=50000, k_virt=k_virt, rate_per_tick=200,
        n_sources=N_SRC, device="cpu"))
    # the q1_ingest_tier phase's declared rate hint: only so that some
    # switch happens (the outputs are the same whichever switches do)
    sched = RateSchedule(((join_at, 6000.0), (n_ticks, 60000.0)))
    tmp = tempfile.TemporaryDirectory()
    ckdir = tmp.name
    cfg = api.RuntimeConfig(
        op="count", wa=1000, ws=2000, wt="multi", k_virt=k_virt,
        out_cap=4096, extra_slots=2, n_max=16, n_active=4, stash_cap=tick,
        device=str(dev), n_sources=N_SRC, ingest_hosts=N_LEAVES,
        ingest_worker="thread", leaf_cap=tick, root_cap=2 * tick,
        out_pad=tick, root_device=True, queue_cap=4, super_batch=k,
        controller="threshold", capacity_per_instance=2500.0,
        checkpoint_dir=ckdir, checkpoint_every=k)
    op = api.make_op(cfg)

    def fast_pipeline():
        return VSNPipeline(
            op, n_max=cfg.n_max, n_active=cfg.n_active,
            stash_cap=cfg.stash_cap,
            tick_fn=lambda o, s, r, m, explicit_w=None: agg.tick_fast(
                o, "count", s, r, m, explicit_w=explicit_w),
            merge_fn=merge_fast_state,
            init_sigma=functools.partial(agg.fast_init, op), device=dev)

    def source(start=0):
        return ReplaySource(batches, n_inputs=N_SRC,
                            schedule=sched).from_tick(start)

    # spans keep the capture and write times (a ring large enough to
    # hold every span of the three runs)
    o = _obs.install(_obs.ObsConfig(enabled=True, trace=True,
                                    span_cap=1 << 16))
    try:
        dispatch.reset_launches()
        # the oracle: uninterrupted, checkpointing off
        oracle = api.build_runtime(
            dataclasses.replace(cfg, checkpoint_dir=None,
                                checkpoint_every=0), source(),
            pipeline=fast_pipeline())
        oracle.tier.add_host(at_tick=join_at)
        oracle.tier.remove_host(0, at_tick=leave_at)
        orep = oracle.run()
        sync()
        want = sorted(oracle.sink.results())

        # the victim: checkpointing on, stopped after crash_after ticks
        victim = api.build_runtime(cfg, source(), pipeline=fast_pipeline())
        victim.tier.add_host(at_tick=join_at)
        victim.tier.remove_host(0, at_tick=leave_at)
        vrep = victim.run(max_ticks=crash_after)
        sync()
        t_detected = time.perf_counter()          # the "crash" instant
        victim.checkpointer.wait()
        saved = list(victim.checkpointer.saved_steps)
        ck = Checkpointer(ckdir)
        last_saved = ck.latest_step()
        torn = f"step_{last_saved + k:08d}"
        (pathlib.Path(ckdir) / torn).mkdir()
        np.save(pathlib.Path(ckdir) / torn / "leaf_00000.npy", np.zeros(3))

        # the restore, step by step as resume_runtime takes it, onto a
        # fresh fast pipeline
        t0 = time.perf_counter()
        step = ck.latest_step()
        manifest = ck.manifest(step)
        extra = manifest["extra"]
        rcfg = api.RuntimeConfig.from_json(extra["config"])
        pipe = fast_pipeline()
        like = ckstream.like_tree(
            pipe, extra, n_sources=rcfg.n_sources, leaf_cap=rcfg.leaf_cap,
            root_cap=rcfg.root_cap, max_leaves=rcfg.effective_max_leaves,
            out_pad=rcfg.out_pad, root_device=rcfg.root_device)
        tree = ck.restore(step, like)
        restore = {"pipe": tree["pipe"], "tick0": step,
                   "tier": ckstream.tier_restore_dict(tree, extra["tier"])}
        sink = StampedSink()
        restored = api.build_runtime(
            rcfg, source(int(extra["source_ticks"])), pipeline=pipe,
            sink=sink, restore=restore)
        restored.tier.remove_host(0, at_tick=leave_at)
        sync()
        t_restored = time.perf_counter()
        rrep = restored.run()
        sync()
        launches = {name: v.launches
                    for name, v in dispatch.registered().items()}
        capture_ms = span_ms(o, "checkpoint.capture")
        write_ms = span_ms(o, "checkpoint.write")
    finally:
        _obs.set_current(None)
        tmp.cleanup()
    got = sorted(victim.sink.results(before_tick=step) + sink.results())
    assert step == want_step, (step, saved)
    assert step == last_saved == saved[-1], "the torn save was visible"
    assert extra["source_ticks"] == step - 1, extra["source_ticks"]
    if got != want:
        raise AssertionError(
            f"q1_recovery: committed + replayed ({len(got)}) != the "
            f"oracle's outputs ({len(want)})")
    if dev.type == "cuda":
        for name in ("scalegate_merge", "scalegate_merge_stacked",
                     "segment_aggregate"):
            assert launches[name] > 0, launches
    n_bytes = sum(int(np.prod(s)) * np.dtype(
        "uint16" if d == "bfloat16" else d).itemsize
        for s, d in zip(manifest["shapes"], manifest["dtypes"]))
    graphs = pipe.persistent_graphs()
    first_replay_ms = (restored.runtime.metrics.records[1].latency_s * 1e3
                       if len(restored.runtime.metrics.records) > 1
                       else None)
    return dict(
        phase="q1_recovery", ticks=n_ticks, tick_tuples=tick,
        k_virt=k_virt, sources=N_SRC, leaves=N_LEAVES, super_batch=k,
        checkpoint_every=k, join_at=join_at, leave_at=leave_at,
        crash_after=crash_after, saved_steps=saved, restored_step=step,
        restored_source_ticks=extra["source_ticks"], torn_step=torn,
        torn_invisible=True, parity=True, outputs=len(want),
        committed=len(victim.sink.results(before_tick=step)),
        replayed=len(sink.results()),
        checkpoint_bytes=n_bytes, checkpoint_leaves=manifest["n_leaves"],
        capture_ms=capture_ms,
        capture_ms_median=statistics.median(capture_ms),
        write_ms=write_ms, write_ms_median=statistics.median(write_ms),
        # a run's first dispatch of a shape warms up and captures its
        # graph; the later ones replay it
        victim=dict(dispatches=vrep.ticks, p50_ms=vrep.p50_ms,
                    p99_ms=vrep.p99_ms, wall_s=vrep.wall_s,
                    dispatch_ms=dispatch_ms(victim)),
        oracle=dict(dispatches=orep.ticks, p50_ms=orep.p50_ms,
                    p99_ms=orep.p99_ms, wall_s=orep.wall_s,
                    dispatch_ms=dispatch_ms(oracle),
                    reconfigs=[(tk, int(rc.n_active))
                               for tk, rc in orep.reconfig_trace]),
        restore_ms=(t_restored - t0) * 1e3,
        detect_to_first_output_ms=(sink.t_first - t_detected) * 1e3,
        split_ms=dict(
            restore=(t_restored - t0) * 1e3,
            run_start_to_first_output=(sink.t_first - t_restored) * 1e3,
            first_graph_capture=(None if not graphs else 1e3 * next(
                iter(graphs.values()))["capture_s"]),
            first_graph_instantiate=(None if not graphs else 1e3 * next(
                iter(graphs.values()))["instantiate_s"]),
            first_replay=first_replay_ms),
        restored_run=dict(dispatches=rrep.ticks, p50_ms=rrep.p50_ms,
                          p99_ms=rrep.p99_ms,
                          dispatch_ms=dispatch_ms(restored),
                          graphs=len(graphs),
                          shapes=["x".join(map(str, key))
                                  for key in graphs]),
        launches=launches)


# ---------------------------------------------------------------------------
# phases 9-13: the stream mesh (MeshPipeline, sigma in fixed key blocks)
# ---------------------------------------------------------------------------

def mesh_pipeline(op, n_shards, device, stash_cap):
    """Q1's ``n_shards``-shard mesh on the fast count path, 4 of 16
    instances active."""
    from repro_torch.core.runtime import MeshPipeline
    from repro_torch.launch.mesh import make_stream_mesh
    return MeshPipeline(op, make_stream_mesh(n_shards, device),
                        stash_cap=stash_cap, mode="fast-agg", n_max=16,
                        n_active=4)


def eager_rows(pipe, batches, rc, rc_at):
    """One ``step_staged`` a tick: per tick (sorted outputs, switched) and
    seconds (host clock, each tick synchronized)."""
    from repro_torch.io.sinks import flatten_outputs
    rows, seconds = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        o1, o2, sw, _ = pipe.step_staged(b, reconfig=rc if i == rc_at
                                         else None)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rows.append((sorted(flatten_outputs(o1) + flatten_outputs(o2)),
                     bool(sw)))
    return rows, seconds


def block_storage(pipe):
    """Each shard's block as (data pointer, shape) a leaf."""
    from repro_torch.tree import tree_leaves
    return [[(a.data_ptr(), tuple(a.shape)) for a in tree_leaves(b)]
            for b in pipe.blocks]


def q1_mesh(dev, n_ticks=40, tick=2048, k_virt=4096, n_shards=4, rc_at=16):
    """Q1 (as ``q1_wordcount``) on a ``n_shards``-shard ``MeshPipeline``
    (the fast count path), 4 -> 16 instances at tick ``rc_at``: tick for
    tick the single-device ``VSNPipeline`` on the card and the same mesh on
    the CPU; one switch moving the tables' bytes, no copy between devices,
    every shard's block in the same storage across the switch; ms a tick
    and a profile beside ``VSNPipeline``'s on the same ticks.  Smaller
    arguments rehearse it on the CPU."""
    from repro_torch.core import aggregate as agg
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.kernels import dispatch

    dev = torch.device(dev)
    card = dev.type == "cuda"
    op, batches, rc = q1_setup(k_virt, n_ticks, tick)

    def vsn_pipeline():
        return VSNPipeline(
            op, n_max=16, n_active=4, stash_cap=tick,
            tick_fn=lambda o, s, r, m, explicit_w=None: agg.tick_fast(
                o, "count", s, r, m, explicit_w=explicit_w),
            merge_fn=merge_fast_state,
            init_sigma=functools.partial(agg.fast_init, op), device=dev)

    vsn_rows, vsn_s = eager_rows(vsn_pipeline(), batches, rc, rc_at)
    t0 = time.perf_counter()
    cpu_rows, _ = eager_rows(mesh_pipeline(op, n_shards, "cpu",
                                           stash_cap=tick), batches, rc, rc_at)
    cpu_seconds = time.perf_counter() - t0

    pipe = mesh_pipeline(op, n_shards, dev, stash_cap=tick)
    storage = block_storage(pipe)
    dispatch.reset_launches()
    rows, seconds = eager_rows(pipe, batches, rc, rc_at)
    launches = {n: v.launches for n, v in dispatch.registered().items()}
    for i, (got, want, cpu) in enumerate(zip(rows, vsn_rows, cpu_rows)):
        if not got == want == cpu:
            raise AssertionError(f"q1_mesh tick {i}: the mesh, VSNPipeline "
                                 f"and the CPU mesh differ")
    sw_ticks = [i for i, r in enumerate(rows) if r[1]]
    assert len(sw_ticks) == 1, sw_ticks
    assert sum(1 for r in rows if r[0]) >= 2
    assert block_storage(pipe) == storage, "a sigma block moved"
    assert pipe.collective_bytes() == {}
    assert pipe.switch_bytes() == vsn_pipeline().switch_bytes()
    assert int(pipe.sg.overflow) == 0
    assert int(pipe.sigma.collisions) == 0
    out = dict(phase="q1_mesh", ticks=n_ticks, tick_tuples=tick,
               k_virt=k_virt, shards=n_shards,
               devices=[str(d) for d in pipe.mesh.devices],
               outputs=sum(len(r[0]) for r in rows), switch_tick=sw_ticks[0],
               equal_to_vsn=True, equal_to_cpu=True,
               cpu_run_seconds=cpu_seconds, collective_bytes={},
               switch_table_bytes=pipe.switch_bytes(),
               block_storage_unchanged=True, launches=launches)
    if not card:
        return out
    assert launches["scalegate_merge"] > 0 and \
        launches["segment_aggregate"] > 0, launches
    steady = lambda s: statistics.median(
        x for i, x in enumerate(s) if i not in (0, *sw_ticks))
    first = 24

    def profile(pipe):
        for i in range(first):
            pipe.step_staged(batches[i], reconfig=rc if i == rc_at else None)
        torch.cuda.synchronize()
        return device_profile(lambda i: pipe.step_staged(batches[first + i]),
                              4, kernel=MERGE_KERNEL_SYMBOL)
    out.update(
        mesh=dict(steady_tick_ms=steady(seconds) * 1e3,
                  reconfig_tick_ms=seconds[sw_ticks[0]] * 1e3,
                  profile=profile(mesh_pipeline(op, n_shards, dev,
                                                stash_cap=tick))),
        vsn=dict(steady_tick_ms=steady(vsn_s) * 1e3,
                 reconfig_tick_ms=vsn_s[sw_ticks[0]] * 1e3,
                 profile=profile(vsn_pipeline())))
    return out


def q1_mesh_persistent(dev, n_ticks=40, tick=2048, k_virt=4096, n_shards=4,
                       k=8, rc_at=19):
    """Q1 on the mesh (as ``q1_mesh``) through ``run_persistent`` in
    super-batches of ``k``, the reconfiguration mid-scan (tick 19,
    ``reconfig_at`` 3): tick for tick the eager mesh run; one graph a
    physical device and shape, replayed by the later super-batches under
    ``set_sync_debug_mode("error")``, no node touching host memory;
    capture and instantiate seconds and ms a tick."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import host_transfer_ops

    dev = torch.device(dev)
    card = dev.type == "cuda"
    op, batches, rc = q1_setup(k_virt, n_ticks, tick)
    want, eager_s = eager_rows(mesh_pipeline(op, n_shards, dev,
                                             stash_cap=tick),
                               batches, rc, rc_at)
    pipe = mesh_pipeline(op, n_shards, dev, stash_cap=tick)
    storage = block_storage(pipe)
    dispatch.reset_launches()
    rows, seconds, overflow = persistent_run(pipe, batches, k, rc, rc_at,
                                             sync_free=card)
    launches = {n: v.launches for n, v in dispatch.registered().items()}
    got = [r[:2] for r in rows]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"q1_mesh_persistent tick {i}: differs "
                                 f"from the eager mesh run")
    assert sum(r[1] for r in got) == 1 and overflow == 0
    assert block_storage(pipe) == storage, "a sigma block moved"
    out = dict(phase="q1_mesh_persistent", ticks=n_ticks, super_batch=k,
               shards=n_shards, reconfig_tick=rc_at, equal_to_eager=True,
               outputs=sum(len(r[0]) for r in got), launches=launches)
    if not card:
        return out
    graphs = pipe.persistent_graphs()
    assert len(graphs) == len(pipe.mesh.groups), list(graphs)
    assert all(g["replays"] == n_ticks // k - 1 for g in graphs.values())
    host = host_transfer_ops(graphs)
    assert host in (0, None), host
    assert launches["scalegate_merge"] > 0 and \
        launches["segment_aggregate"] > 0, launches
    steady_p = [x for j, x in enumerate(seconds) if j not in (0, 2)]
    steady_e = [x for i, x in enumerate(eager_s) if i not in (0, rc_at)]
    out.update(
        host_copies=host, sync_free_replays=True,
        persistent=dict(steady_tick_ms=statistics.median(steady_p) / k * 1e3,
                        first_super_batch_s=seconds[0],
                        reconfig_super_batch_ms=seconds[2] * 1e3),
        eager=dict(steady_tick_ms=statistics.median(steady_e) * 1e3),
        graphs=graph_summary(pipe))
    return out


def general_mesh(dev, n_shards=4, k=4, n_ticks=8, rc_at=4):
    """The general O+ tick at ``live``'s shape (``general_pipeline``: count,
    K 256, 65 lanes, 16 instances) on a ``n_shards``-shard mesh
    (``mode="general"``), 2 -> 16 instances at tick ``rc_at``: eager, tick
    for tick ``VSNPipeline`` on the card and the mesh on the CPU; then
    through ``run_persistent`` in super-batches of ``k`` (one graph a
    device, replayed), equal to the eager mesh run; ms a tick and graph
    nodes.  8 ticks, not ``general_persistent``'s 12: each eager mesh
    tick is ~0.7 s of host issue on the card."""
    from repro_torch import api
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import MeshPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_stream_mesh

    dev = torch.device(dev)
    card = dev.type == "cuda"
    batches = general_batches(n_ticks, 32)
    rc = Reconfiguration(epoch=1, n_active=16, fmu=balanced_fmu(256, 16, 16),
                         active=active_mask(16, 16))
    op = api.make_op(api.RuntimeConfig(op="count", wa=500, ws=1000,
                                       wt="multi", k_virt=256, out_cap=1024,
                                       extra_slots=2))

    def mesh(device):
        return MeshPipeline(op, make_stream_mesh(n_shards, device),
                            stash_cap=32, mode="general", n_max=16,
                            n_active=2)

    vsn_rows, vsn_s = eager_rows(general_pipeline(dev), batches, rc, rc_at)
    t0 = time.perf_counter()
    cpu_rows, _ = eager_rows(mesh("cpu"), batches, rc, rc_at)
    cpu_seconds = time.perf_counter() - t0
    dispatch.reset_launches()
    rows, seconds = eager_rows(mesh(dev), batches, rc, rc_at)
    for i, (got, want, cpu) in enumerate(zip(rows, vsn_rows, cpu_rows)):
        if not got == want == cpu:
            raise AssertionError(f"general_mesh tick {i}: the mesh, "
                                 f"VSNPipeline and the CPU mesh differ")
    assert sum(r[1] for r in rows) == 1 and sum(len(r[0]) for r in rows)
    out = dict(phase="general_mesh", lanes=2 * 32 + 1, instances=16,
               shards=n_shards,
               ticks=n_ticks, reconfig_tick=rc_at, equal_to_vsn=True,
               equal_to_cpu=True, outputs=sum(len(r[0]) for r in rows),
               cpu_run_seconds=cpu_seconds,
               eager_ms_per_tick=1e3 * statistics.median(seconds[2:]),
               vsn_eager_ms_per_tick=1e3 * statistics.median(vsn_s[2:]))
    if not card:
        out["launches"] = {n: v.launches
                           for n, v in dispatch.registered().items()}
        return out
    pipe = mesh(dev)
    prows, pseconds, overflow = persistent_run(pipe, batches, k, rc, rc_at,
                                               sync_free=True)
    out["launches"] = {n: v.launches for n, v in dispatch.registered().items()}
    assert out["launches"]["scalegate_merge"] > 0, out["launches"]
    if [r[:2] for r in prows] != rows or overflow:
        raise AssertionError("general_mesh: the graph replays differ from "
                             "the eager mesh run")
    graphs = pipe.persistent_graphs()
    assert len(graphs) == len(pipe.mesh.groups), graphs
    assert all(g["replays"] == n_ticks // k - 1 for g in graphs.values())
    # one eager tick past the stream under the profiler (the graph's
    # operations are its nodes; profiling ~70,000 of them costs a minute)
    more = general_batches(n_ticks + 1, 32)[n_ticks:]
    out.update(equal_graph_to_eager=True,
               persistent_ms_per_tick=1e3 * statistics.median(pseconds[1:])
               / k, first_call_s=pseconds[0], graphs=graph_summary(pipe),
               eager_profile=device_profile(
                   lambda i: pipe.step_staged(more[i]), 1))
    return out


def q3_mesh(dev, n_shards=4, out_cap=4096):
    """ScaleJoin (as ``q3_scalejoin``: seed 3, band 10 on 2 of 4
    attributes, K 512, ring 16, 12 ticks of 256) through ``vsn.shard_tick``
    with ``join_local_tick`` at 1 and ``n_shards`` shards: the same
    unordered output pairs, the same total comparisons, every shard a
    share of them."""
    from repro_torch.core import join, vsn
    from repro_torch.core.windows import WindowSpec
    from repro_torch.data import datagen
    from repro_torch.io.sinks import flatten_outputs
    from repro_torch.launch.mesh import make_stream_mesh

    K, RING, TICK, N_TICKS, P = 512, 16, 256, 12, 4
    dev = torch.device(dev)
    ws = WindowSpec(wa=1, ws=300_000, wt="single")
    batches = list(datagen.scalejoin(np.random.default_rng(3),
                                     n_ticks=N_TICKS, tick=TICK, k_virt=1,
                                     rate_t_per_s=2000.0, device="cpu"))
    stack = vsn.stack([b.to(dev) for b in batches])

    def run(n):
        mesh = make_stream_mesh(n, dev)
        sigma = dataclasses.replace(join.fast_join_init(K, RING, P, dev),
                                    comparisons=torch.zeros((n,),
                                                            device=dev))
        step = vsn.shard_tick(mesh, K, vsn.join_local_tick(
            ws, join.band_predicate(10.0, 2), K, out_cap))
        t0 = time.perf_counter()
        blocks, outs = step(vsn.mesh_device_put(sigma, mesh, K), stack)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        comps = vsn.mesh_gather(blocks, vsn.mesh_state_spec(sigma, K),
                                dev).comparisons
        pairs = []
        for tau, pay in flatten_outputs(outs):
            half = len(pay) // 2
            pairs.append((tau, tuple(sorted([pay[:half], pay[half:]]))))
        assert int(outs.overflow.sum()) == 0
        return sorted(pairs), comps.cpu().tolist(), seconds

    from repro_torch.kernels import dispatch
    dispatch.reset_launches()
    one, c1, s1 = run(1)
    many, cn, sn = run(n_shards)
    launches = {n: v.launches for n, v in dispatch.registered().items()}
    if one != many:
        raise AssertionError("q3_mesh: the pairs differ between 1 and "
                             f"{n_shards} shards")
    assert sum(cn) == sum(c1) and all(c > 0 for c in cn), (c1, cn)
    return dict(phase="q3_mesh", ticks=N_TICKS, k_virt=K, ring=RING,
                shards=n_shards, output_pairs=len(one), comparisons=sum(c1),
                comparisons_by_shard=cn, seconds={"1": s1,
                                                  str(n_shards): sn},
                pairs_equal=True, launches=launches)


def q1_mesh_recovery(dev, n_ticks=40, tick=2048, k_virt=4096, n_shards=4,
                     crash_after=28, again=2):
    """``launch.recovery.kill_restore_drill`` at ``q1_recovery``'s
    configuration (Q1 over the tier: 8 sources, 4 thread leaves, the fused
    root, ``super_batch`` 8, a checkpoint every 8 ticks) on a
    ``n_shards``-shard mesh, a torn newer save planted: exact parity.
    Then the restored step restored once more onto ``again`` shards: its
    replay equals the uninterrupted run's outputs from that step on."""
    import tempfile

    from repro_torch import api
    from repro_torch.checkpoint import stream as ckstream
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.data import datagen
    from repro_torch.io.sources import ReplaySource
    from repro_torch.kernels import dispatch
    from repro_torch.launch.recovery import kill_restore_drill

    N_SRC, N_LEAVES, K8 = 8, 4, 8
    dev = torch.device(dev)
    batches = list(datagen.tweets(
        np.random.default_rng(7), n_ticks=n_ticks, tick=tick,
        words_per_tweet=6, vocab=50000, k_virt=k_virt, rate_per_tick=200,
        n_sources=N_SRC, device="cpu"))
    with tempfile.TemporaryDirectory() as ckdir:
        cfg = api.RuntimeConfig(
            op="count", wa=1000, ws=2000, wt="multi", k_virt=k_virt,
            out_cap=4096, extra_slots=2, n_max=16, n_active=4,
            stash_cap=tick, mesh_devices=n_shards, device=str(dev),
            n_sources=N_SRC, ingest_hosts=N_LEAVES, ingest_worker="thread",
            leaf_cap=tick, root_cap=2 * tick, out_pad=tick,
            root_device=True, queue_cap=4, super_batch=K8,
            checkpoint_dir=ckdir, checkpoint_every=K8)
        dispatch.reset_launches()
        oracle = api.build_runtime(
            dataclasses.replace(cfg, checkpoint_dir=None, checkpoint_every=0),
            ReplaySource(batches, n_inputs=N_SRC))
        oracle.run()
        want = oracle.sink.results()
        t0 = time.perf_counter()
        rep = kill_restore_drill(cfg, batches, mode="stop",
                                 crash_after=crash_after, crash_mid_save=True,
                                 oracle=want)
        drill_s = time.perf_counter() - t0
        assert rep.parity, rep.summary()
        step = rep.restored_step
        assert step > 0, rep.summary()

        ck = Checkpointer(ckdir)
        extra = ck.manifest(step)["extra"]
        rcfg = dataclasses.replace(api.RuntimeConfig.from_json(
            extra["config"]), mesh_devices=again, checkpoint_dir=None,
            checkpoint_every=0)
        pipe = api.make_pipeline(rcfg)
        like = ckstream.like_tree(
            pipe, extra, n_sources=rcfg.n_sources, leaf_cap=rcfg.leaf_cap,
            root_cap=rcfg.root_cap, max_leaves=rcfg.effective_max_leaves,
            out_pad=rcfg.out_pad, root_device=rcfg.root_device)
        tree = ck.restore(step, like)
        restored = api.build_runtime(
            rcfg, ReplaySource(batches, n_inputs=N_SRC).from_tick(
                int(extra["source_ticks"])), pipeline=pipe,
            restore={"pipe": tree["pipe"], "tick0": step,
                     "tier": ckstream.tier_restore_dict(tree,
                                                        extra["tier"])})
        restored.run()
        launches = {n: v.launches for n, v in dispatch.registered().items()}
    if restored.sink.results() != oracle.sink.results(since_tick=step):
        raise AssertionError(f"q1_mesh_recovery: the snapshot restored on "
                             f"{again} shards replays other outputs")
    if dev.type == "cuda":
        for name in ("scalegate_merge", "scalegate_merge_stacked",
                     "segment_aggregate"):
            assert launches[name] > 0, launches
    return dict(phase="q1_mesh_recovery", ticks=n_ticks, tick_tuples=tick,
                shards=n_shards, super_batch=K8, checkpoint_every=K8,
                crash_after=crash_after, restored_step=step,
                parity=True, detect_to_recover_ms=rep.detect_to_recover_ms,
                committed=rep.n_committed, replayed=rep.n_replayed,
                outputs=rep.n_oracle, drill_seconds=drill_s,
                restored_again_on_shards=again, again_equal=True,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 14: the stream launchers on the card (elastic_drill, live)
# ---------------------------------------------------------------------------

# Runs a launcher's ``main`` in a process of its own, as ``python -m``
# would, and prints the process's kernel launches as the last line.
LAUNCHER = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import dispatch; "
            "mod = __import__('repro_torch.launch.' + sys.argv[2], "
            "fromlist=['main']); rc = mod.main(sys.argv[3:]); "
            "print(json.dumps({k: v.launches for k, v in "
            "dispatch.registered().items()})); sys.exit(rc)")

# the reference's summary lines each launcher prints
LAUNCHER_LINES = ("# device", "[1]", "[1m]", "[2]", "[3]", "[4]", "[5]", "[6]",
                  "[6k]", "[live", "elastic drill OK", "live run OK",
                  "live resume OK")


def run_launcher(module: str, argv, timeout: float,
                 prefixes=LAUNCHER_LINES, threads=None):
    """One launcher in its own process on the card; raises on a nonzero
    exit.  Returns its seconds, its summary lines (those starting with
    one of ``prefixes``) and its launches.  ``threads`` caps the
    process's CPU threads (``OMP_NUM_THREADS``), for processes run side by
    side on the host's few cores."""
    t0 = time.perf_counter()
    env = None if threads is None else {
        **os.environ, "OMP_NUM_THREADS": str(threads),
        "MKL_NUM_THREADS": str(threads)}
    out = subprocess.run(
        [sys.executable, "-c", LAUNCHER, str(ROOT / "src"), module,
         *argv], capture_output=True, text=True, timeout=timeout, env=env)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(
            f"launchers: {module} {' '.join(argv)} exited "
            f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    return dict(argv=[module, *argv], seconds=seconds,
                summary=[ln for ln in lines[:-1] if ln.startswith(prefixes)],
                launches=json.loads(lines[-1]))


def drill_times(limits=(("crash", 90), ("serving", 120), ("ingest", 120),
                        ("straggler", 200), ("live", 240),
                        ("recovery", 300), ("recovery-kill", 300))) -> None:
    """Each drill of ``elastic_drill`` alone on the card, in a process of
    its own, with its seconds; a drill past its limit (seconds) is killed
    and reported so.  One JSON line a drill.

        python3 chip_smoke.py --drill-times
    """
    for drill, limit in limits:
        t0 = time.perf_counter()
        try:
            run = run_launcher("elastic_drill", ["--drills", drill], limit)
            emit(dict(phase="drill_times", drill=drill,
                      seconds=run["seconds"], summary=run["summary"]))
        except subprocess.TimeoutExpired:
            emit(dict(phase="drill_times", drill=drill,
                      seconds=time.perf_counter() - t0,
                      past_limit_s=limit))


def launchers(dev, drills="straggler,live,ingest,serving,crash,recovery,"
              "recovery-kill", live_ticks=24, live_tick=256, every=2):
    """``elastic_drill`` at the reference's own sizes, every drill but the
    mesh's, and at once ``live`` at its reference size (24 ticks of 256)
    with the oracle, checkpoints and a recording followed by ``live
    --resume`` replaying it, each in a process of its own on the card, and
    the same ``live`` run on the CPU, whose output count the card's must
    equal; ``live --super-batch 4`` (8 ticks of 32), the general tick
    in the persistent driver's graphs, equal to its oracle; and the
    stream mesh: ``live --mesh 4`` at 24 ticks of 256 with its oracle and
    ``elastic_drill --drills mesh --mesh 4``.  Nothing is cut
    (``--drill-times`` times each drill alone).  ``recovery-kill``, which
    alone takes about as long as the other drills together (~66 s), runs
    in a process of its own beside theirs.  The card's processes get one
    CPU thread each and the CPU run four: with a thread a core each the
    CPU run took 191 s beside six card processes, with two threads 134 s
    (NVIDIA H100 80GB HBM3 hosts, 8 cores)."""
    import concurrent.futures
    import tempfile

    dev = torch.device(dev)
    # the launchers' own default is the card; the CPU rehearsal asks
    where = [] if dev.type == "cuda" else ["--device", "cpu"]
    alone = "recovery-kill"
    with tempfile.TemporaryDirectory() as d, \
            concurrent.futures.ThreadPoolExecutor(7) as pool:
        ck, rec = str(pathlib.Path(d) / "ck"), str(pathlib.Path(d) /
                                                    "stream.npz")
        size = ["--ticks", str(live_ticks), "--tick", str(live_tick), *where]

        def live_pair():
            first = run_launcher(
                "live", [*size, "--oracle", "--checkpoint-dir", ck,
                         "--checkpoint-every", str(every), "--record", rec],
                timeout=600, threads=1)
            resume = run_launcher(
                "live", [*size, "--resume", "--replay", rec,
                         "--checkpoint-dir", ck], timeout=600, threads=1)
            return first, resume

        split = [",".join(x for x in drills.split(",") if x != alone)]
        split += [alone] if alone in drills.split(",") else []
        drill_fs = [pool.submit(run_launcher, "elastic_drill",
                                ["--drills", x, *where], 600, threads=1)
                    for x in split]
        live_f = pool.submit(live_pair)
        # the default general tick inside the persistent driver: 4 ticks
        # a call, one graph a call shape
        super_f = pool.submit(run_launcher, "live",
                              ["--ticks", "8", "--tick", "32",
                               "--super-batch", "4", "--oracle", *where],
                              600, threads=1)
        # the same live run on this host's CPU: the general tick on the
        # card against its plain path (a host's numpy draws the stream)
        cpu_f = pool.submit(run_launcher, "live",
                            ["--ticks", str(live_ticks), "--tick",
                             str(live_tick), "--oracle", "--device", "cpu"],
                            600, threads=4)
        # the stream mesh: live on 4 shards (the fast count path) with its
        # oracle, and the mesh drill
        mesh_live_f = pool.submit(run_launcher, "live",
                                  [*size, "--oracle", "--mesh", "4"], 600,
                                  threads=1)
        mesh_drill_f = pool.submit(run_launcher, "elastic_drill",
                                   ["--drills", "mesh", "--mesh", "4",
                                    *where], 600, threads=1)
        runs = [drill_fs[0].result(), *live_f.result(), super_f.result(),
                mesh_live_f.result(), mesh_drill_f.result(),
                *(f.result() for f in drill_fs[1:])]
        cpu_run = cpu_f.result()
    text = "\n".join(ln for r in runs for ln in r["summary"])
    for want in ("[1] straggler drain: outputs identical=True",
                 "parity=True", "torn save was invisible",
                 "outputs match static oracle=True",
                 "outputs == single-gate oracle: True",
                 "[3] crash drill: latest complete step = 10",
                 "elastic drill OK", "outputs match static oracle = True",
                 "live run OK", "live resume OK"):
        assert want in text, (want, text)
    mesh_line = re.search(r"\[1m\] mesh straggler drain on 4 shards: "
                          r"outputs identical=True, reconfigs=1, "
                          r"cross-shard state transfer=0 B", text)
    assert mesh_line, text
    assert "outputs match static oracle = True" in \
        "\n".join(runs[4]["summary"]), runs[4]["summary"]
    restored = re.search(r"restored step (\d+)", text)
    assert restored and int(restored.group(1)) > 0, text
    count = re.compile(r"static oracle = True \((\d+) output tuples")
    card_n = count.search("\n".join(runs[1]["summary"])).group(1)
    assert count.search("\n".join(runs[3]["summary"])), runs[3]["summary"]
    cpu_n = count.search("\n".join(cpu_run["summary"])).group(1)
    assert card_n == cpu_n, ("live: card and CPU outputs differ", card_n,
                             cpu_n)
    from repro_torch.kernels import dispatch
    launches = {name: sum(r["launches"].get(name, 0) for r in runs)
                for name in dispatch.registered()}
    if dev.type == "cuda":
        assert runs[0]["launches"]["flash_attention"] > 0, runs[0]["launches"]
    return dict(phase="launchers", drills=drills.split(","),
                cut=None, live=dict(ticks=live_ticks, tick=live_tick),
                checkpoint_every=every, runs=runs, live_outputs=int(card_n),
                live_outputs_equal_to_cpu=True,
                cpu_live_seconds=cpu_run["seconds"], launches=launches)


# ---------------------------------------------------------------------------
# phases 15-18 and 20-22: the elastic serving tier at full width
# (qwen3-14b, rwkv6-7b, deepseek-moe-16b, hymba-1.5b; gemma3-12b,
# stablelm-12b, qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------

SERVE_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention",),
                 "rwkv": ("linear_scan",),
                 "hybrid": ("flash_attention", "linear_scan")}
# a substring of the CUDA kernels' symbols, for the profile
KERNEL_SYMBOL = {"flash_attention": "flash_", "linear_scan": "linear_scan_"}


# The default run's serve phases in order, each with its arguments past
# ``serve_full_width``'s defaults.  gemma3-12b's prompts of 1280 tokens in
# slots of 2048 put every decode step past its local layers' window of
# 1024, and its float32 copy of 6 layers holds a global layer (the sixth).
# The time limit cuts traffic, nothing else: every phase takes 12 arrival
# ticks and replays its first 64 rounds eagerly (the first four served
# 24 and 160 before the last three came), and the last three 8 new
# tokens a request, not 32: at 32 their batch-1 checks took 59, 25 and
# 115 s, and with 16 the whole run took 1,104 s of phases (PERF.md).
# ``--serve ARCH`` runs one phase alone: any of these, or gemma3-4b, which
# takes gemma3-12b's path at smaller widths (``SERVE_ALONE``).
SERVE_CUT = dict(ticks=12, eager_rounds=64)
NEW_CUT = dict(SERVE_CUT, max_new=8)
GEMMA3_SERVE = dict(NEW_CUT, prompt_len=1280, max_seq=2048, check_layers=6)
SERVE_ARGS = {
    "qwen3-14b": SERVE_CUT, "rwkv6-7b": SERVE_CUT,
    "deepseek-moe-16b": SERVE_CUT, "hymba-1.5b": SERVE_CUT,
    "gemma3-12b": GEMMA3_SERVE, "stablelm-12b": NEW_CUT,
    "qwen3-moe-30b-a3b": NEW_CUT,
}
SERVE_ALONE = dict(SERVE_ARGS, **{"gemma3-4b": GEMMA3_SERVE})


# The float32 MoE copy's batch-1 allowance (see ``serve_full_width``): a
# request may leave batch-1 decode only at a token whose top-2 logit gap in
# the reference is below this (the card read one at 2.66e-4, PERF.md)
MOE_BATCH1_GAP = 1e-3


def record_buckets(eng) -> dict:
    """Wrap ``eng._run`` (undone by ``del eng._run``) to record each
    request's decode rounds' buckets: -> {uid: [bucket a decode step]},
    filled as the engine runs."""
    rows = {}
    run = eng._run

    def record(key, body):
        if key[0] == "decode":
            for r in eng.running.values():
                rows.setdefault(r.uid, []).append(key[1])
        run(key, body)
    eng._run = record
    return rows


@torch.inference_mode()
def padded_decode(cfg, params, prompt, max_new, max_seq, rows=None):
    """The port's ``reference_decode`` (greedy, fresh caches, one bulk
    prefill, then token by token), each token with its top-2 logit gap.
    With ``rows`` (an int a decode step), step j runs as a batch of
    ``rows[j]`` lanes, as the engine's round padded to its bucket: the
    request in lane 0, the others pad lanes (token 0, position 0, not
    live) on cache rows of their own.  No lane reads another, so the
    tokens are the same function at the engine's matrix shapes, and the
    card's libraries round a row alike only at equal shapes: where the
    engine leaves batch-1 decode, this tells that rounding from a lane
    leaking into another.  -> (tokens, gaps)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    dev = params["embedding"].device
    width = 1 if rows is None else max(rows, default=1)
    caches, states = transformer.init_caches(cfg, width, max_seq, dev)
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    lane0 = None if rows is None else torch.zeros((1,), dtype=torch.int64,
                                                  device=dev)
    logits, caches, states = M.prefill_with_cache(params, toks, caches,
                                                  states, cfg=cfg,
                                                  lanes=lane0)
    out, gaps = [], []

    def take(row):
        top = row.float().topk(2).values
        out.append(int(row.argmax()))
        gaps.append(float(top[0] - top[1]))
    take(logits[0])
    pos = len(prompt)
    while len(out) < max_new:
        if rows is None:
            logits, caches, states = M.decode_step(
                params, caches, states,
                torch.tensor([out[-1]], device=dev), pos, cfg=cfg)
        else:
            k = rows[len(out) - 1]
            one = lambda v: torch.tensor([v] + [0] * (k - 1), device=dev)
            logits, caches, states = M.decode_step(
                params, caches, states, one(out[-1]), one(pos), cfg=cfg,
                lanes=torch.arange(k, device=dev), live=one(1) != 0)
        take(logits[0])
        pos += 1
    return out, gaps


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


def _replay(eng, schedule, rounds=None):
    """Submit ``schedule``'s requests ((round, uid, prompt, max_new), the
    rounds counted from the engine's first) to ``eng`` at their rounds,
    as the runtime did, and tick; stop after ``rounds`` rounds (None: once
    every request is done).  The engine then batches the same lanes at
    the same rounds.  -> ({uid: tokens so far}, the rounds' span
    quantiles (``serve.decode``, ``serve.prefill``))."""
    from repro_torch import obs as _obs
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import Request
    by_round = {}
    for step, uid, prompt, max_new in schedule:
        by_round.setdefault(step, []).append(
            Request(uid=uid, prompt=prompt, max_new=max_new))
    reqs = [r for rs in by_round.values() for r in rs]
    prev = _obs.get()
    o = _obs.install(ObsConfig(enabled=True, trace=True))
    try:
        while rounds is None or eng.steps < rounds:
            for r in by_round.get(eng.steps, []):
                eng.submit(r)
            eng.tick()
            if (eng.steps > max(by_round) and not eng.running
                    and not eng.waiting):
                break
        lat = o.tracer.stage_latency_ms()
    finally:
        _obs.set_current(prev)
    return {r.uid: list(r.out) for r in reqs if r.out}, lat


def _graph_summary(eng, kernels, n_layers) -> dict:
    """The engine's captured graphs (bucket or prompt length -> capture
    and instantiate seconds, nodes, kernel launches a replay, replays);
    each replays every layer's kernels once and copies nothing to or from
    host memory."""
    out = {}
    for key, g in eng.graph_stats().items():
        nodes = g["nodes"] or {}
        assert all(g["launches"].get(k) == n_layers for k in kernels), \
            (key, g["launches"])
        assert nodes.get("host_copies", 0) == 0, (key, nodes)
        out[key] = dict(capture_s=g["capture_s"],
                        instantiate_s=g["instantiate_s"],
                        nodes=nodes.get("nodes"),
                        by_type=nodes.get("by_type"),
                        launches=g["launches"], replays=g["replays"])
    return out


def _round_profile(eng, prompts, kernels):
    """Where a decode round's time goes: ``prompts`` (one a slot) admitted
    and one round run, then 4 rounds under the profiler; the engine is
    drained after."""
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=1000 + i, prompt=p, max_new=8))
    eng.tick()                                     # admit all + one round
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    # the CUDA activity alone: its runtime calls hold the host syncs, and
    # the CPU operators' events of an eager round took seconds to parse
    profile = device_profile(lambda i: eng.tick(), 4,
                             kernel=KERNEL_SYMBOL[kernels[0]], cpu_ops=False)
    while eng.running:
        eng.tick()
    return profile


def _free_card(dev) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def serve_full_width(dev, arch, *, n_slots=8, max_seq=1024, prompt_len=128,
                     max_new=32, lanes=4, ticks=24, check_layers=4,
                     reduced=False, eager_rounds=160, keep=None):
    """``arch`` at its published width and depth in bfloat16, parameters
    drawn on the card from seed 0, through the serving entry points
    (``build_runtime`` over a ``RequestSource`` -> ``AsyncStreamRuntime``
    -> ``ServingPipeline`` -> ``ServingEngine``, ``SloServingController``),
    the engine capturing a CUDA graph per decode bucket and prompt length.
    Traffic: 2 sources, ``lanes`` request lanes per 50 ms tick, ``ticks``
    arrival ticks at 40 requests/s with 160 in the middle third, prompts
    of ``prompt_len`` tokens, ``max_new`` tokens each, 8 slots of
    ``max_seq`` over 4 instances with 1 active at start.  Checks: every
    request served; first tokens equal the port's ``reference_decode``
    (batch 1 on both sides), and the share of equal tokens over the
    first ``n_slots`` requests' whole outputs, each of those requests
    that leaves batch-1 decode equal to ``padded_decode`` at the buckets
    the engine ran it in (``requests_off_batch1``); the model's kernels
    launched once per layer per forward, and once per layer in every
    graph, which copies nothing to or from the host; the eager engine
    (``graphs=False``), handed the same requests at the same rounds
    (``eager_rounds``: only the first that many rounds, a request cut
    short compared on the tokens it has), gives the same tokens; a mid-decode VSN switch moves 0 bytes and SN more, both
    token-invisible; and a float32 copy cut to ``check_layers`` layers
    (full width), serving prompts of mixed lengths and budgets that
    arrive over several rounds, is token-identical to ``padded_decode``
    at the engine's buckets and to batch-1 ``reference_decode`` (the
    MoE: but for one request at a near tie, ``MOE_BATCH1_GAP``).
    Reported, graph against eager: decode round
    p50 / p99 and prefill p50 (the engine's spans), and a profiled round
    (device operations, host syncs, busy share).  The defaults are the
    card's run; ``reduced=True`` with smaller arguments rehearses the
    phase on the CPU (``dev="cpu"``, both engines eager).  ``keep`` (a
    dict) takes the drawn parameters and the config (``params``,
    ``cfg``) for a later phase."""
    from repro_torch import obs as _obs
    from repro_torch.api import RuntimeConfig, build_runtime
    from repro_torch.configs import canon, get_config
    from repro_torch.io.sources import RateSchedule
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.serving import (RequestSource, ServingConfig,
                                     ServingEngine, reference_decode)
    from repro_torch.tree import tree_leaves

    from repro_torch.configs import reduced as reduce_cfg
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    mcfg = get_config(canon(arch))
    if reduced:
        mcfg = reduce_cfg(mcfg)
    kernels = SERVE_KERNELS[mcfg.kind]
    prev_obs = _obs.get()
    # each part's seconds, and on the card the memory it holds at its end
    # and its peak (GB), the peak reset at each part's start
    parts, memory = {}, {}
    clock = [time.perf_counter()]

    def lap(name):
        sync()
        now = time.perf_counter()
        parts[name] = now - clock[0]
        clock[0] = now
        if cuda:
            memory[name] = dict(
                held=torch.cuda.memory_allocated(dev) / 1e9,
                peak=torch.cuda.max_memory_allocated(dev) / 1e9)
            torch.cuda.reset_peak_memory_stats(dev)
    if cuda:
        # the allocator's statistics exist once CUDA is initialised: a
        # process that runs this phase first (--serve) has not yet
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
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
    pipe, eng = rt.pipeline, rt.pipeline.engine
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(eng.params)) / 1e9
    lap("init")
    assert eng.graphs == cuda
    # the rounds the requests reach the engine at, for the eager replay.
    # The wrapper alone holds the bound method: ``del eng.submit`` below
    # leaves no local that keeps the engine, its pool and the parameters
    # alive through the float32 copy (one did: 61 GB of qwen3-moe's
    # weights beside the copy's)
    schedule = []
    eng.submit = lambda r, submit=eng.submit: (schedule.append(
        (eng.steps, r.uid, r.prompt, r.max_new)), submit(r))[1]
    buckets = record_buckets(eng)

    # the main path: the kernel counts cover exactly this run
    dispatch.reset_launches()
    try:
        rep = rt.run()
    finally:
        _obs.set_current(prev_obs)
        del eng.submit, eng._run
    launches = {k: v.launches for k, v in dispatch.registered().items()}
    prefills, rounds = eng.prefills, eng.decode_rounds
    main_dropped = int(eng.dropped)
    main_dropped_decode = int(eng.dropped_decode)
    # capacity a lane: a decode lane's one token fits every expert it picks
    assert main_dropped_decode == 0, main_dropped_decode
    forwards = prefills + rounds
    assert len(pipe.finished) == source.total_requests > 0, \
        (len(pipe.finished), source.total_requests)
    if cuda:
        for k in kernels:
            assert launches[k] == mcfg.n_layers * forwards > 0, \
                (launches, mcfg.n_layers, forwards)
    assert all(n == 0 for k, n in launches.items() if k not in kernels), \
        launches
    tokens = sum(len(r.out) for r in pipe.finished)
    assert tokens == source.total_requests * max_new
    for ev in pipe.reconfig_events:
        assert ev["kv_bytes_moved"] == 0, ev
    graphs = _graph_summary(eng, kernels, mcfg.n_layers)
    assert (len(graphs) > 0) == cuda
    # the highest position a decode step wrote: a request's last token is
    # the argmax of the step fed its second-to-last
    max_decode_position = max(len(r.prompt) + len(r.out) - 2
                              for r in pipe.finished)
    lap("main_path")

    # the eager engine on the same requests at the same rounds: the same
    # lanes in the same buckets, so the same tokens
    served = {r.uid: list(r.out) for r in pipe.finished}
    eager = ServingEngine(mcfg, eng.params, n_slots=n_slots, max_seq=max_seq,
                          n_instances=4, device=dev, graphs=False)
    eager_out, eager_lat = _replay(eager, schedule, eager_rounds)
    assert eager_out and all(served[uid][:len(out)] == out
                             for uid, out in eager_out.items()), \
        "the eager engine's tokens differ from the graph engine's"
    eager_run = eager.decode_rounds
    lap("eager")

    # tokens against the straight-line batch-1 reference on the card: the
    # first token of every request (a batch-1 prefill on both sides, so
    # equal), and every token of the first n_slots requests (the engine's
    # batched decode rounds differently from batch 1 in bfloat16: a share).
    # A request that leaves batch-1 decode must equal padded_decode at the
    # buckets the engine ran it in: the same function at the same shapes
    whole = {r.uid: reference_decode(mcfg, eng.params, r.prompt, max_new,
                                     max_seq)
             for r in pipe.finished[:n_slots]}
    first_same = sum(
        (whole[r.uid] if r.uid in whole else reference_decode(
            mcfg, eng.params, r.prompt, 1, max_seq))[0] == r.out[0]
        for r in pipe.finished)
    assert first_same == len(pipe.finished), (first_same, len(pipe.finished))
    same, padded = 0, []
    for r in pipe.finished[:n_slots]:
        ref = whole[r.uid]
        assert len(ref) == len(r.out) == max_new
        same += sum(a == b for a, b in zip(ref, r.out))
        if ref != r.out:
            assert len(buckets[r.uid]) == max_new - 1, buckets[r.uid]
            pad, _ = padded_decode(mcfg, eng.params, r.prompt, max_new,
                                   max_seq, rows=buckets[r.uid])
            padded.append(sum(a == b for a, b in zip(pad, r.out)))
    assert all(n == max_new for n in padded), \
        f"the engine differs from padded_decode at its buckets: {padded}"
    lap("reference")

    # a manual reconfiguration mid-decode: token-invisible, 0 bytes (VSN),
    # more than 0 bytes (SN)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, mcfg.vocab, prompt_len) for _ in range(n_slots)]
    base, _ = _engine_tokens(eng, prompts, 16)
    vsn, vsn_moved = _engine_tokens(eng, prompts, 16, at=4, mode="vsn")
    sn, sn_moved = _engine_tokens(eng, prompts, 16, at=4, mode="sn")
    assert vsn == base and vsn_moved == 0, vsn_moved
    assert sn == base and sn_moved > 0, sn_moved
    lap("switches")

    # where a decode round's time goes: 8 lanes, 4 rounds under the
    # profiler, in the graph and in the eager engine
    profile = _round_profile(eng, prompts, kernels)
    if eager.running or eager.waiting:              # a cut replay
        eager = None                                # its pool freed first
        eager = ServingEngine(mcfg, eng.params, n_slots=n_slots,
                              max_seq=max_seq, device=dev, graphs=False)
    eager_profile = _round_profile(eager, prompts, kernels)
    lap("profiles")
    lat = rep.stage_latency_ms
    out = dict(
        phase=f"serve_{canon(arch)}", arch=arch, layers=mcfg.n_layers,
        d_model=mcfg.d_model, params_billion=mcfg.param_count() / 1e9,
        dtype=mcfg.dtype, slots=n_slots, max_seq=max_seq,
        prompt_len=prompt_len, max_new=max_new, ticks=ticks,
        window_pattern=mcfg.window_pattern,
        max_decode_position=max_decode_position, init_s=parts["init"],
        requests=len(pipe.finished), tokens=tokens,
        prefills=prefills, decode_rounds=rounds,
        kernel_calls={k: mcfg.n_layers * forwards for k in kernels},
        first_tokens_equal_reference=first_same,
        token_share_equal_reference=same / (n_slots * max_new),
        requests_off_batch1=len(padded),
        reference_s=parts["reference"],
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
        graphs=graphs,
        eager=dict(rounds=eager_run, seconds=parts["eager"],
                   requests_token_identical_to_graph=len(eager_out),
                   requests_complete=sum(out == served[uid] for uid, out
                                         in eager_out.items()),
                   decode_round_ms=eager_lat.get("serve.decode"),
                   prefill_ms=eager_lat.get("serve.prefill"),
                   profile=eager_profile),
        manual_reconfig=dict(vsn_bytes=vsn_moved, sn_bytes=sn_moved,
                             tokens_unchanged=True),
        profile=profile, weights_gb=weights_gb, launches=launches)
    if mcfg.kind == "moe":
        # (token, expert) pairs past an expert's capacity over every
        # forward the engine ran (the runtime's and the checks'), and the
        # main path's share: with capacity a lane, decode drops none
        out["moe"] = dict(dispatch=mcfg.moe.dispatch,
                          experts=mcfg.moe.n_experts, top_k=mcfg.moe.top_k,
                          dropped_tokens=int(eng.dropped),
                          dropped_main_path=main_dropped,
                          dropped_main_path_decode=main_dropped_decode)
    if keep is not None:
        keep.update(params=eng.params, cfg=mcfg)
    del rt, pipe, eng, eager
    _free_card(dev)

    # float32, full width, cut to check_layers layers: token identity with
    # lanes at mixed depths: 12 prompts of 9 lengths and 4 budgets over
    # the 8 slots, half arriving 3 rounds late, so decode rounds batch
    # lanes at different positions and freed slots are reused mid-run.
    # Held against padded_decode at the buckets the engine ran each
    # request in, and against batch-1 reference_decode: every model, but
    # the MoE's vsn sum rounds to bfloat16 even in float32, so a last-bit
    # difference between two shapes' products can move a near tie; the
    # MoE may leave batch 1 on one request, at a token whose top-2 logit
    # gap in the reference is below MOE_BATCH1_GAP
    cfg32 = dataclasses.replace(mcfg, dtype="float32", n_layers=check_layers)
    params = transformer.init_params(cfg32, seed=3, device=dev)
    eng = ServingEngine(cfg32, params, n_slots=n_slots, max_seq=max_seq,
                        n_instances=4, device=dev)
    rows = record_buckets(eng)
    n32 = n_slots + n_slots // 2
    lens = [max(prompt_len - 9 * (i % 9), 2) for i in range(n32)]
    news = [max(max_new - 5 * (i % 4), 1) for i in range(n32)]
    prompts32 = [rng.integers(1, mcfg.vocab, n) for n in lens]
    got, _ = _engine_tokens(eng, prompts32, news,
                            arrive=[3 * (i % 2) for i in range(n32)])
    del eng._run
    f32_same = sum(got[i] == padded_decode(cfg32, params, p, news[i],
                                           max_seq, rows=rows.get(i, []))[0]
                   for i, p in enumerate(prompts32))
    batch1 = [reference_decode(cfg32, params, p, news[i], max_seq)
              for i, p in enumerate(prompts32)]
    off_gaps = {}
    for i, want in enumerate(batch1):
        if got[i] != want:
            toks, gaps = padded_decode(cfg32, params, prompts32[i], news[i],
                                       max_seq)
            assert toks == want
            j = next(j for j, (a, b) in enumerate(zip(got[i], want))
                     if a != b)
            off_gaps[i] = (j, gaps[j])
    assert f32_same == n32, (f32_same, n32)
    assert (not off_gaps or mcfg.kind == "moe" and len(off_gaps) == 1
            and all(g < MOE_BATCH1_GAP for _, g in off_gaps.values())), \
        off_gaps
    out["float32_copy"] = dict(layers=check_layers, requests=n32,
                               prompt_lens=sorted(set(lens)),
                               tokens_per_request=sorted(set(news)),
                               requests_token_identical=f32_same,
                               requests_token_identical_batch1=n32 - len(
                                   off_gaps),
                               batch1_first_differing=off_gaps,
                               graphs=len(eng.graph_stats()))
    del eng, params
    _free_card(dev)
    lap("float32_copy")
    out["seconds_by_part"] = parts
    if cuda:
        out["memory_gb"] = memory
        out["peak_gb"] = max(m["peak"] for m in memory.values())
    else:
        out["peak_gb"] = None
    return out


# ---------------------------------------------------------------------------
# phase 19: the vsn MoE over 4 expert shards of the model mesh
# ---------------------------------------------------------------------------

MOE_MESH_SHARDS = 4
# a layer's output against one shard's (or the CPU's), over the latter's
# largest value: each of the shards' bf16 additions may round a value by
# up to 2^-8 of it (measured 0.70 % at full width on an NVIDIA H100 80GB
# HBM3, 700.00 W); a float32 whole forward, card against CPU, over its
# largest logit: the same share with
# the shards, one rounding (2^-7) without
MOE_MESH_LAYER_RTOL = MOE_MESH_SHARDS * 2.0 ** -7
# whole bf16 forwards, 4 shards against 1: the logits' difference over the
# one-shard logits, both as Frobenius norms, its median over the forwards.
# The bf16 sums differ, so a route at a near tie may differ between the
# runs and move that token's output (their worst forward is reported); a
# fault in the sum moves every forward.  Measured on the CPU at reduced
# size (2 and 6 layers, seeds 0-2, 8 x 32 tokens, 16 steps): medians
# 0.0069-0.037, with one shard's partial lost 0.17-0.60 at every forward;
# at full width on an NVIDIA H100 80GB HBM3, 700.00 W: median 0.083, worst
# 0.152
MOE_MESH_LOGITS_RTOL = 0.15
# a first token may differ only where the no-mesh run's top-2 gap is below
# this share of its largest logit.  At full width the rows' top-2 gaps
# reach 0.07 of it (measured, as above): past 0.05 three of 8 rows are
# checked; at reduced size at least one row of each seed
MOE_MESH_TIE_RTOL = 0.05


def _moe_mesh_run(mcfg, params, prompts, steps, max_seq, dev, mesh=None,
                  tokens=None, layer_check=None):
    """Prefill ``prompts`` ([B, S] on ``dev``) through
    ``model.prefill_with_cache``, then ``steps`` ``decode_step``s, under
    ``use_rules(mesh)`` (none: no mesh): fed ``tokens`` (a list of [B]
    tensors) when given, else each step's greedy tokens.  ``layer_check``
    (a list, and ``twin(p, x, cfg, kw) -> (y, dropped)``, by default the
    one-shard dispatch on the same input): every MoE layer's call also
    runs ``twin``, and the list takes (dropped, the twin's dropped, the
    outputs' largest difference over the twin's largest value).  ->
    (logits of every forward, the tokens fed, ``dropped`` of every
    forward)."""
    import contextlib
    from repro_torch.models import model as M, moe, sharding, transformer
    ctx = (sharding.use_rules(mesh) if mesh is not None
           else contextlib.nullcontext())
    forward = moe.moe_forward
    log, twin = layer_check or (None, None)
    twin = twin or (lambda p, x, cfg, kw: forward(p, x, cfg, **kw,
                                                  n_shards=1))

    def checked(p, x, cfg, **kw):
        y, d = forward(p, x, cfg, **kw)
        y1, d1 = twin(p, x, cfg, kw)
        y1 = y1.float().to(y.device)
        log.append((int(d), int(d1), float(
            (y.float() - y1).abs().max() / y1.abs().max())))
        return y, d
    b, s = prompts.shape
    logits, fed, dropped = [], [], []
    if layer_check is not None:
        moe.moe_forward = checked
    try:
        with ctx, torch.no_grad():
            caches, states = transformer.init_caches(mcfg, b, max_seq,
                                                     device=dev)
            lg, caches, states, aux = M.prefill_with_cache(
                params, prompts, caches, states, cfg=mcfg, with_aux=True)
            logits.append(lg.float())
            dropped.append(int(aux))
            for i in range(steps):
                tok = lg.argmax(-1) if tokens is None else tokens[i]
                fed.append(tok)
                lg, caches, states, aux = M.decode_step(
                    params, caches, states, tok, s + i, cfg=mcfg,
                    with_aux=True)
                logits.append(lg.float())
                dropped.append(int(aux))
    finally:
        moe.moe_forward = forward
    return logits, fed, dropped


def moe_mesh(dev, params=None, mcfg=None, *, batch=8, prompt_len=128,
             steps=16, check_layers=4, dryrun=True):
    """The ``vsn`` MoE over ``MOE_MESH_SHARDS`` expert shards of a host
    mesh (``launch.mesh.make_host_mesh(1, 4)``: on one card the shards,
    16 experts each, time-share it), at deepseek-moe-16b's full width and
    depth in bfloat16 (``mcfg``, by default ``get_config``'s) with the
    weights ``serve_deepseek_moe_16b`` drew (seed 0; drawn here when the
    phase runs alone).  ``batch`` prompts of ``prompt_len`` tokens, then
    ``steps`` decode steps, through ``model.prefill_with_cache`` and
    ``decode_step``: first with no mesh (greedy), then under the mesh fed
    the same tokens, with the kernel launches counted and the copies
    between devices recorded.  Checks of the mesh run: at every MoE layer
    of every forward, ``dropped`` equal to the one-shard dispatch's on
    the same input (the shards take the same tokens) and the output
    within ``MOE_MESH_LAYER_RTOL``; ``flash_attention`` launched once a
    layer a forward; no byte copied between devices on one card; the
    first tokens equal to the no-mesh run's but at a near tie
    (``MOE_MESH_TIE_RTOL``, at least one row past it); the logits'
    relative gap to the no-mesh run's within ``MOE_MESH_LOGITS_RTOL`` at
    the median forward.  The runs' hidden states differ by the bfloat16
    sums, so a route at a near tie may differ between them and their
    per-forward ``dropped`` is reported, not held.  A float32 copy cut
    to ``check_layers`` layers (full width, drawn from seed 3) under the
    same mesh, a prefill and two decode steps, card against CPU: each
    MoE layer fed the card's input
    (``dropped`` equal, the output within ``MOE_MESH_LAYER_RTOL``) and
    the whole forwards' logits within ``MOE_MESH_LAYER_RTOL`` of their
    largest value (2^-7 without the mesh): the vsn sum's bfloat16
    rounding, the reference's, turns float32 differences into bfloat16
    steps, so 1e-4 cannot hold.  Reported: decode-step ms p50 with 4
    shards and with one (8 steps after a prefill), the device operations
    a step of each, the peak GB, the bytes copied between devices, and
    the dry-run of ``deepseek_moe_16b decode_32k`` on the single-pod
    placeholder mesh (the ``vsn`` MoE under ``local_map``)."""
    import contextlib
    from repro_torch.configs import canon, get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import (collective_bytes, make_host_mesh,
                                         record_copies)
    from repro_torch.models import model as M, sharding, transformer
    from repro_torch.models.moe import moe_forward
    from repro_torch.tree import tree_map
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if mcfg is None:
        mcfg = get_config(canon("deepseek-moe-16b"))
    if params is None:
        params = transformer.init_params(mcfg, seed=0, device=dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_host_mesh(1, MOE_MESH_SHARDS, dev)
    devices = sum(mesh.devices, ())
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(
        1, mcfg.vocab, (batch, prompt_len))).to(dev)
    timed_steps = 8
    max_seq = prompt_len + max(steps, timed_steps + 4)
    clock = [time.perf_counter()]
    split = {}

    def lap(name):
        split[name] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()
    one_logits, toks, one_drop = _moe_mesh_run(mcfg, params, prompts, steps,
                                               max_seq, dev)
    lap("one_shard_run")
    if len(set(devices)) > 1:
        # the shards' experts move to their cards on first use: before
        # the copies are recorded
        _moe_mesh_run(mcfg, params, prompts[:, :8], 0, max_seq, dev, mesh)
    # each MoE layer also against the one-shard dispatch on its input,
    # which launches no kernel and copies nothing between devices
    layers = []
    dispatch.reset_launches()
    with record_copies() as copies:
        mesh_logits, _, mesh_drop = _moe_mesh_run(
            mcfg, params, prompts, steps, max_seq, dev, mesh, toks,
            layer_check=(layers, None))
    launches = {k.name: k.launches for k in dispatch.registered().values()
                if k.launches}
    moved = collective_bytes(copies, devices)
    lap("mesh_run")
    forwards = steps + 1
    gaps = [float((a - b).abs().max())
            for a, b in zip(one_logits, mesh_logits)]
    rel = [float((a - b).norm() / a.norm())
           for a, b in zip(one_logits, mesh_logits)]
    scale = float(one_logits[0].abs().max())
    top2 = one_logits[0].topk(2, dim=-1).values
    first = one_logits[0].argmax(-1), mesh_logits[0].argmax(-1)
    row_gap = (one_logits[0] - mesh_logits[0]).abs().amax(-1).tolist()
    if cuda:
        assert launches.get("flash_attention") == mcfg.n_layers * forwards, \
            launches
        if len(set(devices)) == 1:
            assert not moved, moved
    assert len(layers) == mcfg.n_layers * forwards, len(layers)
    assert all(d == d1 for d, d1, _ in layers), \
        [(i, d, d1) for i, (d, d1, _) in enumerate(layers) if d != d1]
    assert max(g for _, _, g in layers) <= MOE_MESH_LAYER_RTOL, layers
    # a first token may differ only at a near tie of the no-mesh run; at
    # least one row must be past it
    tie = (top2[:, 0] - top2[:, 1]) <= MOE_MESH_TIE_RTOL * scale
    assert not bool(tie.all()), ("every first token at a near tie", top2)
    assert bool(((first[0] == first[1]) | tie).all()), (
        "first tokens differ with the expert shards", first, top2)
    assert statistics.median(rel) <= MOE_MESH_LOGITS_RTOL, rel
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None

    def timed(m):
        caches, states = transformer.init_caches(mcfg, batch, max_seq,
                                                 device=dev)
        ctx = sharding.use_rules(m) if m else contextlib.nullcontext()
        step = lambda i: M.decode_step(params, caches, states, toks[i % len(
            toks)], prompt_len + i, cfg=mcfg)
        with ctx, torch.no_grad():
            M.prefill_with_cache(params, prompts, caches, states, cfg=mcfg)
            prof = device_profile(step, 4, cpu_ops=False)
            ms = []
            for i in range(4, 4 + timed_steps):
                sync()
                t0 = time.perf_counter()
                step(i)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        return prof, ms
    prof, ms = {}, {}
    for name, m in (("shards", mesh), ("one", None)):
        prof[name], ms[name] = timed(m)
    del one_logits, mesh_logits
    _free_card(dev)
    lap("timed")

    # float32, full width, check_layers layers, under the mesh, card
    # against CPU: each MoE layer on the card's input, and whole forwards
    cfg32 = dataclasses.replace(mcfg, dtype="float32", n_layers=check_layers)
    p32 = transformer.init_params(cfg32, seed=3, device=dev)
    cpu = torch.device("cpu")
    h32 = tree_map(lambda t: t.to(cpu), p32)
    twins = {id(a["moe"]): b["moe"] for a, b in zip(p32["layers"],
                                                     h32["layers"])}
    cpu_mesh = make_host_mesh(1, MOE_MESH_SHARDS, cpu)

    def on_cpu(p, x, cfg, kw):
        with sharding.use_rules(cpu_mesh):
            return moe_forward(twins[id(p)], x.cpu(), cfg, **kw)
    toks2 = [t.cpu() for t in toks[:2]]

    def f32_gap(card, host):
        scale = max(float(b.abs().max()) for b in host)
        gap = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(card, host))
        return gap, scale
    f32_layers = []
    card, _, card_drop = _moe_mesh_run(cfg32, p32, prompts, 2, max_seq, dev,
                                       mesh, toks[:2],
                                       layer_check=(f32_layers, on_cpu))
    host, _, host_drop = _moe_mesh_run(cfg32, h32, prompts.cpu(), 2, max_seq,
                                       cpu, cpu_mesh, toks2)
    f32, f32_scale = f32_gap(card, host)
    card1, _, _ = _moe_mesh_run(cfg32, p32, prompts, 2, max_seq, dev, None,
                                toks[:2])
    host1, _, _ = _moe_mesh_run(cfg32, h32, prompts.cpu(), 2, max_seq, cpu,
                                None, toks2)
    f32_one, f32_one_scale = f32_gap(card1, host1)
    assert len(f32_layers) == check_layers * 3, len(f32_layers)
    assert all(d == d1 for d, d1, _ in f32_layers), f32_layers
    assert max(g for _, _, g in f32_layers) <= MOE_MESH_LAYER_RTOL, \
        f32_layers
    assert f32 <= MOE_MESH_LAYER_RTOL * f32_scale, (f32, f32_scale)
    assert f32_one <= 2.0 ** -7 * f32_one_scale, (f32_one, f32_one_scale)
    del p32, h32, twins, card, host, card1, host1
    _free_card(dev)
    lap("float32_copy")

    out = dict(phase="moe_mesh", arch=mcfg.name, layers=mcfg.n_layers,
               experts=mcfg.moe.n_experts, shards=MOE_MESH_SHARDS,
               devices=[str(d) for d in devices],
               batch=batch, prompt_len=prompt_len, decode_steps=steps,
               first_tokens_equal=int((first[0] == first[1]).sum()),
               first_tokens_top2_gap=(top2[:, 0] - top2[:, 1]).tolist(),
               first_tokens_near_tie=int(tie.sum()),
               prefill_row_max_abs_gap=row_gap,
               logits_max_abs=scale,
               dropped={"shards": mesh_drop, "one": one_drop},
               layer_dropped_equal=len(layers),
               layer_max_rel_gap=max(g for _, _, g in layers),
               logits_rel_gap=rel, logits_rel_gap_median=statistics.median(
                   rel), logits_rel_gap_max=max(rel),
               logits_rtol=MOE_MESH_LOGITS_RTOL,
               prefill_logits_max_abs_gap=gaps[0],
               logits_max_abs_gap=max(gaps),
               decode_ms_p50={k: statistics.median(v)
                              for k, v in ms.items()},
               device_ops_per_step={
                   k: v["device_ops_per_tick"] for k, v in prof.items()},
               profile=prof, peak_gb=peak_gb,
               bytes_between_devices=moved.get("device-to-device", 0),
               copies_between_devices=sum(
                   1 for src, dst, _ in copies if src != dst),
               seconds_by_part=split,
               float32_copy=dict(
                   layers=check_layers, moe_layers_checked=len(f32_layers),
                   layer_max_rel_gap=max(g for _, _, g in f32_layers),
                   dropped=card_drop, host_dropped=host_drop,
                   logits_max_abs=f32_scale, logits_max_abs_gap=f32,
                   logits_max_abs_gap_one_shard=f32_one),
               launches=launches)
    if dryrun:
        from repro_torch.launch import dryrun as D
        t0 = time.perf_counter()
        cell = D.run_cell("deepseek_moe_16b", "decode_32k", False)
        cell["seconds"] = time.perf_counter() - t0
        out["dryrun"] = cell
        print(D.row(cell), flush=True)
        if cell["status"] != "ok":
            raise AssertionError(f"dry-run cell: {cell['status']}")
    print(f"moe_mesh decode ms p50: {MOE_MESH_SHARDS} shards "
          f"{out['decode_ms_p50']['shards']:.3f}, 1 shard "
          f"{out['decode_ms_p50']['one']:.3f}", flush=True)
    print(f"moe_mesh device ops a step: {MOE_MESH_SHARDS} shards "
          f"{out['device_ops_per_step']['shards']}, 1 shard "
          f"{out['device_ops_per_step']['one']}", flush=True)
    print(f"moe_mesh peak GB: {peak_gb}", flush=True)
    return out


def join_emit_alone() -> int:
    """``--join-emit``: ``check_window_join_emit`` and ``q3_persistent``
    alone, the kernels built first."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    import repro_torch.kernels.scalegate_merge.ops      # noqa: F401
    import repro_torch.kernels.window_join.ops          # noqa: F401
    build.build()
    build.library()
    dev = torch.device("cuda", 0)
    for check in (check_window_join_emit, q3_persistent):
        t0 = time.perf_counter()
        out = check(dev)
        out["seconds"] = time.perf_counter() - t0
        emit(out)
    return 0


def serve_alone(arch: str) -> int:
    """``--serve ARCH``: one serve phase alone at the default run's
    arguments for ``arch`` (``SERVE_ALONE``), the kernels built first."""
    if arch not in SERVE_ALONE:
        print(f"chip_smoke: --serve takes one of {sorted(SERVE_ALONE)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    import repro_torch.kernels.flash_attention.ops      # noqa: F401
    import repro_torch.kernels.linear_scan.ops          # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    t0 = time.perf_counter()
    out = serve_full_width(torch.device("cuda", 0), arch,
                           **SERVE_ALONE[arch])
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return 0


def moe_mesh_alone() -> int:
    """``--moe-mesh``: the ``moe_mesh`` phase alone, the kernels built
    first; its shards go round-robin over the visible cards (one a card on
    a four-card machine)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    import repro_torch.kernels.flash_attention.ops      # noqa: F401
    import repro_torch.kernels.linear_scan.ops          # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    t0 = time.perf_counter()
    out = moe_mesh(torch.device("cuda", 0))
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return 0


# ---------------------------------------------------------------------------
# phase 23: training hymba-1.5b at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARGS = ("--arch", "hymba-1.5b", "--batch", "8", "--seq", "128")
TRAIN_LINES = ("arch=", "resumed from", "step ", "done")
STEP_LINE = re.compile(r"step (\d+) loss=(\S+) gnorm=(\S+) tok/s=(\d+)")
# bf16: one microbatch's gradient through the kernels against the same
# through the plain versions on the card at the first 4, 8, 16 and 32
# layers (``train_bf16_grads``): each leaf's relative distance within
# twice the largest the card read at step 10 (0.0200, 0.0441, 0.1226,
# 0.2537, the same bits on repeats); the controls read 1.0 (attention's
# dV zeroed) and 0.586-0.658 (the scan's dv zeroed) at every depth
TRAIN_BF16_LEAF = {4: 0.04, 8: 0.09, 16: 0.25, 32: 0.5}
# the float32 4-layer copy, card (kernels) against CPU (plain versions):
# loss and gradient norm relative, each gradient within a share of its
# leaf's largest magnitude, the parameters within 2.5 lr of each other
# and within 1e-6 on all but a share of their elements
TRAIN_F32 = dict(loss_rtol=1e-5, gnorm_rtol=1e-4, grad_rtol=1e-3,
                 param_share=1e-3)


def _step_lines(run) -> dict:
    """step -> (loss, gnorm, tok/s) of a train launcher's printed lines."""
    out = {}
    for ln in run["summary"]:
        m = STEP_LINE.match(ln)
        if m:
            out[int(m.group(1))] = (float(m.group(2)), float(m.group(3)),
                                    int(m.group(4)))
    return out


def _leaf_rel(got, want) -> float:
    """||got - want|| / ||want|| in float32 (0 when both are zero)."""
    g, w = got.float(), want.float()
    den = float(w.norm())
    return float((g - w).norm()) / den if den else float(g.norm())


def _with_launchers(fn, swap):
    """``fn()`` with the CUDA launcher of each kernel named in ``swap``
    replaced by ``swap[name]`` (a plain version, or a control's broken
    kernel).  A comparison, not the main path: each kernel's launch count
    is put back as it was before."""
    from repro_torch.kernels import dispatch
    reg = dispatch.registered()
    saved = {n: (reg[n].cuda, reg[n].launches) for n in swap}
    try:
        for n, f in swap.items():
            reg[n].cuda = f
        return fn()
    finally:
        for n, (f, count) in saved.items():
            reg[n].cuda, reg[n].launches = f, count


def _dropping(name, i):
    """A control: kernel ``name``'s launcher with its output ``i`` (one
    gradient) zeroed, as ``_with_launchers``' ``swap``."""
    from repro_torch.kernels import dispatch
    launch = dispatch.registered()[name].cuda

    def broken(*a, **kw):
        out = list(launch(*a, **kw))
        out[i] = torch.zeros_like(out[i])
        return tuple(out)
    return {name: broken}


def train_launchers(dev, ck, steps=(10, 20), every=10, reduced=False):
    """``python -m repro_torch.launch.train`` (``TRAIN_ARGS``) for
    ``steps[0]`` steps with a checkpoint every ``every`` into ``ck``, then
    the same directory on to ``steps[1]``, each a process of its own with
    two CPU threads -> their ``run_launcher`` results, which
    ``train_hymba_1_5b`` checks.  ``main`` runs them beside the
    ``launchers`` phase, whose processes are host-bound and hold little
    of the card's memory."""
    on_card = torch.device(dev).type == "cuda"
    where = ([] if on_card else ["--device", "cpu"]) + (
        ["--reduced"] if reduced else [])
    return [run_launcher("train", [*TRAIN_ARGS, "--steps", str(n),
                                   "--ckpt-every", str(every),
                                   "--ckpt-dir", ck, *where],
                         timeout=600, prefixes=TRAIN_LINES, threads=2)
            for n in steps]


def train_hymba_1_5b(dev, runs, ck, steps=(10, 20), every=10,
                     check_layers=4, reduced=False):
    """``python -m repro_torch.launch.train`` on hymba-1.5b at full width
    and depth (32 layers, bf16, random parameters from seed 0), batch 8 of
    128 tokens in 8 microbatches, each run a process of its own on the
    card (``runs``, ``train_launchers``' results for the directory
    ``ck``): ``steps[0]`` steps with a checkpoint every ``every``, then
    the same directory on to ``steps[1]`` (``resumed from step 10``).  A
    checkpoint of hymba's ``(params, opt)`` is ~12.6 GB; to keep the
    script's disk writes under ~30 GB, the launchers save every 10 steps
    (two checkpoints) and the in-process round trip saves a cut of the
    restored state to ``check_layers`` layers.  Checks: the printed losses and gradient norms finite, the
    last step's loss below the first's; each process's launches per step,
    flash_attention and linear_scan 2 x 32 x 8 (forward, and the
    recompute of non-reentrant checkpointing per block) and their
    backward kernels 32 x 8.  Then in this process: step 10 restored from
    the launchers' directory, saved again in the reference's layout (cut
    to ``check_layers`` layers) and restored bit for bit; one forward (no
    gradient) on the batch ``default_rng(10)`` draws first, whose loss
    prints as the resumed process's step-11 loss; a few steps timed (p50
    ms, tokens/s, peak GB) and one profiled (device operations, host
    syncs, busy share); a float32 copy cut to ``check_layers`` layers at
    full width, one ``train_step`` (2 microbatches of one row) on the
    card against the CPU's plain path (``TRAIN_F32``); and one
    microbatch's bf16 gradient through the kernels against the same
    through the plain versions on the card (``train_bf16_grads``).
    ``dev="cpu"`` with ``reduced=True`` (and ``train_launchers`` run so)
    rehearses the phase on the CPU at the reduced config (the launch
    counts and peak memory are the card's only)."""
    import tempfile
    from repro_torch.configs import canon, get_config
    from repro_torch.data import datagen
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as TL
    from repro_torch.configs import reduced as reduce_cfg
    from repro_torch.models import model as M, transformer
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    cfg = get_config(canon(TRAIN_ARGS[1]))
    if reduced:
        cfg = reduce_cfg(cfg)
    batch_n, seq = int(TRAIN_ARGS[3]), int(TRAIN_ARGS[5])
    m, layers = cfg.n_microbatches, cfg.n_layers
    out = dict(phase="train_hymba_1_5b", arch=cfg.name, layers=layers,
               batch=batch_n, seq=seq, microbatches=m, steps=list(steps),
               ckpt_every=every)
    secs = {}                                # where the phase's time goes
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - t_mark[0]
        t_mark[0] = now

    with tempfile.TemporaryDirectory() as d:
        printed = [_step_lines(r) for r in runs]
        # the reference's cadence: the first step of a run and every 10th
        for got, (lo, hi) in zip(printed, ((0, steps[0]), steps)):
            want = [s for s in range(lo + 1, hi + 1)
                    if s % 10 == 0 or s == lo + 1]
            assert sorted(got) == want, (got, want)
        assert f"resumed from step {steps[0]}" in runs[1]["summary"], runs[1]
        assert all(r["summary"][-1] == "done" for r in runs), runs
        every_step = {**printed[0], **printed[1]}
        assert all(math.isfinite(l) and math.isfinite(g)
                   for l, g, _ in every_step.values()), every_step
        assert every_step[steps[1]][0] < every_step[1][0], every_step
        per_step = {"flash_attention": 2 * layers * m,
                    "linear_scan": 2 * layers * m,
                    "flash_attention_bwd": layers * m,
                    "linear_scan_bwd": layers * m}
        for r, n in zip(runs, (steps[0], steps[1] - steps[0])):
            got = {k: r["launches"].get(k, 0) for k in per_step}
            if on_card:
                assert got == {k: n * v for k, v in per_step.items()}, got
        out.update(printed={s: dict(loss=l, gnorm=g, tok_s=t)
                            for s, (l, g, t) in sorted(every_step.items())},
                   runs=[dict(argv=r["argv"], seconds=r["seconds"],
                              launches=r["launches"]) for r in runs],
                   launches_per_step=per_step)

        # in this process: step 10 restored from the launchers' directory
        params = transformer.init_params(cfg, seed=0, device=dev)
        opt = adamw.init_opt(params)
        params, opt = TL.restore(ck, steps[0], cfg, params, opt, dev)
        assert int(opt.step) == steps[0]
        mark("restore")
        # the round trip on the restored state's first check_layers layers
        cut = dataclasses.replace(cfg, n_layers=check_layers)
        keep = lambda t: {**t, "layers": t["layers"][:check_layers]}
        part = (keep(params), adamw.OptState(keep(opt.mu), keep(opt.nu),
                                             opt.step))
        again = str(pathlib.Path(d) / "again")
        TL.save(again, steps[0], cut, *part, async_=False)
        back = TL.restore(again, steps[0], cut, *part, dev)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(part),
                                                     tree_leaves(back)))
        del part, back
    out["save_restore_bitwise"] = dict(layers=check_layers, bitwise=True)
    mark("round_trip")

    timed_steps = 2                     # after a warm-up; then one profiled
    batches = datagen.token_batches(np.random.default_rng(steps[0]),
                                    vocab=cfg.vocab, batch=batch_n, seq=seq,
                                    n_batches=timed_steps + 2)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in batches]
    first = batches[0]
    positions = torch.arange(seq, device=dev)
    mb = batch_n // m
    with torch.no_grad():
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(m):
            rows = slice(i * mb, (i + 1) * mb)
            loss = loss + transformer.loss_fn(
                params, cfg, first["inputs"][rows], first["labels"][rows],
                first["mask"][rows], positions)[0]
        forward_loss = f"{float(loss / m):.4f}"
    printed_11 = f"{every_step[steps[0] + 1][0]:.4f}"
    assert forward_loss == printed_11, (forward_loss, printed_11)
    out["restored_forward_loss"] = dict(forward=forward_loss,
                                        printed=printed_11)
    mark("forward")

    # timed and profiled steps from the restored state
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=steps[1],
                                warmup_steps=max(steps[1] // 20, 1))
    state = [params, opt]

    def step(i):
        state[0], state[1], met = M.train_step(state[0], state[1],
                                               batches[1 + i % timed_steps],
                                               cfg=cfg, opt_cfg=opt_cfg)
        return met

    step(0)                                                  # warm-up
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i in range(timed_steps):
        t0 = time.perf_counter()
        float(step(i)["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(walls)
    out["steps_timed"] = dict(
        ms=walls, p50_ms=p50, tokens_per_s=batch_n * seq / p50 * 1e3,
        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if on_card
                 else None))
    out["profile"] = device_profile(lambda i: float(step(i)["loss"]), 1,
                                    kernel="_bwd", cpu_ops=False)
    del opt, state
    _free_card(dev)
    mark("timed_steps")
    out["float32_copy"] = train_f32_copy(dev, cfg, check_layers, seq)
    mark("float32_copy")
    out["bf16_grads"] = train_bf16_grads(
        params, cfg, {k: v[:mb] for k, v in first.items()}, positions)
    del params
    _free_card(dev)
    mark("bf16_grads")
    out["seconds_by_part"] = secs
    out["launches"] = {name: sum(r["launches"].get(name, 0) for r in runs)
                       for name in dispatch.registered()}
    return out


def _grads(params, cfg, batch, positions):
    """``loss_fn``'s gradients at ``params`` (leaf order) on ``batch``."""
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    loss, _ = transformer.loss_fn(live, cfg, batch["inputs"],
                                  batch["labels"], batch["mask"], positions)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_bf16_grads(params, cfg, batch, positions):
    """One microbatch's bf16 gradient through the kernels (``g_k``)
    against the same through the plain versions on the card (``g_p``),
    at the first L layers of ``params`` (full width) for each L of
    ``TRAIN_BF16_LEAF``: every leaf's ||g_k - g_p|| / ||g_p|| within the
    depth's limit.  Two controls must fail that check at every depth:
    ``flash_attention_bwd`` with its dV zeroed and ``linear_scan_bwd``
    with its dv zeroed.  The witness that bf16 rounding, not a kernel,
    sets the distance: each path's whole gradient against the float32
    gradient (``g_32``, through the kernels, which hold their plain
    versions to 2e-5 in float32), E_k and E_p, at each depth; they grow
    with depth alike."""
    import dataclasses as dc
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_map
    plain = {n: k.plain for n, k in dispatch.registered().items()}
    controls = {"attention_dv_zeroed": ("flash_attention_bwd", 2),
                "scan_dv_zeroed": ("linear_scan_bwd", 2)}
    whole = lambda gs, ref: math.sqrt(
        sum(float((g.float() - c.float()).square().sum())
            for g, c in zip(gs, ref))
        / sum(float(c.float().square().sum()) for c in ref))
    res = {}
    for n_layers, limit in TRAIN_BF16_LEAF.items():
        cut = dc.replace(cfg, n_layers=n_layers)
        p = {**params, "layers": params["layers"][:n_layers]}
        grads = lambda c=cut, q=p: _grads(q, c, batch, positions)[1]
        _, g_32 = _grads(tree_map(lambda x: x.float(), p),
                         dc.replace(cut, dtype="float32"), batch, positions)
        g_p = _with_launchers(grads, plain)
        g_k = grads()
        kp = [_leaf_rel(a, b) for a, b in zip(g_k, g_p)]
        at = dict(leaves=len(kp), limit=limit, kernel_vs_plain_max=max(kp),
                  kernel_vs_plain_median=statistics.median(kp),
                  worst_leaf=int(max(range(len(kp)), key=kp.__getitem__)),
                  all_rel_kernel=whole(g_k, g_32),
                  all_rel_plain=whole(g_p, g_32))
        del g_k, g_32
        for name, (kernel, i) in controls.items():
            bad = [_leaf_rel(a, b) for a, b in zip(
                _with_launchers(grads, _dropping(kernel, i)), g_p)]
            at[name] = dict(max=max(bad), leaves_past_limit=sum(
                x > limit for x in bad))
        del g_p
        res[n_layers] = at
    emit(dict(phase="train_hymba_1_5b.bf16_grads", depths=res))
    for n_layers, at in res.items():
        if not at["kernel_vs_plain_max"] <= at["limit"]:    # NaN fails too
            raise AssertionError(f"train bf16 gradients at {n_layers} "
                                 f"layers: kernels against plain past the "
                                 f"limit: {at}")
        for name in controls:
            if not at[name]["leaves_past_limit"]:
                raise AssertionError(f"train bf16 gradients at {n_layers} "
                                     f"layers: the control {name} passed "
                                     f"the check: {at}")
    return res


def train_f32_copy(dev, cfg, n_layers, seq):
    """A float32 copy of ``cfg`` cut to ``n_layers`` at full width, 2
    microbatches of one row: one microbatch's gradients and one
    ``train_step`` on ``dev`` (the kernels) against the same on the CPU
    (the plain versions), within ``TRAIN_F32``."""
    from repro_torch.data import datagen
    from repro_torch.models import model as M, transformer
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers,
                                n_microbatches=2)
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg32, seed=1, device=dev)
    params_cpu = tree_map(lambda x: x.to(cpu), params)
    batch = next(datagen.token_batches(np.random.default_rng(3),
                                       vocab=cfg.vocab, batch=2, seq=seq,
                                       n_batches=1))
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=1)

    def grads(p, where):
        b = {k: torch.from_numpy(v[:1]).to(where) for k, v in batch.items()}
        return _grads(p, cfg32, b, torch.arange(seq, device=where))

    def one_step(p, where):
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        return M.train_step(p, adamw.init_opt(p), b, cfg=cfg32,
                            opt_cfg=opt_cfg)

    lk, gk = grads(params, dev)
    lc, gc = grads(params_cpu, cpu)
    grad_err = max(float((a.cpu() - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(gk, gc))
    del gk, gc
    pk, _, mk = one_step(params, dev)
    pc, _, mc = one_step(params_cpu, cpu)
    lr = float(mc["lr"])
    past = total = 0
    worst = 0.0
    for a, b in zip(tree_leaves(pk), tree_leaves(pc)):
        diff = (a.cpu() - b).abs()
        worst = max(worst, float(diff.max()))
        past += int((diff > 1e-6).sum())
        total += diff.numel()
    res = dict(layers=n_layers, loss_card=float(lk), loss_cpu=float(lc),
               grad_max_err_share=grad_err,
               step_loss=(float(mk["loss"]), float(mc["loss"])),
               step_gnorm=(float(mk["grad_norm"]), float(mc["grad_norm"])),
               param_max_err=worst, param_share_past_1e6=past / total,
               lr=lr, limits=TRAIN_F32)
    lim = TRAIN_F32
    ok = (abs(float(lk) - float(lc)) <= lim["loss_rtol"] * abs(float(lc))
          and grad_err <= lim["grad_rtol"]
          and abs(float(mk["loss"]) - float(mc["loss"]))
          <= lim["loss_rtol"] * abs(float(mc["loss"]))
          and abs(float(mk["grad_norm"]) - float(mc["grad_norm"]))
          <= lim["gnorm_rtol"] * float(mc["grad_norm"])
          and worst <= 2.5 * lr and past <= lim["param_share"] * total)
    if not ok:
        raise AssertionError(f"train float32 copy: card != CPU: {res}")
    del params, params_cpu, pk, pc
    _free_card(dev)
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if argv[:1] == ["--scan-turns"]:
        print(card_line(), flush=True)
        scan_turns(argv[1], argv[2:])
        return 0
    if argv[:1] == ["--drill-times"]:
        print(card_line(), flush=True)
        drill_times()
        return 0
    if argv[:1] == ["--moe-mesh"]:
        print(card_line(), flush=True)
        return moe_mesh_alone()
    if argv[:1] == ["--join-emit"]:
        print(card_line(), flush=True)
        return join_emit_alone()
    if argv[:1] == ["--serve"]:
        print(card_line(), flush=True)
        return serve_alone(argv[1] if len(argv) == 2 else "")
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

    t0 = time.perf_counter()
    rows = [check_scalegate_merge(dev), check_scalegate_merge_stacked(dev),
            check_segment_aggregate(dev), check_window_join(dev),
            check_window_join_emit(dev), check_flash_attention(dev),
            check_linear_scan(dev),
            check_flash_attention_bwd(dev), check_linear_scan_bwd(dev)]
    emit(dict(phase="kernels", seconds=time.perf_counter() - t0,
              kernels=rows))

    # The main path: each pipeline phase zeroes the counts right before its
    # card run and reads them right after it; the processes of the
    # launchers and of the training phase report their own counts.
    import concurrent.futures
    import tempfile
    phases = []

    def phase(run):
        t0 = time.perf_counter()
        phases.append(run(dev))
        phases[-1]["seconds"] = time.perf_counter() - t0
        emit(phases[-1])

    for run in (q1_wordcount, q3_scalejoin, q1_persistent, q3_persistent,
                q1_ingest_tier, q1_recovery, q1_mesh, q1_mesh_persistent,
                general_mesh, q3_mesh, q1_mesh_recovery):
        phase(run)
    with tempfile.TemporaryDirectory() as d, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        # phase 23's two training processes run beside the launchers
        # phase's, which are host-bound and hold little of the card's
        # memory; the serving phases start once both are done
        ck = str(pathlib.Path(d) / "ck")
        trained = pool.submit(train_launchers, dev, ck)
        phase(launchers)
        runs = trained.result()
        kept = {}
        for arch, kw in SERVE_ARGS.items():
            moe = arch == "deepseek-moe-16b"
            phase(functools.partial(serve_full_width, arch=arch,
                                    keep=kept if moe else None, **kw))
            if moe:
                # the model mesh over the weights the serve phase drew
                phase(lambda dev: moe_mesh(dev, kept.pop("params"),
                                           kept.pop("cfg")))
        phase(lambda dev: train_hymba_1_5b(dev, runs, ck))
    launches = {name: sum(ph["launches"].get(name, 0) for ph in phases)
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
                             "decode_split_ms", "deepseek", "hymba",
                             "served",
                             "rwkv6", "limit_used", "bitwise_repeat",
                             "push_cases",
                             "max_abs_err_bf16", "kernels_per_call",
                             "hot_cell_hits", "even", "q3",
                             "no_hits_device_ms", "all_rows", "no_rows")
                 if k in r})
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
