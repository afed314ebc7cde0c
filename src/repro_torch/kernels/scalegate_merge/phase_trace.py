"""Where the cluster merge's time goes: a phase trace on the card.

    python -m repro_torch.kernels.scalegate_merge.phase_trace [name=file.cu ...]

Each source (default: ``csrc/scalegate_merge.cu``) is copied with a stamp
of ``clock64`` and ``%globaltimer`` by thread 0 of every block at the
cluster kernel's phase boundaries (its numbered step comments), built with
``nvcc`` into ``build/repro_torch/trace/`` and run at the main path's
shapes, each at the plan's cluster size and at 16 blocks (22,536 lanes at
every size from 6 to 16).  One JSON line per (source, shape, cluster):
device µs per call (torch.profiler, median of 50) and the nanoseconds
block 0 spent in each phase: loads and counts, compaction, the block's
sort, its store and the first cluster barrier, the watermark, the cluster
rounds, the emit.  Sources are compared in one run, on one card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build

STAMP = r'''
__device__ unsigned long long g_trace[16][16];
#define STAMP(j) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_trace[blockIdx.x][j] = clock64(); g_trace[blockIdx.x][8 + j] = t_; }
'''
# (text in the kernel, stamp, before or after it)
ANCHORS = (("  const bool flat = g.reports == nullptr;\n", 0, False),
           ("  // 2. ", 1, True), ("  // 3. ", 2, True),
           ("  __syncthreads();                 // the last round's", 3, True),
           ("  // 4. ", 4, True), ("  // 5. ", 5, True), ("  // 6. ", 6, True),
           ("  if (rank == 0 && tid == 0) wmark[0] = w;\n", 7, False))
PHASES = ("load_count", "compact", "block_sort", "store_sync", "watermark",
          "cluster_rounds", "emit")


def instrument(text: str) -> str:
    text = text.replace("namespace {\n", STAMP + "namespace {\n", 1)
    for anchor, j, before in ANCHORS:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor {anchor!r} is not unique")
        stamp = f"  STAMP({j});\n"
        text = text.replace(anchor, stamp + anchor if before
                            else anchor + stamp)
    return text + ('\nextern "C" int read_trace(void* h) {\n  return '
                   'static_cast<int>(cudaMemcpyFromSymbol(h, g_trace, '
                   'sizeof(g_trace)));\n}\n')


def compile_all(sources: dict) -> dict:
    out = build.build_root() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(instrument(pathlib.Path(path).read_text()))
        so = out / f"lib{name}.so"
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("repro_scalegate_merge", "repro_scalegate_merge_stacked"):
            getattr(lib, fn).argtypes = list(build.PROTOTYPES[fn])
        lib.read_trace.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def shapes(dev):
    """(label, tau, valid, flat) at the main path's sizes: sorted taus, all
    valid but the last lane or the ingest root's valid share."""
    g = np.random.default_rng(0)
    for n, share, flats in ((4097, None, (True, False)),
                            (22536, None, (True, False)),
                            (22536, 2048 / 22536, (True, False)),
                            (12288, 0.5, (False,)), (20480, 0.6, (False,)),
                            (12288, 2048 / 12288, (False,))):
        tau = torch.as_tensor(np.sort(g.integers(0, 5 * n, n))
                              .astype(np.int32), device=dev)
        valid = torch.as_tensor(g.random(n) < share if share
                                else np.arange(n) < n - 1, device=dev)
        for flat in flats:
            yield (f"{'flat' if flat else 'stacked'} N {n}, "
                   f"{int(valid.sum())} valid"), tau, valid, flat


def main(argv) -> int:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.scalegate_merge.ops import MAX_CLUSTER, plan
    sources = dict(a.split("=", 1) for a in argv) or {
        "kernel": build.CSRC / "scalegate_merge.cu"}
    libs = compile_all(sources)
    dev = torch.device("cuda", 0)
    src = torch.zeros(32768, dtype=torch.int32, device=dev)
    reports = torch.full((8,), 1 << 30, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, tau, valid, flat in shapes(dev):
        n = tau.numel()
        order, ready = (torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(2))
        wmark = torch.empty(1, dtype=torch.int32, device=dev)
        want = torch.argsort(torch.where(valid, tau, 2 ** 31 - 1),
                             stable=True).int()
        sizes = (range(-(-n // 4096), MAX_CLUSTER + 1) if n == 22536
                 else sorted({plan(n).cluster, MAX_CLUSTER}))
        for name, lib in libs.items():
            for c in sizes:
                def call():
                    rc = (lib.repro_scalegate_merge(
                        tau.data_ptr(), src.data_ptr(), valid.data_ptr(), n,
                        1, None, c, None, order.data_ptr(), ready.data_ptr(),
                        wmark.data_ptr(), stream) if flat else
                        lib.repro_scalegate_merge_stacked(
                            tau.data_ptr(), valid.data_ptr(), n,
                            reports.data_ptr(), 8, c, None, order.data_ptr(),
                            ready.data_ptr(), wmark.data_ptr(), stream))
                    build.raise_on_error("scalegate_merge", rc)
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                if not torch.equal(order, want):
                    raise AssertionError(f"{name} {label} cluster {c}: order")
                us = []
                while not us:         # a session may record no device work
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(50):
                            call()
                        torch.cuda.synchronize()
                    us = [e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                trace = np.zeros((16, 16), np.uint64)
                build.raise_on_error("read_trace",
                                     lib.read_trace(trace.ctypes.data))
                ns = np.diff(trace[0, 8:].astype(np.int64))
                print(json.dumps(dict(
                    source=name, shape=label, cluster=c,
                    device_us=statistics.median(us),
                    phase_ns=dict(zip(PHASES, ns.tolist())))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
