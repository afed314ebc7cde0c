"""Where the two backward kernels' time goes: a phase trace on the card.

    python -m repro_torch.kernels.bwd_trace [flash=file.cu] [scan=file.cu]

Each source (default: ``csrc/flash_attention_bwd.cu`` and
``csrc/linear_scan_bwd.cu``) is copied with a ``clock64`` stamp by thread
0 of one watched block at its phase comments, built with ``nvcc`` into
``build/repro_torch/trace/`` and run at hymba-1.5b's training shapes
(the scan also at rwkv6-7b's).  One JSON line per (kernel, block): the
block's cycles in each phase, summed over its tiles or chunks, and the
device ms a call (torch.profiler, the plain library's kernel).  Then the
scan's device ms over T and BH at hymba's SSM: whether a call is one
block's latency or the card's throughput.  Older sources are compared by
passing them; every anchor must occur once.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build

STAMP = r'''
__device__ long long g_trace[64][2];
__device__ int g_watch;
#define STAMP(tag) if (threadIdx.x == 0 && blockIdx.x == g_watch && \
                       trace_n < 64) { \
  g_trace[trace_n][0] = (tag); g_trace[trace_n][1] = clock64(); ++trace_n; }
'''
# kernel -> (text in the source, stamp, before it; -1: declare the count)
ANCHORS = {
    "flash": (
        ("__device__ void dq_block(const Params& p, unsigned char* sm, "
         "int blk) {\n", -1, False),
        ("  load_tile<D, kRows>(qs, at<bf16>(p.q, p.sq, b, h), p.sq.s, i0, "
         "p.len_q);\n  load_tile<D, kRows>(dos", 0, True),
        ("    const unsigned char* kt = kvs + stage * 2 * KV;", 1, True),
        ("    // dS = P * (dP - D_i) on visible keys", 2, True),
        ("    uint32_t a[BK / 16][4];", 3, True),
        ("  wgmma::cp_async_wait<0>();\n  bf16* out", 4, True),
        ("__device__ void dkv_block(const Params& p, unsigned char* sm, "
         "int blk) {\n", -1, False),
        ("  load_tile<D, kRows>(ks, at<bf16>(p.k, p.sk, b, g)", 10, True),
        ("    const unsigned char* qt = qdo + stage * 2 * QB;", 11, True),
        ("    // P^T and dS^T in place of st and dpt", 12, True),
        ("    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];", 13, True),
        ("  // the shares into shared memory", 14, True),
        ("  // this block's 1 / n_rep of the 8-column pieces", 15, True),
        ("  cluster.sync();                    // no block leaves", 16,
         True)),
    "scan": (
        ("  extern __shared__ __align__(16) float smem[];\n"
         "  cg::cluster_group", -1, True),
        ("  // walk 1: forward from s0", 0, True),
        ("  __syncthreads();                             // the checkpoints",
         1, True),
        ("    const Stage sg = stage(c);\n    float* dvm", 8, True),
        ("    // walk 2, the chain:", 2, True),
        ("    // the u terms' two dot products a step", 3, True),
        ("    // the sums, in a fixed order:", 4, True),
        ("    for (int q = tid; q < n * dvc; q += nt) {", 5, True),
        ("    // dv: the cluster's shares in rank order", 6, True),
        ("  if (a.ds0 != nullptr && col) {", 7, True)),
}
# stamp pairs -> phase
PHASES = {
    "flash": {(0, 1): "first loads", (1, 2): "S and dP products",
              (2, 3): "dS", (3, 1): "dQ product", (3, 4): "dQ product",
              (10, 11): "first loads", (11, 12): "S^T and dP^T products",
              (12, 13): "P^T and dS^T", (13, 11): "dV and dK products",
              (13, 14): "dV and dK products", (14, 15): "shares, barrier",
              (15, 16): "head-order sum"},
    "scan": {(0, 1): "forward walk", (1, 8): "setup", (8, 2): "waits",
             (2, 3): "chain walks", (3, 4): "u terms, barrier",
             (4, 5): "row sums",
             (5, 6): "dv shares", (6, 8): "cluster dv sum",
             (6, 7): "cluster dv sum"},
}


def instrument(text: str, kernel: str) -> str:
    text = text.replace("namespace {\n", STAMP + "namespace {\n", 1)
    for anchor, tag, before in ANCHORS[kernel]:
        if text.count(anchor) != 1:
            raise ValueError(f"{kernel}: anchor {anchor!r} is not unique")
        add = "  int trace_n = 0;\n" if tag < 0 else f"  STAMP({tag});\n"
        text = text.replace(anchor, add + anchor if before
                            else anchor + add)
    return text + ('\nextern "C" int read_trace(void* h) {\n  return '
                   'static_cast<int>(cudaMemcpyFromSymbol(h, g_trace, '
                   'sizeof(g_trace)));\n}\nextern "C" int watch(int b) {\n'
                   '  const long long z[64][2] = {};\n  cudaMemcpyToSymbol('
                   'g_trace, z, sizeof(z));\n  return static_cast<int>('
                   'cudaMemcpyToSymbol(g_watch, &b, sizeof(b)));\n}\n')


def compile_all(sources: dict) -> dict:
    out = build.build_root() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, path in sources.items():
        cu = out / f"{kernel}_bwd.cu"
        cu.write_text(instrument(pathlib.Path(path).read_text(), kernel))
        for header in ("per_device.cuh", "wgmma.cuh"):
            (out / header).write_text((build.CSRC / header).read_text())
        so = out / f"lib{kernel}_bwd.so"
        procs[kernel] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for kernel, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {kernel}:\n{log}")
        lib = ctypes.CDLL(str(so))
        entry = ("repro_flash_attention_bwd" if kernel == "flash"
                 else "repro_linear_scan_bwd")
        getattr(lib, entry).argtypes = list(build.PROTOTYPES[entry])
        lib.read_trace.argtypes = [ctypes.c_void_p]
        lib.watch.argtypes = [ctypes.c_int]
        libs[kernel] = lib
    return libs


def device_ms(call, reps: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile
    call()
    us = []
    while not us:               # a session may record no device work
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / reps / 1e3


def phases(lib, kernel: str, block: int, call) -> dict:
    """Cycles a phase of ``block`` in one traced call."""
    build.raise_on_error("watch", lib.watch(block))
    call()
    torch.cuda.synchronize()
    trace = np.zeros((64, 2), np.int64)
    build.raise_on_error("read_trace", lib.read_trace(trace.ctypes.data))
    rows = [(int(t), int(c)) for t, c in trace if c]
    out = {"total": rows[-1][1] - rows[0][1]}
    for (a, ta), (b, tb) in zip(rows, rows[1:]):
        name = PHASES[kernel].get((a, b), f"{a}->{b}")
        out[name] = out.get(name, 0) + tb - ta
    return out


def flash_calls(lib, dev):
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device=dev).manual_seed(3)
    b, hq, hkv, s, d = 1, 25, 5, 128, 64
    q, k, v, do = (torch.randn(x, generator=gen, device=dev)
                   .to(torch.bfloat16) for x in ((b, hq, s, d),
                                                 (b, hkv, s, d),
                                                 (b, hkv, s, d),
                                                 (b, hq, s, d)))
    o, lse = ops.flash_attention_op(q, k, v, n_rep=5, return_lse=True)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    strides = [x for t in (q, k, v, o, do, dq, dk, dv) for x in t.stride()[:3]]
    args = ops.BWD_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), 0, 0, *strides, b, hq, hkv, s, s, d, 1, 0, 1,
        d ** -0.5, torch.cuda.current_stream(dev).cuda_stream)

    def call():
        build.raise_on_error("flash_attention_bwd",
                             lib.repro_flash_attention_bwd(args))
    # a dQ block and a dK/dV block that each walk two tiles
    return "hymba q [1, 25, 128, 64] bf16, n_rep 5", call, {
        "dQ rows 64-127": 5, "dK/dV keys 0-63": b * hq * 2}


def scan_calls(lib, dev):
    from repro_torch.kernels.linear_scan.ops import bwd_scratch_floats
    gen = torch.Generator(device=dev).manual_seed(4)
    for label, (bh, t, dk, dv, u) in {
            "hymba BH 25, T 128, Dk 16, Dv 64": (25, 128, 16, 64, False),
            "rwkv6 BH 64, T 128, Dk 64, Dv 64, u": (64, 128, 64, 64,
                                                    True)}.items():
        rnd = lambda *x: torch.randn(x, generator=gen, device=dev)
        r, k, do = rnd(bh, t, dk), rnd(bh, t, dk), rnd(bh, t, dv)
        v, s0, ds_t = rnd(bh, t, dv), rnd(bh, dk, dv), rnd(bh, dk, dv)
        w = 0.5 + 0.49 * torch.rand((bh, t, dk), generator=gen, device=dev)
        uu = rnd(bh, dk) if u else None
        outs = [torch.empty_like(x) for x in (r, k, v, w)]
        du = None if uu is None else torch.empty_like(uu)
        ds0 = torch.empty_like(s0)
        n = bwd_scratch_floats(bh, t, dk, dv, u)
        scratch = torch.empty(n, device=dev)
        ptr = lambda x: None if x is None else x.data_ptr()

        def call(args=(r, k, v, w, uu, bh if u else 0, s0, do, ds_t,
                       scratch, n, *outs, du, ds0), dims=(bh, t, dk, dv)):
            a = [ptr(x) if isinstance(x, torch.Tensor) or x is None else x
                 for x in args]
            build.raise_on_error("linear_scan_bwd", lib.repro_linear_scan_bwd(
                *a, *dims, torch.cuda.current_stream(dev).cuda_stream))
        yield label, call, {"bh 0, rows block 0": 0}


def main(argv) -> int:
    sources = {"flash": build.CSRC / "flash_attention_bwd.cu",
               "scan": build.CSRC / "linear_scan_bwd.cu"}
    sources.update(a.split("=", 1) for a in argv)
    libs = compile_all(sources)
    dev = torch.device("cuda", 0)
    runs = [("flash", *flash_calls(libs["flash"], dev))]
    runs += [("scan", *c) for c in scan_calls(libs["scan"], dev)]
    for kernel, label, call, blocks in runs:
        for _ in range(3):
            call()
        for name, block in blocks.items():
            print(json.dumps(dict(
                kernel=kernel, source=str(sources[kernel]), shape=label,
                block=name, device_ms=device_ms(call),
                cycles=phases(libs[kernel], kernel, block, call))),
                flush=True)
    # the scan's device ms over T and BH (the library's own kernel)
    from repro_torch.kernels.linear_scan.ops import linear_scan_bwd_op
    gen = torch.Generator(device=dev).manual_seed(5)
    sweep = {}
    for bh, t in ((25, 64), (25, 128), (25, 256), (25, 1000), (1, 128),
                  (132, 128)):
        rnd = lambda *x: torch.randn(x, generator=gen, device=dev)
        w = 0.5 + 0.49 * torch.rand((bh, t, 1), generator=gen, device=dev)
        a = (rnd(bh, t, 16), rnd(bh, t, 16), rnd(bh, t, 64),
             w.expand(bh, t, 16).contiguous(), None, rnd(bh, 16, 64),
             rnd(bh, t, 64), None)
        sweep[f"BH {bh}, T {t}"] = device_ms(lambda: linear_scan_bwd_op(*a))
    print(json.dumps(dict(kernel="scan", device_ms_sweep=sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
