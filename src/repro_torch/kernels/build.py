"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

The sources under ``csrc/`` are compiled at first use for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library under ``<repo>/build/repro_torch/<hash>/``.
The hash covers the sources and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A build failure raises with the
compiler's output.

Kernels launch from several threads (leaf gates, the tier's router, the
runtime's ingest thread) and from spawned leaf processes, so the first
build is serialised twice: a thread lock within the process and an
exclusive ``flock`` on ``<hash>/.lock`` across processes.  Whoever takes
the lock second finds the finished library and only loads it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("scalegate_merge.cu", "segment_aggregate.cu", "window_join.cu",
           "flash_attention.cu", "linear_scan.cu", "flash_attention_bwd.cu",
           "linear_scan_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"
_BUILD_LOCK = threading.RLock()      # build() runs inside library()'s hold
_LIB = None
_FUNCTIONS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
PROTOTYPES = {
    # tau, src, valid, n, n_sources, fold, cluster, keys, order, ready,
    # wmark, stream
    "repro_scalegate_merge": (_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                              _P),
    # tau2, valid2, n, reports, n_reports, cluster, keys, order, ready,
    # wmark, stream
    "repro_scalegate_merge_stacked": (_P, _P, _I, _P, _I, _I, _P, _P, _P,
                                      _P, _P),
    # cluster
    "repro_scalegate_max_clusters": (_I,),
    # keys, slots, vals, acc, out, n, w, k, s, cluster, stream
    "repro_segment_aggregate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # new_tau, new_src, new_pay, b, p, st_tau, st_src, st_pay, k, r,
    # ws, band, n_attrs, counts, comps, stream
    "repro_window_join": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                          ctypes.c_float, _I, _P, _P, _P),
    # one packed argument block (flash_attention/ops.py ARGS)
    "repro_flash_attention": (ctypes.c_char_p,),
    # r, k, v, w, u, u_rows, s0, o, s_out, bh, t_len, dk, dv, chunk, stream
    "repro_linear_scan": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P),
    # q, k, v, o, do, dq, dk, dv, scratch, batch, hq, hkv, len_q, len_kv,
    # d, causal, window, dtype, scale, stream
    "repro_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _P),
    # r, k, v, w, u, u_rows, s0, do, ds_t, scratch, dr, dk, dv, dw, du,
    # ds0, bh, t_len, dk, dv, stream
    "repro_linear_scan_bwd": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def build_root() -> pathlib.Path:
    """``build/repro_torch`` at the root of the checkout."""
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if not already built) and return the library."""
    out = build_root() / _digest()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with _BUILD_LOCK, open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when closed
        if not lib.exists():
            _compile(out, lib)
    return lib


def _compile(out: pathlib.Path, lib: pathlib.Path) -> None:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(out / f"{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in SOURCES]
    log = []
    try:
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src} (rc {proc.returncode})\n{text}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out / f"tmp_{LIB_NAME}"
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
         *(str(out / f"{src}.o") for src in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    (out / "build.log").write_text(
        "\n".join(log) + f"\nbuild seconds: {time.perf_counter() - t0:.3f}\n")
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (from any thread)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def function(name: str):
    """The bound C function ``name`` (argument and return types set),
    kept after the first lookup so a launch costs one dict lookup."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = _FUNCTIONS[name] = getattr(library(), name)
    return fn


def launch(name: str, dev, *args) -> None:
    """Call ``repro_<name>(*args, stream)`` on ``dev``'s current stream,
    switching device only when ``dev`` is not the current one, and raise
    on a launch error: the wrappers' launch path, one dict lookup and one
    C call on the host."""
    import torch
    fn = function(f"repro_{name}")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    raise_on_error(name, rc)


def raise_on_error(name: str, rc: int) -> None:
    """Raise if a launcher returned a nonzero ``cudaGetLastError()``."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
