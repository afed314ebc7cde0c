"""Entry points of the scalegate_merge kernels: plain versions on the CPU,
the CUDA kernels (``csrc/scalegate_merge.cu``) on the card.

Held against ``src/repro/kernels/scalegate_merge/ops.py``: the flat merge
``scalegate_merge`` and the stacked-leaf root merge
``scalegate_merge_stacked``.  Unlike the Pallas wrappers, which pad any N
to a power of two of at least 128 lanes in Python, the CUDA launchers pad
inside the kernel; the wrappers only validate, allocate the outputs (and,
past one shared-memory tile, the global key scratch) and launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.scalegate_merge.ref import (
    scalegate_merge_ref, scalegate_merge_stacked_ref)

MAX_LANES = 1 << 20      # the key scratch of the multi-block path: 8 MB
TILE = 16384             # lanes one block sorts in shared memory (128 KB)
MAX_REPORTS = 128        # leaf reports of one stacked call (one tile)
MIN_LANES = 128


def _outputs(shape, n: int, dev):
    """order, ready, wmark and the key scratch (None within one tile)."""
    n_pad = max(MIN_LANES, 1 << (n - 1).bit_length())
    keys = (torch.empty((n_pad,), dtype=torch.int64, device=dev)
            if n_pad > TILE else None)
    order = torch.empty(shape, dtype=torch.int32, device=dev)
    ready = torch.empty(shape, dtype=torch.int32, device=dev)
    wmark = torch.empty((1,), dtype=torch.int32, device=dev)
    return keys, order, ready, wmark


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_lanes(name: str, n: int) -> None:
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"{name} takes 1..{MAX_LANES} lanes, got {n}")


def _cuda(tau, src, valid, *, n_sources: int):
    n = tau.shape[0]
    dev = tau.device
    dispatch.check("tau", tau, torch.int32, (n,), dev)
    dispatch.check("src", src, torch.int32, (n,), dev)
    dispatch.check("valid", valid, torch.bool, (n,), dev)
    _check_lanes("scalegate_merge", n)
    if not 1 <= n_sources <= 1024:
        raise ValueError(f"n_sources must be in 1..1024, got {n_sources}")
    keys, order, ready, wmark = _outputs((n,), n, dev)
    with torch.cuda.device(dev):
        rc = build.library().repro_scalegate_merge(
            tau.data_ptr(), src.data_ptr(), valid.data_ptr(), n, n_sources,
            _ptr(keys), order.data_ptr(), ready.data_ptr(), wmark.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("scalegate_merge", rc)
    return order, ready, wmark


def _cuda_stacked(tau2, src2, valid2, reports):
    """``src2`` is accepted and ignored, as in the reference: the (tau,
    arrival) order does not consult it."""
    del src2
    dev = tau2.device
    if tau2.ndim != 2:
        raise ValueError(f"tau2 must be [R, C], got shape {tuple(tau2.shape)}")
    shape = tuple(tau2.shape)
    n = shape[0] * shape[1]
    dispatch.check("tau2", tau2, torch.int32, shape, dev)
    dispatch.check("valid2", valid2, torch.bool, shape, dev)
    n_reports = reports.shape[0]
    if not 1 <= n_reports <= MAX_REPORTS:
        raise ValueError(f"scalegate_merge_stacked takes 1..{MAX_REPORTS} "
                         f"leaf reports, got {n_reports}")
    dispatch.check("reports", reports, torch.int32, (n_reports,), dev)
    _check_lanes("scalegate_merge_stacked", n)
    keys, order, ready, wmark = _outputs(shape, n, dev)
    with torch.cuda.device(dev):
        rc = build.library().repro_scalegate_merge_stacked(
            tau2.data_ptr(), valid2.data_ptr(), n, reports.data_ptr(),
            n_reports, _ptr(keys), order.data_ptr(), ready.data_ptr(),
            wmark.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("scalegate_merge_stacked", rc)
    return order, ready, wmark


scalegate_merge_op = dispatch.register(dispatch.Kernel(
    name="scalegate_merge",
    plain=scalegate_merge_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/scalegate_merge/scalegate_merge.py:159",
    source="src/repro_torch/kernels/csrc/scalegate_merge.cu",
))

scalegate_merge_stacked_op = dispatch.register(dispatch.Kernel(
    name="scalegate_merge_stacked",
    plain=scalegate_merge_stacked_ref,
    cuda=_cuda_stacked,
    replaces="src/repro/kernels/scalegate_merge/scalegate_merge.py:207",
    source="src/repro_torch/kernels/csrc/scalegate_merge.cu",
))
