"""Entry points of the scalegate_merge kernels: plain versions on the CPU,
the CUDA kernels (``csrc/scalegate_merge.cu``) on the card.

Held against ``src/repro/kernels/scalegate_merge/ops.py``: the flat merge
``scalegate_merge`` and the stacked-leaf root merge
``scalegate_merge_stacked``.  Unlike the Pallas wrappers, which pad any N
to a power of two of at least 128 lanes in Python, the CUDA launchers take
N as it is; the wrappers validate, pick the launch from N alone
(``plan``), allocate the outputs (and, past the cluster path's capacity,
the multi-block path's key scratch) and launch.  The flat merge takes any
``n_sources >= 0``: 0 asks for the order alone (no fold, W = INT_MAX, the
minimum over no source), and past ``MAX_SHARED_SOURCES`` the per-source
maxima fold into a global scratch the wrapper allocates.  Both take any
N from 1 to ``MAX_LANES``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.scalegate_merge.ref import (
    scalegate_merge_ref, scalegate_merge_stacked_ref)

SHARE = 4096             # lanes one cluster block holds (512 threads x 8)
MAX_CLUSTER = 16         # blocks of one cluster (non-portable above 8)
CLUSTER_LANES = SHARE * MAX_CLUSTER   # the cluster path's capacity
CLUSTER_SMEM = 2 * (SHARE + SHARE // 16) * 8  # two padded key buffers (68 KB)
MAX_LANES = 2 ** 31 - 1  # int32 lane indices (key scratch up to 16 GB)
MAX_REPORTS = 128        # leaf reports of one stacked call
MAX_SHARED_SOURCES = 1024  # the fold in shared memory; past it, global


class Plan(NamedTuple):
    """One merge's launch: ``cluster`` blocks of ``share`` lanes each
    (block b takes lanes [b * share, min((b + 1) * share, n))), or, with
    ``cluster`` 0, the multi-block path over ``scratch`` padded lanes."""
    cluster: int
    share: int
    scratch: int


def plan(n: int, cluster: Optional[int] = None) -> Plan:
    """The launch of a merge over ``n`` lanes, a function of ``n`` alone:
    one cluster of the fewest blocks, a power of two, that hold ``n`` at
    ``SHARE`` lanes a block, up to ``CLUSTER_LANES``; past it the
    multi-block path.  ``cluster`` forces the cluster size (the card's
    sweep over it)."""
    _check_lanes("a merge", n)
    if cluster is None:
        if n > CLUSTER_LANES:
            return Plan(0, 0, 1 << (n - 1).bit_length())
        cluster = 1 << (-(-n // SHARE) - 1).bit_length()
    if not 1 <= cluster <= MAX_CLUSTER or -(-n // cluster) > SHARE:
        raise ValueError(f"{n} lanes do not fit a cluster of {cluster}")
    return Plan(cluster, -(-n // cluster), 0)


def _outputs(shape, p: Plan, dev):
    """order, ready (two views of one allocation), wmark and the key
    scratch (None on the cluster path)."""
    keys = (torch.empty((p.scratch,), dtype=torch.int64, device=dev)
            if p.scratch else None)
    order, ready = torch.empty((2,) + shape, dtype=torch.int32, device=dev)
    wmark = torch.empty((1,), dtype=torch.int32, device=dev)
    return keys, order, ready, wmark


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_lanes(name: str, n: int) -> None:
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"{name} takes 1..{MAX_LANES} lanes, got {n}")


def _cuda(tau, src, valid, *, n_sources: int, cluster: Optional[int] = None):
    n = tau.shape[0]
    dev = tau.device
    dispatch.check("tau", tau, torch.int32, (n,), dev)
    dispatch.check("src", src, torch.int32, (n,), dev)
    dispatch.check("valid", valid, torch.bool, (n,), dev)
    _check_lanes("scalegate_merge", n)
    if n_sources < 0:
        raise ValueError(f"n_sources must be >= 0, got {n_sources}")
    p = plan(n, cluster)
    keys, order, ready, wmark = _outputs((n,), p, dev)
    fold = (torch.empty((n_sources,), dtype=torch.int32, device=dev)
            if n_sources > MAX_SHARED_SOURCES else None)
    build.launch("scalegate_merge", dev, tau.data_ptr(), src.data_ptr(),
                 valid.data_ptr(), n, n_sources, _ptr(fold), p.cluster,
                 _ptr(keys), order.data_ptr(), ready.data_ptr(),
                 wmark.data_ptr())
    return order, ready, wmark


def _cuda_stacked(tau2, src2, valid2, reports, *,
                  cluster: Optional[int] = None):
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
    p = plan(n, cluster)
    keys, order, ready, wmark = _outputs(shape, p, dev)
    build.launch("scalegate_merge_stacked", dev, tau2.data_ptr(),
                 valid2.data_ptr(), n, reports.data_ptr(), n_reports,
                 p.cluster, _ptr(keys), order.data_ptr(), ready.data_ptr(),
                 wmark.data_ptr())
    return order, ready, wmark


def max_clusters(cluster: int) -> int:
    """How many clusters of ``cluster`` merge blocks the current card holds
    at once (0: it cannot schedule one)."""
    count = build.function("repro_scalegate_max_clusters")(cluster)
    build.raise_on_error("scalegate_max_clusters", max(0, -count))
    return count


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
