"""Plain PyTorch versions of the scalegate_merge kernels.

Held against ``src/repro/kernels/scalegate_merge/ref.py``: sort by
``(tau, arrival)`` with invalid lanes keyed ``INF_TIME``, and readiness
``valid & tau <= W`` in sorted order.  The flat merge takes the
Definition-3 watermark ``W = min_s max(-1, max tau of source s)``; the
stacked root merge takes ``W = min(reports)`` over the leaves' pre-masked
reported frontiers, with arrival the row-major flat index.
"""

from __future__ import annotations

import torch

from repro_torch.core.watermark import INF_TIME


def _sort_ready(tau, valid, w):
    sort_tau = torch.where(valid, tau, INF_TIME)
    order = torch.argsort(sort_tau, stable=True)
    ready = (valid[order] & (tau[order] <= w)).to(torch.int32)
    return order.to(torch.int32), ready


def scalegate_merge_ref(tau, src, valid, *, n_sources: int):
    """-> (order i32[N], ready i32[N], watermark i32[1])."""
    s_ids = torch.arange(n_sources, dtype=src.dtype, device=src.device)
    onehot = (src[None, :] == s_ids[:, None]) & valid[None]
    per_src_max = torch.where(onehot, tau[None, :], -1).amax(dim=1)
    w = per_src_max.min()
    order, ready = _sort_ready(tau, valid, w)
    return order, ready, w.reshape(1)


def scalegate_merge_stacked_ref(tau2, src2, valid2, reports):
    """-> (order i32[R, C] flat indices, ready i32[R, C], watermark i32[1]);
    ``src2`` is ignored, as in the reference."""
    del src2
    r, c = tau2.shape
    valid = (valid2 != 0).reshape(-1)
    w = reports.to(torch.int32).min()
    order, ready = _sort_ready(tau2.reshape(-1), valid, w)
    return order.reshape(r, c), ready.reshape(r, c), w.reshape(1)
