"""Plain PyTorch version of the scalegate_merge kernel.

Held against ``src/repro/kernels/scalegate_merge/ref.py``: sort by
``(tau, arrival)`` with invalid lanes keyed ``INF_TIME``, the Definition-3
watermark ``W = min_s max(-1, max tau of source s)`` and readiness
``valid & tau <= W`` in sorted order.
"""

from __future__ import annotations

import torch

from repro_torch.core.watermark import INF_TIME


def scalegate_merge_ref(tau, src, valid, *, n_sources: int):
    """-> (order i32[N], ready i32[N], watermark i32[1])."""
    s_ids = torch.arange(n_sources, dtype=src.dtype, device=src.device)
    onehot = (src[None, :] == s_ids[:, None]) & valid[None]
    per_src_max = torch.where(onehot, tau[None, :], -1).amax(dim=1)
    w = per_src_max.min()
    sort_tau = torch.where(valid, tau, INF_TIME)
    order = torch.argsort(sort_tau, stable=True)
    ready = (valid[order] & (tau[order] <= w)).to(torch.int32)
    return order.to(torch.int32), ready, w.reshape(1)
