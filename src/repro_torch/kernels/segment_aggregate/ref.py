"""Plain PyTorch version of the segment_aggregate kernel.

Held against ``src/repro/kernels/segment_aggregate/ref.py``: hits with a
key outside ``[0, K)`` (``-1`` included) are dead lanes and add nothing.
Unlike the reference, which returns a new array, this updates ``acc`` in
place and returns it, exactly as the CUDA kernel does.
"""

from __future__ import annotations

import torch


def segment_aggregate_ref(keys, slots, vals, acc):
    k, s, _ = acc.shape
    ok = (keys >= 0) & (keys < k) & (slots >= 0) & (slots < s)
    safe_k = keys.clamp(0, k - 1).long()
    safe_s = slots.clamp(0, s - 1).long()
    upd = torch.where(ok[:, None], vals, 0.0)
    return acc.index_put_((safe_k, safe_s), upd, accumulate=True)
