"""Plain PyTorch version of the segment_aggregate kernel.

Held against ``src/repro/kernels/segment_aggregate/ref.py``.  Out-of-place
as the reference and the CUDA kernel: returns ``acc`` plus every hit's
``vals`` row added into ``acc[keys[n], slots[n], :]`` and leaves ``acc``
untouched.  Hits with a key outside ``[0, K)`` (``-1`` included) or a slot
outside ``[0, S)`` are dead lanes and add nothing.  Exact against the
reference for integer-valued contributions below 2^24; float sums agree up
to the order of the adds.
"""

from __future__ import annotations

import torch


def segment_aggregate_ref(keys, slots, vals, acc):
    k, s, _ = acc.shape
    ok = (keys >= 0) & (keys < k) & (slots >= 0) & (slots < s)
    safe_k = keys.clamp(0, k - 1).long()
    safe_s = slots.clamp(0, s - 1).long()
    upd = torch.where(ok[:, None], vals, 0.0)
    return acc.index_put((safe_k, safe_s), upd, accumulate=True)
