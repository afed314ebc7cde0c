"""Plain PyTorch version of the window_join kernel.

Held against ``src/repro/kernels/window_join/ref.py``, exactly.  Returns
``(counts i32[B, K], comps)`` with ``comps`` a 0-dim int64 tensor: the
reference sums it in int32, which the port's shapes never overflow.
``st_tau + ws`` wraps as int32 (a tensor plus a Python int keeps the
tensor's type), as in the reference and the CUDA kernel.
"""

from __future__ import annotations

import torch


def window_join_ref(new_tau, new_src, new_pay, st_tau, st_src, st_pay, *,
                    ws: int, band: float = 10.0, n_attrs: int = 2):
    fresh = st_tau[None] + ws >= new_tau[:, None, None]
    live = (st_tau[None] >= 0) & fresh
    opp = live & (st_src[None] != new_src[:, None, None])
    d = (new_pay[:, None, None, :n_attrs] - st_pay[None, :, :, :n_attrs]).abs()
    hit = opp & (d <= band).all(dim=-1)
    counts = hit.sum(dim=-1, dtype=torch.int32)
    return counts, opp.sum()
