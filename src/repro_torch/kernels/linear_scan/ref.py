"""Plain PyTorch version of the linear_scan kernel.

Held against ``src/repro/kernels/linear_scan/ref.py`` (``linear_scan_ref``,
a ``lax.scan`` over time): the same step, a Python loop over T.  Extended
as the CUDA kernel is: ``s0`` (``[BH, Dk, Dv]``, default zeros) starts the
recurrence, ``u`` may hold one row per head (``[H, Dk]`` with ``BH % H ==
0``, row bh reading ``u[bh % H]``), and the final state is returned:
``(o, S_T)``.  The state is f32; ``o`` takes r's dtype.
"""

from __future__ import annotations

import torch


def linear_scan_ref(r, k, v, w, u=None, s0=None):
    bh, t, dk = r.shape
    dv = v.shape[-1]
    dtype = r.dtype
    s = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    if u is not None:
        u = u.float().repeat(bh // u.shape[0], 1)[:, :, None]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    outs = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        att = s + u * kv if u is not None else s
        outs.append(torch.einsum("bk,bkv->bv", r[:, i], att))
        s = w[:, i, :, None] * s + kv
    o = (torch.stack(outs, dim=1) if outs
         else r.new_zeros((bh, 0, dv)))
    return o.to(dtype), s
