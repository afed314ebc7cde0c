"""Plain PyTorch versions of the window_join kernel and of its second
entry, window_join_emit.

``window_join_ref`` is held against ``src/repro/kernels/window_join/ref.py``,
exactly.  Returns ``(counts i32[B, K], comps)`` with ``comps`` a 0-dim
int64 tensor: the reference sums it in int32, which the port's shapes
never overflow.
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


def window_join_emit_ref(new_tau, new_src, new_pay, new_live, st_tau, st_src,
                         st_pay, resp, *, ws: int, band: float = 10.0,
                         n_attrs: int = 2, out_cap: int = 0):
    """Phase 1 of ``join.tick_fast`` for a band predicate, as the fast tick
    computed it in dense masks: the live (``new_live``), fresh,
    opposite-stream pairs on the ``resp`` rows and their band hits.
    Returns ``(rows, n1, comps)``: the flat indices ``b*K*R + k*R + r`` of
    the first ``out_cap`` hits in ascending order (-1 past them, int64),
    the hits' count (int32) and the pairs' (int64).  ``|new - stored|``
    is ``|stored - new|`` bit for bit, so one order serves both streams."""
    fresh = st_tau[None] + ws >= new_tau[:, None, None]
    stored_live = (st_tau[None] >= 0) & fresh            # [B, K, R]
    opp = stored_live & (st_src[None] != new_src[:, None, None])
    opp = opp & resp[None, :, None] & new_live[:, None, None]
    d = (new_pay[:, None, None, :n_attrs] - st_pay[None, :, :, :n_attrs]).abs()
    hit = opp & (d <= band).all(dim=-1)
    rows = torch.nonzero_static(hit.reshape(-1), size=out_cap,
                                fill_value=-1).squeeze(1)
    return rows, hit.sum(dtype=torch.int32), opp.sum()
