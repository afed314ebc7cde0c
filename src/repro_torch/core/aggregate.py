"""Aggregates: ``A`` and the multi-key ``A+`` (paper §2.1, §4, Appendix D).

Held against ``src/repro/core/aggregate.py``.  ``count_aggregate`` is the
wordcount/paircount operator (Operators 4/5), ``longest_aggregate`` the
longest-tweet operator (Operators 1/2), ``reduce_aggregate`` the generic
commutative reducer.

``tick_fast`` scatters the whole ready batch into (key, window-slot) cells
at once instead of scanning tuple by tuple; count and sum go through the
``segment_aggregate`` kernel, max through a scatter-max.  Both are
out-of-place, as in the reference: every VSN instance of a tick starts
from the same shared ``acc``, and each gets a new accumulator back, so no
instance's adds reach another's input.

Departures from the reference, both deterministic where it is not: the
window-generation table ``slot_l`` is written by in-range lanes only (the
reference also writes the old value back from out-of-range lanes that hit
the same slot, and XLA's scatter order decides which write wins); it feeds
only the disjoint-writer merge, never an output.  ``tick_fast`` also takes
the explicit end-of-tick watermark that ``SNPipeline`` broadcasts
(``explicit_w``), so the fast path under SN closes the same windows as the
general tick does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T
from repro_torch.core.operator import (UNSET_L, OperatorDef, OpState, Outputs,
                                       _empty_outputs, _expire_all,
                                       advance_explicit)
from repro_torch.core.windows import MULTI, SINGLE, WindowSpec
from repro_torch.kernels.segment_aggregate.ops import segment_aggregate_op

INT32_MAX = torch.iinfo(torch.int32).max
INT32_MIN = torch.iinfo(torch.int32).min


def reduce_aggregate(window: WindowSpec, k_virt: int, *, width: int = 1,
                     f_r: Callable, init_val: float, emit_key: bool = True,
                     out_cap: int = 256, extra_slots: int = 0,
                     n_inputs: int = 1,
                     name: str = "aggregate") -> OperatorDef:
    """A/A+ with an incremental reducer f_R and expiry output f_A.

    zeta: {"acc": f32[K, slots, width]}; f_O emits ``[key, acc...]``.
    """

    def init_zeta(device):
        slots = window.n_slots + extra_slots
        return {"acc": torch.full((k_virt, slots, width), init_val,
                                  dtype=torch.float32, device=device)}

    def f_u(zeta_s, tup, win_l, mask):
        acc = f_r(zeta_s["acc"], tup.payload)
        k = acc.shape[0]
        return ({"acc": acc},
                torch.zeros((k, width + 1), dtype=torch.float32,
                            device=acc.device),
                torch.zeros((k,), dtype=torch.bool, device=acc.device))

    def f_o(zeta_s, win_l, key_ids):
        payload = zeta_s["acc"]
        if emit_key:
            payload = torch.cat([key_ids[:, None].to(torch.float32), payload],
                                dim=-1)
        return payload, torch.ones((key_ids.shape[0],), dtype=torch.bool,
                                   device=key_ids.device)

    def f_s(zeta_s, new_left):
        acc = zeta_s["acc"]
        return ({"acc": torch.full_like(acc, init_val)},
                torch.zeros((acc.shape[0],), dtype=torch.bool,
                            device=acc.device))

    return OperatorDef(window=window, n_inputs=n_inputs, k_virt=k_virt,
                       payload_out=width + (1 if emit_key else 0),
                       init_zeta=init_zeta, f_u=f_u, f_o=f_o, f_s=f_s,
                       out_cap=out_cap, extra_slots=extra_slots, name=name)


def count_aggregate(window: WindowSpec, k_virt: int, **kw) -> OperatorDef:
    """Operator 4/5: per-key tuple count (wordcount / paircount)."""
    return reduce_aggregate(window, k_virt, width=1,
                            f_r=lambda acc, payload: acc + 1.0,
                            init_val=0.0, name=kw.pop("name", "count"), **kw)


def longest_aggregate(window: WindowSpec, k_virt: int, **kw) -> OperatorDef:
    """Operator 1/2: longest tweet per hashtag — payload[0] = length(phi)."""
    return reduce_aggregate(
        window, k_virt, width=1,
        f_r=lambda acc, payload: torch.maximum(acc, payload[..., :1]),
        init_val=0.0, name=kw.pop("name", "longest"), **kw)


# ---------------------------------------------------------------------------
# Vectorized fast path (commutative reducers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FastAggState:
    op_state: OpState
    slot_l: torch.Tensor      # i32[slots] window generation in each slot
    collisions: torch.Tensor  # i32[] ring overruns in the LAST tick


def fast_init(op: OperatorDef, device=None) -> FastAggState:
    dev = _device.resolve(device)
    return FastAggState(
        op_state=op.init_state(dev),
        slot_l=torch.arange(op.slots, dtype=torch.int32, device=dev),
        collisions=torch.zeros((), dtype=torch.int32, device=dev))


def _scatter_reduce(op: OperatorDef, kind: str, acc: torch.Tensor,
                    ready: T.TupleBatch, resp: torch.Tensor, next_l):
    """Scatter the whole tick into (key, slot) cells.

    A key repeated inside one tuple's key set contributes once (Definition
    4: ``f_MK`` returns a set).  Returns the new accumulator and the hit
    vectors ``(k, s, l, m, m_any)``: ``m`` marks hits this instance
    applies, ``m_any`` lanes in window range irrespective of key and
    ``resp`` (the slot-grid bookkeeping mask).
    """
    ws = op.window
    live = ready.valid & ~ready.is_control
    l_min = torch.maximum(ws.earliest_win_l(ready.tau), next_l)
    l_max = ws.latest_win_l(ready.tau)
    if ws.wt == SINGLE:
        l_max = l_min
    dup_cols = []
    for kk in range(ready.kmax):
        dup = torch.zeros((ready.batch,), dtype=torch.bool, device=acc.device)
        for kk2 in range(kk):
            dup = dup | (ready.keys[:, kk2] == ready.keys[:, kk])
        dup_cols.append(dup)
    hits_l, hits_k, hits_m, hits_any = [], [], [], []
    for d in range(ws.n_slots if ws.wt == MULTI else 1):
        l = l_min + d
        in_range = (l <= l_max) & live
        for kk in range(ready.kmax):
            key = ready.keys[:, kk]
            in_block = (key >= 0) & (key < op.k_virt) & ~dup_cols[kk]
            k_safe = key.clamp(0, op.k_virt - 1)
            hits_l.append(l)
            hits_k.append(k_safe)
            hits_m.append(in_range & in_block & resp[k_safe.long()])
            hits_any.append(in_range)
    l = torch.cat(hits_l)
    k = torch.cat(hits_k)
    m = torch.cat(hits_m)
    m_any = torch.cat(hits_any)
    s = op.slot_of(l)
    reps = l.shape[0] // ready.batch
    if kind == "max":
        k_s, w = acc.shape[0] * acc.shape[1], acc.shape[2]
        val = ready.payload[:, :1].repeat(reps, 1)
        val = torch.where(m[:, None], val, -torch.inf).expand(-1, w)
        flat = (k.long() * acc.shape[1] + s.long())[:, None].expand(-1, w)
        acc = acc.reshape(k_s, w).scatter_reduce(
            0, flat, val, reduce="amax").reshape(acc.shape)
    else:
        if kind == "count":
            val = torch.ones((l.shape[0], 1), dtype=torch.float32,
                             device=acc.device)
        else:  # "sum"
            val = ready.payload[:, :acc.shape[-1]].repeat(reps, 1)
        acc = segment_aggregate_op(
            torch.where(m, k, -1), s, torch.where(m[:, None], val, 0.0), acc)
    return acc, k, s, l, m, m_any


def tick_fast(op: OperatorDef, kind: str, st: FastAggState,
              ready: T.TupleBatch, resp: torch.Tensor, *,
              explicit_w=None) -> Tuple[FastAggState, Outputs]:
    """Whole-tick scatter update, then expiry (order-free for commutative f_R).

    ``explicit_w`` (SN only) is the end-of-tick watermark broadcast to every
    instance whatever was routed to it (see ``operator.advance_explicit``).
    """
    op = op.resolved()
    ops = st.op_state
    dev = ready.device
    live = ready.valid & ~ready.is_control
    any_live = live.any()
    w_end = torch.maximum(ops.watermark,
                          torch.where(live, ready.tau, 0).max())
    first_tau = torch.where(live, ready.tau, INT32_MAX).min()
    next_l = torch.where((ops.next_l == UNSET_L) & any_live,
                         op.window.earliest_win_l(first_tau), ops.next_l)
    ops = dataclasses.replace(ops, next_l=next_l)

    acc, k_idx, s_idx, l_idx, m_idx, m_any = _scatter_reduce(
        op, kind, ops.zeta["acc"], ready, resp, ops.next_l)

    # Ring overrun: the live window generations spanned by this tick must
    # fit the slot ring, else two generations alias one slot (counted).
    latest = torch.where(live, op.window.latest_win_l(ready.tau),
                         ops.next_l).max()
    span = latest - ops.next_l + 1
    coll = (span - op.slots).clamp(min=0) * any_live.to(torch.int32)

    flat = k_idx.long() * op.slots + s_idx.long()
    occ = ops.occupied.reshape(-1).to(torch.int32).scatter_reduce(
        0, flat, m_idx.to(torch.int32), reduce="amax")
    occ = occ.reshape(ops.occupied.shape) > 0

    s_long = s_idx.long()
    hit_l = torch.full((op.slots,), INT32_MIN, dtype=torch.int32, device=dev)
    hit_l = hit_l.scatter_reduce(0, s_long, torch.where(m_any, l_idx,
                                                        INT32_MIN),
                                 reduce="amax")
    has = torch.zeros((op.slots,), dtype=torch.int32, device=dev)
    has = has.scatter_reduce(0, s_long, m_any.to(torch.int32), reduce="amax")
    slot_l = torch.where(has > 0, hit_l, st.slot_l)

    ops = dataclasses.replace(ops, zeta={"acc": acc}, occupied=occ,
                              watermark=w_end)
    outs = _empty_outputs(op.out_cap, op.payload_out, dev)
    ops, outs = _expire_all(op, ops, outs, w_end, resp,
                            torch.arange(op.k_virt, dtype=torch.int32,
                                         device=dev))
    if explicit_w is not None:
        ops, outs = advance_explicit(op, ops, outs, explicit_w, resp)
    return FastAggState(op_state=ops, slot_l=slot_l, collisions=coll), outs
