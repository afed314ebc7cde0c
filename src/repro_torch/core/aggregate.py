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
instance's adds reach another's input.  What does not depend on the
instance (the hits, the frontier, the slot table, the expiry's plan) is
computed once for the instances of a tick (``operator.shared``), and the
expiry reads nothing back to the host (``operator.expire_closed``), so
the tick can be captured in a CUDA graph.

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
                                       advance_explicit, expire_closed,
                                       expiry_plan, shared)
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


def _hits(op: OperatorDef, kind: str, ready: T.TupleBatch, next_l,
          key_offset: int = 0):
    """The tick's (key, slot) hits, independent of the instance: ``(k, s,
    l, m_pre, m_any, val)``, one row per (window generation d, key column,
    lane), in that order.  ``k`` is the row in the key block ``[key_offset,
    key_offset + K)``; ``m_pre`` marks live in-range hits of a key in that
    block seen first in its tuple's key set (Definition 4: ``f_MK`` returns
    a set; a key outside the block is dropped like ``NO_KEY``); ``m_any``
    the lanes in window range irrespective of key (the slot-grid
    bookkeeping mask, the same on every mesh shard); ``val`` the value each
    row adds."""
    ws = op.window
    dev = ready.device
    live = ready.valid & ~ready.is_control
    l_min = torch.maximum(ws.earliest_win_l(ready.tau), next_l)
    l_max = l_min if ws.wt == SINGLE else ws.latest_win_l(ready.tau)
    n_d = ws.n_slots if ws.wt == MULTI else 1
    keys = ready.keys.t()                                    # [KMAX, B]
    earlier = torch.ones((ready.kmax, ready.kmax), dtype=torch.bool,
                         device=dev).tril(-1)[:, :, None]
    dup = ((keys[:, None] == keys[None]) & earlier).any(dim=1)
    local = keys - key_offset
    in_block = (keys >= 0) & (local >= 0) & (local < op.k_virt) & ~dup
    l = l_min + torch.arange(n_d, dtype=torch.int32, device=dev)[:, None]
    in_range = (l <= l_max) & live                           # [D, B]
    shape = (n_d, ready.kmax, ready.batch)
    l = l[:, None].expand(shape).reshape(-1)
    k = local.clamp(0, op.k_virt - 1)[None].expand(shape).reshape(-1)
    m_pre = (in_range[:, None] & in_block[None]).reshape(-1)
    m_any = in_range[:, None].expand(shape).reshape(-1)
    reps = n_d * ready.kmax
    if kind == "count":
        val = torch.ones((l.shape[0], 1), dtype=torch.float32, device=dev)
    elif kind == "max":
        val = ready.payload[:, :1].repeat(reps, 1)
    else:  # "sum"
        val = ready.payload.repeat(reps, 1)
    return k, op.slot_of(l), l, m_pre, m_any, val


def _apply_hits(kind: str, acc: torch.Tensor, k, s, m, val) -> torch.Tensor:
    """``acc`` plus the hits ``m`` selects (a new accumulator): count and
    sum through the ``segment_aggregate`` kernel, max through a
    scatter-max."""
    if kind == "max":
        k_s, w = acc.shape[0] * acc.shape[1], acc.shape[2]
        val = torch.where(m[:, None], val, -torch.inf).expand(-1, w)
        flat = (k.long() * acc.shape[1] + s.long())[:, None].expand(-1, w)
        return acc.reshape(k_s, w).scatter_reduce(
            0, flat, val, reduce="amax").reshape(acc.shape)
    return segment_aggregate_op(torch.where(m, k, -1), s,
                                torch.where(m[:, None], val[:, :acc.shape[-1]],
                                            0.0), acc)


def _scatter_reduce(op: OperatorDef, kind: str, acc: torch.Tensor,
                    ready: T.TupleBatch, resp: torch.Tensor, next_l):
    """Scatter the whole tick into (key, slot) cells for the instance whose
    responsibility mask is ``resp``.  Returns the new accumulator and the
    hit vectors ``(k, s, l, m, m_any)``: ``m`` marks the hits this instance
    applies (see ``_hits``)."""
    k, s, l, m_pre, m_any, val = _hits(op, kind, ready, next_l)
    m = m_pre & resp[k.long()]
    return _apply_hits(kind, acc, k, s, m, val), k, s, l, m, m_any


def _plan(op: OperatorDef, kind: str, st: FastAggState, ready: T.TupleBatch,
          key_offset: int = 0):
    """Everything of a fast tick that does not depend on the instance: the
    first-contact frontier, the watermark, the hits, the ring-overrun
    count, the slot table and the expiry's plan."""
    ops = st.op_state
    dev = ready.device
    live = ready.valid & ~ready.is_control
    any_live = live.any()
    w_end = torch.maximum(ops.watermark,
                          torch.where(live, ready.tau, 0).max())
    first_tau = torch.where(live, ready.tau, INT32_MAX).min()
    next_l = torch.where((ops.next_l == UNSET_L) & any_live,
                         op.window.earliest_win_l(first_tau), ops.next_l)
    k, s, l, m_pre, m_any, val = _hits(op, kind, ready, next_l, key_offset)

    # Ring overrun: the live window generations spanned by this tick must
    # fit the slot ring, else two generations alias one slot (counted).
    latest = torch.where(live, op.window.latest_win_l(ready.tau),
                         next_l).max()
    coll = (latest - next_l + 1 - op.slots).clamp(min=0) * any_live.to(
        torch.int32)
    s_long = s.long()
    hit_l = torch.full((op.slots,), INT32_MIN, dtype=torch.int32, device=dev)
    hit_l = hit_l.scatter_reduce(0, s_long, torch.where(m_any, l, INT32_MIN),
                                 reduce="amax")
    has = torch.zeros((op.slots,), dtype=torch.int32, device=dev)
    has = has.scatter_reduce(0, s_long, m_any.to(torch.int32), reduce="amax")
    slot_l = torch.where(has > 0, hit_l, st.slot_l)
    key_ids = key_offset + torch.arange(op.k_virt, dtype=torch.int32,
                                        device=dev)
    return dict(next_l=next_l, w_end=w_end, k=k, k_long=k.long(), s=s,
                m_pre=m_pre, val=val, flat=k.long() * op.slots + s_long,
                coll=coll, slot_l=slot_l, key_ids=key_ids,
                expiry=expiry_plan(op, next_l, w_end, key_ids))


def tick_fast(op: OperatorDef, kind: str, st: FastAggState,
              ready: T.TupleBatch, resp: torch.Tensor, *,
              explicit_w=None,
              key_offset: int = 0) -> Tuple[FastAggState, Outputs]:
    """Whole-tick scatter update, then expiry (order-free for commutative f_R).

    The part that does not depend on ``resp`` is computed once for all the
    VSN instances of a tick (``operator.shared``); each instance then
    applies its hits and expires its keys.  ``explicit_w`` (SN only) is the
    end-of-tick watermark broadcast to every instance whatever was routed
    to it (see ``operator.advance_explicit``).  ``key_offset`` runs the
    tick on a mesh shard's key block ``[key_offset, key_offset + K)``
    (``op.k_virt`` is the block's width): keys outside it are dropped, and
    the emitted key ids stay global.
    """
    plan = shared((tick_fast, op, kind, st, ready, key_offset),
                  lambda: _plan(op.resolved(), kind, st, ready, key_offset))
    op = op.resolved()
    ops = st.op_state
    m = plan["m_pre"] & resp[plan["k_long"]]
    acc = _apply_hits(kind, ops.zeta["acc"], plan["k"], plan["s"], m,
                      plan["val"])
    occ = ops.occupied.reshape(-1).to(torch.int32).scatter_reduce(
        0, plan["flat"], m.to(torch.int32), reduce="amax")
    ops = dataclasses.replace(ops, zeta={"acc": acc},
                              occupied=occ.reshape(ops.occupied.shape) > 0,
                              watermark=plan["w_end"], next_l=plan["next_l"])
    ops, outs = expire_closed(op, ops, plan["w_end"], resp, plan["key_ids"],
                              plan["expiry"])
    if explicit_w is not None:
        ops, outs = advance_explicit(op, ops, outs, explicit_w, resp,
                                     key_offset)
    return FastAggState(op_state=ops, slot_l=plan["slot_l"],
                        collisions=plan["coll"]), outs
