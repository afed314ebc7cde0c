"""Joins: ``J``/``J+`` and ScaleJoin (paper §2.1, §4, Appendix D Operator 3).

Held against ``src/repro/core/join.py``.  ScaleJoin is the ``J+`` of the
evaluation (Q3-Q6): every instance counts every tuple, each tuple is
stored round-robin under exactly one virtual key (``c % K``), and each
instance compares incoming tuples with the tuples stored under its keys.

Two paths: ``scalejoin_def`` on the general ``operator.tick`` (the semantic
oracle) and ``tick_fast``, the blocked whole-tick compare.
``band_join_counts`` is the counting-only compare through the
``window_join`` kernel.  ``tick_fast`` has the reference's two layouts:
monolithic (all K rows, ``resp`` masks) and sliced (``k_global`` /
``k_offset``: one mesh shard's contiguous row block).  Its phase 1 (the
incoming block against the stored rings) runs through the
``window_join_emit`` kernel for a ``BandPredicate``, which reads only the
instance's own rows; any other predicate, a Python callable the kernel
cannot evaluate, takes dense ``[B, K, R]`` masks (``DENSE_PHASE1_CALLS``
counts those calls).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T
from repro_torch.core.operator import (OperatorDef, Outputs, Tup,
                                       _empty_outputs, _put, compact,
                                       compacted_outputs)
from repro_torch.core.watermark import INF_TIME
from repro_torch.core.windows import SINGLE, WindowSpec
from repro_torch.kernels.window_join.ops import (window_join_emit_op,
                                                 window_join_op)

# tick_fast calls whose phase 1 took the dense masks (a predicate other
# than a BandPredicate)
DENSE_PHASE1_CALLS = 0


@dataclasses.dataclass(frozen=True)
class BandPredicate:
    """Q3 predicate: |phi_L[i] - phi_R[i]| <= width for the first ``attrs``.
    A value ``tick_fast`` can read, so its phase 1 runs in the
    ``window_join_emit`` kernel (the same float32 subtraction and compare a
    column)."""
    width: float = 10.0
    attrs: int = 2

    def __call__(self, pl, pr):
        d = (pl[..., :self.attrs] - pr[..., :self.attrs]).abs()
        return (d <= self.width).all(dim=-1)


def band_predicate(width: float = 10.0, attrs: int = 2) -> BandPredicate:
    """Q3 predicate: |phi_L[i] - phi_R[i]| <= width for the first ``attrs``."""
    return BandPredicate(width, attrs)


def hedge_predicate(lo: float = -1.05, hi: float = -0.95) -> Callable:
    """Q6 NYSE predicate on payload ``[id, nd]``: different company and
    ND_R / ND_L in [lo, hi] (negative correlation)."""
    def f_j(pl, pr):
        ratio = pr[..., 1] / torch.where(pl[..., 1] == 0, 1e-9, pl[..., 1])
        return (pl[..., 0] != pr[..., 0]) & (ratio >= lo) & (ratio <= hi)
    return f_j


def _directed(f_j, pay_new, src_new, pay_stored):
    """Apply f_J with stream-consistent argument order (L first)."""
    lr = f_j(pay_new, pay_stored)   # new is L, stored is R
    rl = f_j(pay_stored, pay_new)   # stored is L, new is R
    return torch.where(src_new == 0, lr, rl)


def scalejoin_def(window: WindowSpec, k_virt: int, f_j: Callable, *,
                  payload_width: int, ring: int, out_cap: int = 256,
                  name: str = "scalejoin") -> OperatorDef:
    """Operator 3 on the general O+ path (WT=single, WA=delta, I=2).

    zeta per key: tuple ring (tau/pay/stream), per-key store cursor n, and
    the global round-robin counter c (replicated per key).
    """
    if window.wt != SINGLE:
        raise ValueError("ScaleJoin uses WT=single")

    def init_zeta(device):
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "tau": torch.full((k_virt, 1, ring), -1, **i32),
            "pay": torch.zeros((k_virt, 1, ring, payload_width),
                               dtype=torch.float32, device=device),
            "stream": torch.zeros((k_virt, 1, ring), **i32),
            "n": torch.zeros((k_virt, 1), **i32),
            "c": torch.zeros((k_virt, 1), **i32),
        }

    def f_u(zeta_s, tup: Tup, win_l, mask):
        k = zeta_s["tau"].shape[0]
        key_ids = torch.arange(k, device=tup.tau.device)
        # purge stale opposite tuples (Operator 3 L18-19)
        fresh = zeta_s["tau"] + window.ws >= tup.tau
        live = (zeta_s["tau"] >= 0) & fresh
        tau = torch.where(live, zeta_s["tau"], -1)
        # match against opposite-stream stored tuples (L20-21)
        opp = live & (zeta_s["stream"] != tup.source)
        hit = opp & _directed(f_j, tup.payload, tup.source, zeta_s["pay"])
        out_pay = torch.cat([tup.payload.expand(k, ring, -1), zeta_s["pay"]],
                            dim=-1)
        # store round-robin: the key with c % K == k stores t (L22-23)
        store = (zeta_s["c"] % k_virt) == key_ids
        pos = (zeta_s["n"] % ring).long()

        def put(a, v):
            new = a.clone()
            new[key_ids, pos] = torch.where(
                store.reshape(store.shape + (1,) * (a.ndim - 2)), v,
                a[key_ids, pos])
            return new

        new = {
            "tau": put(tau, tup.tau.expand(k)),
            "pay": put(zeta_s["pay"], tup.payload.expand(k, -1)),
            "stream": put(zeta_s["stream"], tup.source.expand(k)),
            "n": zeta_s["n"] + store.to(torch.int32),
            "c": zeta_s["c"] + 1,
        }
        return new, out_pay, hit

    return OperatorDef(window=window, n_inputs=2, k_virt=k_virt,
                       payload_out=2 * payload_width, init_zeta=init_zeta,
                       f_u=f_u, f_o=None, f_s=None, out_cap=out_cap,
                       lazy_expiry=True, name=name)


@dataclasses.dataclass(frozen=True)
class FastJoinState:
    tau: torch.Tensor          # i32[K, R] stored event times (-1 = empty)
    pay: torch.Tensor          # f32[K, R, P]
    stream: torch.Tensor       # i32[K, R]
    n: torch.Tensor            # i32[K] per-key store cursor
    c: torch.Tensor            # i32[] global round-robin tuple counter
    comparisons: torch.Tensor  # f32[] comparisons in the LAST tick


def fast_join_init(k_virt: int, ring: int, payload_width: int,
                   device=None) -> FastJoinState:
    dev = _device.resolve(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return FastJoinState(
        tau=torch.full((k_virt, ring), -1, **i32),
        pay=torch.zeros((k_virt, ring, payload_width), dtype=torch.float32,
                        device=dev),
        stream=torch.zeros((k_virt, ring), **i32),
        n=torch.zeros((k_virt,), **i32),
        c=torch.zeros((), **i32),
        comparisons=torch.zeros((), dtype=torch.float32, device=dev),
    )


def band_join_counts(st: FastJoinState, ready: T.TupleBatch,
                     window: WindowSpec, *, band: float = 10.0,
                     n_attrs: int = 2):
    """Counting-only band-join tick through the ``window_join`` kernel:
    per-incoming-tuple match counts against the stored rings plus the
    live-comparison total.  Returns ``(counts i32[B, K], comparisons)``.

    Invalid and control lanes get ``tau = INF_TIME``: they match nothing
    and count no comparisons.
    """
    live = ready.valid & ~ready.is_control
    tau = torch.where(live, ready.tau, INF_TIME)
    return window_join_op(tau, ready.source, ready.payload, st.tau, st.stream,
                          st.pay, ws=window.ws, band=band, n_attrs=n_attrs)


def _dense_phase1(window: WindowSpec, f_j: Callable, st: FastJoinState,
                  ready: T.TupleBatch, live_in: torch.Tensor,
                  resp: torch.Tensor, out_cap: int, emit: bool):
    """Phase 1 for any predicate, as ``window_join_emit``'s contract: dense
    ``[B, K, R]`` masks over every stored slot, then ``resp``.  A counting
    tick skips the predicate and returns no rows."""
    global DENSE_PHASE1_CALLS
    DENSE_PHASE1_CALLS += 1
    fresh = st.tau[None] + window.ws >= ready.tau[:, None, None]
    stored_live = (st.tau[None] >= 0) & fresh            # [B, K, R]
    opp = stored_live & (st.stream[None] != ready.source[:, None, None])
    opp = opp & resp[None, :, None] & live_in[:, None, None]
    if not emit:
        return None, None, opp.sum()
    hit1 = opp & _directed(f_j, ready.payload[:, None, None, :],
                           ready.source[:, None, None], st.pay[None])
    rows1, _, n1 = compact(hit1.reshape(-1), out_cap)
    return rows1, n1, opp.sum()


def tick_fast(window: WindowSpec, f_j: Callable, st: FastJoinState,
              ready: T.TupleBatch, resp: torch.Tensor, out_cap: int,
              emit: bool = True, k_global: int = None,
              k_offset: int = 0) -> Tuple[FastJoinState, Outputs]:
    """Whole-tick ScaleJoin: block compare + in-block triangle + store.

    Monolithic (the default): ``st`` holds all K rows and ``resp`` masks
    this instance's rows.  Sliced (``k_global`` set): ``st`` holds the rows
    ``[k_offset, k_offset + K)`` of a ``k_global``-row store, the
    owner-computes layout of ``vsn.shard_tick``; a tuple is stored, and
    its in-block pairs counted, by the shard whose block holds its store
    key ``(c + rank) % k_global``, so every pair is compared once.
    Requires ``ready.batch <= k_global`` (one store row per tuple per
    tick).

    Outputs are appended in the reference's order: phase-1 hits by
    ``(b, k, r)``, then phase-2 hits by ``(later, earlier)``, in one
    fixed-size emission (phase 1's rows from ``window_join_emit`` or the
    dense masks, phase 2's from ``operator.compact``): no shape depends on
    the data and nothing is read back to the host.
    """
    k_virt, ring = st.tau.shape
    kg = k_virt if k_global is None else k_global
    b = ready.batch
    p = ready.payload.shape[-1]
    dev = ready.device
    if b > kg:
        raise ValueError("the fast path stores at most one tuple per key per "
                         f"tick: batch {b} > K {kg}")
    live_in = ready.valid & ~ready.is_control
    li = live_in.to(torch.int32)
    rank = torch.cumsum(li, 0, dtype=torch.int32) - li
    store_g = (st.c + rank) % kg                         # global key ids
    in_slice = (store_g >= k_offset) & (store_g < k_offset + k_virt)
    store_key = (store_g - k_offset).clamp(0, k_virt - 1).long()

    # --- phase 1: incoming block vs stored rings (resp rows only) ---------
    if isinstance(f_j, BandPredicate):
        rows1, n1, comps1 = window_join_emit_op(
            ready.tau, ready.source, ready.payload, live_in, st.tau,
            st.stream, st.pay, resp, ws=window.ws, band=float(f_j.width),
            n_attrs=ready.payload[:, :f_j.attrs].shape[-1],
            out_cap=out_cap if emit else 0)
    else:
        rows1, n1, comps1 = _dense_phase1(window, f_j, st, ready, live_in,
                                          resp, out_cap, emit)

    # --- phase 2: in-block cross-stream upper triangle ---------------------
    ii = torch.arange(b, device=dev)
    earlier = ii[None, :] < ii[:, None]                  # j earlier than i
    cross = ready.source[:, None] != ready.source[None, :]
    owner = resp[store_key] & in_slice                   # owner of earlier tuple
    pair = (earlier & cross & owner[None, :] & live_in[:, None]
            & live_in[None, :])
    comps2 = pair.sum()

    # --- outputs (Observation 1: tau = incoming tau + WA) ------------------
    # The predicates only decide outputs: a counting tick skips them.
    outs = _empty_outputs(out_cap, 2 * p, dev)
    if emit:
        within = ready.tau[:, None] - ready.tau[None, :] <= window.ws
        hit2 = pair & within & _directed(f_j, ready.payload[:, None, :],
                                         ready.source[:, None],
                                         ready.payload[None])
        rows2, _, n2 = compact(hit2.reshape(-1), out_cap)
        # one fixed-size emission over both phases, in row order: phase 1's
        # (b, k, r) rows, then phase 2's (i, j) rows from lane n1
        all1 = b * k_virt * ring
        lane = torch.arange(out_cap, device=dev)
        rows = torch.where(lane < n1, rows1,
                           all1 + rows2[(lane - n1).clamp(0, out_cap - 1)])
        n = n1 + n2
        ok = lane < n
        first = rows < all1
        r1 = rows.clamp(max=all1 - 1)
        ki, ri = r1 // ring % k_virt, r1 % ring
        r2 = (rows - all1).clamp(min=0)
        left = torch.where(first, r1 // (k_virt * ring), r2 // b)
        right = torch.where(first[:, None], st.pay[ki, ri],
                            ready.payload[r2 % b])
        outs = compacted_outputs(
            out_cap, ok, n, ready.tau[left] + window.wa,
            torch.cat([ready.payload[left], right], dim=-1))

    # --- phase 3: store (round-robin, one key per tuple) -------------------
    # Lanes this block does not store (not live, or another shard's key) go
    # to one past the end, which _put and index_add drop.
    pos = (st.n[store_key] % ring).long()
    mine = live_in & in_slice
    row = torch.where(mine, store_key, k_virt)
    cell = torch.where(mine, store_key * ring + pos, k_virt * ring)

    def store(a, v):
        flat = a.reshape((k_virt * ring,) + a.shape[2:])
        return _put(flat, cell, v).reshape(a.shape)

    n = torch.cat([st.n, st.n.new_zeros(1)]).index_add(0, row, li)[:k_virt]
    st = FastJoinState(
        tau=store(st.tau, ready.tau),
        pay=store(st.pay, ready.payload),
        stream=store(st.stream, ready.source),
        n=n,
        c=st.c + li.sum(dtype=torch.int32),
        comparisons=(comps1 + comps2).to(torch.float32),
    )
    return st, outs
