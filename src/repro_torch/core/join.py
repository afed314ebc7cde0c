"""Joins: ``J``/``J+`` and ScaleJoin (paper §2.1, §4, Appendix D Operator 3).

Held against ``src/repro/core/join.py``.  ScaleJoin is the ``J+`` of the
evaluation (Q3-Q6): every instance counts every tuple, each tuple is
stored round-robin under exactly one virtual key (``c % K``), and each
instance compares incoming tuples with the tuples stored under its keys.

Two paths: ``scalejoin_def`` on the general ``operator.tick`` (the semantic
oracle) and ``tick_fast``, the blocked whole-tick compare.
``band_join_counts`` is the counting-only compare through the
``window_join`` kernel.  Only the monolithic layout (all K rows, ``resp``
masks) is ported here; the reference's sliced mesh layout
(``k_global``/``k_offset``) comes with the mesh slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T
from repro_torch.core.operator import (OperatorDef, Outputs, Tup, _emit,
                                       _empty_outputs, _put)
from repro_torch.core.watermark import INF_TIME
from repro_torch.core.windows import SINGLE, WindowSpec
from repro_torch.kernels.window_join.ops import window_join_op


def band_predicate(width: float = 10.0, attrs: int = 2) -> Callable:
    """Q3 predicate: |phi_L[i] - phi_R[i]| <= width for the first ``attrs``."""
    def f_j(pl, pr):
        d = (pl[..., :attrs] - pr[..., :attrs]).abs()
        return (d <= width).all(dim=-1)
    return f_j


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


def tick_fast(window: WindowSpec, f_j: Callable, st: FastJoinState,
              ready: T.TupleBatch, resp: torch.Tensor, out_cap: int,
              emit: bool = True) -> Tuple[FastJoinState, Outputs]:
    """Whole-tick ScaleJoin: block compare + in-block triangle + store.

    ``st`` holds all K rows and ``resp`` masks this instance's rows.
    Requires ``ready.batch <= K`` (one store row per tuple per tick).
    Outputs are appended in the reference's order: phase-1 hits by
    ``(b, k, r)``, then phase-2 hits by ``(later, earlier)``.
    """
    k_virt, ring = st.tau.shape
    b = ready.batch
    p = ready.payload.shape[-1]
    dev = ready.device
    if b > k_virt:
        raise ValueError("the fast path stores at most one tuple per key per "
                         f"tick: batch {b} > K {k_virt}")
    live_in = ready.valid & ~ready.is_control
    li = live_in.to(torch.int32)
    rank = torch.cumsum(li, 0, dtype=torch.int32) - li
    store_key = ((st.c + rank) % k_virt).long()

    # --- phase 1: incoming block vs stored rings (resp rows only) ---------
    fresh = st.tau[None] + window.ws >= ready.tau[:, None, None]
    stored_live = (st.tau[None] >= 0) & fresh            # [B, K, R]
    opp = stored_live & (st.stream[None] != ready.source[:, None, None])
    opp = opp & resp[None, :, None] & live_in[:, None, None]
    comps1 = opp.sum()

    # --- phase 2: in-block cross-stream upper triangle ---------------------
    ii = torch.arange(b, device=dev)
    earlier = ii[None, :] < ii[:, None]                  # j earlier than i
    cross = ready.source[:, None] != ready.source[None, :]
    owner = resp[store_key]                              # owner of earlier tuple
    pair = (earlier & cross & owner[None, :] & live_in[:, None]
            & live_in[None, :])
    comps2 = pair.sum()

    # --- outputs (Observation 1: tau = incoming tau + WA) ------------------
    # The predicates only decide outputs: a counting tick skips them.
    outs = _empty_outputs(out_cap, 2 * p, dev)
    if emit:
        hit1 = opp & _directed(f_j, ready.payload[:, None, None, :],
                               ready.source[:, None, None], st.pay[None])
        within = ready.tau[:, None] - ready.tau[None, :] <= window.ws
        hit2 = pair & within & _directed(f_j, ready.payload[:, None, :],
                                         ready.source[:, None],
                                         ready.payload[None])
        idx = hit1.reshape(-1).nonzero().squeeze(1)
        bi, rest = idx // (k_virt * ring), idx % (k_virt * ring)
        ki, ri = rest // ring, rest % ring
        pay1 = torch.cat([ready.payload[bi], st.pay[ki, ri]], dim=-1)
        outs = _emit(outs, ready.tau[bi] + window.wa, pay1,
                     torch.ones_like(idx, dtype=torch.bool))
        idx = hit2.reshape(-1).nonzero().squeeze(1)
        i2, j2 = idx // b, idx % b
        pay2 = torch.cat([ready.payload[i2], ready.payload[j2]], dim=-1)
        outs = _emit(outs, ready.tau[i2] + window.wa, pay2,
                     torch.ones_like(idx, dtype=torch.bool))

    # --- phase 3: store (round-robin, one key per tuple) -------------------
    # Non-live lanes go to one past the end, which _put and index_add drop.
    pos = (st.n[store_key] % ring).long()
    row = torch.where(live_in, store_key, k_virt)
    cell = torch.where(live_in, store_key * ring + pos, k_virt * ring)

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
