"""The generalized stateful operator ``O+`` (paper §4.2, Alg. 2).

Held against ``src/repro/core/operator.py``.  User functions are vectorized
over the virtual key axis ``K``; the runtime keeps per-(key, slot)
occupancy, the ring of live window generations (``slot(l) = l % slots``)
and one scalar ``next_l``, the earliest non-expired window index.

  f_u(zeta_s, tup, win_l, mask[K])  -> (zeta_s', out_payload[K,P], out_valid[K])
  f_o(zeta_s, win_l, key_ids[K])    -> (out_payload[K,P], out_valid[K])
  f_s(zeta_s, new_left)             -> (zeta_s', occupied[K])

``zeta`` is a dict of tensors with leading dims ``[K, slots]``.
``init_zeta(device)`` builds it on a device.

``tick`` processes a ready batch one tuple at a time, in a Python loop over
the lanes (the reference's ``lax.scan``): it is the semantic oracle, run in
the CPU tests at small sizes and by ``SNPipeline``'s default tick.  Its
expiry loop (``_expire_all``) is a Python ``while`` that reads ``next_l``
back to the host once per round.  ``expire_closed`` is the same expiry
with no host read, for the whole-tick fast paths: every closed generation
is expired in one vectorised pass over the slot ring, and ``compact``
writes the emitted rows into a fixed-size output buffer.

State updates are out of place: one state is the input of every VSN
instance of a tick, so no instance may write into it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T
from repro_torch.core.windows import MULTI, SINGLE, WindowSpec

# next_l before any tuple arrived (resolved on first contact, Alg. 2 L24).
UNSET_L = torch.iinfo(torch.int32).min


@dataclasses.dataclass(frozen=True)
class Tup:
    """One tuple, as seen by f_U."""
    tau: torch.Tensor       # i32[]
    payload: torch.Tensor   # f32[P]
    source: torch.Tensor    # i32[]
    keys: torch.Tensor      # i32[KMAX]


@dataclasses.dataclass(frozen=True)
class OpState:
    zeta: Any                # dict of tensors, leaves [K, slots, ...]
    occupied: torch.Tensor   # bool[K, slots]
    next_l: torch.Tensor     # i32[] earliest non-expired window index
    watermark: torch.Tensor  # i32[] instance watermark W


@dataclasses.dataclass(frozen=True)
class Outputs:
    """Fixed-capacity output buffer for one tick (+ overflow accounting)."""
    tau: torch.Tensor       # i32[cap]
    payload: torch.Tensor   # f32[cap, P]
    valid: torch.Tensor     # bool[cap]
    count: torch.Tensor     # i32[] number of valid lanes
    overflow: torch.Tensor  # i32[] outputs dropped (buffer too small)


_SHARED = threading.local()


@contextlib.contextmanager
def instances_share():
    """Inside this block ``shared`` builds each value once.  The VSN
    instances of one tick hand their tick function the same state and the
    same ready batch; the work that does not depend on an instance's
    responsibility mask is then the same for all of them, and is done once
    (the reference's ``vmap`` computes it once as well)."""
    prev = getattr(_SHARED, "memo", None)
    _SHARED.memo = {}
    try:
        yield
    finally:
        _SHARED.memo = prev


def shared(key: tuple, build: Callable):
    """``build()``, or inside ``instances_share`` the value already built
    for the same ``key`` objects (compared by identity)."""
    memo = getattr(_SHARED, "memo", None)
    if memo is None:
        return build()
    ids = tuple(id(x) for x in key)
    hit = memo.get(ids)
    if hit is None or any(a is not b for a, b in zip(hit[0], key)):
        hit = memo[ids] = (key, build())
    return hit[1]


def _empty_outputs(cap: int, p: int, device) -> Outputs:
    i32 = dict(dtype=torch.int32, device=device)
    return Outputs(tau=torch.zeros((cap,), **i32),
                   payload=torch.zeros((cap, p), dtype=torch.float32,
                                       device=device),
                   valid=torch.zeros((cap,), dtype=torch.bool, device=device),
                   count=torch.zeros((), **i32),
                   overflow=torch.zeros((), **i32))


def _put(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``buf[idx] = vals`` out of place; ``idx == len(buf)`` is dropped (the
    reference's ``mode="drop"``).  Real indices must be unique."""
    ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    return ext.index_put((idx,), vals)[:-1]


def _emit(outs: Outputs, tau, payload: torch.Tensor,
          valid: torch.Tensor) -> Outputs:
    """Append the valid rows, in row order, into the output buffer; rows
    past its capacity are dropped and counted."""
    cap = outs.tau.shape[0]
    vi = valid.to(torch.int32)
    pos = outs.count + torch.cumsum(vi, 0, dtype=torch.int32) - vi
    idx = torch.where(valid & (pos < cap), pos, cap).long()
    n = vi.sum(dtype=torch.int32)
    tau_b = torch.as_tensor(tau, dtype=torch.int32,
                            device=valid.device).expand(valid.shape)
    return Outputs(
        tau=_put(outs.tau, idx, tau_b),
        payload=_put(outs.payload, idx, payload.to(torch.float32)),
        valid=_put(outs.valid, idx, valid),
        count=(outs.count + n).clamp(max=cap),
        overflow=outs.overflow + (outs.count + n - cap).clamp(min=0)
        - (outs.count - cap).clamp(min=0),
    )


# ---------------------------------------------------------------------------
# Table-1 default behaviours
# ---------------------------------------------------------------------------

def _set_at(a: torch.Tensor, rows, cols, v) -> torch.Tensor:
    new = a.clone()
    new[rows, cols] = v
    return new


def default_f_u(zeta_s, tup: Tup, win_l, mask):
    """Store t in w.zeta of t's sender; return no phi (Table 1)."""
    k, ring = zeta_s["tau"].shape
    slot = (zeta_s["count"] % ring).long()
    k_ids = torch.arange(k, device=slot.device)
    new = {
        "tau": _set_at(zeta_s["tau"], k_ids, slot, tup.tau),
        "payload": _set_at(zeta_s["payload"], k_ids, slot, tup.payload),
        "source": _set_at(zeta_s["source"], k_ids, slot, tup.source),
        "count": zeta_s["count"] + 1,
    }
    p = tup.payload.shape[-1]
    return (new, torch.zeros((k, p), dtype=torch.float32, device=slot.device),
            torch.zeros((k,), dtype=torch.bool, device=slot.device))


def default_f_o(zeta_s, win_l, key_ids):
    """Return no phi (Table 1)."""
    k = key_ids.shape[0]
    p = (zeta_s["payload"].shape[-1]
         if isinstance(zeta_s, dict) and "payload" in zeta_s else 1)
    return (torch.zeros((k, p), dtype=torch.float32, device=key_ids.device),
            torch.zeros((k,), dtype=torch.bool, device=key_ids.device))


def default_f_s(ws: int):
    """Purge stale tuples (Table 1): drop entries with tau < new left bound."""
    def f_s(zeta_s, new_left):
        zeta = dict(zeta_s)
        zeta["tau"] = torch.where(zeta_s["tau"] < new_left, -1, zeta_s["tau"])
        live = (zeta["tau"] >= 0).sum(dim=-1)
        return zeta, live > 0
    return f_s


# ---------------------------------------------------------------------------
# The operator definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OperatorDef:
    """``O+(WA, WS, I, f_MK, WT, S, f_mu, f_U, f_O, f_S)`` — paper §4.2.

    Key sets arrive materialized in ``TupleBatch.keys``; ``f_mu`` lives
    with the executor (epoch state), not here.
    """
    window: WindowSpec
    n_inputs: int                                   # I
    k_virt: int                                     # virtual key space |K|
    payload_out: int                                # S (flattened width)
    init_zeta: Callable[[Any], Any]                 # device -> zeta
    f_u: Callable = None
    f_o: Callable = None
    f_s: Callable = None
    out_cap: int = 256                              # per-tick output lanes
    extra_slots: int = 0                            # ring slack for batched paths
    lazy_expiry: bool = False                       # skip f_O rounds when f_O = "-"
    name: str = "o_plus"

    @property
    def slots(self) -> int:
        """Physical slot-ring size >= live window instances."""
        return self.window.n_slots + self.extra_slots

    def slot_of(self, l):
        return l % self.slots

    def resolved(self) -> "OperatorDef":
        """Fill Table-1 defaults for unspecified functions."""
        return dataclasses.replace(
            self,
            f_u=self.f_u or default_f_u,
            f_o=self.f_o or default_f_o,
            f_s=self.f_s or default_f_s(self.window.ws),
        )

    def init_state(self, device=None) -> OpState:
        dev = _device.resolve(device)
        return OpState(
            zeta=self.init_zeta(dev),
            occupied=torch.zeros((self.k_virt, self.slots), dtype=torch.bool,
                                 device=dev),
            next_l=torch.full((), UNSET_L, dtype=torch.int32, device=dev),
            watermark=torch.zeros((), dtype=torch.int32, device=dev))


def _slot_index(s):
    return s.long() if isinstance(s, torch.Tensor) else s


def _slice_slot(zeta, s):
    s = _slot_index(s)
    return {name: a[:, s] for name, a in zeta.items()}


def _set_col(a: torch.Tensor, s, v) -> torch.Tensor:
    new = a.clone()
    new[:, _slot_index(s)] = v
    return new


def _set_slot(zeta, s, zeta_s):
    return {name: _set_col(a, s, zeta_s[name]) for name, a in zeta.items()}


def _expire_round(op: OperatorDef, st: OpState, outs: Outputs,
                  resp: torch.Tensor, key_ids: torch.Tensor):
    """forwardAndShift for the earliest live window generation (Alg. 2 L12-18)."""
    ws = op.window
    s = op.slot_of(st.next_l)
    zeta_s = _slice_slot(st.zeta, s)
    payload, f_valid = op.f_o(zeta_s, st.next_l, key_ids)
    occ = st.occupied[:, _slot_index(s)]
    outs = _emit(outs, ws.right_of(st.next_l), payload, f_valid & occ & resp)

    if ws.wt == SINGLE:
        zeta_new, still_occ = op.f_s(zeta_s, ws.left_of(st.next_l + 1))
        zeta = _set_slot(st.zeta, s, zeta_new)
        occupied = _set_col(st.occupied, s, still_occ & occ)
    else:
        fresh = _slice_slot(op.init_zeta(st.occupied.device), s)
        zeta = _set_slot(st.zeta, s, fresh)
        occupied = _set_col(st.occupied, s, False)
    return dataclasses.replace(st, zeta=zeta, occupied=occupied,
                               next_l=st.next_l + 1), outs


def compact(valid: torch.Tensor, cap: int):
    """The first ``cap`` rows of ``valid`` that are set, in row order, with
    no host read: ``(rows, ok, n)``, where ``rows`` (int64[cap]) is each
    output lane's row (0 on a lane past the last set row), ``ok`` marks the
    lanes in use and ``n`` (int32[]) counts every set row."""
    idx = torch.nonzero_static(valid, size=cap, fill_value=-1).squeeze(1)
    ok = idx >= 0
    return idx.clamp(min=0), ok, valid.sum(dtype=torch.int32)


def compacted_outputs(cap: int, ok: torch.Tensor, n: torch.Tensor,
                      tau: torch.Tensor, payload: torch.Tensor) -> Outputs:
    """A fresh output buffer holding ``compact``'s lanes: what ``_emit``
    into an empty buffer gives for the same rows (the lanes past the count
    zero, rows past ``cap`` dropped and counted)."""
    return Outputs(
        tau=torch.where(ok, tau, 0),
        payload=torch.where(ok[:, None], payload.to(torch.float32), 0.0),
        valid=ok, count=n.clamp(max=cap), overflow=(n - cap).clamp(min=0))


def expiry_plan(op: OperatorDef, n0, w, key_ids: torch.Tensor) -> dict:
    """The part of ``expire_closed`` that depends only on the frontier
    ``n0`` (= ``next_l``) and the watermark ``w``: which generations close,
    their slots, their output taus, and the slots they empty."""
    ws = op.window
    n_s = op.slots
    k = key_ids.shape[0]
    next_l = torch.where(n0 == UNSET_L, n0,
                         torch.maximum(n0, ws.earliest_win_l(w)))
    n_closed = next_l - n0
    d = torch.arange(n_s, dtype=torch.int32, device=key_ids.device)
    l = n0 + d                                     # generation n0 + d ...
    ring = (d - n0) % n_s                          # ... slot s holds n0 + ring[s]
    return dict(next_l=next_l, closes=d < n_closed, s_d=(l % n_s).long(),
                l_rows=l.repeat_interleave(k), key_rows=key_ids.repeat(n_s),
                tau_rows=ws.right_of(l).repeat_interleave(k),
                gone=ring < n_closed, gen=n0 + ring)


def expire_closed(op: OperatorDef, st: OpState, w, resp: torch.Tensor,
                  key_ids: torch.Tensor, plan: dict = None
                  ) -> Tuple[OpState, Outputs]:
    """``_expire_all`` into an empty buffer, with no host read.

    The generations ``next_l .. e - 1`` close, where ``e =
    earliest_win_l(w)``.  The ring holds ``op.slots`` consecutive
    generations, one a slot, so the first ``op.slots`` of them are the
    ones that can emit: each is emptied at its round (a recycled slot under
    WT=multi; under WT=single ``f_s``, which for the fast path's aggregates
    clears the slot), and a later round on the same slot finds it
    unoccupied.  Their rounds run as one pass over the ring in window order
    (rows ``(d, k)`` for generation ``next_l + d`` and key ``k``, the
    loop's emission order), and ``next_l`` moves to ``max(next_l, e)`` at
    once.  ``plan`` is ``expiry_plan(op, st.next_l, w, key_ids)``, shared
    by the instances of a tick.
    """
    if plan is None:
        plan = expiry_plan(op, st.next_l, w, key_ids)
    ws = op.window
    n_s = op.slots
    k = key_ids.shape[0]
    s_d = plan["s_d"]
    zeta_d = {name: a.transpose(0, 1)[s_d].reshape((n_s * k,) + a.shape[2:])
              for name, a in st.zeta.items()}
    payload, f_valid = op.f_o(zeta_d, plan["l_rows"], plan["key_rows"])
    emit = (st.occupied.t()[s_d] & resp & plan["closes"][:, None])
    rows, ok, n = compact(emit.reshape(-1) & f_valid, op.out_cap)
    outs = compacted_outputs(op.out_cap, ok, n, plan["tau_rows"][rows],
                             payload[rows])

    gone = plan["gone"]                            # emptied slots
    if ws.wt == SINGLE:
        flat = {name: a.reshape((k * n_s,) + a.shape[2:])
                for name, a in st.zeta.items()}
        new, still = op.f_s(flat, ws.left_of(plan["gen"] + 1).repeat(k))
        new = {name: a.reshape(st.zeta[name].shape) for name, a in new.items()}
        occupied = torch.where(gone, still.reshape(k, n_s) & st.occupied,
                               st.occupied)
    else:
        new = op.init_zeta(resp.device)
        occupied = st.occupied & ~gone
    zeta = {name: torch.where(
        gone.reshape((1, n_s) + (1,) * (a.ndim - 2)), new[name], a)
        for name, a in st.zeta.items()}
    return dataclasses.replace(st, zeta=zeta, occupied=occupied,
                               next_l=plan["next_l"]), outs


def _expire_all(op: OperatorDef, st: OpState, outs: Outputs, w,
                resp: torch.Tensor, key_ids: torch.Tensor):
    """while rho + WS <= W: forwardAndShift (Alg. 2 L33-35).

    A window ``[l*WA, l*WA+WS)`` closes once ``W >= l*WA + WS``.  The loop
    condition is read back to the host each round.
    """
    while bool((st.next_l != UNSET_L) & (op.window.right_of(st.next_l) <= w)):
        st, outs = _expire_round(op, st, outs, resp, key_ids)
    return st, outs


def process_tuple(op: OperatorDef, st: OpState, outs: Outputs, tup: Tup,
                  resp: torch.Tensor, valid) -> Tuple[OpState, Outputs]:
    """processSN/processVSN body for one ready tuple (Alg. 2 L31-36).

    ``resp`` is the responsibility mask over virtual keys for this
    instance under the current epoch's f_mu (Alg. 2 L26 / Alg. 4 L23).
    """
    ws = op.window
    dev = resp.device
    key_ids = torch.arange(op.k_virt, dtype=torch.int32, device=dev)

    w = torch.where(valid, torch.maximum(st.watermark, tup.tau), st.watermark)
    next_l = torch.where((st.next_l == UNSET_L) & valid,
                         ws.earliest_win_l(tup.tau), st.next_l)
    st = dataclasses.replace(st, watermark=w, next_l=next_l)

    if op.lazy_expiry:
        e = ws.earliest_win_l(w)
        next_l = torch.where(st.next_l == UNSET_L, e,
                             torch.maximum(st.next_l, e))
        st = dataclasses.replace(st, next_l=next_l)
    else:
        st, outs = _expire_all(op, st, outs, w, resp, key_ids)

    # handleInputTuple (Alg. 2 L19-30): union of the key set's one-hots.
    khit = torch.zeros((op.k_virt,), dtype=torch.bool, device=dev)
    for kk in range(tup.keys.shape[0]):
        key = tup.keys[kk]
        khit = khit | ((key_ids == key) & (key >= 0))
    khit = khit & resp & valid

    l_min_raw, l_max = ws.window_indices(tup.tau)
    l_min = torch.maximum(l_min_raw, st.next_l)  # expired generations excluded
    if ws.wt == SINGLE:
        l_max = l_min

    for off in range(ws.n_slots if ws.wt == MULTI else 1):
        l = l_min + off
        s = op.slot_of(l)
        zeta_s = _slice_slot(st.zeta, s)
        mask = khit & (l <= l_max)
        zeta_new, payload, f_valid = op.f_u(zeta_s, tup, l, mask)
        zeta_sel = {
            name: torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                              new, zeta_s[name])
            for name, new in zeta_new.items()}
        occ = st.occupied[:, _slot_index(s)]
        st = dataclasses.replace(st, zeta=_set_slot(st.zeta, s, zeta_sel),
                                 occupied=_set_col(st.occupied, s, occ | mask))
        # f_U may emit multiple outputs per key: payload [K,P] or [K,E,P].
        if payload.ndim == 3:
            emit_valid = (f_valid & mask[:, None]).reshape(-1)
            payload = payload.reshape(-1, payload.shape[-1])
        else:
            emit_valid = f_valid & mask
        outs = _emit(outs, ws.right_of(l), payload, emit_valid)
    return st, outs


def advance_explicit(op: OperatorDef, st: OpState, outs: Outputs,
                     explicit_w, resp: torch.Tensor):
    """Explicit watermark at the end of a tick (§2.3): an end-of-tick
    watermark reaches the instance whatever was routed to it, and the
    windows it closes are expired."""
    w = torch.maximum(st.watermark, torch.as_tensor(
        explicit_w, dtype=torch.int32, device=st.watermark.device))
    e = op.window.earliest_win_l(w)
    next_l = torch.where(st.next_l == UNSET_L, e, st.next_l)
    st = dataclasses.replace(st, watermark=w, next_l=next_l)
    if op.lazy_expiry:
        return dataclasses.replace(st, next_l=torch.maximum(st.next_l, e)), outs
    key_ids = torch.arange(op.k_virt, dtype=torch.int32, device=resp.device)
    return _expire_all(op, st, outs, w, resp, key_ids)


def tick(op: OperatorDef, st: OpState, ready: T.TupleBatch,
         resp: torch.Tensor, explicit_w=None) -> Tuple[OpState, Outputs]:
    """Process one ready batch tuple by tuple (general, order-preserving).

    ``explicit_w`` models explicit watermark propagation (§2.3), which SN
    needs when an instance's queue runs dry.
    """
    op = op.resolved()
    outs = _empty_outputs(op.out_cap, op.payload_out, ready.device)
    live = ready.valid & ~ready.is_control
    for lane in range(ready.batch):
        tup = Tup(tau=ready.tau[lane], payload=ready.payload[lane],
                  source=ready.source[lane], keys=ready.keys[lane])
        st, outs = process_tuple(op, st, outs, tup, resp, live[lane])
    if explicit_w is not None:
        st, outs = advance_explicit(op, st, outs, explicit_w, resp)
    return st, outs
