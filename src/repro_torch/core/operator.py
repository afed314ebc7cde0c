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

Two marks on the functions, set by the Table-1 defaults, let the general
tick's bounded expiry skip rounds whatever the state (``_skippable``):
``f_s.purge`` (f_S only drops entries left of its bound, so two purges
equal the later one) and ``f_o.silent`` (f_O emits nothing).  No other
mark is read; an unmarked f_S is checked on the data instead.

``tick_instances`` is the general tick: Alg. 2 one ready tuple at a
time, for every VSN or SN instance in one pass (a leading ``[n]`` axis on
``resp``, the state and the outputs, the reference's ``vmap`` of its
``lax.scan``).  Captured, it reads nothing back to the host: each lane is
a fixed set of tensor operations, the lanes' watermarks and window
frontiers are prefix maxima over the sorted batch, and the expiry's
``while`` is bounded (``_plan``: one masked round a slot, and under
WT=single a second pass for each slot's last due round).  That bound is
taken only where it is needed: inside a CUDA graph capture, or where it
is exact whatever the data.  Where it may not be exact a tick run eagerly
reads the most rounds due back to the host (one host read a tick, only
for such operators) and runs every one of them, as the reference's
``while`` does; a captured tick sets a device flag instead where the
bound cannot be shown exact, and the caller raises ``ExpiryBoundError``
after the replay.  User functions run under ``torch.func.vmap``, each
call seeing one slot, as the reference calls them.  ``tick`` is its
one-instance form.  ``expire_closed`` is the whole-tick fast paths'
expiry (one vectorised pass over the slot ring), and ``compact`` writes
their emitted rows into a fixed-size output buffer.

The shared input state is never written: one state is the input of
every VSN instance of a tick.  A tick's own buffers are written in place.
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

    def as_batch(self, kmax: int = 1) -> T.TupleBatch:
        """The buffer as a ``TupleBatch`` on its device (no keys)."""
        return T.make_batch(self.tau, self.payload, valid=self.valid,
                            kmax=kmax, device=self.tau.device)


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


# ---------------------------------------------------------------------------
# Table-1 default behaviours
# ---------------------------------------------------------------------------

def tuple_store_init(k: int, n_slots: int, ring: int, p: int, device=None):
    """Default zeta: bounded per-(key, slot) tuple ring (Table 1 f_U
    default), on ``device`` (default: the card)."""
    dev = _device.resolve(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "tau": torch.full((k, n_slots, ring), -1, **i32),
        "payload": torch.zeros((k, n_slots, ring, p), dtype=torch.float32,
                               device=dev),
        "source": torch.zeros((k, n_slots, ring), **i32),
        "count": torch.zeros((k, n_slots), **i32),
    }


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


default_f_o.silent = True


def default_f_s(ws: int):
    """Purge stale tuples (Table 1): drop entries with tau < new left bound."""
    def f_s(zeta_s, new_left):
        zeta = dict(zeta_s)
        zeta["tau"] = torch.where(zeta_s["tau"] < new_left, -1, zeta_s["tau"])
        live = (zeta["tau"] >= 0).sum(dim=-1)
        return zeta, live > 0
    f_s.purge = True
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
    """The round-by-round expiry (Alg. 2 L33-35) into an empty buffer,
    with no host read.

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




# ---------------------------------------------------------------------------
# The general tick: every instance in one pass, no host read
# ---------------------------------------------------------------------------

class ExpiryBoundError(RuntimeError):
    """A captured general tick's bounded expiry could not be shown to
    equal the round-by-round loop: under WT=single more than two rounds
    were due on a slot, and after its first one the slot held an occupied
    key or f_S still changed its state (see ``_expire``).  Raised only
    after a graph replay; an eager tick runs every due round instead."""


_FAULTS = threading.local()


@contextlib.contextmanager
def expiry_faults():
    """Collect, instead of raising, the general ticks' expiry flags (device
    bool scalars) of the calls inside this block: the caller reads them at
    a sync it already has (``raise_on_fault``)."""
    prev = getattr(_FAULTS, "flags", None)
    _FAULTS.flags = []
    try:
        yield _FAULTS.flags
    finally:
        _FAULTS.flags = prev


def any_fault(flags):
    """The collected flags as one device bool, or None when no tick could
    raise one."""
    return torch.stack(flags).any() if flags else None


def raise_on_fault(fault) -> None:
    """Host read of a collected flag; raises ``ExpiryBoundError``."""
    if fault is not None and bool(fault):
        raise ExpiryBoundError(
            "the general tick's expiry closed more than two window "
            "generations on a slot that f_S kept occupied or kept "
            "changing; its bounded form cannot show the rounds between to "
            "be empty")


def _report(fault) -> None:
    flags = getattr(_FAULTS, "flags", None)
    if flags is None:
        raise_on_fault(fault)           # a standalone call: its end
    else:
        flags.append(fault)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _take(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``a[i, s[i, d]]``: a slot-major ``[n, S, ...]`` leaf at the slots
    ``s`` (int64 ``[n, D]``) -> ``[n, D, ...]``."""
    ix = s.reshape(s.shape + (1,) * (a.ndim - 2)).expand(
        s.shape + a.shape[2:])
    return torch.gather(a, 1, ix)


def _give(a: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_take``'s inverse, in place on the tick's private ``a``:
    ``a[i, s[i, d]] = v[i, d]`` (the slots of a row are distinct)."""
    ix = s.reshape(s.shape + (1,) * (a.ndim - 2)).expand(v.shape)
    return a.scatter_(1, ix, v.to(a.dtype))


def _bcast(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (a.ndim - m.ndim))


def _flat2(zeta: dict) -> dict:
    """``[n, D, K, ...]`` views as ``[n * D, K, ...]``."""
    return {nm: a.reshape((-1,) + a.shape[2:]) for nm, a in zeta.items()}


def _rounds(op: OperatorDef, z, occ, gen, act, resp, key_ids, fresh):
    """Closing rounds (forwardAndShift, Alg. 2 L12-18) of the generations
    ``gen`` (i32 ``[n, D]``, distinct slots in a row) where ``act``; ``z``,
    ``occ`` and ``fresh`` are slot-major.  Returns the new ``z``, ``occ``,
    the rows emitted, round by round: ``payload [n, D * K, P]`` and
    ``valid [n, D * K]`` (their taus are ``right_of(gen)``), and under
    WT=single ``same`` (bool ``[n, D]``: f_S returned the slot's state as
    it was; None under WT=multi)."""
    ws = op.window
    n, d = gen.shape
    k = key_ids.shape[0]
    s = (gen % op.slots).long()
    zd = {name: _take(a, s) for name, a in z.items()}
    occ_d = _take(occ, s)
    payload, f_valid = torch.func.vmap(lambda zs, l: op.f_o(zs, l, key_ids))(
        _flat2(zd), gen.reshape(-1))
    valid = (f_valid.reshape(n, d, k) & occ_d & resp[:, None, :]
             & act[..., None])
    if ws.wt == SINGLE:
        new, still = torch.func.vmap(op.f_s)(
            _flat2(zd), ws.left_of(gen + 1).reshape(-1))
        z = {nm: _give(a, s, torch.where(
            _bcast(act, zd[nm]), new[nm].reshape(zd[nm].shape), zd[nm]))
            for nm, a in z.items()}
        occ = _give(occ, s, torch.where(
            act[..., None], still.reshape(n, d, k) & occ_d, occ_d))
        same = _same(zd, new)
    else:
        same = None
        z = {nm: _give(a, s, torch.where(_bcast(act, zd[nm]), fresh[nm][s],
                                         zd[nm]))
             for nm, a in z.items()}
        occ = _give(occ, s, occ_d & ~act[..., None])
    return (z, occ, payload.reshape(n, d * k, -1), valid.reshape(n, d * k),
            same)


def _same(zd: dict, new: dict) -> torch.Tensor:
    """bool ``[n, D]``: f_S's result ``new`` (``[n * D, K, ...]``) is the
    slots' state ``zd`` (``[n, D, K, ...]``) as it was."""
    n, d = next(iter(zd.values())).shape[:2]
    return torch.stack([
        (new[nm].reshape(zd[nm].shape) == zd[nm]).reshape(n, d, -1).all(-1)
        for nm in zd]).all(0)


def _keeps(op: OperatorDef, z, s, gen) -> torch.Tensor:
    """bool ``[n, D]``: f_S at the closing bound of generation ``gen``
    returns the state of slot ``s`` (both ``[n, D]``) as it is."""
    zd = {name: _take(a, s) for name, a in z.items()}
    new, _ = torch.func.vmap(op.f_s)(_flat2(zd),
                                     op.window.left_of(gen + 1).reshape(-1))
    return _same(zd, new)


def _skippable(op: OperatorDef) -> bool:
    """The rounds between a slot's first and last closing round change
    nothing the last one does not, whatever the state: WT=multi recycles
    the slot, or f_S purges by its left bound (purges compose to the last)
    while f_O emits nothing (the module's ``purge`` and ``silent``
    marks)."""
    return (op.window.wt == MULTI
            or (getattr(op.f_s, "purge", False)
                and getattr(op.f_o, "silent", False)))


def _plan(op: OperatorDef, m, c):
    """The expiry loop (Alg. 2 L33-35) with a bound, for the ``c``
    generations that close from ``m`` (i32, any leading shape ``[...]``):
    ``op.slots`` masked rounds, the first round of each slot.  A later
    round on a slot finds it emptied under WT=multi.  Under WT=single
    ``f_S`` may keep it occupied, so a second pass runs each slot's last
    due round; the rounds between are skipped, which is exact where
    ``_skippable`` says so and otherwise checked on the data (``_expire``).
    Returns the passes ``[(gen, act)]`` (``[..., slots]`` each, rounds in
    order) and ``skips`` (``[..., slots]``: the second pass's slots with
    rounds skipped before it, or None where none can matter).  Where the
    skip may matter and the tick is not captured, the loop is run whole
    instead: the most rounds due are read back to the host and every one
    of them runs, a pass of ``op.slots`` rounds at a time."""
    n_s = op.slots
    d = torch.arange(n_s, dtype=torch.int32, device=m.device)
    if op.window.wt == SINGLE and not _skippable(op) and not _capturing():
        n_pass = max(1, -(-int(c.max()) // n_s))
        return [(m[..., None] + j * n_s + d, j * n_s + d < c[..., None])
                for j in range(n_pass)], None
    passes = [(m[..., None] + d, d < c[..., None])]
    skips = None
    if op.window.wt == SINGLE:
        d2 = c[..., None] - n_s + d
        passes.append((m[..., None] + d2, d2 >= n_s))
        if not _skippable(op):
            skips = d2 >= 2 * n_s
    return passes, skips


def _expire(op: OperatorDef, z, occ, passes, skips, resp, key_ids, fresh):
    """Run ``_plan``'s passes (``[n, slots]`` each) on slot-major state.
    Returns ``(z, occ, rows, fault)``: ``rows`` a ``(payload, valid)`` a
    pass, ``fault`` a device bool (or None) that a skipped round may have
    mattered.

    A slot's skipped rounds are empty where, after its first round, no key
    of the slot is occupied (nothing emits, and occupancy stays false) and
    f_S returns the slot's state as it was both at the last round's left
    bound and at the earliest skipped round's: the skipped rounds then
    apply f_S to that same state.  That f_S leaves it so at the bounds
    between too is taken as given: true of an f_S that ignores the bound
    (one that clears the slot), of a purge by it and of one that changes
    the state only left of some bound.  Anywhere else the fault is set."""
    rows, fault = [], None
    for i, (gen, act) in enumerate(passes):
        kept = None
        if i and skips is not None:
            s = (gen % op.slots).long()
            kept = _take(occ.any(dim=-1), s)
            m = passes[0][0][..., :1]
            early = _keeps(op, z, s, m + (gen - m) % op.slots + op.slots)
        z, occ, payload, valid, same = _rounds(op, z, occ, gen, act, resp,
                                               key_ids, fresh)
        if kept is not None:
            fault = (skips & (kept | ~same | ~early)).any()
        rows.append((payload, valid))
    return z, occ, rows, fault


@dataclasses.dataclass
class _Buf:
    """Stacked output buffers with a drop lane at ``cap`` and the
    unclamped count of rows offered, written in place (private to one
    tick)."""
    tau: torch.Tensor       # i32[n, cap + 1]
    payload: torch.Tensor   # f32[n, cap + 1, P]
    valid: torch.Tensor     # bool[n, cap + 1]
    total: torch.Tensor     # i32[n]

    @classmethod
    def empty(cls, n: int, cap: int, p: int, device) -> "_Buf":
        z = lambda *sh, dt=torch.int32: torch.zeros(sh, dtype=dt,
                                                    device=device)
        return cls(z(n, cap + 1), z(n, cap + 1, p, dt=torch.float32),
                   z(n, cap + 1, dt=torch.bool), z(n))

    @classmethod
    def of(cls, outs: Outputs) -> "_Buf":
        """An ``Outputs`` (unstacked) as a one-row buffer."""
        pad = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[None]
        return cls(pad(outs.tau), pad(outs.payload), pad(outs.valid),
                   (outs.count + outs.overflow)[None])

    def emit(self, tau, payload, valid) -> None:
        """Append the valid rows in row order: ``tau [n, M]``, ``payload
        [n, M, P]``, ``valid [n, M]``."""
        cap = self.tau.shape[1] - 1
        vi = valid.to(torch.int32)
        pos = self.total[:, None] + torch.cumsum(vi, 1, dtype=torch.int32) - vi
        idx = torch.where(valid & (pos < cap), pos, cap).long()
        self.tau.scatter_(1, idx, tau)
        self.payload.scatter_(1, idx[..., None].expand(payload.shape),
                              payload.to(torch.float32))
        self.valid.scatter_(1, idx, valid)
        self.total += vi.sum(dim=1, dtype=torch.int32)

    def outputs(self) -> Outputs:
        cap = self.tau.shape[1] - 1
        return Outputs(tau=self.tau[:, :cap], payload=self.payload[:, :cap],
                       valid=self.valid[:, :cap],
                       count=self.total.clamp(max=cap),
                       overflow=(self.total - cap).clamp(min=0))


def _row_taus(taus, k: int, per: list):
    """Each lane's row taus, lane-major: ``taus`` a ``[n, C, D_i]`` tensor
    a part, each entry repeated ``per[i]`` times."""
    n, c = taus[0].shape[:2]
    return torch.cat([t[..., None].expand(n, c, t.shape[2], r).reshape(
        n, c, -1) for t, r in zip(taus, per)], dim=2).reshape(n, -1)


def _slot_major(zeta, n: int, stacked: bool):
    """State leaves ``[K, S, ...]`` (shared) or ``[n, K, S, ...]``
    (stacked) as the tick's private slot-major ``[n, S, K, ...]`` copy,
    which it then writes in place (the input is only read)."""
    copy = lambda a: a.clone(memory_format=torch.contiguous_format)
    if stacked:
        return {name: copy(a.transpose(1, 2)) for name, a in zeta.items()}
    return {name: copy(a.transpose(0, 1)[None].expand(
        (n,) + a.transpose(0, 1).shape)) for name, a in zeta.items()}


# lanes whose output rows are appended to the buffer together
EMIT_CHUNK = 32


def tick_instances(op: OperatorDef, st: OpState, ready: T.TupleBatch,
                   resp: torch.Tensor, *, live: torch.Tensor = None,
                   explicit_w=None, stacked: bool = False,
                   key_offset: int = 0):
    """The general tick (Alg. 2, one ready tuple at a time) for ``n``
    instances in one pass: the reference's ``vmap`` of its ``lax.scan``.

    ``resp`` is bool ``[n, K]``.  ``st`` is one state every instance
    starts from (VSN: it is only read) or, ``stacked``, one a row (SN).
    ``live`` (bool ``[n, B]``) is each instance's queue, default
    ``ready.valid & ~ready.is_control`` for all.  ``key_offset`` runs the
    tick on the key block ``[key_offset, key_offset + K)`` of a mesh
    shard: tuple keys outside it hit nothing, and the key ids ``f_O``
    sees stay global.  Returns ``(state [n, ...], outputs [n, ...])``.
    The watermark and window frontier of every lane come from prefix
    maxima over the sorted batch, and with them every lane's expiry plan
    and window range; the lanes then run in order, each a fixed set of
    tensor operations, and their output rows are appended ``EMIT_CHUNK``
    lanes at a time.  Inside a CUDA graph capture nothing is read back to
    the host; run eagerly, the tick reads the most rounds due where a
    bounded expiry could not be exact (``_plan``).
    """
    op = op.resolved()
    ws = op.window
    n, k = resp.shape
    dev = resp.device
    i32 = dict(dtype=torch.int32, device=dev)
    if live is None:
        live = (ready.valid & ~ready.is_control)[None].expand(n, ready.batch)
    w0 = st.watermark if stacked else st.watermark.expand(n)
    n0 = st.next_l if stacked else st.next_l.expand(n)
    z = _slot_major(st.zeta, n, stacked)
    occ = _slot_major({"o": st.occupied}, n, stacked)["o"]
    fresh = {name: a.transpose(0, 1) for name, a in op.init_zeta(dev).items()}
    key_ids = key_offset + torch.arange(k, **i32)
    buf = _Buf.empty(n, op.out_cap, op.payload_out, dev)
    faults = []

    b = ready.batch
    w_end, n_end = w0, n0
    if b:
        tau = ready.tau
        w = torch.maximum(w0[:, None], torch.cummax(
            torch.where(live, tau, torch.iinfo(torch.int32).min), 1).values)
        e = ws.earliest_win_l(w)
        set0 = (n0 != UNSET_L)[:, None]
        if op.lazy_expiry:
            nb = torch.where(set0, torch.maximum(n0[:, None], e), e)
            passes, skips = [], None
        else:
            first = ws.earliest_win_l(tau[live.to(torch.int32).argmax(1)])
            on = set0 | (torch.cumsum(live.to(torch.int32), 1) > 0)
            nb = torch.where(on, torch.maximum(
                torch.where(set0, n0[:, None], first[:, None]), e), UNSET_L)
            prev = torch.cat([n0[:, None], nb[:, :-1]], 1)
            m = torch.where(on & (prev == UNSET_L), first[:, None], prev)
            passes, skips = _plan(op, m, nb - torch.where(on, m, nb))
        n_upd = ws.n_slots if ws.wt == MULTI else 1
        l_min = torch.maximum(ws.earliest_win_l(tau)[None], nb)
        l_max = l_min if ws.wt == SINGLE else ws.latest_win_l(tau)[None]
        l_u = l_min[..., None] + torch.arange(n_upd, **i32)     # [n, B, U]
        s_u = (l_u % op.slots).long()
        act_u = l_u <= l_max[..., None]
        taus = [ws.right_of(g) for g, _ in passes] + [ws.right_of(l_u)]
        local = ready.keys - key_offset
        kidx = torch.where((ready.keys >= 0) & (local >= 0) & (local < k),
                           local, k).long()
        hit = torch.zeros((b, k + 1), dtype=torch.bool, device=dev).scatter_(
            1, kidx, True)[:, :k]
        pend = []
        for lane in range(b):
            if passes:
                z, occ, rows, fault = _expire(
                    op, z, occ, [(g[:, lane], a[:, lane]) for g, a in passes],
                    None if skips is None else skips[:, lane], resp, key_ids,
                    fresh)
                if fault is not None:
                    faults.append(fault)
            else:
                rows = []
            s = s_u[:, lane]
            mask = ((hit[lane] & resp & live[:, lane, None])[:, None, :]
                    & act_u[:, lane, :, None])
            zu = {name: _take(a, s) for name, a in z.items()}
            occ_u = _take(occ, s)
            tup = Tup(tau=tau[lane], payload=ready.payload[lane],
                      source=ready.source[lane], keys=ready.keys[lane])
            new, payload, f_valid = torch.func.vmap(
                lambda zs, l, mk: op.f_u(zs, tup, l, mk))(
                _flat2(zu), l_u[:, lane].reshape(-1),
                mask.reshape(n * n_upd, k))
            z = {nm: _give(a, s, torch.where(
                _bcast(mask, zu[nm]), new[nm].reshape(zu[nm].shape), zu[nm]))
                for nm, a in z.items()}
            occ = _give(occ, s, occ_u | mask)
            f_valid = f_valid.reshape((n, n_upd, k) + f_valid.shape[2:])
            rows.append((payload.reshape(n, -1, payload.shape[-1]),
                         (f_valid & _bcast(mask, f_valid)).reshape(n, -1)))
            pend.append(rows)
            if len(pend) == EMIT_CHUNK or lane == b - 1:
                j0 = lane + 1 - len(pend)
                buf.emit(_row_taus([t[:, j0:lane + 1] for t in taus], k,
                                   [k] * len(passes) +
                                   [rows[-1][1].shape[1] // n_upd]),
                         torch.cat([p for r in pend for p, _ in r], dim=1),
                         torch.cat([v for r in pend for _, v in r], dim=1))
                pend = []
        w_end, n_end = w[:, -1], nb[:, -1]

    if explicit_w is not None:
        w_end = torch.maximum(w_end, torch.as_tensor(explicit_w, **i32))
        e = ws.earliest_win_l(w_end)
        start = torch.where(n_end == UNSET_L, e, n_end)
        n_end = torch.maximum(start, e)
        if not op.lazy_expiry:
            z, occ, fault = _expire_emit(op, z, occ, start, n_end - start,
                                         resp, key_ids, fresh, buf)
            if fault is not None:
                faults.append(fault)
    if faults:
        _report(torch.stack(faults).any())
    state = OpState(zeta={name: a.transpose(1, 2) for name, a in z.items()},
                    occupied=occ.transpose(1, 2), next_l=n_end,
                    watermark=w_end)
    return state, buf.outputs()


def _expire_emit(op: OperatorDef, z, occ, m, c, resp, key_ids, fresh,
                 buf: _Buf):
    """The bounded expiry of ``c`` generations from ``m`` (``[n]``), its
    rows appended to ``buf``.  Returns ``(z, occ, fault)``."""
    passes, skips = _plan(op, m, c)
    z, occ, rows, fault = _expire(op, z, occ, passes, skips, resp, key_ids,
                                  fresh)
    k = key_ids.shape[0]
    buf.emit(_row_taus([op.window.right_of(g)[:, None] for g, _ in passes],
                       k, [k] * len(passes)),
             torch.cat([p for p, _ in rows], dim=1),
             torch.cat([v for _, v in rows], dim=1))
    return z, occ, fault


def tick(op: OperatorDef, st: OpState, ready: T.TupleBatch,
         resp: torch.Tensor, explicit_w=None,
         key_offset: int = 0) -> Tuple[OpState, Outputs]:
    """One instance's general tick (``tick_instances`` with one row).

    ``explicit_w`` models explicit watermark propagation (§2.3), which SN
    needs when an instance's queue runs dry.  ``key_offset``: the mesh
    shard's key block (see ``tick_instances``).
    """
    state, outs = tick_instances(op, st, ready, resp[None],
                                 explicit_w=explicit_w, key_offset=key_offset)
    one = lambda a: a[0]
    return (OpState(zeta={nm: one(a) for nm, a in state.zeta.items()},
                    occupied=one(state.occupied), next_l=one(state.next_l),
                    watermark=one(state.watermark)),
            Outputs(*(one(getattr(outs, f.name))
                      for f in dataclasses.fields(Outputs))))


def advance_explicit(op: OperatorDef, st: OpState, outs: Outputs,
                     explicit_w, resp: torch.Tensor, key_offset: int = 0):
    """Explicit watermark at the end of a tick (§2.3): an end-of-tick
    watermark reaches the instance whatever was routed to it, and the
    windows it closes are expired (bounded, as the general tick's), their
    rows appended to ``outs`` (key ids from ``key_offset``)."""
    op = op.resolved()
    w = torch.maximum(st.watermark, torch.as_tensor(
        explicit_w, dtype=torch.int32, device=st.watermark.device))
    e = op.window.earliest_win_l(w)
    start = torch.where(st.next_l == UNSET_L, e, st.next_l)
    st = dataclasses.replace(st, watermark=w, next_l=torch.maximum(start, e))
    if op.lazy_expiry:
        return st, outs
    key_ids = key_offset + torch.arange(op.k_virt, dtype=torch.int32,
                                        device=resp.device)
    fresh = {name: a.transpose(0, 1)
             for name, a in op.init_zeta(resp.device).items()}
    buf = _Buf.of(outs)
    z, occ, fault = _expire_emit(
        op, _slot_major(st.zeta, 1, False),
        _slot_major({"o": st.occupied}, 1, False)["o"], start[None],
        (st.next_l - start)[None], resp[None], key_ids, fresh, buf)
    if fault is not None:
        _report(fault)
    got = buf.outputs()
    return dataclasses.replace(
        st, zeta={name: a[0].transpose(0, 1) for name, a in z.items()},
        occupied=occ[0].transpose(0, 1)), Outputs(
        *(getattr(got, f.name)[0] for f in dataclasses.fields(Outputs)))
