"""The general O+ tick as a host loop: the port's tick before it ran as
one device program, kept as the semantic oracle of the ``test_torch_*``
files.  One Python iteration a lane, one instance at a time, and the
expiry's ``while`` reads ``next_l`` back to the host every round, as
``src/repro/core/operator.py``'s ``lax.while_loop`` spells it."""

import dataclasses

import torch

from repro_torch.core.operator import (UNSET_L, OperatorDef, OpState,
                                       Outputs, Tup, _empty_outputs, _put)
from repro_torch.core.windows import MULTI, SINGLE


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


def _col(s):
    return s.long() if isinstance(s, torch.Tensor) else s


def _slice_slot(zeta, s):
    return {name: a[:, _col(s)] for name, a in zeta.items()}


def _set_col(a, s, v):
    new = a.clone()
    new[:, _col(s)] = v
    return new


def _set_slot(zeta, s, zeta_s):
    return {name: _set_col(a, s, zeta_s[name]) for name, a in zeta.items()}


def _expire_round(op: OperatorDef, st: OpState, outs: Outputs, resp,
                  key_ids):
    """forwardAndShift for the earliest live window generation."""
    ws = op.window
    s = op.slot_of(st.next_l)
    zeta_s = _slice_slot(st.zeta, s)
    payload, f_valid = op.f_o(zeta_s, st.next_l, key_ids)
    occ = st.occupied[:, _col(s)]
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


def expire_all(op: OperatorDef, st: OpState, outs: Outputs, w, resp,
               key_ids):
    """while rho + WS <= W: forwardAndShift, reading the condition back to
    the host each round."""
    while bool((st.next_l != UNSET_L) & (op.window.right_of(st.next_l) <= w)):
        st, outs = _expire_round(op, st, outs, resp, key_ids)
    return st, outs


def process_tuple(op: OperatorDef, st: OpState, outs: Outputs, tup: Tup,
                  resp, valid):
    ws = op.window
    key_ids = torch.arange(op.k_virt, dtype=torch.int32, device=resp.device)
    w = torch.where(valid, torch.maximum(st.watermark, tup.tau), st.watermark)
    next_l = torch.where((st.next_l == UNSET_L) & valid,
                         ws.earliest_win_l(tup.tau), st.next_l)
    st = dataclasses.replace(st, watermark=w, next_l=next_l)
    if op.lazy_expiry:
        e = ws.earliest_win_l(w)
        st = dataclasses.replace(st, next_l=torch.where(
            st.next_l == UNSET_L, e, torch.maximum(st.next_l, e)))
    else:
        st, outs = expire_all(op, st, outs, w, resp, key_ids)
    khit = torch.zeros((op.k_virt,), dtype=torch.bool, device=resp.device)
    for kk in range(tup.keys.shape[0]):
        key = tup.keys[kk]
        khit = khit | ((key_ids == key) & (key >= 0))
    khit = khit & resp & valid
    l_min_raw, l_max = ws.window_indices(tup.tau)
    l_min = torch.maximum(l_min_raw, st.next_l)
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
        occ = st.occupied[:, _col(s)]
        st = dataclasses.replace(st, zeta=_set_slot(st.zeta, s, zeta_sel),
                                 occupied=_set_col(st.occupied, s, occ | mask))
        if payload.ndim == 3:
            emit_valid = (f_valid & mask[:, None]).reshape(-1)
            payload = payload.reshape(-1, payload.shape[-1])
        else:
            emit_valid = f_valid & mask
        outs = _emit(outs, ws.right_of(l), payload, emit_valid)
    return st, outs


def tick(op: OperatorDef, st: OpState, ready, resp, explicit_w=None):
    """One instance's tick, lane by lane on the host."""
    op = op.resolved()
    outs = _empty_outputs(op.out_cap, op.payload_out, ready.device)
    live = ready.valid & ~ready.is_control
    for lane in range(ready.batch):
        tup = Tup(tau=ready.tau[lane], payload=ready.payload[lane],
                  source=ready.source[lane], keys=ready.keys[lane])
        st, outs = process_tuple(op, st, outs, tup, resp, live[lane])
    if explicit_w is not None:
        w = torch.maximum(st.watermark, torch.as_tensor(
            explicit_w, dtype=torch.int32, device=st.watermark.device))
        e = op.window.earliest_win_l(w)
        st = dataclasses.replace(st, watermark=w, next_l=torch.where(
            st.next_l == UNSET_L, e, st.next_l))
        if op.lazy_expiry:
            st = dataclasses.replace(st, next_l=torch.maximum(st.next_l, e))
        else:
            key_ids = torch.arange(op.k_virt, dtype=torch.int32,
                                   device=resp.device)
            st, outs = expire_all(op, st, outs, w, resp, key_ids)
    return st, outs
