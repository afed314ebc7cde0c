"""Shared-Nothing execution (paper §2.2, Alg. 1-2) — the baseline.

Held against ``src/repro/core/sn.py``.  forwardSN copies each tuple to
every instance responsible for at least one of its keys (the duplication
of Theorem 1); each instance keeps a dedicated state ``sigma_j``, stacked
on a leading instance axis.  Copies are per-instance valid masks over the
same lane layout.  The reference ``vmap``s over instances; the general
O+ tick runs them all in one pass (``operator.tick_instances`` on the
stacked states), a fast-path tick function once an instance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import tuples as T
from repro_torch.core.operator import OperatorDef, tick, tick_instances
from repro_torch.core.vsn import responsibilities, responsibility, stack
from repro_torch.tree import tree_map


def route_matrix(batch: T.TupleBatch, fmu: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """route[b, j] = instance j receives a copy of tuple b (Alg. 1 L5-7)."""
    n_inst = active.shape[0]
    key_ok = batch.keys >= 0                                      # [B, KMAX]
    dest = fmu[batch.keys.clamp(0, fmu.shape[0] - 1).long()]      # [B, KMAX]
    inst = torch.arange(n_inst, device=fmu.device)
    route = ((dest[..., None] == inst) & key_ok[..., None]).any(dim=1)
    route = route | batch.is_control[:, None]     # control reaches everyone
    return route & batch.valid[:, None] & active[None, :]


def duplication_factor(batch: T.TupleBatch, fmu: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """Copies sent per input tuple (1.0 = no duplication)."""
    sent = route_matrix(batch, fmu, active).to(torch.float32).sum()
    n = batch.valid.to(torch.float32).sum().clamp(min=1.0)
    return sent / n


def run_tick(op: OperatorDef, states_j, ready: T.TupleBatch,
             fmu: torch.Tensor, active: torch.Tensor,
             tick_fn: Callable = tick):
    """One SN tick: route copies, then each instance processes its queue
    against its dedicated state; the tick's end watermark is broadcast to
    every instance explicitly (§2.3)."""
    route = route_matrix(ready, fmu, active)
    live = ready.valid & ~ready.is_control
    w_end = torch.where(live, ready.tau, 0).max()
    if tick_fn is tick:
        return tick_instances(op, states_j, ready,
                              responsibilities(fmu, active),
                              live=route.t() & ~ready.is_control[None],
                              explicit_w=w_end, stacked=True)
    states, outs = [], []
    for j in range(active.shape[0]):
        queued = dataclasses.replace(ready, valid=route[:, j])
        st_j, out_j = tick_fn(op, tree_map(lambda a: a[j], states_j), queued,
                              responsibility(fmu, j, active), explicit_w=w_end)
        states.append(st_j)
        outs.append(out_j)
    return stack(states), stack(outs)


def init_states(one, n_inst: int):
    """Dedicated per-instance states: ``one`` copied on a leading axis."""
    return tree_map(lambda a: a.unsqueeze(0).repeat((n_inst,) + (1,) * a.ndim),
                    one)
