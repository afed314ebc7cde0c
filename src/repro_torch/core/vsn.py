"""VSN execution (paper §5, Alg. 3-4): shared Tuple Buffer, shared state.

Held against the single-host half of ``src/repro/core/vsn.py``
(``responsibility`` .. ``flatten_outputs``); the mesh half comes with the
mesh slice.  Every instance consumes the same totally-ordered ready batch
and processes exactly the keys it is responsible for under the epoch's
``f_mu``; row k of the shared ``sigma`` is written by instance ``f_mu(k)``
only, so the merged state is "row k from instance f_mu(k)" and a
reconfiguration moves no state (Theorem 3).

The reference ``vmap``s over instances.  Here the general O+ tick runs
every instance in one pass (``operator.tick_instances``, a leading
``[n_max]`` axis on ``resp``, the state and the outputs); a fast-path tick
function runs once an instance in a loop, computing its
instance-independent part once (``operator.instances_share``), and the
CUDA kernels run once per instance.  Both give the states and outputs
stacked on a leading axis (the reference's layout, which
``flatten_outputs`` and the merges read).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import elastic, scalegate
from repro_torch.core import tuples as T
from repro_torch.core.aggregate import FastAggState
from repro_torch.core.join import FastJoinState
from repro_torch.core.operator import (OperatorDef, OpState, Outputs,
                                       instances_share, tick, tick_instances)
from repro_torch.tree import tree_map


def responsibility(fmu: torch.Tensor, j: int, active: torch.Tensor
                   ) -> torch.Tensor:
    """resp[k] = (f_mu(k) == j) for an active instance, else empty."""
    return (fmu == j) & active[j]


def responsibilities(fmu: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Every instance's ``responsibility`` stacked: bool ``[n_max, K]``."""
    inst = torch.arange(active.shape[0], device=fmu.device)
    return (fmu[None, :] == inst[:, None]) & active[:, None]


def stack(trees):
    """Stack per-instance trees on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _pick_rows(leaf: torch.Tensor, fmu: torch.Tensor) -> torch.Tensor:
    """[n_inst, K, ...] -> [K, ...], row k from instance fmu[k]."""
    return leaf[fmu.long(), torch.arange(leaf.shape[1], device=leaf.device)]


def merge_states(stacked: OpState, fmu: torch.Tensor) -> OpState:
    """Disjoint-writer merge: row k of sigma comes from instance f_mu(k);
    the scalars advance identically on every instance (max)."""
    return OpState(zeta={n: _pick_rows(a, fmu) for n, a in stacked.zeta.items()},
                   occupied=_pick_rows(stacked.occupied, fmu),
                   next_l=stacked.next_l.max(),
                   watermark=stacked.watermark.max())


def merge_fast_state(stacked, fmu: torch.Tensor):
    """Disjoint-writer merge for the fast-path states: keyed leaves are
    row-picked by f_mu; global counters take the max; per-instance metrics
    (collisions, comparisons) sum."""
    if isinstance(stacked, FastAggState):
        return FastAggState(op_state=merge_states(stacked.op_state, fmu),
                            slot_l=stacked.slot_l.amax(dim=0),
                            collisions=stacked.collisions.sum(
                                dtype=torch.int32))
    if isinstance(stacked, FastJoinState):
        return FastJoinState(
            tau=_pick_rows(stacked.tau, fmu), pay=_pick_rows(stacked.pay, fmu),
            stream=_pick_rows(stacked.stream, fmu),
            n=_pick_rows(stacked.n, fmu), c=stacked.c.max(),
            comparisons=stacked.comparisons.sum())
    raise TypeError(type(stacked))


def run_tick(op: OperatorDef, state, ready: T.TupleBatch,
             fmu: torch.Tensor, active: torch.Tensor,
             tick_fn: Callable = tick, merge_fn: Callable = merge_states):
    """One VSN tick over all instances against the shared state.

    ``tick_fn(op, state, ready, resp, explicit_w=None) -> (state, outs)``;
    returns the merged state and the per-instance stacked outputs.
    """
    if tick_fn is tick:
        stacked, outs = tick_instances(op, state, ready,
                                       responsibilities(fmu, active))
        return merge_fn(stacked, fmu), outs
    states, outs = [], []
    with instances_share():
        for j in range(active.shape[0]):
            st_j, out_j = tick_fn(op, state, ready,
                                  responsibility(fmu, j, active),
                                  explicit_w=None)
            states.append(st_j)
            outs.append(out_j)
    return merge_fn(stack(states), fmu), stack(outs)


def pipeline_tick(sg, epoch, sigma, incoming: T.TupleBatch,
                  fmu_new: torch.Tensor, active_new: torch.Tensor,
                  tick_with_epoch: Callable, on_ready: Callable = None):
    """One pipeline tick: ScaleGate push -> prepareReconfig -> two-phase
    epoch-split tick (Alg. 4 L17) -> advanceEpoch.

    Returns ``(sg, epoch, sigma, outs_pre, outs_post, switched, wmk,
    extra)``; ``extra`` is ``on_ready(ready, epoch)`` under the in-effect
    ``f_mu`` (the per-instance-load hook).
    """
    sg, ready = scalegate.push(sg, incoming)
    epoch = elastic.prepare_reconfig(epoch, ready, fmu_new, active_new)
    pre, post = elastic.split_epoch_masks(epoch, ready)
    extra = None if on_ready is None else on_ready(ready, epoch)

    ready_pre = dataclasses.replace(
        ready, valid=pre | (ready.is_control & ready.valid))
    sigma, outs1 = tick_with_epoch(sigma, ready_pre, epoch)

    live = ready.valid & ~ready.is_control
    w_end = torch.where(live, ready.tau, 0).max()
    epoch, switched = elastic.advance_epoch(epoch, w_end)

    ready_post = dataclasses.replace(ready, valid=post)
    sigma, outs2 = tick_with_epoch(sigma, ready_post, epoch)
    return (sg, epoch, sigma, outs1, outs2, switched, sg.wmark.value(),
            extra)


def flatten_outputs(stacked: Outputs) -> Outputs:
    """Merge per-instance output buffers into one, ordered by (tau,
    instance): a stable sort by tau of the concatenated buffers."""
    tau = stacked.tau.reshape(-1)
    payload = stacked.payload.reshape(-1, stacked.payload.shape[-1])
    valid = stacked.valid.reshape(-1)
    order = torch.argsort(torch.where(valid, tau, torch.iinfo(torch.int32).max),
                          stable=True)
    return Outputs(tau=tau[order], payload=payload[order], valid=valid[order],
                   count=stacked.count.sum(dtype=torch.int32),
                   overflow=stacked.overflow.sum(dtype=torch.int32))
