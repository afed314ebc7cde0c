"""VSN execution (paper §5, Alg. 3-4): shared Tuple Buffer, shared state.

Held against ``src/repro/core/vsn.py``.  Every instance consumes the
same totally-ordered ready batch and processes exactly the keys it is
responsible for under the epoch's ``f_mu``; row k of the shared
``sigma`` is written by instance ``f_mu(k)`` only, so the merged state is
"row k from instance f_mu(k)" and a reconfiguration moves no state
(Theorem 3).

The reference ``vmap``s over instances.  Here the general O+ tick runs
every instance in one pass (``operator.tick_instances``, a leading
``[n_max]`` axis on ``resp``, the state and the outputs); a fast-path tick
function runs once an instance in a loop, computing its
instance-independent part once (``operator.instances_share``), and the
CUDA kernels run once per instance.  Both give the states and outputs
stacked on a leading axis (the reference's layout, which
``flatten_outputs`` and the merges read).

The mesh half (``localize_op`` on) keeps ``sigma`` in fixed contiguous key
blocks, one a shard (owner-computes: storage layout == responsibility).
The reference runs the shards under ``shard_map``; here one controller
process drives every shard of a ``launch.mesh.StreamMesh`` (a device a
shard, several shards may share one).  The replicated parts (the
ScaleGate state and its merge, the ``EpochState`` tables) run once a
physical device, and the shards on it read that one copy: the shared
Tuple Buffer on shared memory.  Each shard's local tick reads and writes
its own block only, so a step copies no state between devices and an
``f_mu`` switch swaps the replicated tables alone (Theorem 3).
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


# ---------------------------------------------------------------------------
# Mesh execution (owner-computes key blocks, one controller process)
# ---------------------------------------------------------------------------

def localize_op(op: OperatorDef, lo: int, rows: int) -> OperatorDef:
    """View of ``op`` over the contiguous key block ``[lo, lo + rows)``:
    ``init_zeta`` leaves with a leading ``k_virt`` axis are row-sliced, so
    a recycled slot gets block-local fresh state.  The user functions must
    treat the key axis positionally (global key ids reach them through
    the tick's ``key_offset``); ScaleJoin's round-robin store does not, and
    runs on the mesh through ``join_local_tick``."""
    full_init = op.init_zeta
    k_full = op.k_virt

    def init_local(device):
        return tree_map(lambda a: (a[lo:lo + rows]
                                   if getattr(a, "ndim", 0)
                                   and a.shape[0] == k_full else a),
                        full_init(device))

    return dataclasses.replace(op, k_virt=rows, init_zeta=init_local)


def mesh_state_spec(sigma, k_virt: int):
    """Which leaves of a VSN state are key-blocked (True: a leading
    ``k_virt`` axis, split over the shards) and which replicated (False:
    scalars and tables, identical on every shard because every shard reads
    the same ready batch).  ``FastJoinState.comparisons``, the one
    per-shard metric (``[n_shards]`` in the mesh layout), is marked by
    field, not by shape."""
    spec = tree_map(lambda a: bool(getattr(a, "ndim", 0))
                    and a.shape[0] == k_virt, sigma)
    if isinstance(sigma, FastJoinState):
        spec = dataclasses.replace(spec, comparisons=True)
    return spec


def mesh_device_put(sigma, mesh, k_virt: int) -> list:
    """One block a shard of a global state (``sigma``, on any device): the
    key-blocked leaves row-sliced, the others copied whole, each on its
    shard's device in storage of its own.  The layout is fixed for the
    pipeline's lifetime (Theorem 3)."""
    n = mesh.n_shards
    if k_virt % n:
        raise ValueError(f"k_virt={k_virt} must divide over {n} shards")
    spec = mesh_state_spec(sigma, k_virt)

    def block(j, dev):
        def put(a, keyed):
            if keyed:
                rows = a.shape[0] // n
                a = a[j * rows:(j + 1) * rows]
            return a.to(dev, copy=True)
        return tree_map(put, sigma, spec)
    return [block(j, dev) for j, dev in enumerate(mesh.devices)]


def mesh_gather(blocks: list, spec, device):
    """The blocks' global state on ``device``: key-blocked leaves
    concatenated in shard order, the replicated ones from shard 0."""
    return tree_map(lambda keyed, *leaves: (
        torch.cat([a.to(device) for a in leaves]) if keyed
        else leaves[0].to(device)), spec, *blocks)


def general_local_tick(op: OperatorDef) -> Callable:
    """Owner-computes local tick on the general O+ path: the shard
    processes every key it stores (``f_mu`` remaps logical work
    attribution, never storage)."""
    def make(lo: int, rows: int):
        op_l = localize_op(op, lo, rows)

        def fn(state, ready):
            resp = torch.ones((rows,), dtype=torch.bool, device=ready.device)
            return tick(op_l, state, ready, resp, key_offset=lo)
        return fn
    return make


def fast_agg_local_tick(op: OperatorDef, kind: str) -> Callable:
    """Owner-computes local tick on the aggregate fast path.  Ring
    collisions accumulate across the ticks of a call (a per-tick delta is
    invisible from inside a batched step)."""
    from repro_torch.core.aggregate import tick_fast as agg_fast

    def make(lo: int, rows: int):
        op_l = localize_op(op, lo, rows)

        def fn(state, ready):
            resp = torch.ones((rows,), dtype=torch.bool, device=ready.device)
            new, outs = agg_fast(op_l, kind, state, ready, resp,
                                 key_offset=lo)
            return dataclasses.replace(
                new, collisions=state.collisions + new.collisions), outs
        return fn
    return make


def join_local_tick(window, f_j: Callable, k_virt: int, out_cap: int,
                    emit: bool = True) -> Callable:
    """Owner-computes local tick of the ScaleJoin fast path (the sliced
    layout of ``join.tick_fast``): ``comparisons`` is the shard's
    cumulative count, ``[1]`` a block, ``[n_shards]`` gathered."""
    from repro_torch.core.join import tick_fast as join_fast

    def make(lo: int, rows: int):
        def fn(state, ready):
            resp = torch.ones((rows,), dtype=torch.bool, device=ready.device)
            new, outs = join_fast(window, f_j, state, ready, resp, out_cap,
                                  emit=emit, k_global=k_virt, k_offset=lo)
            return dataclasses.replace(
                new, comparisons=state.comparisons + new.comparisons), outs
        return fn
    return make


def local_ticks(mesh, k_virt: int, make_local_tick: Callable) -> list:
    """Every shard's local tick, shard j owning rows ``[j * rows, (j + 1) *
    rows)``."""
    if k_virt % mesh.n_shards:
        raise ValueError(f"k_virt={k_virt} must divide over "
                         f"{mesh.n_shards} shards")
    rows = k_virt // mesh.n_shards
    return [make_local_tick(j * rows, rows) for j in range(mesh.n_shards)]


def gather_outs(mesh, per_shard: list) -> Outputs:
    """Per-shard ``[T, cap]`` outputs (shard order) as the reference's
    mesh layout on the mesh's first device: the shards' lanes side by side
    (``[T, n_shards * cap]``) and a count a shard (``[T, n_shards]``).
    This is the sink's read of the outputs, not state."""
    dev = mesh.device
    lanes = lambda f: torch.cat([getattr(o, f).to(dev) for o in per_shard], 1)
    return Outputs(tau=lanes("tau"), payload=lanes("payload"),
                   valid=lanes("valid"),
                   count=torch.stack([o.count.to(dev) for o in per_shard], 1),
                   overflow=torch.stack([o.overflow.to(dev)
                                         for o in per_shard], 1))


def regroup(mesh, groups: list) -> list:
    """Per-group lists of per-shard values in shard order."""
    out = [None] * mesh.n_shards
    for (_, shards), vals in zip(mesh.groups, groups):
        for j, v in zip(shards, vals):
            out[j] = v
    return out


def shard_tick(mesh, k_virt: int, make_local_tick: Callable):
    """The batched mesh VSN tick: ``step(blocks, ready_stack) -> (blocks,
    outs)`` runs T pre-gated ready batches (``ready_stack``, leading axis
    T, replicated onto each device of the mesh) through every shard's
    local tick; no merge (rows are disjoint by layout) and no state
    crosses a device.  ``outs`` is ``gather_outs``'s layout."""
    ticks = local_ticks(mesh, k_virt, make_local_tick)

    def step(blocks, ready_stack):
        blocks = list(blocks)
        outs = [[] for _ in blocks]
        for (_, shards), stack_g in zip(mesh.groups,
                                        mesh.replicate(ready_stack)):
            for t in range(stack_g.tau.shape[0]):
                ready = tree_map(lambda a: a[t], stack_g)
                for j in shards:
                    blocks[j], o = ticks[j](blocks[j], ready)
                    outs[j].append(o)
        return blocks, gather_outs(mesh, [stack(o) for o in outs])
    return step


def group_pipeline_ticks(ticks: list, sg, epoch, blocks, inc_stack,
                         fmu_new, active_new):
    """The pipeline's T ticks (``inc_stack``, leading axis T) on one
    physical device: ScaleGate merge, epoch handling and the two-phase
    tick, once a tick for the device's shards (``ticks`` and ``blocks``,
    one a shard), which all read the one ready batch and ``EpochState``.
    Returns ``(sg, epoch, blocks, outs_pre, outs_post, switched[T],
    wmark[T])``, the outputs a list of per-shard ``[T, ...]`` stacks."""
    def tick_with_epoch(blocks, ready, epoch):
        res = [t(b, ready) for t, b in zip(ticks, blocks)]
        return [s_ for s_, _ in res], [o for _, o in res]

    rows = []
    for t in range(inc_stack.tau.shape[0]):
        sg, epoch, blocks, o1, o2, sw, wmk, _ = pipeline_tick(
            sg, epoch, blocks, tree_map(lambda a: a[t], inc_stack), fmu_new,
            active_new, tick_with_epoch)
        rows.append((o1, o2, sw, wmk))
    per_shard = lambda i: [stack([r[i][j] for r in rows])
                           for j in range(len(ticks))]
    return (sg, epoch, blocks, per_shard(0), per_shard(1),
            torch.stack([r[2] for r in rows]),
            torch.stack([r[3] for r in rows]))


def shard_pipeline_step(op: OperatorDef, mesh, make_local_tick: Callable):
    """The full VSN pipeline step on the mesh over T stacked incoming
    ticks:

        step(sgs, epochs, blocks, inc_stacks, fmu_news, active_news)
          -> (sgs, epochs, blocks, outs_pre, outs_post, switched[T],
              wmark[T])

    Everything but ``blocks`` (one state block a shard) comes one copy a
    physical device (``mesh.groups``): the replicated state ``sgs`` and
    ``epochs``, and the incoming ticks and tables as ``mesh.replicate``
    places them.  Each device runs ``group_pipeline_ticks`` over its
    shards: identical merges over identical tuples, so the shared-TB
    contract holds and the step copies nothing between devices.  The
    outputs come a shard (``gather_outs`` gives the reference's layout);
    ``switched`` and ``wmark`` are the first device's (every device
    computes the same)."""
    ticks = local_ticks(mesh, op.k_virt, make_local_tick)

    def step(sgs, epochs, blocks, inc_stacks, fmu_news, active_news):
        res = [group_pipeline_ticks([ticks[j] for j in shards], *args,
                                    [blocks[j] for j in shards], *inputs)
               for (_, shards), args, inputs in zip(
                   mesh.groups, zip(sgs, epochs),
                   zip(inc_stacks, fmu_news, active_news))]
        return ([r[0] for r in res], [r[1] for r in res],
                *(regroup(mesh, [r[i] for r in res]) for i in (2, 3, 4)),
                res[0][5], res[0][6])
    return step
