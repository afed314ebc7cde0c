"""ScaleGate / Elastic ScaleGate as a batched merge (paper §2.4, §6).

Held against ``src/repro/core/scalegate.py``.  ``push(state, incoming) ->
(state', ready_batch)``: every source's tuples arrive timestamp-sorted; the
watermark is ``W = min_i max_m tau_i^m`` over active sources; the ready
batch is the merged tick in a deterministic total order, holding exactly
the tuples with ``tau <= W`` not yet delivered; the rest wait in a
fixed-capacity stash whose overflow is counted.

The merge order comes from ``merge_order``.  On CUDA tensors it launches
the ``scalegate_merge`` kernel for every buffer of two or more lanes, and
orders by ``(tau, arrival)``.  On CPU tensors it runs ``_stable_order``,
``(tau, source, arrival)``, the reference's ``xla`` contract, so the CPU
port equals the reference bit for bit.  This is a deliberate departure
from the reference's ``merge_order``, which sends a buffer to the kernel
only when its length is a power of two: the port's main path never goes
around the kernel (the q1 buffer is 4097 lanes).  ``push_stacked``, the
ingest tier's fused root merge, launches ``scalegate_merge_stacked`` every
round on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T
from repro_torch.core import watermark as wm
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ScaleGateState:
    stash: T.TupleBatch          # fixed-capacity not-yet-ready tuples
    wmark: wm.WatermarkState     # per-source frontiers (Definition 3)
    overflow: torch.Tensor       # i32 count of tuples dropped on stash overflow

    @property
    def capacity(self) -> int:
        return self.stash.batch


def init_scalegate(n_sources: int, capacity: int, kmax: int,
                   payload_width: int, active=None,
                   device=None) -> ScaleGateState:
    dev = _device.resolve(device)
    return ScaleGateState(
        stash=T.empty_batch(capacity, kmax, payload_width, dev),
        wmark=wm.init_watermark(n_sources, active=active, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _stable_order(tau, source, valid) -> torch.Tensor:
    """Deterministic total order: valid first, then (tau, source, arrival)."""
    order1 = torch.argsort(source, stable=True)
    tau1 = torch.where(valid, tau, wm.INF_TIME)[order1]
    order2 = torch.argsort(tau1, stable=True)
    return order1[order2]


# The tie-break contract of merge_order, by device type.  Both are valid
# ScaleGate total orders: the ready set and the per-tau grouping are the
# same under either; only the order among equal-tau tuples differs.  That
# order is not invisible downstream: ScaleJoin's in-block pair output is
# [later, earlier] and its round-robin store key follows the order, so the
# card's join outputs equal the CPU's as unordered pairs.
TIE_BREAK = {
    "torch": ("tau", "source", "arrival"),
    "cuda": ("tau", "arrival"),
}


def tie_break(device) -> tuple:
    """The sort key of ``merge_order`` for tensors on ``device``."""
    return TIE_BREAK["cuda" if torch.device(device).type == "cuda"
                     else "torch"]


def merge_order(tau, source, valid, n_sources: int) -> torch.Tensor:
    """The merge's total order (see ``TIE_BREAK``); int64 lane indices."""
    if tau.device.type == "cpu":
        return _stable_order(tau, source, valid)
    if tau.shape[0] < 2:
        return torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    from repro_torch.kernels.scalegate_merge.ops import scalegate_merge_op
    order, _, _ = scalegate_merge_op(tau, source, valid, n_sources=n_sources)
    return order.long()


def stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """Lane order with the ``keep`` lanes first, each group in lane order:
    ``argsort(~keep, stable=True)`` computed with two prefix sums."""
    k = keep.to(torch.int64)
    n_keep = k.sum()
    pos = torch.where(keep, torch.cumsum(k, 0) - 1,
                      n_keep + torch.cumsum(1 - k, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(keep.shape[0], device=keep.device)
    return order


def _release(state: ScaleGateState, merged: T.TupleBatch, w,
             wstate: wm.WatermarkState
             ) -> Tuple[ScaleGateState, T.TupleBatch]:
    """Emit the merged buffer's lanes with ``tau <= w`` and keep the rest,
    compacted to the front, as the new stash (overflow counted)."""
    cap = state.capacity
    ready = merged.valid & (merged.tau <= w)
    out = dataclasses.replace(merged, valid=ready)
    keep = merged.valid & ~ready
    keep_order = stable_partition(keep)
    n_keep = keep.sum(dtype=torch.int32)
    lanes = torch.arange(cap, device=keep.device)
    stash = T.take(merged, keep_order[:cap], fill_invalid=lanes >= n_keep)
    dropped = (n_keep - cap).clamp(min=0)
    new_state = ScaleGateState(stash=stash, wmark=wstate,
                               overflow=state.overflow + dropped)
    return new_state, out


def push(state: ScaleGateState, incoming: T.TupleBatch, *,
         wstate: wm.WatermarkState = None
         ) -> Tuple[ScaleGateState, T.TupleBatch]:
    """Merge a tick of per-source tuples; emit the ready prefix.

    The emitted batch has size ``capacity + incoming.batch`` with a
    validity mask selecting the ready tuples (sorted, exactly once).
    ``wstate`` overrides the implicit per-tuple frontier fold with an
    externally computed ``WatermarkState``.
    """
    combined = T.concat(state.stash, incoming)

    if wstate is None:
        wstate = wm.observe(state.wmark, incoming.source, incoming.tau,
                            incoming.valid)
    w = wstate.value()

    order = merge_order(combined.tau, combined.source, combined.valid,
                        state.wmark.n_sources)
    return _release(state, T.take(combined, order), w, wstate)


def push_stacked(state: ScaleGateState, stacked: T.TupleBatch, reports,
                 rmask) -> Tuple[ScaleGateState, T.TupleBatch]:
    """Fused root merge: one kernel call over stacked per-leaf chunk rows.

    ``stacked`` is a TupleBatch whose fields carry a leading ``[rows, C]``
    layout (each row one padded ready chunk from a leaf, rows in leaf
    order); ``reports``/``rmask`` are the per-leaf reported watermarks and
    report mask of this round.  The frontier fold, the Definition-3
    reduction and the merge stay on the device (``wm.fold_reports`` +
    ``scalegate_merge_stacked``): the round reads nothing back.  Requires
    ``capacity % C == 0`` so the stash prepends as whole rows.

    Emission order is ``(tau, arrival)`` on every device, with arrival =
    stash lanes first, then leaf rows in order: the ready set and tau
    grouping equal ``push``'s; only the order among equal taus may differ
    from the CPU's flat ``(tau, source, arrival)``.
    """
    from repro_torch.kernels.scalegate_merge.ops import \
        scalegate_merge_stacked_op

    rows, c = stacked.tau.shape
    if state.capacity % c:
        raise ValueError(f"stash capacity {state.capacity} is not a "
                         f"multiple of the chunk width {c}")

    wstate, eff, w = wm.fold_reports(state.wmark, reports, rmask)

    incoming = tree_map(lambda a: a.reshape((rows * c,) + a.shape[2:]),
                        stacked)
    combined = T.concat(state.stash, incoming)
    n = combined.batch
    order2, _, _ = scalegate_merge_stacked_op(
        combined.tau.reshape(n // c, c), combined.source.reshape(n // c, c),
        combined.valid.reshape(n // c, c), eff)
    return _release(state, T.take(combined, order2.reshape(-1)), w, wstate)


def add_sources(state: ScaleGateState, mask, gamma) -> ScaleGateState:
    """ESG addSources — Lemma 3: start the new frontier at gamma."""
    return dataclasses.replace(state,
                               wmark=wm.add_sources(state.wmark, mask, gamma))


def remove_sources(state: ScaleGateState, mask) -> ScaleGateState:
    """ESG removeSources — flush semantics of §6."""
    return dataclasses.replace(state,
                               wmark=wm.remove_sources(state.wmark, mask))


def export_np(state: ScaleGateState) -> dict:
    """Host snapshot of a gate (stash + frontier + overflow) as numpy."""
    return {
        "stash": {f: getattr(state.stash, f).cpu().numpy() for f in T.FIELDS},
        "wmark": wm.export_np(state.wmark),
        "overflow": state.overflow.cpu().numpy(),
    }


def import_np(d: dict, device=None) -> ScaleGateState:
    dev = _device.resolve(device)
    stash = T.TupleBatch(**{
        f: torch.tensor(np.asarray(d["stash"][f]), dtype=dtype, device=dev)
        for f, dtype in T.DTYPES.items()})
    return ScaleGateState(
        stash=stash, wmark=wm.import_np(d["wmark"], dev),
        overflow=torch.tensor(np.asarray(d["overflow"]), dtype=torch.int32,
                              device=dev))


def template_np(n_sources: int, capacity: int, kmax: int,
                payload_width: int) -> dict:
    """Zero-filled ``export_np``-shaped dict for a gate of these dimensions."""
    return export_np(init_scalegate(n_sources, capacity, kmax, payload_width,
                                    device="cpu"))
