"""Root merge: the upper level of the hierarchical ScaleGate (§6).

Held against ``src/repro/ingest/root.py``.  The root is ``scalegate.push``
one level up: its "sources" are the leaf gates, whose ready batches are
themselves timestamp-sorted streams.  Two deltas from a flat gate, both
threaded through the core primitives:

* **explicit watermarks**: the root's frontier axis is the leaf set while
  its tuples keep their original source ids for the downstream pipeline,
  so the per-tuple fold is replaced by ``wm.observe_explicit`` over the
  leaves' *reported* watermarks.  A leaf only forwards ``tau <= W_leaf``,
  so the report dominates any forwarded tau, and Definition 3 composes:
  ``W_root = min_leaf W_leaf = min_i frontier_i``, the flat gate's
  watermark.
* **rebalance clamps**: when a leaf *gains* a migrated source, the root's
  frontier for that leaf drops to the source's Lemma-3 bound gamma
  (``wm.clamp_frontier``); gamma is an active source's frontier, hence
  ``>= W_root``, so the root watermark never regresses.

The root also checks its two end-to-end invariants (the emitted stream's
tau is non-decreasing across rounds and the watermark is monotone) and
surfaces stash overflow (its own and each leaf's reported count) through
``warnings`` and stats, never silently.

Tie-break tolerance: the root re-sorts whatever arrives, so leaves on the
card (``(tau, arrival)``) and on the CPU (``(tau, source, arrival)``) feed
it alike; the root's ready *set* and tau grouping are the same either way
(``repro_torch.core.scalegate.TIE_BREAK``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.core import scalegate
from repro_torch.core import tuples as T
from repro_torch.core import watermark as wm
from repro_torch.ingest.leaf import (FIELDS, LeafOut, concat_np, empty_np,
                                     np_to_batch, pad_np)

MIN_PAD = 32


def bucket(n: int, lo: int = MIN_PAD) -> int:
    """Power-of-two lane bucket >= n (bounds the set of buffer shapes)."""
    p = lo
    while p < n:
        p <<= 1
    return p


class RootMerge:
    """``device=True`` selects the fused round: per-leaf ready chunks are
    stacked into one rank-2 buffer and merged by a single
    ``scalegate_merge_stacked`` call with the watermark gate evaluated on
    the device (``wm.fold_reports``), so the steady-state round reads
    nothing back to the host.  The per-round invariant checks of the host
    path then run every ``check_every`` rounds (each check is a device
    sync); stats accrue lazily (``sync_stats``).  The root's state lives
    on ``torch_device`` (default: the card).  ``device=None`` takes the
    fused round on the card and the host path elsewhere, so no default
    path on the card goes around the stacked kernel."""

    def __init__(self, max_leaves: int, cap: int, kmax: int,
                 payload_width: int, active_leaves: Sequence[int],
                 out_pad: int = MIN_PAD, device: Optional[bool] = None,
                 check_every: int = 8, torch_device=None):
        self.dev = _device.resolve(torch_device)
        if device is None:
            device = self.dev.type == "cuda"
        self.max_leaves = max_leaves
        self.kmax = kmax
        self.payload_width = payload_width
        # lane floor for the incoming pad: a floor near the steady-state
        # round volume keeps the emitted batch shape constant
        self.out_pad = out_pad
        self.device = device
        self.check_every = check_every
        if device:
            # chunk rows of the stacked buffer; the stash prepends as whole
            # rows, so the capacity must be row-aligned
            self.chunk = bucket(out_pad)
        cap = self.effective_cap(cap, out_pad, device)
        active = np.zeros((max_leaves,), bool)
        active[list(active_leaves)] = True
        self.state = scalegate.init_scalegate(
            max_leaves, cap, kmax, payload_width, active=active,
            device=self.dev)
        # -- invariants + accounting -------------------------------------
        self.last_emitted_tau = -1       # total-order witness across rounds
        self.wmark = -1                  # monotone watermark witness
        self.leaf_overflow: Dict[int, int] = {l: 0 for l in active_leaves}
        self.tuples_out = 0
        self.rounds = 0
        self._out_valid: List = []       # device count handles, unsynced
        self._last_overflow_warned = 0

    @property
    def overflow(self) -> int:
        return int(self.state.overflow)

    # -- membership ----------------------------------------------------------
    def _mask(self, leaf: int) -> torch.Tensor:
        m = torch.zeros((self.max_leaves,), dtype=torch.bool, device=self.dev)
        m[leaf] = True
        return m

    def add_leaf(self, leaf: int, gamma: int) -> None:
        self.state = scalegate.add_sources(self.state, self._mask(leaf),
                                           gamma)
        self.leaf_overflow.setdefault(leaf, 0)

    def remove_leaf(self, leaf: int) -> None:
        self.state = scalegate.remove_sources(self.state, self._mask(leaf))

    def clamp_leaf(self, leaf: int, gamma: int) -> None:
        """The leaf gained a migrated source with safe bound gamma."""
        self.state = scalegate.ScaleGateState(
            stash=self.state.stash,
            wmark=wm.clamp_frontier(self.state.wmark, self._mask(leaf),
                                    gamma),
            overflow=self.state.overflow)

    def apply_pre(self, root_ops: Sequence) -> None:
        for op in root_ops:
            if op[0] == "add_leaf":
                self.add_leaf(op[1], op[2])
            elif op[0] == "clamp":
                self.clamp_leaf(op[1], op[2])

    def apply_post(self, root_ops: Sequence) -> None:
        for op in root_ops:
            if op[0] == "remove_leaf":
                self.remove_leaf(op[1])

    # -- the merge -----------------------------------------------------------
    def _fold_leaf_reports(self, outs: Sequence[LeafOut]):
        """Per-leaf reported watermarks + report mask of this round, with
        the leaf-overflow surfacing shared by both merge paths."""
        reports = np.full((self.max_leaves,), -1, np.int64)
        rmask = np.zeros((self.max_leaves,), bool)
        for o in outs:
            reports[o.leaf_id] = max(reports[o.leaf_id], o.wmark)
            rmask[o.leaf_id] = True
            prev = self.leaf_overflow.get(o.leaf_id, 0)
            if o.overflow > prev:
                warnings.warn(
                    f"ingest leaf {o.leaf_id} stash overflow: "
                    f"{o.overflow} tuples dropped (was {prev})",
                    RuntimeWarning, stacklevel=2)
                _obs.event("leaf_overflow", leaf_id=o.leaf_id,
                           overflow=o.overflow, was=prev)
            self.leaf_overflow[o.leaf_id] = max(prev, o.overflow)
        return reports, rmask

    def push(self, outs: Sequence[LeafOut]) -> T.TupleBatch:
        """Merge one round of leaf outputs; returns the root-ready batch
        (fixed lane count, validity-masked, totally ordered)."""
        if self.device:
            return self._push_device(outs)
        return self._push_host(outs)

    def _check_order(self, out: T.TupleBatch) -> None:
        """The watermark never falls and the emitted stream stays sorted,
        within the round and across rounds (a host read of ``out``)."""
        w = int(self.state.wmark.value())
        if w < self.wmark:
            raise AssertionError(
                f"root watermark regressed: {self.wmark} -> {w}")
        self.wmark = w
        valid = out.valid.cpu().numpy()
        if valid.any():
            emitted = out.tau.cpu().numpy()[valid]
            if int(emitted[0]) < self.last_emitted_tau:
                raise AssertionError(
                    "root ready stream not totally ordered: emitted "
                    f"tau {int(emitted[0])} after {self.last_emitted_tau}")
            if (np.diff(emitted) < 0).any():
                raise AssertionError("root ready batch not tau-sorted")
            self.last_emitted_tau = int(emitted[-1])

    def _push_host(self, outs: Sequence[LeafOut]) -> T.TupleBatch:
        reports, rmask = self._fold_leaf_reports(outs)
        incoming_np = concat_np([o.ready for o in outs],
                                self.kmax, self.payload_width)
        n = incoming_np["tau"].shape[0]
        incoming = np_to_batch(pad_np(incoming_np, bucket(n, self.out_pad)),
                               self.dev)
        wstate = wm.observe_explicit(self.state.wmark, reports, rmask)
        prev_overflow = self.overflow
        self.state, out = scalegate.push(self.state, incoming, wstate=wstate)

        self._check_order(out)                 # every round on this path
        self.tuples_out += int(out.valid.sum())
        if self.overflow > prev_overflow:
            warnings.warn(
                f"ingest root stash overflow: {self.overflow} tuples "
                f"dropped (was {prev_overflow})", RuntimeWarning,
                stacklevel=2)
            _obs.event("root_overflow", overflow=self.overflow,
                       was=prev_overflow)
        self.rounds += 1
        o = _obs.get()
        if o is not None:
            reg = o.registry
            reg.inc("root.rounds")
            reg.set_gauge("root.wmark", self.wmark)
            reg.set_gauge("root.tuples_out", self.tuples_out)
        return out

    def _push_device(self, outs: Sequence[LeafOut]) -> T.TupleBatch:
        """The fused round: stack per-leaf ready chunks into rank-2 rows and
        issue ONE ``push_stacked`` (merge + watermark gate on the device).
        Arrival order inside the stacked buffer preserves the leaves'
        relative lane order, so the emitted (tau, arrival) stream groups
        exactly like the host path's compacted concat."""
        reports, rmask = self._fold_leaf_reports(outs)
        chunk = self.chunk
        rows = []
        for o in outs:
            n, off = o.n_ready, 0
            while off < n:
                part = {f: o.ready[f][off:off + chunk] for f in FIELDS}
                rows.append(pad_np(part, chunk))
                off += chunk
        # a power-of-two row count bounds the set of buffer shapes; the
        # floor at the round's leaf count keeps the steady-state output
        # shape constant (a leaf with nothing ready contributes no data
        # rows, and a flip-flopping shape changes the pipeline's buffer)
        n_rows = bucket(max(len(rows), len(outs), 1), lo=1)
        if len(rows) < n_rows:
            empty = pad_np(empty_np(self.kmax, self.payload_width), chunk)
            rows += [empty] * (n_rows - len(rows))
        stacked = T.TupleBatch(**{
            f: torch.tensor(np.stack([r[f] for r in rows]),
                            dtype=T.DTYPES[f], device=self.dev)
            for f in FIELDS})
        self.state, out = scalegate.push_stacked(self.state, stacked,
                                                 reports, rmask)
        self.rounds += 1
        _obs.counter_inc("root.rounds")
        self._out_valid.append(out.valid.sum())
        if self.check_every and self.rounds % self.check_every == 0:
            self._verify_round(out)
        return out

    def _verify_round(self, out: T.TupleBatch) -> None:
        """The host path's invariant checks, run periodically on the device
        path (each is a device sync).  ``last_emitted_tau`` then witnesses
        order across *checked* rounds: still sound, since a correct emitted
        stream is non-decreasing across every round between them."""
        self._check_order(out)
        if self.overflow > self._last_overflow_warned:
            warnings.warn(
                f"ingest root stash overflow: {self.overflow} tuples "
                f"dropped (was {self._last_overflow_warned})",
                RuntimeWarning, stacklevel=2)
            _obs.event("root_overflow", overflow=self.overflow,
                       was=self._last_overflow_warned)
        self._last_overflow_warned = self.overflow
        _obs.gauge_set("root.wmark", self.wmark)

    def sync_stats(self) -> None:
        """Materialize the device path's lazily tracked stats (reads the
        accumulated counts back; call outside the hot loop)."""
        if self._out_valid:
            self.tuples_out += int(torch.stack(self._out_valid).sum())
            self._out_valid.clear()
        if self.device:
            self.wmark = max(self.wmark, int(self.state.wmark.value()))

    # -- checkpoint/restore --------------------------------------------------
    @staticmethod
    def effective_cap(cap: int, out_pad: int, device: bool) -> int:
        """The stash capacity a ``RootMerge(cap=cap)`` actually allocates
        (the fused path row-aligns it)."""
        if not device:
            return cap
        chunk = bucket(out_pad)
        return ((cap + chunk - 1) // chunk) * chunk

    def export_state(self) -> Dict:
        """Numpy snapshot of the root gate and its host-side invariant
        counters, taken at a round boundary (the tier's consumer thread is
        the only mutator)."""
        self.sync_stats()
        return {
            "sg": scalegate.export_np(self.state),
            "meta": {
                "last_emitted_tau": self.last_emitted_tau,
                "wmark": self.wmark,
                "leaf_overflow": dict(self.leaf_overflow),
                "tuples_out": self.tuples_out,
                "rounds": self.rounds,
                "last_overflow_warned": self._last_overflow_warned,
            },
        }

    def import_state(self, snap: Dict) -> None:
        got = np.asarray(snap["sg"]["stash"]["tau"]).shape[0]
        want = self.state.capacity
        assert got == want, f"root stash capacity changed: {got} != {want}"
        self.state = scalegate.import_np(snap["sg"], self.dev)
        meta = snap["meta"]
        self.last_emitted_tau = int(meta["last_emitted_tau"])
        self.wmark = int(meta["wmark"])
        self.leaf_overflow = {int(k): int(v)
                              for k, v in meta["leaf_overflow"].items()}
        self.tuples_out = int(meta["tuples_out"])
        self.rounds = int(meta["rounds"])
        self._last_overflow_warned = int(meta["last_overflow_warned"])
        self._out_valid = []
