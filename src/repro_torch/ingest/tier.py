"""IngestTier: the hierarchical multi-host ScaleGate, end to end.

Held against ``src/repro/ingest/tier.py``.  Every gate of the tier (leaves
and root) lives on ``device`` (default: the card); process workers
resolve it themselves in their spawned child.

Topology (paper §6's elastic/hierarchical TB)::

    source stream ──router──> leaf 0 (ScaleGate over its sources) ─┐
                  ├─────────> leaf 1                              ─┤──> root
                  └─────────> leaf N-1                            ─┘   merge
                                                                        │
                                              totally-ordered ready ────┘
                                              stream (one tick/round)

* the **router** splits each source tick over the leaves by the
  ``SourcePartitioner`` assignment and folds the host-side per-source
  frontier (the Lemma-3 gamma oracle for rebalances);
* each **leaf worker** (``worker="thread" | "process" | "inline"``) owns
  one ``LeafGate`` and answers every round with a ``LeafOut`` — ready
  tuples + reported watermark + overflow count (the round barrier that
  makes the tier deterministic);
* the **root merge** runs in the consumer's thread (for
  ``AsyncStreamRuntime`` that is its ingest thread: the tier is a drop-in
  source upstream of ``pipeline.stage()``) and yields one totally-ordered
  ready batch per round.

Backpressure propagates root→leaf→source through the bounded channels
alone: a slow consumer stops collecting rounds, the leaf→root channel
fills, leaves block, the router's leaf channels fill, and the source
iterator stalls — memory never grows with the lag.

Elasticity: ``add_host``/``remove_host`` reuse the ESG semantics at both
levels with **zero state transfer** — moved sources restart at their
Lemma-3 safe bound gamma on the gaining leaf while their stashed tuples
drain from the losing leaf's flush; the root clamps the gaining leaf's
frontier to gamma (`wm.clamp_frontier`) so total order survives the move.
Attach/detach latency (command issued → membership round merged at the
root) is measured per command.

Snapshots: ``snapshot_every=K`` inserts a barrier "snap" round after every
K-th routed source tick; each leaf answers it with its exported gate
state (``LeafSnap``, numpy), and the consumer assembles the tier-wide cut
(``pop_snapshot``) that ``checkpoint.StreamCheckpointer`` saves.
``restore=`` rebuilds the tier from such a cut: routing, frontier and
counters, every leaf gate (on its own device, in its own process for
process workers) and the root gate.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.core import scalegate
from repro_torch.core import tuples as T
from repro_torch.core import watermark as wm
from repro_torch.ingest import leaf as L
from repro_torch.ingest.channels import make_channel
from repro_torch.ingest.partitioner import SourcePartitioner
from repro_torch.ingest.root import MIN_PAD, RootMerge
from repro_torch.io.queues import TIMEOUT, BoundedQueue, QueueClosed

ROUND_TIMEOUT_S = 120.0       # hang guard: a missing leaf answer is a bug


class LeafFailure(RuntimeError):
    """A leaf worker process died before answering its round (unplanned
    host loss — SIGKILL, OOM, crash).  Raised by the consumer promptly (the
    liveness check runs every collect poll, not after ``ROUND_TIMEOUT_S``);
    ``t_detected`` stamps the detection instant so recovery drills can
    report detection→recovered latency."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.t_detected = time.perf_counter()


@dataclasses.dataclass
class _Command:
    kind: str                 # "add" | "remove"
    leaf_id: int
    at_tick: Optional[int]
    t_issued: float           # re-stamped when the command is *released*
    #                           (an at_tick-deferred command must report
    #                           the membership handshake, not queue wait)


@dataclasses.dataclass
class _RoundRec:
    round_id: int
    kind: str                 # "tick" | "reconfig" | "final" | "snap"
    leaves: Tuple[int, ...]   # who must answer this round
    root_ops: Tuple = ()
    cmd: Optional[_Command] = None
    # snap rounds only: the router-side cut captured at build time (the
    # router runs ahead of the consumer, so consumer-side reads would race)
    snap_tick: Optional[int] = None       # source ticks routed before cut
    snap_frontier: Optional[np.ndarray] = None
    snap_assignment: Optional[List[int]] = None
    snap_tuples_in: int = 0
    snap_next_leaf_id: int = 0


@dataclasses.dataclass
class IngestStats:
    leaves: Tuple[int, ...]
    rounds: int
    ticks: int
    tuples_in: int
    tuples_out: int
    watermark: int
    root_overflow: int
    leaf_overflow: Dict[int, int]
    attach_ms: List[float]
    detach_ms: List[float]

    @property
    def total_overflow(self) -> int:
        return self.root_overflow + sum(self.leaf_overflow.values())

    def summary(self) -> str:
        att = (f"{np.mean(self.attach_ms):.1f}ms" if self.attach_ms
               else "n/a")
        det = (f"{np.mean(self.detach_ms):.1f}ms" if self.detach_ms
               else "n/a")
        return (f"{len(self.leaves)} leaves, {self.rounds} rounds "
                f"({self.ticks} ticks): {self.tuples_in} tuples in, "
                f"{self.tuples_out} out, W={self.watermark}, attach {att}, "
                f"detach {det}, overflow root={self.root_overflow} "
                f"leaves={sum(self.leaf_overflow.values())}")


class _Handle:
    """One leaf worker, any transport."""

    def __init__(self, leaf_id: int):
        self.leaf_id = leaf_id
        self.gate: Optional[L.LeafGate] = None    # inline only
        self.chan = None                          # thread/process only
        self.thread: Optional[threading.Thread] = None
        self.proc = None


class IngestTier:
    """Iterable of root-ready ``TupleBatch`` ticks over ``stream``.

    ``stream`` yields source ticks (``TupleBatch``; per-source
    timestamp-sorted, source ids in ``[0, n_sources)``).  One-shot: iterate
    it once.  ``device`` is where every gate lives.  ``root_device``
    selects the root round (``RootMerge(device=...)``): by default the
    fused ``scalegate_merge_stacked`` round on the card and the host path
    on the CPU, where the tests hold it against the reference.
    """

    def __init__(self, stream, n_sources: int, n_leaves: int, *,
                 worker: str = "thread", leaf_cap: int = 128,
                 root_cap: int = 256, chan_cap: int = 4,
                 max_leaves: Optional[int] = None, record: bool = False,
                 schedule=None, out_pad: int = MIN_PAD,
                 root_device: Optional[bool] = None,
                 root_check_every: int = 8, device=None,
                 snapshot_every: int = 0, restore: Optional[Dict] = None):
        assert worker in ("thread", "process", "inline"), worker
        assert n_leaves >= 1
        self.device = _device.resolve(device)
        self.stream = stream
        self.n_sources = n_sources
        self.worker = worker
        self.leaf_cap = leaf_cap
        self.root_cap = root_cap
        self.chan_cap = chan_cap
        self.max_leaves = max_leaves or max(2 * n_leaves, n_leaves + 4)
        assert n_leaves <= self.max_leaves
        self.schedule = schedule
        self.out_pad = out_pad
        self.root_device = root_device
        self.root_check_every = root_check_every
        # snapshot_every=K inserts a barrier "snap" round after every K-th
        # routed source tick: every leaf answers with its exported state at
        # that exact boundary, so the assembled snapshot is consistent
        # across the whole tier by construction (no leaf has seen tick K
        # when it answers, every leaf has pushed tick K-1)
        self.snapshot_every = snapshot_every
        self._snapshots: Dict[int, Dict] = {}   # emitted_rounds -> payload
        self._restore = restore
        if restore is not None:
            self.part = SourcePartitioner(n_sources, restore["leaves"])
            self.part.assignment[:] = np.asarray(restore["assignment"],
                                                 np.int64)
            self.frontier = np.asarray(restore["frontier"],
                                       np.int64).copy()
            self._next_leaf_id = int(restore["next_leaf_id"])
            self._tick_index = int(restore["source_ticks"])
            self._rounds_emitted = int(restore["emitted_rounds"])
            self.tuples_in = int(restore.get("tuples_in", 0))
        else:
            self.part = SourcePartitioner(n_sources, range(n_leaves))
            self.frontier = np.zeros((n_sources,), np.int64)
            self._next_leaf_id = n_leaves
            self._tick_index = 0
            self._rounds_emitted = 0
            self.tuples_in = 0
        self._last_snap_tick = self._tick_index
        self.emitted: Optional[List[T.TupleBatch]] = [] if record else None

        self._handles: Dict[int, _Handle] = {}
        self._cmds: List[_Command] = []
        self._cmd_lock = threading.Lock()
        self._round = 0
        self._stream_done = False
        self._flushed = False
        self._started = False
        self._stop = False
        self._router_error: Optional[BaseException] = None
        self._kmax: Optional[int] = None
        self._pw: Optional[int] = None
        self._ctx = None
        self.root: Optional[RootMerge] = None
        self.attach_ms: List[float] = []
        self.detach_ms: List[float] = []
        # thread/process plumbing, created in _start()
        self._rounds: Optional[BoundedQueue] = None
        self._root_in = None
        self._outs_buf: Dict[int, Dict[int, L.LeafOut]] = defaultdict(dict)

    # -- public control -------------------------------------------------------
    def add_host(self, at_tick: Optional[int] = None) -> int:
        """Schedule an ingest host join (applied at the next tick boundary,
        or right before data tick ``at_tick``).  Returns the new leaf id."""
        with self._cmd_lock:
            leaf_id = self._next_leaf_id
            assert leaf_id < self.max_leaves, "max_leaves exhausted"
            self._next_leaf_id += 1
            self._cmds.append(_Command("add", leaf_id, at_tick,
                                       time.perf_counter()))
        return leaf_id

    def remove_host(self, leaf_id: int, at_tick: Optional[int] = None) -> None:
        """Schedule an ingest host leave (ESG flush semantics)."""
        with self._cmd_lock:
            self._cmds.append(_Command("remove", leaf_id, at_tick,
                                       time.perf_counter()))

    def rate_hint(self, tick: int) -> Optional[float]:
        return self.schedule.rate_at(tick) if self.schedule else None

    def stats(self) -> IngestStats:
        r = self.root
        if r is not None:
            r.sync_stats()
        return IngestStats(
            leaves=self.part.leaves,
            rounds=0 if r is None else r.rounds,
            ticks=self._tick_index,
            tuples_in=self.tuples_in,
            tuples_out=0 if r is None else r.tuples_out,
            watermark=-1 if r is None else r.wmark,
            root_overflow=0 if r is None else r.overflow,
            leaf_overflow=dict({} if r is None else r.leaf_overflow),
            attach_ms=list(self.attach_ms),
            detach_ms=list(self.detach_ms))

    # -- startup --------------------------------------------------------------
    def _start(self) -> None:
        assert not self._started, "IngestTier is one-shot"
        self._started = True
        self._it = iter(self.stream)
        first = next(self._it, None)
        if first is not None:
            self._it = itertools.chain([first], self._it)
            self._kmax, self._pw = first.kmax, first.payload_width
        elif self._restore is not None:
            # empty replay suffix (the snapshot covered the whole stream):
            # the gates still need their exact restored shapes to flush
            self._stream_done = True
            st = next(iter(self._restore["leaf_states"].values()))
            self._kmax = int(st["stash"]["keys"].shape[1])
            self._pw = int(st["stash"]["payload"].shape[1])
        else:
            self._stream_done = True
            self._kmax, self._pw = 1, 1
        if self._restore is not None:
            # restore dimensions must match the snapshotted stream's (the
            # RuntimeConfig in the manifest rebuilds an identical stack)
            st = next(iter(self._restore["leaf_states"].values()))
            want_kmax = st["stash"]["keys"].shape[1]
            if want_kmax != self._kmax:
                raise ValueError(f"restored leaf gates hold kmax "
                                 f"{want_kmax}, the stream {self._kmax}")
        if self.worker == "process":
            import multiprocessing as mp
            self._ctx = mp.get_context("spawn")
        self.root = RootMerge(self.max_leaves, self.root_cap, self._kmax,
                              self._pw, self.part.leaves,
                              out_pad=self.out_pad, device=self.root_device,
                              check_every=self.root_check_every,
                              torch_device=self.device)
        if self._restore is not None:
            self.root.import_state(self._restore["root"])
        if self.worker != "inline":
            self._rounds = BoundedQueue(max(2 * self.chan_cap, 4))
            cap = max(4, (self.chan_cap + 2) * self.max_leaves)
            self._root_in = make_channel(self.worker, cap, self._ctx)
        restore_states = ({} if self._restore is None
                          else self._restore["leaf_states"])
        for leaf_id in self.part.leaves:
            self._spawn(leaf_id, self.part.owned_mask(leaf_id),
                        state=restore_states.get(leaf_id))
        if self.worker != "inline":
            self._router = threading.Thread(target=self._route_loop,
                                            daemon=True)
            self._router.start()

    def _spawn(self, leaf_id: int, owned: np.ndarray,
               state: Optional[Dict] = None) -> None:
        h = _Handle(leaf_id)
        if self.worker == "inline":
            h.gate = L.LeafGate(leaf_id, self.n_sources, owned,
                                self.leaf_cap, self._kmax, self._pw,
                                device=self.device, state=state)
        elif self.worker == "thread":
            gate = L.LeafGate(leaf_id, self.n_sources, owned, self.leaf_cap,
                              self._kmax, self._pw, device=self.device,
                              state=state)
            h.chan = make_channel("thread", self.chan_cap)
            h.thread = threading.Thread(
                target=L.run_gate_loop,
                args=(gate, h.chan.get, self._root_in.put), daemon=True)
            h.thread.start()
        else:                                     # process
            cfg = dict(leaf_id=leaf_id, n_sources=self.n_sources,
                       owned=np.asarray(owned, bool), cap=self.leaf_cap,
                       kmax=self._kmax, payload_width=self._pw,
                       device=str(self.device), state=state)
            o = _obs.get()
            if o is not None:
                # the child installs its own Obs with the parent's config
                # and ships drained payloads back on LeafOut.obs
                cfg["obs"] = o.cfg.to_dict()
            h.chan = make_channel("process", self.chan_cap, self._ctx)
            h.proc = self._ctx.Process(
                target=L.process_worker_main,
                args=(cfg, h.chan._q, self._root_in._q), daemon=True)
            h.proc.start()
        self._handles[leaf_id] = h

    # -- round construction (router role) ------------------------------------
    def _pop_due_cmd(self) -> Optional[_Command]:
        with self._cmd_lock:
            for i, c in enumerate(self._cmds):
                if c.at_tick is None or c.at_tick <= self._tick_index:
                    c = self._cmds.pop(i)
                    c.t_issued = time.perf_counter()
                    return c
        return None

    def _build_reconfig(self, cmd: _Command):
        ops_by_leaf: Dict[int, List[Tuple]] = {l: [] for l in
                                               self.part.leaves}
        if cmd.kind == "add":
            moves = self.part.rebalance(add=[cmd.leaf_id])
            ops_by_leaf[cmd.leaf_id] = []
            self._spawn(cmd.leaf_id,
                        np.zeros((self.n_sources,), bool))  # gains via ops
        else:
            moves = self.part.rebalance(remove=[cmd.leaf_id])
            ops_by_leaf[cmd.leaf_id] = [("flush",)]
        gains: Dict[int, int] = {}                # leaf -> min gamma gained
        for src, (old, new) in sorted(moves.items()):
            gamma = int(self.frontier[src])
            if cmd.kind != "remove" or old != cmd.leaf_id:
                # a flushing leaf removes everything wholesale
                ops_by_leaf.setdefault(old, []).append(
                    ("remove_source", src))
            ops_by_leaf.setdefault(new, []).append(
                ("add_source", src, gamma))
            gains[new] = min(gains.get(new, gamma), gamma)
        root_ops: List[Tuple] = []
        if cmd.kind == "add":
            root_ops.append(("add_leaf", cmd.leaf_id,
                             gains.pop(cmd.leaf_id, int(wm.INF_TIME))))
        for leaf, gamma in sorted(gains.items()):
            root_ops.append(("clamp", leaf, gamma))
        if cmd.kind == "remove":
            root_ops.append(("remove_leaf", cmd.leaf_id))
        participants = tuple(sorted(set(self.part.leaves) |
                                    {cmd.leaf_id}))
        rec = _RoundRec(self._round, "reconfig", participants,
                        tuple(root_ops), cmd)
        msgs = {l: ("cmd", self._round, tuple(ops_by_leaf.get(l, ())))
                for l in participants}
        return rec, msgs

    def _fold_frontier(self, b_np: Dict[str, np.ndarray]) -> int:
        ok = b_np["valid"] & ~b_np["is_control"]
        src = b_np["source"][ok]
        tau = b_np["tau"][ok]
        if src.size:
            assert int(src.max()) < self.n_sources, \
                f"source id {int(src.max())} >= n_sources={self.n_sources}"
            np.maximum.at(self.frontier, src, tau.astype(np.int64))
        return int(ok.sum())

    def _build_next(self):
        """Next (rec, msgs_by_leaf), or None when the stream is fully
        routed and flushed."""
        if (self.snapshot_every and not self._flushed
                and self._tick_index > self._last_snap_tick
                and self._tick_index % self.snapshot_every == 0):
            # barrier snapshot round at the K-tick boundary, built BEFORE
            # any due membership command so the captured cut excludes it
            # (commands are controller intents, re-issued after a restore,
            # not snapshotted state)
            self._last_snap_tick = self._tick_index
            with self._cmd_lock:
                next_leaf_id = self._next_leaf_id
            rec = _RoundRec(self._round, "snap", self.part.leaves,
                            snap_tick=self._tick_index,
                            snap_frontier=self.frontier.copy(),
                            snap_assignment=self.part.assignment.tolist(),
                            snap_tuples_in=self.tuples_in,
                            snap_next_leaf_id=next_leaf_id)
            msgs = {l: ("snap", self._round, None) for l in self.part.leaves}
            self._round += 1
            return rec, msgs
        cmd = self._pop_due_cmd()
        if cmd is not None:
            out = self._build_reconfig(cmd)
            self._round += 1
            return out
        if not self._stream_done:
            b = next(self._it, None)
            if b is None:
                self._stream_done = True
            else:
                b_np = L.batch_to_np(b)
                self.tuples_in += self._fold_frontier(b_np)
                tl = _obs.exemplars()
                if tl is not None:
                    # admission: the first stage of a sampled tuple's
                    # end-to-end timeline (same predicate at every stage)
                    tl.scan(b_np["source"], b_np["tau"],
                            b_np["valid"] & ~b_np["is_control"], "admit")
                keep = b_np["valid"]
                leaf_of_lane = self.part.assignment[
                    np.clip(b_np["source"], 0, self.n_sources - 1)]
                msgs = {}
                for l in self.part.leaves:
                    sel = keep & (leaf_of_lane == l)
                    msgs[l] = ("tick", self._round,
                               {f: b_np[f][sel] for f in L.FIELDS})
                rec = _RoundRec(self._round, "tick", self.part.leaves)
                self._round += 1
                self._tick_index += 1
                return rec, msgs
        if not self._flushed:
            self._flushed = True
            rec = _RoundRec(self._round, "final", self.part.leaves)
            msgs = {l: ("cmd", self._round, (("flush",),))
                    for l in self.part.leaves}
            self._round += 1
            return rec, msgs
        return None

    # -- threaded router ------------------------------------------------------
    def _route_loop(self) -> None:
        try:
            while not self._stop:
                item = self._build_next()
                if item is None:
                    break
                rec, msgs = item
                # record first: the consumer may only block on leaf outs
                # for rounds it knows about
                self._rounds.put(rec)
                for l, msg in msgs.items():
                    self._handles[l].chan.put(msg)
        except QueueClosed:
            pass                                   # shutdown while blocked
        except BaseException as e:                 # surfaced by consumer
            self._router_error = e
        finally:
            self._rounds.close()

    # -- consumer side --------------------------------------------------------
    def _collect(self, rec: _RoundRec) -> List[L.LeafOut]:
        if self.worker == "inline":
            raise AssertionError("inline mode collects synchronously")
        buf = self._outs_buf
        deadline = time.monotonic() + ROUND_TIMEOUT_S
        while set(buf[rec.round_id]) != set(rec.leaves):
            if self._router_error is not None:
                raise self._router_error
            out = self._root_in.get(timeout=1.0)
            if out is TIMEOUT:
                missing = sorted(set(rec.leaves) - set(buf[rec.round_id]))
                for l in missing:
                    h = self._handles.get(l)
                    if (h is not None and h.proc is not None
                            and not h.proc.is_alive()):
                        _obs.event("leaf_failure", leaf_id=l,
                                   round_id=rec.round_id,
                                   exitcode=h.proc.exitcode)
                        raise LeafFailure(
                            f"ingest leaf {l} died (exit code "
                            f"{h.proc.exitcode}) before answering round "
                            f"{rec.round_id}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ingest round {rec.round_id} timed out waiting "
                        f"for leaves {missing}")
                continue
            buf[out.round_id][out.leaf_id] = out
        round_outs = buf.pop(rec.round_id)
        return [round_outs[l] for l in rec.leaves]

    def _dispatch_inline(self, rec: _RoundRec,
                         msgs: Dict[int, Tuple]) -> List[L.LeafOut]:
        outs = []
        for l in rec.leaves:
            h = self._handles[l]
            kind, r, payload = msgs[l]
            if kind == "tick":
                outs.append(h.gate.push_round(r, payload))
            elif kind == "snap":
                outs.append(L.LeafSnap(l, r, h.gate.export_state()))
            else:
                leaving = h.gate.apply(payload)
                outs.append(h.gate.push_round(r, None, final=leaving))
                if leaving:
                    del self._handles[l]
        return outs

    # -- snapshots ------------------------------------------------------------
    def _store_snapshot(self, rec: _RoundRec, snaps: List) -> None:
        """Assemble the tier-wide cut: every leaf's state at the barrier,
        the root gate (owned by the consumer thread, so between-rounds is
        safe), and the router-side routing state captured when the snap
        round was built.  The assignment too: the reference reads it here,
        where a thread or process router may already have applied a later
        membership command.  Keyed by ``emitted_rounds``, the number of merged
        rounds the consumer (pipeline) has seen before this cut, which is
        what aligns it with the runtime's tick ids."""
        self._snapshots[self._rounds_emitted] = {
            "leaves": [int(l) for l in rec.leaves],
            "assignment": list(rec.snap_assignment),
            "next_leaf_id": int(rec.snap_next_leaf_id),
            "frontier": np.asarray(rec.snap_frontier, np.int64),
            "source_ticks": int(rec.snap_tick),
            "emitted_rounds": int(self._rounds_emitted),
            "tuples_in": int(rec.snap_tuples_in),
            "leaf_states": {int(s.leaf_id): s.state for s in snaps},
            "root": self.root.export_state(),
        }

    def pop_snapshot(self, emitted_rounds: int) -> Optional[Dict]:
        """The snapshot whose cut sits exactly before merged round
        ``emitted_rounds`` (and drop any older ones); None if not taken.
        The consumer thread stores, any thread may pop: single dict
        operations under the GIL, plus the runtime's happens-before (the
        tier always collects the snap round before yielding the next
        tick)."""
        snap = self._snapshots.pop(emitted_rounds, None)
        for k in [k for k in self._snapshots if k < emitted_rounds]:
            self._snapshots.pop(k, None)
        return snap

    def latest_snapshot(self) -> Optional[Dict]:
        if not self._snapshots:
            return None
        return self._snapshots[max(self._snapshots)]

    def __iter__(self):
        self._start()
        try:
            while True:
                if self.worker == "inline":
                    item = self._build_next()
                    if item is None:
                        break
                    rec, msgs = item
                    outs = self._dispatch_inline(rec, msgs)
                else:
                    try:
                        rec = self._rounds.get()
                    except QueueClosed:
                        if self._router_error is not None:
                            raise self._router_error
                        break
                    outs = self._collect(rec)
                if rec.kind == "snap":
                    self._store_snapshot(rec, outs)
                    _obs.event("tier_snapshot", round_id=rec.round_id,
                               source_ticks=rec.snap_tick,
                               emitted_rounds=self._rounds_emitted)
                    continue               # snapshots merge nothing
                for lo in outs:            # cross-process obs piggybacks
                    if lo.obs is not None:
                        _obs.ingest_payload(lo.obs)
                tl = _obs.exemplars()
                if tl is not None:
                    for lo in outs:
                        r = lo.ready
                        if r["tau"].shape[0]:
                            tl.scan(r["source"], r["tau"],
                                    r["valid"] & ~r["is_control"],
                                    "root_merge")
                with _obs.span("root.merge"):
                    self.root.apply_pre(rec.root_ops)
                    out = self.root.push(outs)
                    self.root.apply_post(rec.root_ops)
                if rec.cmd is not None:
                    lat = (time.perf_counter() - rec.cmd.t_issued) * 1e3
                    (self.attach_ms if rec.cmd.kind == "add"
                     else self.detach_ms).append(lat)
                    _obs.event("tier_reconfig", cmd=rec.cmd.kind,
                               leaf_id=rec.cmd.leaf_id,
                               round_id=rec.round_id, latency_ms=lat,
                               leaves=[int(l) for l in self.part.leaves])
                if self.emitted is not None:
                    self.emitted.append(out)
                self._rounds_emitted += 1
                yield out
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        self._stop = True
        for h in list(self._handles.values()):
            if h.chan is not None:
                try:
                    h.chan.put(("stop",), timeout=0.1)
                except Exception:
                    pass
                h.chan.close()
        if self._rounds is not None:
            self._rounds.close()
        for h in list(self._handles.values()):
            if h.thread is not None:
                h.thread.join(timeout=10)
            if h.proc is not None:
                h.proc.join(timeout=20)
                if h.proc.is_alive():              # pragma: no cover
                    h.proc.terminate()
        if getattr(self, "_router", None) is not None \
                and self.worker != "inline":
            self._router.join(timeout=10)


# -- the flat oracle ---------------------------------------------------------

def single_gate_stream(stream, n_sources: int, cap: int, *,
                       flush: bool = True,
                       device=None) -> List[T.TupleBatch]:
    """The single-gate oracle the tier must match: one flat ScaleGate over
    all sources on ``device`` (default: the card), pushed tick by tick
    (plus a final ESG flush so the tail drains); returns the list of ready
    batches."""
    dev = _device.resolve(device)
    state = None
    outs: List[T.TupleBatch] = []
    for b in stream:
        if state is None:
            state = scalegate.init_scalegate(n_sources, cap, b.kmax,
                                             b.payload_width, device=dev)
        state, out = scalegate.push(state, b.to(dev))
        outs.append(out)
    if state is not None and flush:
        state = scalegate.remove_sources(
            state, torch.ones((n_sources,), dtype=torch.bool, device=dev))
        state, out = scalegate.push(state, T.empty_batch(
            MIN_PAD, outs[0].kmax, outs[0].payload_width, dev))
        outs.append(out)
    return outs


def collect_tuples(batches: Iterable[T.TupleBatch]) -> List[Tuple]:
    """Sorted multiset of (tau, source, keys, payload) over the valid lanes:
    the tier-level parity currency (payloads rounded as in io.sinks)."""
    res = []
    for b in batches:
        d = L.batch_to_np(b)
        for i in np.nonzero(d["valid"])[0]:
            res.append((int(d["tau"][i]), int(d["source"][i]),
                        tuple(d["keys"][i].tolist()),
                        tuple(np.round(d["payload"][i], 4).tolist())))
    return sorted(res)


def emitted_taus(batches: Iterable[T.TupleBatch]) -> np.ndarray:
    """Concatenated valid-lane taus in emission order (the total-order
    witness: callers assert non-decreasing)."""
    taus = [b.tau.cpu().numpy()[b.valid.cpu().numpy()] for b in batches]
    return (np.concatenate(taus) if taus else np.zeros((0,), np.int64))
