"""Leaf ScaleGate: one ingest worker's merge over its owned sources.

Held against ``src/repro/ingest/leaf.py``.  A leaf is the paper's per-host
ScaleGate (§6 hierarchical TB): it merges the timestamp-sorted streams of
its *disjoint* source subset into a ready stream that is itself
timestamp-sorted, so the leaf outputs compose as sources of the root merge
one level up.  The leaf is a thin, host-driven wrapper around the same
``scalegate.push`` the pipelines use (on the card: the ``scalegate_merge``
kernel):

* per round it pushes its routed slice (chunked to a fixed lane width) and
  emits a ``LeafOut``: the *compacted* ready tuples plus the leaf's
  reported watermark ``W_leaf`` and its cumulative stash-overflow count
  (surfaced every round, never silent);
* ESG membership ops ride the same round stream: ``add_source`` starts a
  gained source at its Lemma-3 safe bound gamma, ``remove_source`` flushes
  (the frontier stops gating; stashed tuples drain as W rises), ``flush``
  removes every owned source so the final push empties the stash.

``LeafOut`` payloads are plain numpy (the tier's channels may cross process
boundaries); the worker loops for thread and process mode live here too so
a spawn-context child can import them top-level.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import scalegate
from repro_torch.core import tuples as T

FIELDS = T.FIELDS


def batch_to_np(b: T.TupleBatch) -> Dict[str, np.ndarray]:
    return {f: getattr(b, f).cpu().numpy() for f in FIELDS}


def np_to_batch(d: Dict[str, np.ndarray], device) -> T.TupleBatch:
    return T.TupleBatch(**{f: torch.tensor(d[f], dtype=T.DTYPES[f],
                                           device=device) for f in FIELDS})


def compact_np(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Keep only the valid lanes (host-side; output of a gate push)."""
    keep = d["valid"]
    return {f: d[f][keep] for f in FIELDS}


def empty_np(kmax: int, payload_width: int) -> Dict[str, np.ndarray]:
    return {
        "tau": np.zeros((0,), np.int32),
        "keys": np.zeros((0, kmax), np.int32),
        "payload": np.zeros((0, payload_width), np.float32),
        "source": np.zeros((0,), np.int32),
        "valid": np.zeros((0,), bool),
        "is_control": np.zeros((0,), bool),
        "ctrl_epoch": np.zeros((0,), np.int32),
    }


def concat_np(parts: Sequence[Dict[str, np.ndarray]],
              kmax: int, payload_width: int) -> Dict[str, np.ndarray]:
    parts = [p for p in parts if p["tau"].shape[0]]
    if not parts:
        return empty_np(kmax, payload_width)
    return {f: np.concatenate([p[f] for p in parts]) for f in FIELDS}


def pad_np(d: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Pad to exactly ``n`` lanes with invalid filler (fixed shapes)."""
    have = d["tau"].shape[0]
    assert have <= n, (have, n)
    if have == n:
        return d
    pad = n - have
    out = {}
    for f in FIELDS:
        a = d[f]
        shape = (pad,) + a.shape[1:]
        out[f] = np.concatenate([a, np.zeros(shape, a.dtype)])
    return out


@dataclasses.dataclass
class LeafOut:
    """One leaf's contribution to one root round (picklable: numpy only)."""
    leaf_id: int
    round_id: int
    ready: Dict[str, np.ndarray]   # compacted ready tuples, tau-sorted
    wmark: int                     # reported leaf watermark W_leaf
    overflow: int                  # cumulative leaf stash-overflow count
    final: bool = False            # last message (leaf flushed and left)
    # cross-process observability payload (drained child spans/counters/
    # events piggybacking on the round stream); None in thread mode, where
    # the leaf shares the parent's registry directly
    obs: Optional[Dict] = None

    @property
    def n_ready(self) -> int:
        return int(self.ready["tau"].shape[0])


class LeafGate:
    """The leaf state machine; drivable inline, from a thread, or from a
    child process (see the worker loops below).  Its gate lives on
    ``device`` (default: the card)."""

    def __init__(self, leaf_id: int, n_sources: int, owned: np.ndarray,
                 cap: int, kmax: int, payload_width: int,
                 chunk: Optional[int] = None, device=None):
        self.leaf_id = leaf_id
        self.n_sources = n_sources
        self.kmax = kmax
        self.payload_width = payload_width
        self.device = _device.resolve(device)
        # chunk width: the combined merge size is cap + chunk
        self.chunk = chunk or cap
        self.state = scalegate.init_scalegate(
            n_sources, cap, kmax, payload_width,
            active=np.asarray(owned, bool), device=self.device)

    # -- per-round work ------------------------------------------------------
    def push_round(self, round_id: int, slice_np: Optional[Dict] = None,
                   final: bool = False) -> LeafOut:
        """Push this round's routed tuples (possibly none) and report."""
        parts: List[Dict[str, np.ndarray]] = []
        lanes = 0 if slice_np is None else slice_np["tau"].shape[0]
        off = 0
        while True:
            n = min(self.chunk, lanes - off)
            if slice_np is None or n <= 0:
                chunk = pad_np(empty_np(self.kmax, self.payload_width),
                               self.chunk)
            else:
                chunk = pad_np({f: slice_np[f][off:off + n] for f in FIELDS},
                               self.chunk)
            self.state, out = scalegate.push(
                self.state, np_to_batch(chunk, self.device))
            parts.append(compact_np(batch_to_np(out)))
            off += self.chunk
            if off >= lanes:
                break
        ready = concat_np(parts, self.kmax, self.payload_width)
        return LeafOut(self.leaf_id, round_id, ready,
                       wmark=int(self.state.wmark.value()),
                       overflow=int(self.state.overflow), final=final)

    # -- ESG membership ------------------------------------------------------
    def _mask(self, src: int) -> torch.Tensor:
        m = torch.zeros((self.n_sources,), dtype=torch.bool,
                        device=self.device)
        m[src] = True
        return m

    def add_source(self, src: int, gamma: int) -> None:
        self.state = scalegate.add_sources(self.state, self._mask(src), gamma)

    def remove_source(self, src: int) -> None:
        self.state = scalegate.remove_sources(self.state, self._mask(src))

    def flush_all(self) -> None:
        self.state = scalegate.remove_sources(
            self.state, torch.ones((self.n_sources,), dtype=torch.bool,
                                   device=self.device))

    def apply(self, ops: Sequence[Tuple]) -> bool:
        """Apply a reconfiguration op list; returns True when this leaf is
        leaving (its subsequent push is its flush + final message)."""
        leaving = False
        for op in ops:
            if op[0] == "add_source":
                self.add_source(op[1], op[2])
            elif op[0] == "remove_source":
                self.remove_source(op[1])
            elif op[0] == "flush":
                self.flush_all()
                leaving = True
            else:
                raise ValueError(f"unknown leaf op {op!r}")
        return leaving


def run_gate_loop(gate: LeafGate, recv, send, ship_obs: bool = False) -> None:
    """The worker protocol: drive ``gate`` from ``recv()`` messages until a
    stop/flush; shared verbatim by thread and process workers.

    Messages: ``("tick", round, slice_np)`` | ``("cmd", round, ops)`` |
    ``("stop",)``.  Every tick/cmd message produces exactly one
    ``LeafOut`` via ``send``: the root's round barrier counts on it.

    ``ship_obs=True`` (process workers only) attaches the child's drained
    observability payload to each outgoing ``LeafOut``; thread workers
    share the parent's registry and must NOT ship (double-counting).
    """
    from repro_torch import obs as _obs
    from repro_torch.io.queues import QueueClosed

    def answer(out: LeafOut) -> None:
        _obs.counter_inc("leaf.rounds")
        _obs.counter_inc("leaf.tuples_ready", out.n_ready)
        _obs.event("leaf_push", leaf_id=out.leaf_id, round_id=out.round_id,
                   n_ready=out.n_ready, wmark=out.wmark,
                   overflow=out.overflow, final=out.final)
        if ship_obs:
            out.obs = _obs.drain_payload()
        send(out)

    while True:
        try:
            msg = recv()
        except QueueClosed:
            break
        kind = msg[0]
        if kind == "stop":
            break
        if kind == "tick":
            tl = _obs.exemplars()
            if tl is not None and msg[2] is not None:
                s = msg[2]
                tl.scan(s["source"], s["tau"],
                        s["valid"] & ~s["is_control"], "leaf_push")
            with _obs.span("leaf.push"):
                out = gate.push_round(msg[1], msg[2])
            answer(out)
        elif kind == "cmd":
            leaving = gate.apply(msg[2])
            with _obs.span("leaf.push"):
                out = gate.push_round(msg[1], None, final=leaving)
            answer(out)
            if leaving:
                break
        else:
            raise ValueError(f"unknown message {msg!r}")


def process_worker_main(cfg: Dict, in_q, out_q) -> None:
    """Child-process entry point (spawn context: top-level importable).

    ``cfg`` carries the LeafGate constructor arguments as picklable values,
    the device as a string: the child resolves it itself (a CUDA context
    is never inherited, since the tier spawns instead of forking).  All
    channel payloads are numpy.  Mirrors ``run_gate_loop`` over the mp
    queues.
    """
    from repro_torch import obs as _obs
    from repro_torch.ingest.channels import MP_CLOSE
    from repro_torch.io.queues import QueueClosed

    ship_obs = False
    if cfg.get("obs"):
        # the child gets its own Obs (same config as the parent's) and
        # ships drained payloads back on the round stream
        _obs.install(_obs.ObsConfig.from_dict(cfg["obs"]))
        ship_obs = True

    gate = LeafGate(cfg["leaf_id"], cfg["n_sources"],
                    np.asarray(cfg["owned"], bool), cfg["cap"], cfg["kmax"],
                    cfg["payload_width"], chunk=cfg.get("chunk"),
                    device=cfg["device"])

    def recv():
        msg = in_q.get()
        if msg == MP_CLOSE:
            raise QueueClosed
        return msg

    run_gate_loop(gate, recv, out_q.put, ship_obs=ship_obs)
