"""VSN serving slot pool: state-transfer-free elastic inference.

Held against ``src/repro/serving/kv_pool.py``.  The KV cache pool is
STRETCH's shared sigma for the serving operator: request slots are virtual
keys with a fixed storage layout; which instance (active replica group)
serves a slot is the epoch's ``f_mu`` — scaling replicas up or down
rewrites the small table and moves no byte of KV (the SN baseline,
kept for comparison, migrates the moved slots' KV through the host).

The engine implements continuous batching as a stream operator: requests
are tuples (tau = arrival time), admission prefills the whole prompt into
a free slot in one forward (the first output token is the argmax of the
prefill's final logits), and each tick advances every running request by
one decode step in one batched forward.  The reference gathers the
running slots into a power-of-two bucket padded with an out-of-range slot
id (JAX clamps the gather and drops the pad lanes' scatter) and decodes it
with ``vmap`` over per-slot positions.  The port batches exactly the
running lanes: each lane carries its own position, the attention kernel
reads and writes each lane's slot of the pool in place (``lanes``), and
the recurrent states are gathered and written back by slot.  No pad lane
exists, so none can write back, and there are no buckets to compile.  An
MoE model routes each lane as a group of its own in that one forward (the
capacity is per lane, as under the reference's per-lane ``vmap``), and
the tokens the experts drop are counted (``dropped``, a device total;
``dropped_decode`` the decode rounds' share).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.models import model as M, transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # token ids
    max_new: int
    arrived: int = 0             # tau
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    admitted_step: int = -1
    finished_step: int = -1


def _leaves(*trees) -> List[torch.Tensor]:
    return [leaf for tree in trees if tree is not None
            for leaf in tree.values()]


@dataclasses.dataclass
class SlotPool:
    """Fixed-capacity decode slots; free-list + f_mu ownership table.
    Caches and states are stacked ``[L, n_slots, ...]`` on ``device``."""
    cfg: ModelConfig
    n_slots: int
    max_seq: int
    n_instances: int
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)
        self.caches, self.states = transformer.init_caches(
            self.cfg, self.n_slots, self.max_seq, self.device)
        self.free = list(range(self.n_slots))
        self.pos = np.zeros((self.n_slots,), np.int32)
        self.n_active = self.n_instances
        self.fmu = np.arange(self.n_slots, dtype=np.int32) % self.n_instances
        self.active = np.ones((self.n_instances,), bool)
        self.kv_bytes_moved = 0   # SN baseline counter

    def alloc(self) -> Optional[int]:
        return self.free.pop() if self.free else None

    def release(self, slot: int):
        self.pos[slot] = 0
        # a recycled slot must not leak the previous occupant: the recurrent
        # state feeds straight into the next request's first step, so it
        # MUST be zeroed; the KV cache is zeroed too (positions past ``pos``
        # are causally masked, so this half is hygiene), which keeps a freed
        # slot identical to a fresh one.
        for leaf in _leaves(self.caches, self.states):
            leaf[:, slot].zero_()
        self.free.append(slot)

    def slot_bytes(self) -> int:
        return sum(leaf.element_size() * leaf.numel() // leaf.shape[1]
                   for leaf in _leaves(self.caches, self.states)
                   if leaf.dim() > 1)

    def occupied(self) -> List[int]:
        free = set(self.free)
        return [s for s in range(self.n_slots) if s not in free]

    # ---- elasticity -------------------------------------------------------
    def reconfigure_vsn(self, n_active: int) -> int:
        """VSN: remap slot ownership; zero KV movement.  Returns bytes."""
        self.active[:] = False
        self.active[:n_active] = True
        self.n_active = max(n_active, 1)
        self.fmu = np.arange(self.n_slots, dtype=np.int32) % self.n_active
        return self.fmu.nbytes + self.active.nbytes

    def reconfigure_sn(self, n_active: int) -> int:
        """SN baseline: slots whose owner changed ship their KV state.  The
        shipped bytes are materialized (a device -> host -> device round
        trip of the moved slots' caches and states), so the measured
        reconfiguration time reflects a real migration."""
        old = self.fmu.copy()
        self.reconfigure_vsn(n_active)
        free = set(self.free)
        moved = [s for s in range(self.n_slots)
                 if old[s] != self.fmu[s] and s not in free]
        moved_bytes = len(moved) * self.slot_bytes()
        if moved:
            idx = torch.as_tensor(moved, device=self.device)
            for leaf in _leaves(self.caches, self.states):
                host = leaf[:, idx].cpu()                     # "send"
                leaf[:, idx] = host.to(self.device)           # "receive"
        self.kv_bytes_moved += moved_bytes
        return moved_bytes


class ServingEngine:
    """Continuous batching driver over a SlotPool, greedy (argmax) as the
    reference's.  ``params`` lie on ``device`` (default: the card).
    ``prefills`` and ``decode_rounds`` count the forwards run (each runs
    every layer once).  The reference's ``greedy`` flag, which it never
    reads, and its ``chunk`` have no counterpart."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_seq: int, n_instances: int = 1, device=None):
        self.cfg, self.params = cfg, params
        self.device = _device.resolve(device)
        self.pool = SlotPool(cfg, n_slots, max_seq, n_instances, self.device)
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.steps = 0
        self.tokens_out = 0
        self.requests_done = 0
        self.prefills = 0
        self.decode_rounds = 0
        self.dropped = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self.dropped_decode = torch.zeros_like(self.dropped)

    def submit(self, req: Request):
        self.waiting.append(req)

    def _admit(self, done: List[Request]):
        pool = self.pool
        while self.waiting:
            slot = pool.alloc()
            if slot is None:
                return
            req = self.waiting.popleft()
            req.slot = slot
            req.admitted_step = self.steps
            if len(req.prompt) + req.max_new > pool.max_seq:
                raise ValueError("request does not fit the slot sequence "
                                 "budget")
            with _obs.span("serve.prefill"):
                toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                       device=self.device)
                logits, _, _, aux = M.prefill_with_cache(
                    self.params, toks, pool.caches, pool.states, cfg=self.cfg,
                    lanes=torch.tensor([slot], device=self.device),
                    with_aux=True)
                self.dropped += aux
                first = int(logits[0].argmax())
            self.prefills += 1
            pool.pos[slot] = len(req.prompt)
            req.out.append(first)
            self.tokens_out += 1
            if len(req.out) >= req.max_new:     # max_new == 1: done at admit
                self._finish(req, done)
            else:
                self.running[req.uid] = req

    def _finish(self, req: Request, done: List[Request]):
        req.finished_step = self.steps
        self.running.pop(req.uid, None)
        self.pool.release(req.slot)
        self.requests_done += 1
        done.append(req)

    def tick(self) -> List[Request]:
        """One decode round over all running requests; returns finished."""
        done: List[Request] = []
        self._admit(done)
        if self.running:
            pool = self.pool
            reqs = list(self.running.values())
            lanes = np.asarray([r.slot for r in reqs], np.int64)
            as_dev = lambda a: torch.as_tensor(a, device=self.device)
            with _obs.span("serve.decode"):
                logits, _, _, aux = M.decode_step(
                    self.params, pool.caches, pool.states,
                    as_dev(np.asarray([r.out[-1] for r in reqs], np.int64)),
                    as_dev(pool.pos[lanes].astype(np.int64)), cfg=self.cfg,
                    lanes=as_dev(lanes), with_aux=True)
                self.dropped += aux
                self.dropped_decode += aux
                toks = logits.argmax(dim=-1).cpu().numpy()  # sync: real time
            self.decode_rounds += 1
            for i, req in enumerate(reqs):
                req.out.append(int(toks[i]))
                pool.pos[req.slot] += 1
                self.tokens_out += 1
                if len(req.out) >= req.max_new:
                    self._finish(req, done)
        self.steps += 1
        return done

    # ---- elasticity -------------------------------------------------------
    def reconfigure(self, n_active: int, mode: str = "vsn"):
        """Apply a replica-count change as the paper's f_mu rewrite (VSN)
        or the SN migration baseline.  Returns (kv_bytes_moved, wall_ms)."""
        t0 = time.perf_counter()
        with _obs.span("serve.reconfig"):
            if mode == "vsn":
                self.pool.reconfigure_vsn(n_active)
                moved = 0
            elif mode == "sn":
                moved = self.pool.reconfigure_sn(n_active)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            else:
                raise ValueError(f"unknown reconfig mode {mode!r}")
        ms = (time.perf_counter() - t0) * 1e3
        _obs.event("serve_reconfig", mode=mode, n_active=int(n_active),
                   kv_bytes_moved=int(moved), ms=ms)
        return moved, ms

    def inst_load(self) -> np.ndarray:
        """Active decode slots per instance under the current f_mu."""
        load = np.zeros((self.pool.n_instances,), np.int64)
        slots = [r.slot for r in self.running.values()]
        if slots:
            np.add.at(load, self.pool.fmu[np.asarray(slots)], 1)
        return load


def reference_decode(cfg: ModelConfig, params, prompt, max_new: int,
                     max_seq: int) -> List[int]:
    """Straight-line batch-1 greedy decode: fresh caches, one bulk prefill,
    then token by token, on the parameters' device.  The engine's
    per-request output must match this — the contract the continuous
    batching machinery is tested against."""
    dev = params["embedding"].device
    caches, states = transformer.init_caches(cfg, 1, max_seq, dev)
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    logits, caches, states = M.prefill_with_cache(params, toks, caches,
                                                  states, cfg=cfg)
    out = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(out) < max_new:
        logits, caches, states = M.decode_step(
            params, caches, states,
            torch.tensor([out[-1]], device=dev), pos, cfg=cfg)
        out.append(int(logits[0].argmax()))
        pos += 1
    return out
