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
one decode step in one batched forward.  As the reference's
``_bucket(len(reqs), n_slots)`` does, a round pads its running lanes to
the power-of-two bucket above their count, each lane at its own position.
The reference pads with the out-of-range slot id ``n_slots``: XLA clamps
the gather and drops the scatter.  The port's forward reads and writes the
pool in place by lane, where such an index would raise, so the pool keeps
one scratch row past its slots, at index ``n_slots``: a pad lane (token 0,
position 0, ``live`` false) reads and writes only that row.  The row is
left out of ``caches``/``states`` (views of the slots), ``slot_bytes``
and the SN migration, and an MoE counts no pad lane's drops.  An MoE
routes each lane as a group of its own (the capacity is per lane, as
under the reference's per-lane ``vmap``), and the tokens the experts drop
are counted (``dropped``, a device total; ``dropped_decode`` the decode
rounds' share).

A round's inputs (lanes, last tokens, positions, live flags) and a
prefill's (slot, prompt) are written on the host into one staging tensor
each (pinned on the card) and copied into static device buffers; the
forward reads only those, so no depth becomes a Python number inside it.
On the card (``graphs``, the default there) the first round of each
bucket and the first prefill of each prompt length run on a side stream
and are then captured as a CUDA graph, the reference's one executable per
shape; every later one replays it.  All graphs share one memory pool.  A
capture that fails raises ``GraphCaptureError``; there is no eager
fallback.  ``graphs=False`` runs the same rounds eagerly, the card's
comparison and the CPU's only engine.  One host read a call remains: the
round's tokens, or the prefill's first token.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.core.runtime import GraphCaptureError, graph_nodes
from repro_torch.kernels import dispatch
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
    """The tensors of caches/states trees (a dict, one tensor or None)."""
    out = []
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif tree is not None:
            out.extend(tree.values())
    return out


def _rows(tree, n: int):
    """Views of the first ``n`` rows (axis 1) of a caches/states tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[:, :n]
    return {k: v[:, :n] for k, v in tree.items()}


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n (capped): one graph a bucket, at most
    log2(n_slots) + 1 of them (the reference's ``_bucket``)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class SlotPool:
    """Fixed-capacity decode slots; free-list + f_mu ownership table.
    Caches and states are stacked ``[L, n_slots + 1, ...]`` on ``device``
    (``caches_all``/``states_all``); row ``n_slots`` is the pad lanes'
    scratch row, and ``caches``/``states`` are views of the slots."""
    cfg: ModelConfig
    n_slots: int
    max_seq: int
    n_instances: int
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)
        self.caches_all, self.states_all = transformer.init_caches(
            self.cfg, self.n_slots + 1, self.max_seq, self.device)
        self.caches = _rows(self.caches_all, self.n_slots)
        self.states = _rows(self.states_all, self.n_slots)
        self.scratch = self.n_slots
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
        # slot identical to a fresh one.  In place, so that the graphs'
        # captured storage stays the pool's.
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
                leaf[:, idx] = host.to(self.device)           # "receive",
                # in place: the graphs' captured storage stays the pool's
        self.kv_bytes_moved += moved_bytes
        return moved_bytes


@dataclasses.dataclass
class _Graph:
    """One captured prefill or decode round and what its capture recorded."""
    graph: Any
    launches: Dict[str, int]       # kernel launches of one replay, by name
    capture_s: float
    instantiate_s: float
    nodes: Optional[dict]
    replays: int = 0


class ServingEngine:
    """Continuous batching driver over a SlotPool, greedy (argmax) as the
    reference's.  ``params`` lie on ``device`` (default: the card).
    ``graphs`` (default: True on the card, where the eager engine is
    ``graphs=False``; the CPU runs eagerly) captures each decode bucket
    and prompt length as a CUDA graph.  ``prefills`` and ``decode_rounds``
    count the forwards run (each runs every layer once).  The reference's
    ``greedy`` flag, which it never reads, and its ``chunk`` have no
    counterpart."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_seq: int, n_instances: int = 1, device=None,
                 graphs: Optional[bool] = None):
        self.cfg, self.params = cfg, params
        self.device = dev = _device.resolve(device)
        cuda = dev.type == "cuda"
        self.graphs = cuda if graphs is None else bool(graphs)
        if self.graphs and not cuda:
            raise ValueError("CUDA graphs need a CUDA device; the engine "
                             "runs eagerly on the CPU")
        self.pool = SlotPool(cfg, n_slots, max_seq, n_instances, dev)
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.steps = 0
        self.tokens_out = 0
        self.requests_done = 0
        self.prefills = 0
        self.decode_rounds = 0
        self.dropped = torch.zeros((), dtype=torch.float32, device=dev)
        self.dropped_decode = torch.zeros_like(self.dropped)
        # host staging and the static device buffers the forwards read:
        # a round's [lanes, last tokens, positions, live] a lane, and a
        # prefill's [slot, prompt...]; then their argmax tokens
        i64 = dict(dtype=torch.int64)
        self._round_host = torch.zeros((4, n_slots), **i64)
        self._prompt_host = torch.zeros((max_seq + 1,), **i64)
        if cuda:
            self._round_host = self._round_host.pin_memory()
            self._prompt_host = self._prompt_host.pin_memory()
        self._round = torch.zeros((4, n_slots), device=dev, **i64)
        self._prompt = torch.zeros((max_seq + 1,), device=dev, **i64)
        self._next = torch.zeros((n_slots,), device=dev, **i64)
        self._first = torch.zeros((), device=dev, **i64)
        self._graphs: Dict[tuple, _Graph] = {}
        self._graph_pool = None

    def submit(self, req: Request):
        self.waiting.append(req)

    # ---- the forwards ------------------------------------------------------
    def _prefill_body(self, n: int):
        """The prompt in ``_prompt[1:1 + n]`` into the slot ``_prompt[0]``;
        its first token into ``_first``."""
        pool = self.pool
        logits, _, _, aux = M.prefill_with_cache(
            self.params, self._prompt[1:1 + n][None], pool.caches_all,
            pool.states_all, cfg=self.cfg, lanes=self._prompt[:1],
            with_aux=True)
        self.dropped += aux
        self._first.copy_(logits[0].argmax())

    def _decode_body(self, k: int):
        """One decode step of the ``k`` lanes staged in ``_round``; their
        tokens into ``_next[:k]``."""
        pool = self.pool
        lanes, toks, pos, live = self._round[:, :k]
        logits, _, _, aux = M.decode_step(
            self.params, pool.caches_all, pool.states_all, toks, pos,
            cfg=self.cfg, lanes=lanes, live=live != 0, with_aux=True)
        self.dropped += aux
        self.dropped_decode += aux
        self._next[:k].copy_(logits.argmax(dim=-1))

    def _run(self, key: tuple, body) -> None:
        """``body()`` eagerly, or its graph's replay (captured at the
        key's first call)."""
        if not self.graphs:
            body()
            return
        g = self._graphs.get(key)
        if g is None:
            self._capture(key, body)
            return
        g.graph.replay()
        dispatch.add_launches(g.launches)
        g.replays += 1

    def _capture(self, key: tuple, body) -> None:
        """A key's first call: ``body`` runs on a side stream (the warm-up
        torch asks for before a capture; it is this call's work), then is
        captured into the engine's graph pool without running."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        try:
            with dispatch.recording() as tally, torch.cuda.graph(
                    graph, pool=self._graph_pool,
                    capture_error_mode="thread_local"):
                body()
        except RuntimeError as e:
            cause = e.__context__ if e.__context__ is not None else e
            raise GraphCaptureError(
                f"the serving {key[0]} of shape {key[1]} cannot be captured "
                f"as a CUDA graph ({type(cause).__name__}: {cause})") from e
        capture_s = time.perf_counter() - t0
        nodes = graph_nodes(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        self._graphs[key] = _Graph(
            graph=graph, launches=tally, capture_s=capture_s,
            instantiate_s=time.perf_counter() - t0, nodes=nodes)

    def graph_stats(self) -> Dict[str, dict]:
        """For each captured shape (``decode/<bucket>``, ``prefill/<prompt
        length>``): kernel launches a replay by name, the graph's nodes
        (``core.runtime.graph_nodes``), capture and instantiate seconds
        and the replays so far."""
        return {f"{kind}/{n}": dict(
            launches=dict(g.launches), nodes=g.nodes, capture_s=g.capture_s,
            instantiate_s=g.instantiate_s, replays=g.replays)
            for (kind, n), g in self._graphs.items()}

    # ---- continuous batching -----------------------------------------------
    def _admit(self, done: List[Request]):
        pool = self.pool
        while self.waiting:
            slot = pool.alloc()
            if slot is None:
                return
            req = self.waiting.popleft()
            req.slot = slot
            req.admitted_step = self.steps
            n = len(req.prompt)
            if n + req.max_new > pool.max_seq:
                raise ValueError("request does not fit the slot sequence "
                                 "budget")
            with _obs.span("serve.prefill"):
                self._prompt_host[0] = slot
                self._prompt_host[1:1 + n] = torch.from_numpy(
                    np.asarray(req.prompt, np.int64))
                self._prompt.copy_(self._prompt_host, non_blocking=True)
                self._run(("prefill", n),
                          functools.partial(self._prefill_body, n))
                first = int(self._first)            # sync: real time
            self.prefills += 1
            pool.pos[slot] = n
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
        """One decode round over all running requests, padded to its
        bucket; returns the finished requests."""
        done: List[Request] = []
        self._admit(done)
        if self.running:
            pool = self.pool
            reqs = list(self.running.values())
            n = len(reqs)
            k = _bucket(n, pool.n_slots)
            slots = np.asarray([r.slot for r in reqs], np.int64)
            host = self._round_host.numpy()
            host[:, n:k] = [[pool.scratch], [0], [0], [0]]   # pad lanes
            host[0, :n] = slots
            host[1, :n] = [r.out[-1] for r in reqs]
            host[2, :n] = pool.pos[slots]
            host[3, :n] = 1
            self._round.copy_(self._round_host, non_blocking=True)
            with _obs.span("serve.decode"):
                self._run(("decode", k),
                          functools.partial(self._decode_body, k))
                toks = self._next[:n].cpu().numpy()  # sync: real time
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
