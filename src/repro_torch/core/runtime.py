"""Pipeline driver: ScaleGate -> epoch handling -> executor tick (§7, Fig. 5).

Held against ``src/repro/core/runtime.py`` (``fold_frontier``,
``ctrl_lanes``, ``VSNPipeline``, ``SNPipeline``).  A pipeline has ``n_max``
instances of which ``n_active`` are connected.  Each ``step``:

  1. a ``Reconfiguration`` becomes per-source control tuples stamped with
     the last forwarded tau (Alg. 5), pushed with the data;
  2. ScaleGate merges and gates the ready tuples (the shared TB);
  3. prepareReconfig adopts the pending tables (Alg. 6);
  4. the tick runs in two epoch phases split at gamma (Alg. 4 L17);
  5. the per-instance outputs are returned stacked.

``VSNPipeline`` shares sigma; ``SNPipeline`` keeps dedicated ``sigma_j`` and
pays duplication and state transfer.  Both run on ``device`` (default: the
CUDA device; ``"cpu"`` only when asked).

The persistent K-tick driver (``stage_super``, ``run_persistent_staged``,
``run_persistent``) runs K ticks of a ``[K, B + n_inputs]`` super-batch in
one call, the counterpart of the reference's ``lax.scan`` with donated
state.  On the CPU it is a plain loop of K ticks.  On the card it is one
CUDA graph per super-batch shape ``(K, lanes, kmax, payload_width)``: the
first call of a shape runs the K ticks on a side stream (the warm-up torch
asks for before a capture) and then captures them; every later call copies
its operands into the graph's static buffers and replays it.  A
reconfiguration's control tuples are written into the pad lanes of tick
``reconfig_at`` inside the graph, at a tick index held in a device tensor,
so one graph serves the steady and the reconfiguring call alike.  Every
tick function the repo builds is captured, the general O+ tick included
(under capture it reads nothing back to the host); one that does read the
host makes the call raise ``GraphCaptureError``.  The captured general
tick's expiry is bounded (``operator._plan``); where the bound cannot be
shown exact it sets a device flag (``fault``) that the pipeline raises on
after the replay, at a read it already makes: the end of
``run_persistent``, or the async runtime's control-lane read.  Run
eagerly, the tick runs every due round instead.
``MeshPipeline`` comes with the mesh slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import elastic, scalegate, sn, vsn
from repro_torch.core import tuples as T
from repro_torch.core.controller import Reconfiguration
from repro_torch.core.operator import (OperatorDef, any_fault,
                                       expiry_faults, raise_on_fault,
                                       tick as general_tick)
from repro_torch.kernels import dispatch
from repro_torch.tree import tree_leaves, tree_map


def fold_frontier(frontier: np.ndarray, b: T.TupleBatch,
                  n_inputs: int) -> None:
    """Fold one batch's per-source max data tau into a host-side frontier
    (mutated in place): the Alg. 5 bookkeeping behind control stamps."""
    tau = b.tau.cpu().numpy()
    src = b.source.cpu().numpy()
    ok = b.valid.cpu().numpy() & ~b.is_control.cpu().numpy()
    for i in range(n_inputs):
        sel = ok & (src == i)
        if sel.any():
            frontier[i] = max(frontier[i], int(tau[sel].max()))


def ctrl_lanes(n_inputs: int, frontier, epoch_id: int, kmax: int, p: int,
               device) -> T.TupleBatch:
    """One control tuple per source so every per-source stream stays
    sorted (Alg. 5); each stamped with that source's last forwarded tau."""
    lanes = []
    for i in range(n_inputs):
        c = elastic.make_control_tuple(int(frontier[i]), epoch_id, kmax, p,
                                       device)
        lanes.append(dataclasses.replace(
            c, source=torch.full((1,), i, dtype=torch.int32, device=device)))
    return functools.reduce(T.concat, lanes)


def inject_ctrl(stack: T.TupleBatch, ctrl: T.TupleBatch, rc_tick,
                n_inputs: int) -> T.TupleBatch:
    """Overwrite the ctrl pad region (the last ``n_inputs`` lanes) of tick
    ``rc_tick`` in a ``[K, B + n_inputs]`` super-batch with ``ctrl``'s
    lanes (out of place).  ``rc_tick`` is an int64[1] tensor on the stack's
    device, so one captured graph covers the reconfiguring and the steady
    call: with no reconfiguration the caller passes all-invalid ``ctrl``
    lanes, and the write changes nothing (``stage_super`` fills the pad
    region with them)."""
    width = stack.tau.shape[1]
    lanes = torch.arange(width - n_inputs, width, device=stack.device)
    return tree_map(lambda a, c: a.index_put((rc_tick, lanes),
                                             c.to(a.dtype)), stack, ctrl)


@dataclasses.dataclass
class PersistentOut:
    """What one persistent K-tick call returns: the stacked data lane and
    the control lane, each with a leading K axis."""
    outs_pre: Any                  # [K, ...] per-tick pre-phase outputs
    outs_post: Any                 # [K, ...] per-tick post-phase outputs
    switched: torch.Tensor         # bool[K]  epoch switch per tick
    wmark: torch.Tensor            # i32[K]   watermark report per tick
    inst_load: Any = None          # i32[K, n_max]
    fault: Any = None              # bool[] bounded-expiry flag, or None


class GraphCaptureError(RuntimeError):
    """A persistent call's ticks could not be captured as a CUDA graph."""


def _driver():
    """The CUDA driver's graph-inspection calls, with their argument and
    result types declared."""
    cu = ctypes.CDLL("libcuda.so.1")
    p, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
            ("cuGraphGetNodes", (p, pp, ctypes.POINTER(ctypes.c_size_t))),
            ("cuGraphNodeGetType", (p, ctypes.POINTER(ctypes.c_int))),
            ("cuGraphKernelNodeGetParams", (p, pp)),
            ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), p)),
            ("cuGraphMemcpyNodeGetParams", (p, ctypes.c_void_p))):
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return cu


def graph_nodes(graph) -> Optional[dict]:
    """A captured graph's nodes by type, its kernels by name and the
    memory copies that touch host memory (the zero-host-transfer
    witness), read through the driver API; None where the driver lacks a
    call."""
    try:
        cu = _driver()
    except (AttributeError, OSError):
        return None
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)):
        return None
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}
    by_type: Dict[str, int] = {}
    by_kernel: Dict[str, int] = {}
    host_copies = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        name = kinds.get(kind.value, f"type{kind.value}")
        by_type[name] = by_type.get(name, 0) + 1
        if name == "kernel":
            params = (ctypes.c_void_p * 16)()   # CUfunction is the first field
            fname = ctypes.c_char_p()
            ok = (cu.cuGraphKernelNodeGetParams(node, params) == 0
                  and cu.cuFuncGetName(ctypes.byref(fname), params[0]) == 0)
            key = fname.value.decode() if ok and fname.value else "?"
            by_kernel[key] = by_kernel.get(key, 0) + 1
        elif name == "memcpy":
            mp = _Memcpy3D()
            if (cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(mp)) == 0
                    and 1 in (mp.srcMemoryType, mp.dstMemoryType)):
                host_copies += 1
    return dict(nodes=len(nodes), by_type=by_type, by_kernel=by_kernel,
                host_copies=host_copies)


class _Memcpy3D(ctypes.Structure):
    """The driver's ``CUDA_MEMCPY3D`` (memory type 1 is host memory)."""
    _fields_ = [(n, t) for side in ("src", "dst") for n, t in (
        (f"{side}XInBytes", ctypes.c_size_t), (f"{side}Y", ctypes.c_size_t),
        (f"{side}Z", ctypes.c_size_t), (f"{side}LOD", ctypes.c_size_t),
        (f"{side}MemoryType", ctypes.c_int), (f"{side}Host", ctypes.c_void_p),
        (f"{side}Device", ctypes.c_void_p), (f"{side}Array", ctypes.c_void_p),
        (f"reserved_{side}", ctypes.c_void_p),
        (f"{side}Pitch", ctypes.c_size_t), (f"{side}Height", ctypes.c_size_t))
    ] + [("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
         ("Depth", ctypes.c_size_t)]


@dataclasses.dataclass
class _Graph:
    """One captured persistent call: its static inputs (``state`` =
    (sg, epoch, sigma), which the graph overwrites with the state after the
    K ticks, and ``operands`` = (stack, ctrl, rc tick, fmu_new,
    active_new)), its stacked outputs, and what its capture recorded."""
    graph: Any
    state: tuple
    operands: tuple
    outs: tuple
    launches: Dict[str, int]       # kernel launches of one replay, by name
    capture_s: float
    instantiate_s: float
    nodes: Optional[dict]
    replays: int = 0


def _load(dst, src) -> None:
    """Copy the tree ``src`` into the static tree ``dst`` (leaves that are
    already the static buffers are skipped; host leaves go through pinned
    memory, asynchronously)."""
    for d, s_ in zip(tree_leaves(dst), tree_leaves(src)):
        if s_ is d:
            continue
        if s_.device.type == "cpu":
            s_ = s_.pin_memory()
        d.copy_(s_, non_blocking=True)


def _to_np(tree):
    """Host copy of a state tree as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_np(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return np.asarray(tree)


def _from_np(template, d, device):
    """Fill ``template``'s structure from ``d``: nested dicts, or any object
    exposing the same field names (e.g. a reference snapshot whose leaves
    were converted to numpy).  Leaves take the template's dtype."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _from_np(getattr(template, f.name), _field(d, f.name),
                             device)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _from_np(v, _field(d, k), device)
                for k, v in template.items()}
    return torch.tensor(np.asarray(d), dtype=template.dtype, device=device)


def _field(d, name):
    return d[name] if isinstance(d, dict) else getattr(d, name)


def _initial_epoch(k_virt: int, n_active: int, n_max: int,
                   device) -> elastic.EpochState:
    """Keys round-robin over the first ``n_active`` of ``n_max`` instances."""
    fmu = torch.as_tensor(np.arange(k_virt) % n_active, dtype=torch.int32,
                          device=device)
    active = torch.as_tensor(np.arange(n_max) < n_active, device=device)
    return elastic.init_epoch(fmu, active)


def _with_ctrl(pipe, staged: T.TupleBatch, reconfig, frontier):
    """The tick as pushed, and the tables it carries: ``staged`` plus
    ``n_inputs`` control lanes stamped with each source's last forwarded
    tau (a reconfiguration), or all-invalid pad lanes (none)."""
    n, kmax, p = pipe.op.n_inputs, staged.kmax, staged.payload_width
    if reconfig is None:
        return (T.concat(staged, T.empty_batch(n, kmax, p, pipe.device)),
                pipe.epoch.fmu, pipe.epoch.active)
    if frontier is None:
        frontier = pipe.sg.wmark.frontier.cpu().numpy()
    ctrl = ctrl_lanes(n, frontier, reconfig.epoch, kmax, p, pipe.device)
    return (T.concat(staged, ctrl),
            torch.as_tensor(reconfig.fmu, dtype=torch.int32,
                            device=pipe.device),
            torch.as_tensor(reconfig.active, dtype=torch.bool,
                            device=pipe.device))


@dataclasses.dataclass
class VSNPipeline:
    op: OperatorDef
    n_max: int
    n_active: int
    stash_cap: int = 256
    tick_fn: Callable = None        # (op, state, ready, resp, explicit_w)
    merge_fn: Callable = None       # (stacked state, fmu) -> state
    init_sigma: Callable = None     # device -> state
    device: Any = None
    # step_staged returns a device-computed per-instance load vector (the
    # async runtime then skips its host-side key-histogram fallback)
    device_inst_load = True

    def __post_init__(self):
        self.device = _device.resolve(self.device)
        self.op = self.op.resolved()
        self.epoch = _initial_epoch(self.op.k_virt, self.n_active, self.n_max,
                                    self.device)
        self.sigma = (self.init_sigma or self.op.init_state)(self.device)
        self.sg = None                  # shaped by the first tick
        self._tick = self.tick_fn or general_tick
        self._merge = self.merge_fn or vsn.merge_states
        # VSN moves no sigma bytes at a switch (Theorem 3): there is no
        # transfer path, so this stays 0; SNPipeline counts its transfers.
        self.bytes_transferred = 0
        self._graphs: Dict[tuple, _Graph] = {}   # (K, lanes, kmax, p) ->
        self._stage_stream = None
        # the last call's bounded-expiry flag (device bool), None where its
        # tick function cannot raise one
        self.fault = None

    def _ensure_gate(self, kmax: int, payload_width: int):
        if self.sg is None:
            self.sg = scalegate.init_scalegate(
                self.op.n_inputs, self.stash_cap, kmax, payload_width,
                device=self.device)

    def ensure_gate_for(self, kmax: int, payload_width: int):
        """Shape the gate from dimensions alone (no data tick yet)."""
        self._ensure_gate(kmax, payload_width)

    # -- state snapshots ----------------------------------------------------
    def export_state(self) -> dict:
        """The pipeline's mutable state at a tick boundary (ScaleGate stash
        + watermark, EpochState with any pending switch, sigma)."""
        if self.sg is None:
            raise RuntimeError("export_state() before the first tick")
        return {"sg": self.sg, "epoch": self.epoch, "sigma": self.sigma}

    def import_state(self, state: dict):
        self.sg, self.epoch, self.sigma = (state["sg"], state["epoch"],
                                           state["sigma"])

    def export_state_np(self) -> dict:
        """``export_state`` as nested dicts of numpy arrays."""
        return _to_np(self.export_state())

    def import_state_np(self, state) -> None:
        """Install a host snapshot: ``export_state_np``'s dicts, or the
        reference ``VSNPipeline.export_state()`` tree with numpy leaves
        (fields are matched by name).  The sigma layout must match this
        pipeline's ``init_sigma``."""
        stash = _field(_field(state, "sg"), "stash")
        self._ensure_gate(np.asarray(_field(stash, "keys")).shape[1],
                          np.asarray(_field(stash, "payload")).shape[1])
        if np.asarray(_field(stash, "tau")).shape[0] != self.stash_cap:
            raise ValueError("snapshot stash capacity differs from stash_cap")
        cur = self.export_state()
        self.import_state({k: _from_np(cur[k], _field(state, k), self.device)
                           for k in cur})

    # -- the step -----------------------------------------------------------
    def _inst_load(self, ready: T.TupleBatch, epoch) -> torch.Tensor:
        """Per-instance load of one tick under the in-effect f_mu: one unit
        per (valid data lane, key-set entry) routed to its owner (§8.4)."""
        data = ready.valid & ~ready.is_control
        kmask = data[:, None] & (ready.keys != T.NO_KEY)
        owners = epoch.fmu[ready.keys.clamp(0, epoch.fmu.shape[0] - 1).long()]
        return torch.zeros((self.n_max,), dtype=torch.int32,
                           device=self.device).index_add(
            0, owners.reshape(-1).long(), kmask.reshape(-1).to(torch.int32))

    def _tick_with_epoch(self, sigma, ready, epoch):
        return vsn.run_tick(self.op, sigma, ready, epoch.fmu, epoch.active,
                            self._tick, self._merge)

    def stage(self, incoming: T.TupleBatch) -> T.TupleBatch:
        """Place a tick on the pipeline's device (asynchronous copy)."""
        self._ensure_gate(incoming.kmax, incoming.payload_width)
        return incoming.to(self.device, non_blocking=True)

    def step_staged(self, staged: T.TupleBatch,
                    reconfig: Optional[Reconfiguration] = None,
                    frontier=None):
        """``step`` on a staged batch; returns ``(outs_pre, outs_post,
        switched, inst_load)``.  ``frontier`` (host i32[n_inputs]: last
        forwarded tau per source) stamps control tuples without reading the
        gate's frontier back from the device."""
        incoming, fmu_new, active_new = _with_ctrl(
            self, self.stage(staged), reconfig, frontier)
        with expiry_faults() as flags:
            (self.sg, self.epoch, self.sigma, outs1, outs2, switched, _wmk,
             inst_load) = vsn.pipeline_tick(self.sg, self.epoch, self.sigma,
                                            incoming, fmu_new, active_new,
                                            self._tick_with_epoch,
                                            self._inst_load)
        self.fault = any_fault(flags)
        return outs1, outs2, switched, inst_load

    def step(self, incoming: T.TupleBatch,
             reconfig: Optional[Reconfiguration] = None):
        """Push one tick; returns (outputs_pre, outputs_post, switched)."""
        outs1, outs2, switched, _ = self.step_staged(incoming, reconfig)
        raise_on_fault(self.fault)
        return outs1, outs2, switched

    def switch_bytes(self) -> int:
        """Bytes a reconfiguration moves: the tables only."""
        return elastic.vsn_switch_bytes(self.epoch)

    # -- persistent K-tick driver -------------------------------------------
    def _frontier_after(self, batches, frontier0=None) -> np.ndarray:
        """Per-source last forwarded tau once ``batches`` have been pushed
        (the Alg. 5 stamp of a control tuple injected after them);
        ``frontier0`` avoids reading the gate's frontier from the device."""
        frontier = (np.asarray(frontier0).copy() if frontier0 is not None
                    else self.sg.wmark.frontier.cpu().numpy().copy())
        for b in batches:
            fold_frontier(frontier, b, self.op.n_inputs)
        return frontier

    def stage_super(self, batches) -> T.TupleBatch:
        """Stack K same-shape ticks, each followed by its all-invalid ctrl
        pad lanes, into one ``[K, B + n_inputs]`` super-batch on the
        pipeline's device.  Host ticks bound for the card are stacked in
        pinned memory and copied once per field on a side stream; the
        current stream waits for the copies on an event (the host does
        not), and the result is recorded on it."""
        batches = list(batches)
        if not batches:
            raise ValueError("empty super-batch")
        b0 = batches[0]
        kmax, p, n = b0.kmax, b0.payload_width, self.op.n_inputs
        self._ensure_gate(kmax, p)
        pad = T.empty_batch(n, kmax, p, "cpu")
        if self.device.type != "cuda" or any(b.device.type == "cuda"
                                             for b in batches):
            pad = pad.to(self.device)
            batches = [b.to(self.device) for b in batches]
            return T.TupleBatch(**{f: torch.stack([
                torch.cat([getattr(b, f), getattr(pad, f)])
                for b in batches]) for f in T.FIELDS})
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        k, width = len(batches), b0.batch + n
        host = {}
        for f in T.FIELDS:
            a0 = getattr(b0, f)
            h = torch.empty((k, width) + tuple(a0.shape[1:]), dtype=a0.dtype,
                            pin_memory=True)
            h[:, :b0.batch] = torch.stack([getattr(b, f) for b in batches])
            h[:, b0.batch:] = getattr(pad, f)
            host[f] = h
        with torch.cuda.stream(self._stage_stream):
            staged = {f: h.to(self.device, non_blocking=True)
                      for f, h in host.items()}
            done = torch.cuda.Event()
            done.record(self._stage_stream)
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in staged.values():
            t.record_stream(cur)
        return T.TupleBatch(**staged)

    def run_persistent_staged(self, stack: T.TupleBatch,
                              reconfig: Optional[Reconfiguration] = None,
                              reconfig_at: int = 0,
                              frontier=None) -> PersistentOut:
        """K ticks over a staged super-batch in one call.  A
        reconfiguration's control tuples go into the ctrl pad lanes of
        tick ``reconfig_at``; ``frontier`` must then be the per-source last
        forwarded tau after the ticks before it (see ``run_persistent``).
        After the call the pipeline's state is the state after tick K."""
        k, width = stack.tau.shape
        kmax, p, n = stack.keys.shape[-1], stack.payload.shape[-1], \
            self.op.n_inputs
        self._ensure_gate(kmax, p)
        if reconfig is not None:
            if frontier is None:
                frontier = self.sg.wmark.frontier.cpu().numpy()
            ctrl = ctrl_lanes(n, frontier, reconfig.epoch, kmax, p, "cpu")
            rc = max(reconfig_at, 0)
            fmu_new = torch.as_tensor(np.asarray(reconfig.fmu),
                                      dtype=torch.int32)
            active_new = torch.as_tensor(np.asarray(reconfig.active),
                                         dtype=torch.bool)
        else:
            ctrl, rc = T.empty_batch(n, kmax, p, "cpu"), 0
            fmu_new, active_new = self.epoch.fmu, self.epoch.active
        operands = (stack, ctrl, torch.tensor([rc], dtype=torch.int64),
                    fmu_new, active_new)
        if self.device.type == "cuda":
            res = self._replay((k, width, kmax, p), operands)
        else:
            res = self._persistent_ticks(
                self.sg, self.epoch, self.sigma,
                *(tree_map(lambda a: a.to(self.device), x) for x in operands))
        (self.sg, self.epoch, self.sigma, o1, o2, sw, wmk, il,
         self.fault) = res
        return PersistentOut(outs_pre=o1, outs_post=o2, switched=sw,
                             wmark=wmk, inst_load=il, fault=self.fault)

    def run_persistent(self, batches,
                       reconfig: Optional[Reconfiguration] = None,
                       reconfig_at: int = 0, frontier0=None) -> PersistentOut:
        """``stage_super`` + ``run_persistent_staged``: tick for tick the
        same as K sequential ``step_staged`` calls, a reconfiguration at
        tick ``reconfig_at`` included."""
        batches = list(batches)
        if not batches:
            raise ValueError("empty super-batch")
        self._ensure_gate(batches[0].kmax, batches[0].payload_width)
        frontier = None
        if reconfig is not None:
            frontier = self._frontier_after(batches[:max(reconfig_at, 0)],
                                            frontier0)
        out = self.run_persistent_staged(self.stage_super(batches),
                                         reconfig=reconfig,
                                         reconfig_at=reconfig_at,
                                         frontier=frontier)
        raise_on_fault(out.fault)
        return out

    def persistent_graphs(self) -> Dict[tuple, dict]:
        """For each captured super-batch shape: the kernel launches of one
        replay by kernel (the wrappers' tally at capture), the graph's
        nodes by type and kernel name and its memory copies touching host
        memory (``graph_nodes``; a capture admits no host sync), the
        capture and instantiate seconds and the replays so far."""
        return {key: dict(launches=dict(g.launches), nodes=g.nodes,
                          capture_s=g.capture_s,
                          instantiate_s=g.instantiate_s, replays=g.replays)
                for key, g in self._graphs.items()}

    def _persistent_ticks(self, sg, epoch, sigma, stack, ctrl, rc, fmu_new,
                          active_new):
        """The K ticks (the scan body), with the outputs stacked and the
        ticks' bounded-expiry flag last."""
        stack = inject_ctrl(stack, ctrl, rc, self.op.n_inputs)
        ticks = []
        with expiry_faults() as flags:
            for i in range(stack.tau.shape[0]):
                (sg, epoch, sigma, *out) = vsn.pipeline_tick(
                    sg, epoch, sigma, tree_map(lambda a: a[i], stack),
                    fmu_new, active_new, self._tick_with_epoch,
                    self._inst_load)
                ticks.append(out)
        return ((sg, epoch, sigma) + tuple(vsn.stack(x) for x in zip(*ticks))
                + (any_fault(flags),))

    def _replay(self, key, operands):
        """The card's persistent call: replay the shape's graph, or, on the
        shape's first call, run the ticks on a side stream and capture
        them."""
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, operands)
        _load(g.state, (self.sg, self.epoch, self.sigma))
        _load(g.operands, operands)
        g.graph.replay()
        dispatch.add_launches(g.launches)
        g.replays += 1
        return g.state + tuple(tree_map(_clone, o) for o in g.outs)

    def _capture(self, key, operands):
        dev = self.device
        state = (self.sg, self.epoch, self.sigma)
        static = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                                device=dev), (state, operands))
        _load(static, (state, operands))
        args = static[0] + static[1]
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._persistent_ticks(*args)
        cur.wait_stream(side)
        for t in tree_leaves(first):
            if t is not None:
                t.record_stream(cur)

        # kept after capture, so that its nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        try:
            with dispatch.recording() as tally, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                out = self._persistent_ticks(*args)
                _copy_state(static[0], out[:3])
        except RuntimeError as e:
            # the failed call's error, where ending the capture raised anew
            cause = e.__context__ if e.__context__ is not None else e
            raise GraphCaptureError(
                f"the tick function cannot be captured as a CUDA graph "
                f"({type(cause).__name__}: {cause}); the persistent driver "
                f"needs a tick function that reads nothing back to the "
                f"host (no .item(), bool() or nonzero on a device value), "
                f"as the fast paths and the general O+ tick are") from e
        capture_s = time.perf_counter() - t0
        nodes = graph_nodes(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        instantiate_s = time.perf_counter() - t0
        self._graphs[key] = _Graph(
            graph=graph, state=static[0], operands=static[1],
            outs=tuple(out[3:]), launches=tally, capture_s=capture_s,
            instantiate_s=instantiate_s, nodes=nodes)
        return first


def _clone(a):
    return None if a is None else a.clone()


def _copy_state(dst, src) -> None:
    """Inside a capture: write the state after the K ticks into the static
    state buffers, the next replay's input (a leaf the ticks passed through
    unchanged is already there)."""
    pairs = [(d, s_) for d, s_ in zip(tree_leaves(dst), tree_leaves(src))
             if d is not s_]
    dsts = {id(d) for d, _ in pairs}
    # a source that is another position's static buffer is read first
    pairs = [(d, s_.clone() if id(s_) in dsts else s_) for d, s_ in pairs]
    for d, s_ in pairs:
        d.copy_(s_)


@dataclasses.dataclass
class SNPipeline:
    """The shared-nothing baseline: dedicated sigma_j, duplication at
    forward, state transfer at reconfiguration."""
    op: OperatorDef
    n_max: int
    n_active: int
    stash_cap: int = 256
    tick_fn: Callable = None        # (op, state, ready, resp, explicit_w)
    init_sigma: Callable = None     # device -> one instance's state
    device: Any = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)
        self.op = self.op.resolved()
        self.epoch = _initial_epoch(self.op.k_virt, self.n_active, self.n_max,
                                    self.device)
        one = (self.init_sigma or self.op.init_state)(self.device)
        self.sigmas = sn.init_states(one, self.n_max)
        self._tick = self.tick_fn or general_tick
        self.sg = None
        self.bytes_transferred = 0
        self.duplication = []

    def step(self, incoming: T.TupleBatch,
             reconfig: Optional[Reconfiguration] = None):
        incoming = incoming.to(self.device)
        if self.sg is None:
            self.sg = scalegate.init_scalegate(
                self.op.n_inputs, self.stash_cap, incoming.kmax,
                incoming.payload_width, device=self.device)
        incoming, fmu_new, active_new = _with_ctrl(self, incoming, reconfig,
                                                   None)

        self.sg, ready = scalegate.push(self.sg, incoming)
        epoch = elastic.prepare_reconfig(self.epoch, ready, fmu_new,
                                         active_new)
        pre, post = elastic.split_epoch_masks(epoch, ready)
        self.duplication.append(float(sn.duplication_factor(
            dataclasses.replace(ready, valid=pre), epoch.fmu, epoch.active)))
        ready_pre = dataclasses.replace(
            ready, valid=pre | (ready.is_control & ready.valid))
        with expiry_faults() as flags:
            sigmas, outs1 = sn.run_tick(self.op, self.sigmas, ready_pre,
                                        epoch.fmu, epoch.active, self._tick)

            live = ready.valid & ~ready.is_control
            w_end = torch.where(live, ready.tau, 0).max()
            fmu_old = epoch.fmu
            epoch, switched = elastic.advance_epoch(epoch, w_end)
            if bool(switched):      # SN pays the state transfer (§2.5)
                sigmas, moved = elastic.sn_transfer(sigmas, fmu_old,
                                                    epoch.fmu)
                self.bytes_transferred += moved

            ready_post = dataclasses.replace(ready, valid=post)
            self.sigmas, outs2 = sn.run_tick(self.op, sigmas, ready_post,
                                             epoch.fmu, epoch.active,
                                             self._tick)
        raise_on_fault(any_fault(flags))
        self.epoch = epoch
        return outs1, outs2, switched
