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
CUDA device; ``"cpu"`` only when asked).  The reference's persistent K-tick
scan (``run_persistent``) and ``MeshPipeline`` come with later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import elastic, scalegate, sn, vsn
from repro_torch.core import tuples as T
from repro_torch.core.controller import Reconfiguration
from repro_torch.core.operator import OperatorDef, tick as general_tick


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
        (self.sg, self.epoch, self.sigma, outs1, outs2, switched, _wmk,
         inst_load) = vsn.pipeline_tick(self.sg, self.epoch, self.sigma,
                                        incoming, fmu_new, active_new,
                                        self._tick_with_epoch,
                                        self._inst_load)
        return outs1, outs2, switched, inst_load

    def step(self, incoming: T.TupleBatch,
             reconfig: Optional[Reconfiguration] = None):
        """Push one tick; returns (outputs_pre, outputs_post, switched)."""
        outs1, outs2, switched, _ = self.step_staged(incoming, reconfig)
        return outs1, outs2, switched

    def switch_bytes(self) -> int:
        """Bytes a reconfiguration moves: the tables only."""
        return elastic.vsn_switch_bytes(self.epoch)


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
        sigmas, outs1 = sn.run_tick(self.op, self.sigmas, ready_pre, epoch.fmu,
                                    epoch.active, self._tick)

        live = ready.valid & ~ready.is_control
        w_end = torch.where(live, ready.tau, 0).max()
        fmu_old = epoch.fmu
        epoch, switched = elastic.advance_epoch(epoch, w_end)
        if bool(switched):      # SN pays the state transfer (§2.5)
            sigmas, moved = elastic.sn_transfer(sigmas, fmu_old, epoch.fmu)
            self.bytes_transferred += moved

        ready_post = dataclasses.replace(ready, valid=post)
        self.sigmas, outs2 = sn.run_tick(self.op, sigmas, ready_post,
                                         epoch.fmu, epoch.active, self._tick)
        self.epoch = epoch
        return outs1, outs2, switched
