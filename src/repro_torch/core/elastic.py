"""Elastic reconfiguration — epochs, control tuples, the watermark barrier
(paper §5, §7, Alg. 4 L13-21, Alg. 5-6).

Held against ``src/repro/core/elastic.py``.  A reconfiguration is a new
epoch with instance set ``O*`` and mapping ``f_mu*``, delivered by a
control tuple stamped with the last forwarded event time per source; the
switch fires when the watermark first exceeds ``gamma = t_ctrl.tau``.

State-transfer accounting: a VSN switch swaps the tables only
(``vsn_switch_bytes``); the SN baseline ships every sigma row whose owner
changed (``sn_transfer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import tuples as T
from repro_torch.core import watermark as wm
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class EpochState:
    """Cond. 2 variables {e, e*, O, O*, f_mu*, gamma} (§5)."""
    e: torch.Tensor            # i32[] current epoch id
    fmu: torch.Tensor          # i32[K] current key -> instance map
    active: torch.Tensor       # bool[n_max] current instance set O
    e_next: torch.Tensor       # i32[] pending epoch id (== e when none)
    fmu_next: torch.Tensor     # i32[K]
    active_next: torch.Tensor  # bool[n_max]
    gamma: torch.Tensor        # i32[] trigger event time (INF when none)
    reconfigs: torch.Tensor    # i32[] completed reconfigurations


def init_epoch(fmu: torch.Tensor, active: torch.Tensor) -> EpochState:
    zero = torch.zeros((), dtype=torch.int32, device=fmu.device)
    return EpochState(
        e=zero, fmu=fmu, active=active, e_next=zero, fmu_next=fmu,
        active_next=active,
        gamma=torch.full((), wm.INF_TIME, dtype=torch.int32,
                         device=fmu.device),
        reconfigs=zero)


def make_control_tuple(last_tau: int, epoch_id: int, kmax: int,
                       payload_width: int, device=None) -> T.TupleBatch:
    """addSTRETCH (Alg. 5): a control tuple carrying the reconfiguration
    id, stamped with the last forwarded tau so per-source order holds."""
    b = T.empty_batch(1, kmax, payload_width, device)
    dev = b.device
    return dataclasses.replace(
        b,
        tau=torch.tensor([last_tau], dtype=torch.int32, device=dev),
        valid=torch.ones((1,), dtype=torch.bool, device=dev),
        is_control=torch.ones((1,), dtype=torch.bool, device=dev),
        ctrl_epoch=torch.tensor([epoch_id], dtype=torch.int32, device=dev))


def prepare_reconfig(st: EpochState, batch: T.TupleBatch,
                     fmu_new: torch.Tensor,
                     active_new: torch.Tensor) -> EpochState:
    """prepareReconfig (Alg. 6): adopt the latest control tuple whose epoch
    id exceeds the operator's (Theorem 4: latest wins, same for all)."""
    is_ctrl = batch.is_control & batch.valid
    newest = torch.where(is_ctrl, batch.ctrl_epoch, -1).max()
    gamma_c = torch.where(is_ctrl & (batch.ctrl_epoch == newest),
                          batch.tau, -1).max()
    take = newest > st.e
    return dataclasses.replace(
        st,
        e_next=torch.where(take, newest, st.e_next),
        fmu_next=torch.where(take, fmu_new, st.fmu_next),
        active_next=torch.where(take, active_new, st.active_next),
        gamma=torch.where(take, gamma_c, st.gamma))


def split_epoch_masks(st: EpochState, batch: T.TupleBatch):
    """Partition a tick at gamma (Alg. 4 L17): lanes with tau <= gamma run
    under f_mu, later lanes under f_mu*."""
    data = batch.valid & ~batch.is_control
    return data & (batch.tau <= st.gamma), data & (batch.tau > st.gamma)


def advance_epoch(st: EpochState, w_end) -> Tuple[EpochState, torch.Tensor]:
    """Commit the pending epoch once the watermark has passed gamma.
    Returns (state, switched)."""
    switch = (st.e_next > st.e) & (w_end > st.gamma)
    new = EpochState(
        e=torch.where(switch, st.e_next, st.e),
        fmu=torch.where(switch, st.fmu_next, st.fmu),
        active=torch.where(switch, st.active_next, st.active),
        e_next=st.e_next,
        fmu_next=st.fmu_next,
        active_next=st.active_next,
        gamma=torch.where(switch, wm.INF_TIME, st.gamma),
        reconfigs=st.reconfigs + switch.to(torch.int32),
    )
    return new, switch


def vsn_switch_bytes(st: EpochState) -> int:
    """Bytes touched by a VSN reconfiguration: the tables only."""
    return int(st.fmu.numel() * 4 + st.active.numel() + 12)


def sn_transfer(states_j: Any, fmu_old: torch.Tensor, fmu_new: torch.Tensor):
    """The SN baseline's state transfer: ship every key row whose owner
    changed from its old instance to its new one.  ``states_j`` leaves are
    ``[n_inst, K, ...]`` (other leaves stay put).  Returns (new states,
    bytes moved)."""
    moved = fmu_old != fmu_new
    k_virt = fmu_old.shape[0]
    k_ids = torch.arange(k_virt, device=fmu_old.device)

    def keyed(leaf) -> bool:
        return leaf.ndim >= 2 and leaf.shape[1] == k_virt

    def reship(leaf):
        if not keyed(leaf):
            return leaf
        from_old = leaf[fmu_old.long(), k_ids]                 # [K, ...]
        inst = torch.arange(leaf.shape[0], device=leaf.device)
        take = (fmu_new[None, :] == inst[:, None]) & moved[None, :]
        take = take.reshape(take.shape + (1,) * (leaf.ndim - 2))
        return torch.where(take, from_old[None], leaf)

    row_bytes = sum(l.element_size() * l.numel() // (l.shape[0] * l.shape[1])
                    for l in tree_leaves(states_j) if keyed(l))
    moved_rows = int(moved.sum())
    return tree_map(reship, states_j), moved_rows * row_bytes
