"""Watermark tracking (paper §2.3, Definitions 2-3).

Held against ``src/repro/core/watermark.py``.  The state is
``frontier[i]`` (latest tau, or latest explicit watermark, per source) plus
the ESG source set; ``W = min`` over active sources of their frontier.
Removed sources stop gating W (§6 flush); added ones start at the Lemma-3
safe bound ``gamma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device

INF_TIME = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class WatermarkState:
    frontier: torch.Tensor   # i32[n_sources]
    active: torch.Tensor     # bool[n_sources]

    @property
    def n_sources(self) -> int:
        return self.frontier.shape[0]

    def value(self) -> torch.Tensor:
        """W = min over *active* sources of their frontier (Definition 3)."""
        return torch.where(self.active, self.frontier, INF_TIME).min()


def init_watermark(n_sources: int, active=None, device=None) -> WatermarkState:
    dev = _device.resolve(device)
    if active is None:
        active = np.ones((n_sources,), bool)
    return WatermarkState(
        frontier=torch.zeros((n_sources,), dtype=torch.int32, device=dev),
        active=torch.tensor(np.asarray(active), dtype=torch.bool,
                               device=dev))


def observe(state: WatermarkState, source: torch.Tensor, tau: torch.Tensor,
            valid: torch.Tensor) -> WatermarkState:
    """Fold a batch of (source, tau) observations into the frontier.

    Frontiers only move forward.  Source ids index as the reference's
    ``frontier.at[source].max(..., mode="drop")`` does: an id in
    ``[-n, -1]`` wraps to ``n + id`` (JAX normalises negative indices
    before the drop), and any other id outside ``[0, n)`` is dropped.
    """
    n = state.n_sources
    idx = torch.where(source < 0, source + n, source)
    ok = (idx >= 0) & (idx < n)
    upd = torch.where(valid, tau, -1)
    upd = torch.where(ok, upd, torch.iinfo(torch.int32).min)
    frontier = state.frontier.scatter_reduce(
        0, torch.where(ok, idx, 0).long(), upd, reduce="amax")
    return dataclasses.replace(state, frontier=frontier)


def observe_explicit(state: WatermarkState, values, mask) -> WatermarkState:
    """Explicit-watermark mode: fold reported per-source watermark values
    (the root merge's per-leaf reports; frontiers stay non-decreasing)."""
    dev = state.frontier.device
    values = torch.as_tensor(values, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    frontier = torch.where(mask, torch.maximum(state.frontier, values),
                           state.frontier)
    return dataclasses.replace(state, frontier=frontier)


def fold_reports(state: WatermarkState, reports, mask):
    """Device-side frontier reduction for the fused root merge: fold the
    leaves' reported watermarks (``observe_explicit``) and reduce to the
    gate value.  Returns ``(state', eff, W)``: ``eff`` is the per-leaf
    effective frontier (INF on inactive leaves, the stacked kernel's
    reports) and ``W = min(eff)``; nothing is read back to the host."""
    st = observe_explicit(state, reports, mask)
    eff = torch.where(st.active, st.frontier, INF_TIME)
    return st, eff, eff.min()


def clamp_frontier(state: WatermarkState, mask, gamma) -> WatermarkState:
    """Rebalance clamp (Lemma 3): a source that gains a sub-stream with safe
    lower bound ``gamma`` below its frontier drops to ``gamma``."""
    gamma = torch.as_tensor(gamma, dtype=torch.int32,
                            device=state.frontier.device)
    frontier = torch.where(mask, torch.minimum(state.frontier, gamma),
                           state.frontier)
    return dataclasses.replace(state, frontier=frontier)


def add_sources(state: WatermarkState, mask, gamma) -> WatermarkState:
    """ESG ``addSources``: new sources start at the Lemma-3 safe bound gamma."""
    gamma = torch.as_tensor(gamma, dtype=torch.int32,
                            device=state.frontier.device)
    frontier = torch.where(mask & ~state.active, gamma, state.frontier)
    return WatermarkState(frontier=frontier, active=state.active | mask)


def remove_sources(state: WatermarkState, mask) -> WatermarkState:
    """ESG ``removeSources``: flush — the leaving source stops gating W."""
    return dataclasses.replace(state, active=state.active & ~mask)


def export_np(state: WatermarkState) -> dict:
    return {"frontier": state.frontier.cpu().numpy(),
            "active": state.active.cpu().numpy()}


def import_np(d: dict, device=None) -> WatermarkState:
    dev = _device.resolve(device)
    return WatermarkState(
        frontier=torch.tensor(np.asarray(d["frontier"]),
                                 dtype=torch.int32, device=dev),
        active=torch.tensor(np.asarray(d["active"]), dtype=torch.bool,
                               device=dev))
