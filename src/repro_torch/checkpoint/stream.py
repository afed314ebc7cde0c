"""StreamCheckpointer: epoch-consistent tick-boundary capture of a runtime.

Held against ``src/repro/checkpoint/stream.py``.  At the tick boundary
*before* tick S is dispatched it captures

* the pipeline state (ScaleGate stash, watermark and epoch tables, sigma)
  through ``pipeline.export_state()``, copied to the host before
  ``maybe_save`` returns: the next dispatch overwrites the state in place
  (a CUDA graph replay writes the state after its K ticks into the same
  buffers, and on the CPU ``tensor.numpy()`` would share the live
  memory), so the capture is a synchronous ``.cpu()`` of each CUDA tensor
  and a clone of each CPU one;
* the ingest-tier cut for that exact boundary, when the source is an
  ``IngestTier``: the tier's barrier "snap" round already pinned every
  leaf gate, the root gate, and the router's frontier/assignment to the
  boundary (``IngestTier.pop_snapshot``), so the checkpoint is consistent
  across ingest hosts, the root and the pipeline by construction.

The checkpoint's meaning: "state after every tick < S; resume the source
at ``source_ticks``".  Exactly-once restore = this state + replaying the
source from that frontier (``io.sources.ReplaySource.from_tick``) +
treating the victim's outputs below S as committed
(``CollectSink.results(before_tick=S)``).

The tree goes through ``Checkpointer.save`` (async write, atomic manifest
commit); the serialized ``RuntimeConfig``, the stream's dimensions and the
tier's routing metadata ride in the manifest's ``extra``, so
``api.resume_runtime`` can rebuild an identical stack before it reads a
single ``.npy``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.checkpoint.checkpoint import Checkpointer, host_copy
from repro_torch.tree import tree_map


def _leaf_key(leaf_id: int) -> str:
    return f"{int(leaf_id):05d}"


def _np(tree):
    """Every tensor of ``tree`` as a numpy array (leaf states may cross a
    spawn-process boundary)."""
    return tree_map(lambda a: a.numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a), tree)


class StreamCheckpointer:
    """Tick-boundary snapshots of ``pipeline`` (+ optional ingest ``tier``)
    into ``checkpointer``, every ``every`` pipeline ticks.

    With a tier, timing is *tier-driven*: the tier must be constructed with
    ``snapshot_every=every`` (``api.build_runtime`` does), and a checkpoint
    lands exactly when the tier produced the matching barrier cut, so with
    ``super_batch=K`` choose ``every`` a multiple of K, or boundary ticks
    land mid-group and the cut is skipped (never captured inconsistently).
    """

    def __init__(self, checkpointer: Checkpointer, every: int, pipeline,
                 tier=None, config=None):
        self.ckpt = checkpointer
        self.every = int(every)
        self.pipeline = pipeline
        self.tier = tier
        self.config = config          # RuntimeConfig (or None)
        self.saved_steps: List[int] = []

    # ----------------------------------------------------------- capture --
    def maybe_save(self, next_tick: int, frontier: np.ndarray,
                   before: Optional[Callable[[], None]] = None
                   ) -> Optional[int]:
        """Called by the runtime at the boundary before dispatching tick
        ``next_tick`` (``frontier`` = host frontier before it).  ``before``
        runs when the boundary is due, ahead of the capture (the runtime
        settles the tick still in flight there).  Returns the step saved,
        or None when this boundary is not due."""
        tier_snap = None
        if self.tier is not None:
            tier_snap = self.tier.pop_snapshot(next_tick)
            if tier_snap is None:
                return None
        elif not (self.every > 0 and next_tick > 0
                  and next_tick % self.every == 0):
            return None
        if before is not None:
            before()
        # host copy NOW: the dispatch right after this call overwrites the
        # pipeline's state
        with _obs.span("checkpoint.capture"):
            pipe_host = tree_map(host_copy, self.pipeline.export_state())
        tree: Dict[str, Any] = {"pipe": pipe_host}
        stash = pipe_host["sg"].stash
        extra: Dict[str, Any] = {
            "step": int(next_tick),
            "kmax": int(stash.keys.shape[-1]),
            "payload_width": int(stash.payload.shape[-1]),
            "frontier": np.asarray(frontier, np.int64).tolist(),
            "source_ticks": int(next_tick),
            "config": (self.config.to_json()
                       if self.config is not None else None),
            "tier": None,
        }
        if tier_snap is not None:
            tree["tier"] = {
                "frontier": np.asarray(tier_snap["frontier"], np.int64),
                "leaves": {_leaf_key(lid): st
                           for lid, st in tier_snap["leaf_states"].items()},
                "root": tier_snap["root"]["sg"],
            }
            extra["source_ticks"] = int(tier_snap["source_ticks"])
            extra["tier"] = {
                "leaves": [int(l) for l in tier_snap["leaves"]],
                "assignment": [int(a) for a in tier_snap["assignment"]],
                "next_leaf_id": int(tier_snap["next_leaf_id"]),
                "source_ticks": int(tier_snap["source_ticks"]),
                "emitted_rounds": int(tier_snap["emitted_rounds"]),
                "tuples_in": int(tier_snap["tuples_in"]),
                "root_meta": tier_snap["root"]["meta"],
            }
        self.ckpt.save(int(next_tick), tree, async_=True, extra=extra)
        self.saved_steps.append(int(next_tick))
        _obs.event("checkpoint", step=int(next_tick),
                   tiered=tier_snap is not None)
        _obs.counter_inc("checkpoint.saves")
        return int(next_tick)

    def wait(self) -> None:
        self.ckpt.wait()


def like_tree(pipeline, extra: dict, *, n_sources: int, leaf_cap: int,
              root_cap: int, max_leaves: int, out_pad: int,
              root_device) -> Dict[str, Any]:
    """A restore template matching what ``maybe_save`` wrote: the rebuilt
    pipeline's own exported state (``ensure_gate_for`` first so the gate
    shapes exist) plus zero-state ScaleGate templates for every tier gate
    recorded in the manifest ``extra``.  ``root_device=None`` resolves as
    the tier's root does: the fused round on the card."""
    from repro_torch.core import scalegate
    from repro_torch.ingest.root import RootMerge

    kmax = int(extra["kmax"])
    pw = int(extra["payload_width"])
    pipeline.ensure_gate_for(kmax, pw)
    like: Dict[str, Any] = {"pipe": pipeline.export_state()}
    tmeta = extra.get("tier")
    if tmeta is not None:
        if root_device is None:
            root_device = pipeline.device.type == "cuda"
        like["tier"] = {
            "frontier": np.zeros((n_sources,), np.int64),
            "leaves": {_leaf_key(lid): scalegate.template_np(
                n_sources, leaf_cap, kmax, pw)
                for lid in tmeta["leaves"]},
            "root": scalegate.template_np(
                max_leaves,
                RootMerge.effective_cap(root_cap, out_pad, root_device),
                kmax, pw),
        }
    return like


def tier_restore_dict(tree: Dict[str, Any], tmeta: dict) -> Dict[str, Any]:
    """Reassemble the ``IngestTier(restore=...)`` payload from a restored
    checkpoint tree + the manifest's tier metadata (all arrays to numpy:
    leaf states may cross a spawn-process boundary)."""
    t = _np(tree["tier"])
    return {
        "leaves": [int(l) for l in tmeta["leaves"]],
        "assignment": [int(a) for a in tmeta["assignment"]],
        "next_leaf_id": int(tmeta["next_leaf_id"]),
        "frontier": np.asarray(t["frontier"], np.int64),
        "source_ticks": int(tmeta["source_ticks"]),
        "emitted_rounds": int(tmeta["emitted_rounds"]),
        "tuples_in": int(tmeta["tuples_in"]),
        "leaf_states": {int(k): v for k, v in t["leaves"].items()},
        "root": {"sg": t["root"], "meta": tmeta["root_meta"]},
    }
