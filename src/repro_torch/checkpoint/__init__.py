"""Fault-tolerance layer: atomic-manifest checkpoints + streaming snapshots.

Held against ``src/repro/checkpoint``.  ``checkpoint`` is the storage
substrate (async saves, atomic manifest commit, shape-checked restore, in
the reference's on-disk format); ``stream`` aligns it with the streaming
runtime (epoch-consistent tick-boundary capture of pipeline + ingest-tier
state, manifest-carried ``RuntimeConfig`` for identical-stack rebuild).
"""

from repro_torch.checkpoint.checkpoint import (Checkpointer, latest_step,
                                               read_manifest, restore,
                                               restore_latest, save, wait)
from repro_torch.checkpoint.stream import StreamCheckpointer

__all__ = [
    "Checkpointer", "StreamCheckpointer", "latest_step", "read_manifest",
    "restore", "restore_latest", "save", "wait",
]
