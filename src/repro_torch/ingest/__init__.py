"""Hierarchical multi-host ScaleGate: the distributed ingest tier (§6).

Held against ``src/repro/ingest``.  Many ingest hosts (leaf ScaleGates,
each merging a disjoint source subset) feed the pipeline through a root
merge that is ``scalegate.push`` one level up: Definition 3 composes
(``W = min_leaf W_leaf = min_i frontier_i``) and the ready stream stays
totally ordered end to end.  ``IngestTier`` is the runtime: elastic
membership (``add_host``/``remove_host`` with the ESG
``addSources``/``removeSources`` semantics, zero state transfer),
bounded-channel backpressure root→leaf→source, and a drop-in iterable
source for ``AsyncStreamRuntime``.
"""

from repro_torch.ingest.leaf import LeafGate, LeafOut
from repro_torch.ingest.partitioner import SourcePartitioner
from repro_torch.ingest.root import RootMerge
from repro_torch.ingest.tier import (IngestStats, IngestTier, LeafFailure,
                                     collect_tuples, emitted_taus,
                                     single_gate_stream)

__all__ = [
    "IngestStats", "IngestTier", "LeafFailure", "LeafGate", "LeafOut",
    "RootMerge", "SourcePartitioner", "collect_tuples", "emitted_taus",
    "single_gate_stream",
]
