"""Source partitioner: the sources→leaves map of the hierarchical ScaleGate.

Held against ``src/repro/ingest/partitioner.py`` (the same class, numpy
only).

Each ingest leaf owns a *disjoint* subset of the physical sources (the
shared-nothing property of the tier: no source is merged by two leaves, so
no coordination below the root).  The partitioner is pure host-side
bookkeeping:

* ``assignment[src] -> leaf_id`` — the current map;
* ``rebalance(add=…, remove=…)`` — recompute membership with **minimal
  movement**: only as many sources move as the balance targets require, and
  a removed leaf's sources are spread over the survivors.  Every move is
  returned as ``src -> (old_leaf, new_leaf)`` so the tier can drive the ESG
  ``removeSources``/``addSources`` handshake (old leaf flushes, new leaf
  starts the source at its Lemma-3 safe bound) — membership changes move
  *metadata only*, never stashed tuples.

Determinism: iteration over sources and leaves is by ascending id, so the
same command sequence always yields the same assignment (tests and the
single-gate parity oracle rely on this).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class SourcePartitioner:
    def __init__(self, n_sources: int, leaf_ids: Iterable[int]):
        leaf_ids = sorted(leaf_ids)
        assert leaf_ids, "at least one leaf"
        self.n_sources = n_sources
        self._leaves: List[int] = list(leaf_ids)
        # initial contiguous balanced split over the leaves, ascending
        self.assignment = np.empty((n_sources,), np.int64)
        for i, src_ids in enumerate(np.array_split(np.arange(n_sources),
                                                   len(leaf_ids))):
            self.assignment[src_ids] = leaf_ids[i]

    # -- views ---------------------------------------------------------------
    @property
    def leaves(self) -> Tuple[int, ...]:
        return tuple(self._leaves)

    def leaf_of(self, src: int) -> int:
        return int(self.assignment[src])

    def sources_of(self, leaf: int) -> np.ndarray:
        return np.nonzero(self.assignment == leaf)[0]

    def owned_mask(self, leaf: int) -> np.ndarray:
        return self.assignment == leaf

    def counts(self) -> Dict[int, int]:
        return {l: int((self.assignment == l).sum()) for l in self._leaves}

    # -- rebalance -----------------------------------------------------------
    def rebalance(self, add: Optional[Iterable[int]] = None,
                  remove: Optional[Iterable[int]] = None
                  ) -> Dict[int, Tuple[int, int]]:
        """Apply a membership change; returns ``{src: (old, new)}`` moves.

        Balance target: every surviving leaf ends within one source of
        ``n_sources / n_leaves``.  Moves are chosen deterministically
        (largest donors first, sources by ascending id) and minimally (a
        source moves only if its leaf is above target and another is
        below).
        """
        add = sorted(set(add or ()))
        remove = sorted(set(remove or ()))
        for a in add:
            assert a not in self._leaves, f"leaf {a} already active"
        for r in remove:
            assert r in self._leaves, f"leaf {r} not active"
        new_leaves = sorted((set(self._leaves) | set(add)) - set(remove))
        assert new_leaves, "cannot remove the last leaf"

        moves: Dict[int, Tuple[int, int]] = {}
        counts = {l: 0 for l in new_leaves}
        for src in range(self.n_sources):
            l = int(self.assignment[src])
            if l in counts:
                counts[l] += 1

        # 1. orphaned sources (their leaf is leaving) must move;
        # 2. then shave overfull leaves down to the ceil target.
        base, extra = divmod(self.n_sources, len(new_leaves))
        target = {l: base + (1 if i < extra else 0)
                  for i, l in enumerate(new_leaves)}

        def receiver() -> int:
            # most-underfull surviving leaf; ties to the smallest id
            return min(new_leaves, key=lambda l: (counts[l] - target[l], l))

        for src in range(self.n_sources):
            old = int(self.assignment[src])
            if old not in counts:                      # orphaned
                new = receiver()
                moves[src] = (old, new)
                self.assignment[src] = new
                counts[new] += 1
        donors = sorted(new_leaves, key=lambda l: -(counts[l] - target[l]))
        for d in donors:
            while counts[d] > target[d]:
                new = receiver()
                if counts[new] - target[new] >= 0:
                    break                              # already balanced
                src = int(self.sources_of(d)[0])       # smallest id moves
                moves[src] = (d, new)
                self.assignment[src] = new
                counts[d] -= 1
                counts[new] += 1
        self._leaves = new_leaves
        return moves
