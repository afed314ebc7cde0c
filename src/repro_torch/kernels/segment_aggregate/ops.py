"""Entry point of the segment_aggregate kernel: plain version on the CPU,
the CUDA kernel (``csrc/segment_aggregate.cu``) on the card.

Held against ``src/repro/kernels/segment_aggregate/ops.py``.  Contract, as
the reference's: ``segment_aggregate_op(keys, slots, vals, acc)`` returns a
new accumulator ``acc + contributions`` and leaves ``acc`` untouched, so
every VSN instance can start from the same shared state.  Hits with a key
outside ``[0, K)`` (``-1`` included) or a slot outside ``[0, S)`` add
nothing.  The reference's ``tile_k`` is a Pallas tiling knob with no
counterpart here.

On the card, ``plan`` picks the body: one launch of one thread-block
cluster of ``MAX_CLUSTER`` blocks, which copies ``acc`` to the output and
then adds the hits, while ``ceil(K / MAX_CLUSTER) * S * W`` cells fit a
block's ``BLOCK_CELLS``; else a device copy and a global-atomic kernel.

Tolerance between the two realizations: exact for integer-valued ``vals``
(counts) below 2^24; otherwise atomics and the warp's combining reorder
the adds, and the sums agree to ``rtol=1e-6`` for a few contributions
per cell.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref

MAX_CLUSTER = 16          # blocks of the cluster body (csrc kMaxCluster)
BLOCK_CELLS = 16384       # accumulator cells a block copies (kBlockCells)


def plan(k: int, s: int, w: int, cluster: Optional[int] = None) -> int:
    """The cluster size for an accumulator ``[k, s, w]``: ``MAX_CLUSTER``
    while a block's key rows (the cells it copies) fit ``BLOCK_CELLS``,
    else 0 (the global body).  ``cluster`` forces a size (the card's
    sweep over it)."""
    fits = lambda c: -(-k // c) * s * w <= BLOCK_CELLS
    if cluster is None:
        return MAX_CLUSTER if fits(MAX_CLUSTER) else 0
    if not (cluster == 0 or 1 <= cluster <= MAX_CLUSTER and fits(cluster)):
        raise ValueError(f"acc [{k}, {s}, {w}] does not fit a cluster of "
                         f"{cluster}")
    return cluster


def _cuda(keys, slots, vals, acc, *, cluster: Optional[int] = None):
    n, w = vals.shape
    k, s, w2 = acc.shape
    dev = acc.device
    dispatch.check("keys", keys, torch.int32, (n,), dev)
    dispatch.check("slots", slots, torch.int32, (n,), dev)
    dispatch.check("vals", vals, torch.float32, (n, w), dev)
    dispatch.check("acc", acc, torch.float32, (k, s, w), dev)
    if n * w >= 2 ** 31 or k * s * w >= 2 ** 31:
        raise ValueError("segment_aggregate indexes with 32-bit counts")
    out = torch.empty_like(acc)
    build.launch("segment_aggregate", dev, keys.data_ptr(), slots.data_ptr(),
                 vals.data_ptr(), acc.data_ptr(), out.data_ptr(), n, w, k, s,
                 plan(k, s, w, cluster))
    return out


segment_aggregate_op = dispatch.register(dispatch.Kernel(
    name="segment_aggregate",
    plain=segment_aggregate_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/segment_aggregate/segment_aggregate.py:83",
    source="src/repro_torch/kernels/csrc/segment_aggregate.cu",
))
