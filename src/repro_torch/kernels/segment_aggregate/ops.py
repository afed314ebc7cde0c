"""Entry point of the segment_aggregate kernel: plain version on the CPU,
the CUDA kernel (``csrc/segment_aggregate.cu``) on the card.

Held against ``src/repro/kernels/segment_aggregate/ops.py``.  Both
realizations update ``acc`` in place and return it; a caller that shares
``acc`` with another reader passes its own copy (``core/aggregate.py``
clones it per instance).  The reference's ``tile_k`` is a Pallas tiling
knob with no counterpart here.

Tolerance between the two realizations: exact for integer-valued ``vals``
(counts) below 2^24; otherwise the atomics reorder the adds, and the sums
agree to ``rtol=1e-6`` for a few contributions per cell.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref


def _cuda(keys, slots, vals, acc):
    n, w = vals.shape
    k, s, w2 = acc.shape
    dev = acc.device
    dispatch.check("keys", keys, torch.int32, (n,), dev)
    dispatch.check("slots", slots, torch.int32, (n,), dev)
    dispatch.check("vals", vals, torch.float32, (n, w), dev)
    dispatch.check("acc", acc, torch.float32, (k, s, w), dev)
    if n * w >= 2 ** 31 or k * s * w >= 2 ** 31:
        raise ValueError("segment_aggregate indexes with 32-bit counts")
    with torch.cuda.device(dev):
        rc = build.library().repro_segment_aggregate(
            keys.data_ptr(), slots.data_ptr(), vals.data_ptr(),
            acc.data_ptr(), n, w, k, s,
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("segment_aggregate", rc)
    return acc


segment_aggregate_op = dispatch.register(dispatch.Kernel(
    name="segment_aggregate",
    plain=segment_aggregate_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/segment_aggregate/segment_aggregate.py:83",
    source="src/repro_torch/kernels/csrc/segment_aggregate.cu",
))
