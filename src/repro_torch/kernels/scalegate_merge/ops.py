"""Entry point of the scalegate_merge kernel: plain version on the CPU, the
CUDA kernel (``csrc/scalegate_merge.cu``) on the card.

Held against ``src/repro/kernels/scalegate_merge/ops.py``.  Unlike the
Pallas wrapper, which pads any N to a power of two of at least 128 lanes in
Python, the CUDA launcher pads inside the kernel's shared memory; the
wrapper only validates, allocates the outputs and launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.scalegate_merge.ref import scalegate_merge_ref

MAX_LANES = 16384        # one thread block: 128 KB of 64-bit keys


def _cuda(tau, src, valid, *, n_sources: int):
    n = tau.shape[0]
    dev = tau.device
    dispatch.check("tau", tau, torch.int32, (n,), dev)
    dispatch.check("src", src, torch.int32, (n,), dev)
    dispatch.check("valid", valid, torch.bool, (n,), dev)
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"scalegate_merge takes 1..{MAX_LANES} lanes, got {n}")
    if not 1 <= n_sources <= 1024:
        raise ValueError(f"n_sources must be in 1..1024, got {n_sources}")
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    ready = torch.empty((n,), dtype=torch.int32, device=dev)
    wmark = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().repro_scalegate_merge(
            tau.data_ptr(), src.data_ptr(), valid.data_ptr(), n, n_sources,
            order.data_ptr(), ready.data_ptr(), wmark.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("scalegate_merge", rc)
    return order, ready, wmark


scalegate_merge_op = dispatch.register(dispatch.Kernel(
    name="scalegate_merge",
    plain=scalegate_merge_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/scalegate_merge/scalegate_merge.py:159",
    source="src/repro_torch/kernels/csrc/scalegate_merge.cu",
))
