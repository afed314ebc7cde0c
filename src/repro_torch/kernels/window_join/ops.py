"""Entry point of the window_join kernel: plain version on the CPU, the CUDA
kernel (``csrc/window_join.cu``) on the card.

Held against ``src/repro/kernels/window_join/ops.py``.  Returns
``(counts i32[B, K], comps)``; ``comps`` is a 0-dim int64 tensor (the
kernel accumulates it with 64-bit atomics).  Both results are exact.
Incoming lanes past B inside the kernel's last tile stage ``INF_TIME``, as
the Pallas wrapper's sublane padding does, and count nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.window_join.ref import window_join_ref

MAX_ATTRS = 8


def _cuda(new_tau, new_src, new_pay, st_tau, st_src, st_pay, *,
          ws: int, band: float = 10.0, n_attrs: int = 2):
    b, p = new_pay.shape
    k, r = st_tau.shape
    dev = new_tau.device
    dispatch.check("new_tau", new_tau, torch.int32, (b,), dev)
    dispatch.check("new_src", new_src, torch.int32, (b,), dev)
    dispatch.check("new_pay", new_pay, torch.float32, (b, p), dev)
    dispatch.check("st_tau", st_tau, torch.int32, (k, r), dev)
    dispatch.check("st_src", st_src, torch.int32, (k, r), dev)
    dispatch.check("st_pay", st_pay, torch.float32, (k, r, p), dev)
    if not 0 <= n_attrs <= min(p, MAX_ATTRS):
        raise ValueError(f"n_attrs must be in 0..{min(p, MAX_ATTRS)}")
    if b * k >= 2 ** 31 or k * r * p >= 2 ** 31 or (k + 7) // 8 > 65535:
        raise ValueError("window_join shape exceeds its 32-bit indexing")
    counts = torch.empty((b, k), dtype=torch.int32, device=dev)
    comps = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().repro_window_join(
            new_tau.data_ptr(), new_src.data_ptr(), new_pay.data_ptr(), b, p,
            st_tau.data_ptr(), st_src.data_ptr(), st_pay.data_ptr(), k, r,
            int(ws), float(band), n_attrs, counts.data_ptr(),
            comps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("window_join", rc)
    return counts, comps


window_join_op = dispatch.register(dispatch.Kernel(
    name="window_join",
    plain=window_join_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/window_join/window_join.py:104",
    source="src/repro_torch/kernels/csrc/window_join.cu",
))
