"""Entry point of the window_join kernel: plain version on the CPU, the CUDA
kernel (``csrc/window_join.cu``) on the card.

Held against ``src/repro/kernels/window_join/ops.py``.  Contract, as the
reference's: returns ``(counts i32[B, K], comps)``, the band matches of
each incoming tuple against each key row's live (``st_tau >= 0``), fresh
(``st_tau + ws >= new_tau`` with int32 wrap-around), opposite-stream
entries, and the total of such opposite pairs without the band test;
``comps`` is a 0-dim int64 tensor (the kernel accumulates it with 64-bit
atomics).  Tolerance: none, both results are exact against the plain
version (integer counts; the band test is one float subtraction and
compare per column, rounded alike).  Incoming lanes past B inside the
kernel's last tile stage ``INF_TIME``, as the Pallas wrapper's sublane
padding does, and count nothing.  Any B, K, R and ``n_attrs <= P`` is
taken, as the reference takes it (the kernel unrolls the first 8 columns
and reads the rest from memory).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.window_join.ref import window_join_ref


def validate(new_tau, new_src, new_pay, st_tau, st_src, st_pay, *,
             n_attrs: int = 2):
    """Raise on what the kernel does not take."""
    b, p = new_pay.shape
    k, r = st_tau.shape
    dev = new_tau.device
    dispatch.check("new_tau", new_tau, torch.int32, (b,), dev)
    dispatch.check("new_src", new_src, torch.int32, (b,), dev)
    dispatch.check("new_pay", new_pay, torch.float32, (b, p), dev)
    dispatch.check("st_tau", st_tau, torch.int32, (k, r), dev)
    dispatch.check("st_src", st_src, torch.int32, (k, r), dev)
    dispatch.check("st_pay", st_pay, torch.float32, (k, r, p), dev)
    if not 0 <= n_attrs <= p:
        raise ValueError(f"n_attrs must be in 0..{p}")
    if b * k >= 2 ** 31 or k * r * p >= 2 ** 31:
        raise ValueError("window_join shape exceeds its 32-bit indexing")


def _cuda(new_tau, new_src, new_pay, st_tau, st_src, st_pay, *,
          ws: int, band: float = 10.0, n_attrs: int = 2):
    validate(new_tau, new_src, new_pay, st_tau, st_src, st_pay,
             n_attrs=n_attrs)
    b, p = new_pay.shape
    k, r = st_tau.shape
    dev = new_tau.device
    counts = torch.empty((b, k), dtype=torch.int32, device=dev)
    comps = torch.empty((), dtype=torch.int64, device=dev)
    build.launch("window_join", dev, new_tau.data_ptr(), new_src.data_ptr(),
                 new_pay.data_ptr(), b, p, st_tau.data_ptr(),
                 st_src.data_ptr(), st_pay.data_ptr(), k, r, int(ws),
                 float(band), n_attrs, counts.data_ptr(), comps.data_ptr())
    return counts, comps


window_join_op = dispatch.register(dispatch.Kernel(
    name="window_join",
    plain=window_join_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/window_join/window_join.py:104",
    source="src/repro_torch/kernels/csrc/window_join.cu",
))
