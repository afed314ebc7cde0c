"""Entry point of the linear_scan kernel: plain version on the CPU, the CUDA
kernel (``csrc/linear_scan.cu``) on the card.

Held against ``src/repro/kernels/linear_scan/ops.py`` (``linear_scan_op``).
Returns ``(o, S_T)``: beyond the reference's signature the recurrence
starts from ``s0`` (``f32[BH, Dk, Dv]``; left out, zeros, the TPU kernel's
start) and hands back its final state, which the RWKV time-mix carries
from prefill into every decode tick.  ``u`` is ``[BH, Dk]`` as in the
reference or one row per head (``[H, Dk]``, broadcast over the batch).
The reference's ``chunk`` is a Pallas tiling knob; here ``chunk`` picks
the chunk length C of the kernel's chunked body (``CHUNK`` by default;
16 at Dk 64 for the card's sweep), which runs every call of T >= C at Dk
32, 64 and 128; shorter calls (decode) and smaller keys take its
sequential body.  The domain is w in [0, 1].

Tolerance between the two realizations: 1e-4, the reference's (the sums
over Dk and the chunk's steps run in another order).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.linear_scan.ref import CHUNK, linear_scan_ref

KEY_DIMS = (8, 16, 32, 64, 128)
SWEEP_CHUNKS = (CHUNK, 16)        # chunk lengths built at Dk 64


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def validate(r, k, v, w, u=None, s0=None):
    """Raise on what the kernel does not take; -> the rows of u."""
    bh, t, dk = r.shape
    dv = v.shape[-1]
    dev = r.device
    f32 = torch.float32
    for name, x in (("r", r), ("k", k), ("w", w)):
        dispatch.check(name, x, f32, (bh, t, dk), dev)
    dispatch.check("v", v, f32, (bh, t, dv), dev)
    if dk not in KEY_DIMS:
        raise ValueError(f"key size {dk} is not one of {KEY_DIMS}")
    u_rows = 0
    if u is not None:
        u_rows = u.shape[0]
        dispatch.check("u", u, f32, (u_rows, dk), dev)
        if u_rows < 1 or bh % u_rows:
            raise ValueError("u needs BH or a divisor of BH rows")
    if s0 is not None:
        dispatch.check("s0", s0, f32, (bh, dk, dv), dev)
    return u_rows


def _cuda(r, k, v, w, u=None, s0=None, *, chunk: int = CHUNK):
    u_rows = validate(r, k, v, w, u, s0)
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if chunk != CHUNK and (dk != 64 or chunk not in SWEEP_CHUNKS):
        raise ValueError(f"chunk {chunk} is built only at Dk 64, one of "
                         f"{SWEEP_CHUNKS}")
    dev, f32 = r.device, torch.float32
    o = torch.empty((bh, t, dv), dtype=f32, device=dev)
    s_out = torch.empty((bh, dk, dv), dtype=f32, device=dev)
    build.launch("linear_scan", dev, r.data_ptr(), k.data_ptr(),
                 v.data_ptr(), w.data_ptr(), _ptr(u), u_rows, _ptr(s0),
                 o.data_ptr(), s_out.data_ptr(), bh, t, dk, dv, chunk)
    return o, s_out


linear_scan_op = dispatch.register(dispatch.Kernel(
    name="linear_scan",
    plain=linear_scan_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/linear_scan/linear_scan.py:104",
    source="src/repro_torch/kernels/csrc/linear_scan.cu",
))
