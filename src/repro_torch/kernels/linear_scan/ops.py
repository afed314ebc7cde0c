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

The backward is a kernel of its own, ``linear_scan_bwd``
(``csrc/linear_scan_bwd.cu``; plain version ``ref.linear_scan_bwd_ref``),
with the same dispatch: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors.  ``linear_scan`` is the differentiable entry the
models call: with no input needing a gradient it is ``linear_scan_op``
itself, so the serving path and its CUDA graphs launch exactly what they
did; otherwise a ``torch.autograd.Function`` runs the forward through
``linear_scan_op`` and its backward through ``linear_scan_bwd_op``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.linear_scan.ref import (CHUNK, linear_scan_bwd_ref,
                                                  linear_scan_ref)

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


def bwd_scratch_floats(bh: int, t: int, dk: int, dv: int) -> int:
    """The backward kernel's float32 scratch: the state at the start of
    each chunk of 512 / Dk steps (``Shape::C`` in
    ``csrc/linear_scan_bwd.cu``), the dk/dw/dr partials of each 32-column
    tile, v_t . do_t."""
    chunks = -(-t // (512 // dk))
    tiles = -(-dv // 32)
    return bh * chunks * dk * dv + 3 * tiles * bh * t * dk + bh * t


def _bwd_cuda(r, k, v, w, u=None, s0=None, do=None, ds_t=None):
    u_rows = validate(r, k, v, w, u, s0)
    bh, t, dk = r.shape
    dv = v.shape[-1]
    dev, f32 = r.device, torch.float32
    if do is None:
        do = torch.zeros((bh, t, dv), dtype=f32, device=dev)
    dispatch.check("do", do, f32, (bh, t, dv), dev)
    if ds_t is not None:
        dispatch.check("ds_t", ds_t, f32, (bh, dk, dv), dev)
    dr, dkk, dw = (torch.empty_like(x) for x in (r, k, w))
    dvv = torch.empty_like(v)
    du = None if u is None else torch.empty_like(u)
    ds0 = torch.empty((bh, dk, dv), dtype=f32, device=dev)
    scratch = torch.empty(bwd_scratch_floats(bh, t, dk, dv), dtype=f32,
                          device=dev)
    build.launch("linear_scan_bwd", dev, r.data_ptr(), k.data_ptr(),
                 v.data_ptr(), w.data_ptr(), _ptr(u), u_rows, _ptr(s0),
                 do.data_ptr(), _ptr(ds_t), scratch.data_ptr(),
                 dr.data_ptr(), dkk.data_ptr(), dvv.data_ptr(),
                 dw.data_ptr(), _ptr(du), ds0.data_ptr(), bh, t, dk, dv)
    return dr, dkk, dvv, dw, du, ds0


linear_scan_bwd_op = dispatch.register(dispatch.Kernel(
    name="linear_scan_bwd",
    plain=linear_scan_bwd_ref,
    cuda=_bwd_cuda,
    replaces="jax.grad of src/repro/kernels/linear_scan/ref.py:7 "
             "linear_scan_ref",
    source="src/repro_torch/kernels/csrc/linear_scan_bwd.cu",
))


class _LinearScan(torch.autograd.Function):
    """``(o, S_T) = linear_scan_op(...)`` with ``linear_scan_bwd_op`` as
    its gradient.  Inputs are float32 and contiguous, as the kernel takes
    them; a gradient left unused arrives as None (no zeros are made)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return linear_scan_op(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, do, ds_t):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dr, dk, dv, dw, du, ds0 = linear_scan_bwd_op(
            r, k, v, w, u, s0,
            None if do is None else do.contiguous(),
            None if ds_t is None else ds_t.contiguous())
        return (dr, dk, dv, dw, du if ctx.needs_input_grad[4] else None,
                ds0 if ctx.needs_input_grad[5] else None)


def linear_scan(r, k, v, w, u=None, s0=None):
    """``linear_scan_op`` with a gradient: through ``_LinearScan`` when
    gradients are on and an input needs one, else ``linear_scan_op``
    itself (which saves nothing)."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        return _LinearScan.apply(r, k, v, w, u, s0)
    return linear_scan_op(r, k, v, w, u, s0)
