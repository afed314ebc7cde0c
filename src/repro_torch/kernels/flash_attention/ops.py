"""Entry point of the flash_attention kernel: plain version on the CPU, the
CUDA kernel (``csrc/flash_attention.cu``) on the card.

Held against ``src/repro/kernels/flash_attention/ops.py``
(``flash_attention_op``).  GQA is an index, not a copy: query head h reads
KV head ``h // n_rep``.  Beyond the reference's signature the entry takes
``q_offset`` (each query row's position on the KV timeline, ``i32[B]``
per batch row, as the model passes it, or ``i32[B * H_q]`` per (batch,
head) row, the reference-shaped form; left out, ``Skv - Sq`` as the TPU
kernel places them) and ``kv_index`` (``i32[B]``, the KV row each batch
row attends over, so a decode batch of running lanes reads a slot pool in
place).  ``q`` may be ``[BH, Sq, D]`` as in the reference or a ``[B, H,
Sq, D]`` view with any strides but a unit last one (the model passes its
``[B, S, H, D]`` activations and cache transposed, without a copy); the
output has q's shape and strides.  The reference's ``blk_q``/``blk_k``
are Pallas tiling knobs with no counterpart here.

On the card bfloat16 takes one of two bodies by shape (split-KV decode
for at most 16 rows per KV head, its blocks per (batch row, KV head)
merging through a thread-block cluster; wgmma prefill above) and float32
the SIMT body; bfloat16 rows must start on 16-byte boundaries.  A call is
one launch whatever the body.

Tolerance between the two realizations: 2e-5 in float32 (the reference's
own); in bfloat16 p is rounded against a chunk's or the running max in
the kernel and against the row max in the plain version, so they agree
to bfloat16's precision (chip_smoke.py states the bound it checks).

The backward is a kernel of its own, ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``; plain version
``ref.flash_attention_bwd_ref``), dispatched the same way: a wgmma body
for bfloat16 at D 64 and 128 (n_rep <= 8), the SIMT body elsewhere.
``flash_attention`` is the differentiable entry the models call: with no
input needing a gradient it is ``flash_attention_op`` itself, so the
serving path and its CUDA graphs launch exactly what they did; otherwise a
``torch.autograd.Function`` runs the forward through
``flash_attention_op`` (asking it for each row's log-sum-exp, which the
prefill body writes and the wgmma backward reads instead of taking it
again) and its backward through ``flash_attention_bwd_op`` on the saved
views as they lie.  A gradient through a cached call (``q_offset`` or
``kv_index``) raises: training attends without a cache, as the
reference's does.
"""

from __future__ import annotations

import struct

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                      flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 16        # n_rep * Sq at most: the split-KV decode body
MAX_SPLIT = 8           # decode blocks per (batch row, KV head): a cluster
# the C entry's LaunchArgs: q, k, v, o, 12 strides, q_offset, qo_b, qo_h,
# kv_index, lse (int64); n_split, batch, hq, hkv, len_q, len_kv, d, causal,
# window, dtype (int32); scale (float); stream (int64)
ARGS = struct.Struct("<21q10if4xq")
# the backward's BwdArgs: q, k, v, o, do, dq, dk, dv, lse, scratch, the
# scratch's floats, 24 strides (int64); batch, hq, hkv, len_q, len_kv, d,
# causal, window, dtype (int32); scale (float); stream (int64)
BWD_ARGS = struct.Struct("<35q9ifq")
WGMMA_BWD_DIMS = (64, 128)  # the backward's wgmma body: bfloat16, these D,
MAX_CLUSTER = 8             # and n_rep up to the portable cluster size

_SMS = {}               # device -> streaming multiprocessors


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          n_rep: int = 1, q_offset=None, kv_index=None,
                          return_lse: bool = False):
    """The plain version with the wrapper's signature: ``q_offset`` per
    batch row is widened to the per-row form ``flash_attention_ref``
    takes."""
    b, hq = (1, q.shape[0]) if q.dim() == 3 else q.shape[:2]
    if q_offset is not None and q_offset.numel() != b * hq:
        q_offset = q_offset.repeat_interleave(hq)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               n_rep=n_rep, q_offset=q_offset,
                               kv_index=kv_index, return_lse=return_lse)


def _index(name, t, n, dev):
    """An int32 vector of ``n`` on ``dev`` with unit stride."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if t.shape != (n,) or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be a contiguous i32[{n}] on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")


def validate(q, k, v, *, causal: bool = True, window=None, n_rep: int = 1,
             q_offset=None, kv_index=None):
    """Raise on what the kernel does not take; -> q, k, v as 4-D views,
    their (b, h, s) element strides (nine ints) and their data pointers."""
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [BH, S, D] or [B, H, S, D]")
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = kshape = k.shape
    dtype, dev = q.dtype, q.device
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError("q, k and v must share float32 or bfloat16")
    if v.shape != kshape or dk != d:
        raise ValueError("k and v must be [B, H_kv, Skv, D] with q's D")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} is not one of {HEAD_DIMS}")
    if hq != hkv * n_rep:
        raise ValueError(f"{hq} query heads != {hkv} KV heads x {n_rep}")
    if kv_index is None and bk != b:
        raise ValueError("without kv_index, k's batch must equal q's")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if (k.device != dev or v.device != dev
            or qs[3] != 1 or ks[3] != 1 or vs[3] != 1):
        raise ValueError("q, k, v must lie on one device with unit stride "
                         "in D")
    if window is not None and window < 1:
        raise ValueError("window must be None or >= 1")
    # every block on grid axis x: at most 2^31 - 1 of them, 16 query rows
    # (or one split) a block at the finest
    if skv < 1 or b * hkv * max(MAX_SPLIT, -(-n_rep * sq // 16)) >= 2 ** 31:
        raise ValueError("flash_attention: grid or sequence out of range")
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if dtype == torch.bfloat16 and (
            (ptrs[0] | ptrs[1] | ptrs[2]) & 15
            or (qs[0] | qs[1] | qs[2] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1]
                | vs[2]) & 7):
        raise ValueError("bfloat16 rows of q, k and v must start on "
                         "16-byte boundaries")
    if q_offset is not None:
        _index("q_offset", q_offset,
               b * hq if q_offset.numel() == b * hq else b, dev)
    if kv_index is not None:
        _index("kv_index", kv_index, b, dev)
    return q, k, v, qs[:3] + ks[:3] + vs[:3], ptrs


def _cuda(q, k, v, *, causal: bool = True, window=None, n_rep: int = 1,
          q_offset=None, kv_index=None, return_lse: bool = False):
    q4, _, _, strides, ptrs = validate(
        q, k, v, causal=causal, window=window, n_rep=n_rep,
        q_offset=q_offset, kv_index=kv_index)
    b, hq, sq, d = q4.shape
    hkv, skv = k.shape[-3], k.shape[-2]
    dev = q.device
    out = torch.empty_like(q4)
    n_split = 0
    if n_rep * sq <= DECODE_ROWS and q.dtype == torch.bfloat16:
        # blocks per (batch row, KV head): two per SM over the grid
        sms = _SMS.get(dev)
        if sms is None:
            sms = _SMS[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        n_split = min(MAX_SPLIT, max(1, -(-2 * sms // (b * hkv))))
    qo_b = qo_h = 0
    if q_offset is not None:
        qo_b, qo_h = (hq, 1) if q_offset.numel() == b * hq else (1, 0)
    # each row's log-sum-exp: the prefill body's (bfloat16, more than 16
    # rows a KV head) writes it; the others give None
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
           if return_lse and q.dtype == torch.bfloat16
           and n_rep * sq > DECODE_ROWS else None)
    args = ARGS.pack(
        *ptrs, out.data_ptr(), *strides, *out.stride()[:3],
        0 if q_offset is None else q_offset.data_ptr(), qo_b, qo_h,
        0 if kv_index is None else kv_index.data_ptr(),
        0 if lse is None else lse.data_ptr(), n_split, b, hq,
        hkv, sq, skv, d, int(causal),
        0 if window is None else int(window), DTYPES[q.dtype], d ** -0.5,
        torch._C._cuda_getCurrentRawStream(dev.index))
    fn = build.function("repro_flash_attention")
    if dev.index == torch.cuda.current_device():
        rc = fn(args)
    else:
        with torch.cuda.device(dev):
            rc = fn(args)
    build.raise_on_error("flash_attention", rc)
    out = out[0] if q.dim() == 3 else out
    if not return_lse:
        return out
    return out, (lse[0] if lse is not None and q.dim() == 3 else lse)


flash_attention_op = dispatch.register(dispatch.Kernel(
    name="flash_attention",
    plain=flash_attention_plain,
    cuda=_cuda,
    replaces="src/repro/kernels/flash_attention/flash_attention.py:108",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
))


def flash_attention_bwd_plain(q, k, v, o, do, *, causal: bool = True,
                              window=None, n_rep: int = 1, lse=None):
    """The plain backward with the wrapper's signature, on contiguous
    copies: it takes each row's statistics itself, so ``lse`` is not
    read."""
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    return flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                   window=window, n_rep=n_rep)


def _readable(x):
    """``x`` if the kernel reads its rows where they lie (a unit last
    stride; bfloat16 rows on 16-byte boundaries), else a contiguous copy
    (an expanded dO, say)."""
    st = x.stride()
    if st[-1] == 1 and (x.dtype != torch.bfloat16 or not (
            x.data_ptr() & 15 or (st[0] | st[1] | st[2]) & 7)):
        return x
    return x.contiguous()


def _bwd_cuda(q, k, v, o, do, *, causal: bool = True, window=None,
              n_rep: int = 1, lse=None):
    flat = q.dim() == 3
    q4, k4, v4, o4, do4 = (x[None] if flat else x for x in (q, k, v, o, do))
    b, hq, sq, d = q4.shape
    hkv, skv = k4.shape[1], k4.shape[2]
    dtype, dev = q.dtype, q.device
    if dtype not in DTYPES or d not in HEAD_DIMS or hq != hkv * n_rep:
        raise ValueError(f"flash_attention_bwd: {dtype}, head size {d}, "
                         f"{hq} query heads over {hkv} x {n_rep}")
    for name, x, shape in (("q", q4, (b, hq, sq, d)), ("o", o4, (b, hq, sq, d)),
                           ("do", do4, (b, hq, sq, d)),
                           ("k", k4, (b, hkv, skv, d)),
                           ("v", v4, (b, hkv, skv, d))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, expected "
                             f"{dtype} {shape} on {dev}")
    if window is not None and window < 1:
        raise ValueError("window must be None or >= 1")
    q4, k4, v4, o4, do4 = (_readable(x) for x in (q4, k4, v4, o4, do4))
    dq, dk, dv = (torch.empty_like(x) for x in (q4, k4, v4))
    wgmma = (dtype == torch.bfloat16 and d in WGMMA_BWD_DIMS
             and n_rep <= MAX_CLUSTER)
    if lse is not None:
        lse = lse[None] if flat else lse
        if not wgmma:
            lse = None                       # the SIMT body takes its own
        else:
            dispatch.check("lse", lse, torch.float32, (b, hq, sq), dev)
    # scratch: wgmma, each row's log-sum-exp unless given; SIMT, each
    # row's max, sum and D_i and each query head's share of dK and dV
    n = ((0 if lse is not None else b * hq * sq) if wgmma
         else 3 * b * hq * sq + 2 * b * hq * skv * d)
    scratch = torch.empty(n, dtype=torch.float32, device=dev)
    if sq:
        strides = [s for x in (q4, k4, v4, o4, do4, dq, dk, dv)
                   for s in x.stride()[:3]]
        args = BWD_ARGS.pack(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            0 if lse is None else lse.data_ptr(), scratch.data_ptr(), n,
            *strides, b, hq, hkv, sq, skv, d, int(causal),
            0 if window is None else int(window), DTYPES[dtype], d ** -0.5,
            torch._C._cuda_getCurrentRawStream(dev.index))
        fn = build.function("repro_flash_attention_bwd")
        if dev.index == torch.cuda.current_device():
            rc = fn(args)
        else:
            with torch.cuda.device(dev):
                rc = fn(args)
        build.raise_on_error("flash_attention_bwd", rc)
    else:
        dk.zero_()
        dv.zero_()
    return (dq[0], dk[0], dv[0]) if flat else (dq, dk, dv)


flash_attention_bwd_op = dispatch.register(dispatch.Kernel(
    name="flash_attention_bwd",
    plain=flash_attention_bwd_plain,
    cuda=_bwd_cuda,
    replaces="jax.grad of src/repro/kernels/flash_attention/ref.py:6 "
             "attention_ref",
    source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
))


class _FlashAttention(torch.autograd.Function):
    """``flash_attention_op`` (no cache) with ``flash_attention_bwd_op``
    as its gradient.  q, k and v may be strided views (the model's
    transposed activations); the backward reads them, o and dO where they
    lie, with each row's log-sum-exp from the forward where its body
    gave one, and returns gradients laid out as the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, n_rep):
        o, lse = flash_attention_op(q, k, v, causal=causal, window=window,
                                    n_rep=n_rep, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, n_rep=n_rep)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_op(q, k, v, o, do, lse=lse,
                                            **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    n_rep: int = 1, q_offset=None, kv_index=None):
    """``flash_attention_op`` with a gradient: through ``_FlashAttention``
    when gradients are on and q, k or v needs one, else
    ``flash_attention_op`` itself (which saves nothing)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset is not None or kv_index is not None:
            raise NotImplementedError(
                "flash_attention: no gradient through a cached call "
                "(q_offset or kv_index); training attends without a cache")
        return _FlashAttention.apply(q, k, v, causal, window, n_rep)
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              n_rep=n_rep, q_offset=q_offset,
                              kv_index=kv_index)
