"""Entry point of the flash_attention kernel: plain version on the CPU, the
CUDA kernel (``csrc/flash_attention.cu``) on the card.

Held against ``src/repro/kernels/flash_attention/ops.py``
(``flash_attention_op``).  GQA is an index, not a copy: query head h reads
KV head ``h // n_rep``.  Beyond the reference's signature the entry takes
``q_offset`` (``i32[B * H_q]``, each query row's position on the KV
timeline; left out, ``Skv - Sq`` as the TPU kernel places them) and
``kv_index`` (``i32[B]``, the KV row each batch row attends over, so a
decode batch of running lanes reads a slot pool in place).  ``q`` may be
``[BH, Sq, D]`` as in the reference or a ``[B, H, Sq, D]`` view with any
strides but a unit last one (the model passes its ``[B, S, H, D]``
activations and cache transposed, without a copy); the output has q's
shape and strides.  The reference's ``blk_q``/``blk_k`` are Pallas tiling
knobs with no counterpart here.

Tolerance between the two realizations: 2e-5 in float32 (the reference's
own); in bfloat16 p is rounded against the running max in the kernel and
against the row max in the plain version, so they agree to bfloat16's
precision (chip_smoke.py states the bound it checks).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def validate(q, k, v, *, causal: bool = True, window=None, n_rep: int = 1,
             q_offset=None, kv_index=None):
    """Raise on what the kernel does not take; -> q, k, v as 4-D views."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("flash_attention takes [BH, S, D] or [B, H, S, D]")
    q4, k4, v4 = (x[None] if q.dim() == 3 else x for x in (q, k, v))
    b, hq, sq, d = q4.shape
    bk, hkv, skv, _ = k4.shape
    dev = q.device
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share float32 or bfloat16")
    if tuple(v4.shape) != tuple(k4.shape) or k4.shape[3] != d:
        raise ValueError("k and v must be [B, H_kv, Skv, D] with q's D")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} is not one of {HEAD_DIMS}")
    if hq != hkv * n_rep:
        raise ValueError(f"{hq} query heads != {hkv} KV heads x {n_rep}")
    if kv_index is None and bk != b:
        raise ValueError("without kv_index, k's batch must equal q's")
    if any(x.device != dev or x.stride(-1) != 1 for x in (q4, k4, v4)):
        raise ValueError("q, k, v must lie on one device with unit stride "
                         "in D")
    if window is not None and window < 1:
        raise ValueError("window must be None or >= 1")
    if b * hkv > 65535 or skv < 1:
        raise ValueError("flash_attention: grid or sequence out of range")
    for name, t, n in (("q_offset", q_offset, b * hq),
                       ("kv_index", kv_index, b)):
        if t is not None:
            dispatch.check(name, t, torch.int32, (n,), dev)
    return q4, k4, v4


def _cuda(q, k, v, *, causal: bool = True, window=None, n_rep: int = 1,
          q_offset=None, kv_index=None):
    q4, k4, v4 = validate(q, k, v, causal=causal, window=window,
                          n_rep=n_rep, q_offset=q_offset, kv_index=kv_index)
    b, hq, sq, d = q4.shape
    hkv, skv = k4.shape[1], k4.shape[2]
    dev = q.device
    out = torch.empty_like(q4)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q4, k4, v4, out) for i in range(3)))
    with torch.cuda.device(dev):
        rc = build.library().repro_flash_attention(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p),
            _ptr(q_offset), _ptr(kv_index),
            b, hq, hkv, sq, skv, d, int(causal),
            0 if window is None else int(window), float(d ** -0.5),
            DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("flash_attention", rc)
    return out[0] if q.dim() == 3 else out


flash_attention_op = dispatch.register(dispatch.Kernel(
    name="flash_attention",
    plain=flash_attention_ref,
    cuda=_cuda,
    replaces="src/repro/kernels/flash_attention/flash_attention.py:108",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
))
