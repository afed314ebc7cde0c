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
"""

from __future__ import annotations

import struct

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 16        # n_rep * Sq at most: the split-KV decode body
MAX_SPLIT = 8           # decode blocks per (batch row, KV head): a cluster
# the C entry's LaunchArgs: q, k, v, o, 12 strides, q_offset, qo_b, qo_h,
# kv_index (int64); n_split, batch, hq, hkv, len_q, len_kv, d, causal,
# window, dtype (int32); scale (float); stream (int64)
ARGS = struct.Struct("<20q10if4xq")

_SMS = {}               # device -> streaming multiprocessors


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          n_rep: int = 1, q_offset=None, kv_index=None):
    """The plain version with the wrapper's signature: ``q_offset`` per
    batch row is widened to the per-row form ``flash_attention_ref``
    takes."""
    b, hq = (1, q.shape[0]) if q.dim() == 3 else q.shape[:2]
    if q_offset is not None and q_offset.numel() != b * hq:
        q_offset = q_offset.repeat_interleave(hq)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               n_rep=n_rep, q_offset=q_offset,
                               kv_index=kv_index)


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
          q_offset=None, kv_index=None):
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
    args = ARGS.pack(
        *ptrs, out.data_ptr(), *strides, *out.stride()[:3],
        0 if q_offset is None else q_offset.data_ptr(), qo_b, qo_h,
        0 if kv_index is None else kv_index.data_ptr(), n_split, b, hq,
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
    return out[0] if q.dim() == 3 else out


flash_attention_op = dispatch.register(dispatch.Kernel(
    name="flash_attention",
    plain=flash_attention_plain,
    cuda=_cuda,
    replaces="src/repro/kernels/flash_attention/flash_attention.py:108",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
))
