"""Plain PyTorch version of the flash_attention kernel.

Held against ``src/repro/kernels/flash_attention/ref.py`` (``attention_ref``)
with the GQA expansion of its ``ops.py``.  It takes what the CUDA kernel
takes: ``q`` ``[BH_q, Sq, D]`` or ``[B, H_q, Sq, D]``, ``k``/``v`` with
``H_kv = H_q / n_rep`` heads, an optional ``q_offset`` (``i32[B * H_q]``:
query row i of a head sits at ``q_offset + i`` on the KV timeline; left
out, ``Skv - Sq`` as in the reference) and an optional ``kv_index``
(``i32[B]``: batch b attends over KV row ``kv_index[b]``).

Its arithmetic is the kernel's: f32 logits scaled by ``D^-1/2``, masked
logits -1e30, p = exp(s - max) rounded to v's dtype before the PV
product, and ``acc / max(l, 1e-30)`` in q's dtype.  The reference
normalises p before that rounding; in float32 the two agree to rounding
error (2e-5), in bfloat16 to bfloat16's precision.

``flash_attention_bwd_ref`` is the plain version of the backward kernel:
the explicit gradient of this function, not autograd of it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        n_rep: int = 1, q_offset=None, kv_index=None):
    flat = q.dim() == 3
    if flat:
        q, k, v = q[None], k[None], v[None]
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if kv_index is not None:
        k, v = k[kv_index.long()], v[kv_index.long()]
    k = k.repeat_interleave(n_rep, dim=1).float()
    v32 = v.repeat_interleave(n_rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (d ** -0.5)
    if q_offset is None:
        off = torch.full((b, hq), skv - sq, dtype=torch.long,
                         device=q.device)
    else:
        off = q_offset.reshape(b, hq).long()
    q_pos = off[:, :, None, None] + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones(q_pos.shape[:3] + (skv,), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None and window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v32)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out[0] if flat else out


def _mask(sq, skv, causal, window, device):
    """[Sq, Skv] visibility, query row i at Skv - Sq + i."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None and window > 0:
        mask &= q_pos - k_pos < window
    return mask


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window=None, n_rep: int = 1):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention_ref`` (no
    ``q_offset``/``kv_index``: query row i at ``Skv - Sq + i``), each in
    its input's dtype, given its output ``o`` and ``do``.  With p =
    exp(s - max), l = rowsum(p), P = p / l and ``P_v`` = p rounded to v's
    dtype over l (the forward's PV operand)::

        dV = P_v^T dO,   dS = P * (dO V^T - rowsum(dO * O)) on visible
        keys (0 on masked ones),   dQ = dS K / sqrt(D),
        dK = dS^T Q / sqrt(D),

    each KV head's dK and dV summed over its n_rep query heads, all in
    float32."""
    flat = q.dim() == 3
    if flat:
        q, k, v, o, do = q[None], k[None], v[None], o[None], do[None]
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    k32 = k.repeat_interleave(n_rep, dim=1).float()
    v32 = v.repeat_interleave(n_rep, dim=1).float()
    q32, o32, do32 = q.float(), o.float(), do.float()
    mask = _mask(sq, skv, causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float() / l, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    di = (do32 * o32).sum(-1, keepdim=True)
    ds = torch.where(mask, p / l * (dp - di), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    fold = lambda x: x.view(b, hkv, n_rep, skv, d).sum(2)
    dq, dk, dv = dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
    return (dq[0], dk[0], dv[0]) if flat else (dq, dk, dv)
