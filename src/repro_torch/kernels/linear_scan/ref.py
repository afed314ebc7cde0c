"""Plain PyTorch version of the linear_scan kernel.

Held against ``src/repro/kernels/linear_scan/ref.py`` (``linear_scan_ref``,
a ``lax.scan`` over time): the same step, a Python loop over T.  Extended
as the CUDA kernel is: ``s0`` (``[BH, Dk, Dv]``, default zeros) starts the
recurrence, ``u`` may hold one row per head (``[H, Dk]`` with ``BH % H ==
0``, row bh reading ``u[bh % H]``), and the final state is returned:
``(o, S_T)``.  The state is f32; ``o`` takes r's dtype.

``linear_scan_chunked_ref`` renders the CUDA kernel's chunked body in
plain PyTorch, for the tests only: the same equations and chunk length,
every decay a running product of w over the steps it spans.
"""

from __future__ import annotations

import torch

CHUNK = 8       # steps per chunk of the CUDA kernel's chunked body


def linear_scan_ref(r, k, v, w, u=None, s0=None):
    bh, t, dk = r.shape
    dv = v.shape[-1]
    dtype = r.dtype
    s = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    if u is not None:
        u = u.float().repeat(bh // u.shape[0], 1)[:, :, None]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    outs = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        att = s + u * kv if u is not None else s
        outs.append(torch.einsum("bk,bkv->bv", r[:, i], att))
        s = w[:, i, :, None] * s + kv
    o = (torch.stack(outs, dim=1) if outs
         else r.new_zeros((bh, 0, dv)))
    return o.to(dtype), s


def linear_scan_chunked_ref(r, k, v, w, u=None, s0=None, chunk: int = CHUNK):
    """The function of ``linear_scan_ref`` computed chunk by chunk, as the
    CUDA kernel's chunked body does.  For a chunk of n steps from state S0,
    with P_t the product of w over the chunk's steps up to t:
    ``o_t = (r_t P_{t-1}) S0 + sum_{s<t} A[t, s] v_s + (r_t . u k_t) v_t``,
    ``A[t, s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]`` and
    ``S_end = diag(P_{n-1}) S0 + sum_s (k_s prod_{s<tau<n} w_tau)^T v_s``.
    """
    bh, t, dk = r.shape
    dv = v.shape[-1]
    dtype = r.dtype
    s = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uu = (torch.zeros((bh, dk), dtype=torch.float32, device=r.device)
          if u is None else u.float().repeat(bh // u.shape[0], 1))
    r, k, v, w = (x.float() for x in (r, k, v, w))
    outs = []
    for t0 in range(0, t, chunk):
        rc, kc, vc, wc = (x[:, t0:t0 + chunk] for x in (r, k, v, w))
        n = rc.shape[1]
        ones = torch.ones_like(wc[:, :1])
        p = torch.cumprod(wc, dim=1)                     # P_t
        p_before = torch.cat([ones, p[:, :-1]], dim=1)   # P_{t-1}
        # prod_{s<tau<n} w_tau: the suffix products, shifted by one step
        after = torch.cat([wc[:, 1:], ones], dim=1)
        g = torch.flip(torch.cumprod(torch.flip(after, [1]), 1), [1])
        a = torch.diag_embed((rc * uu[:, None] * kc).sum(-1))
        for s_ in range(n - 1):
            # prod_{s_<tau<t} w_tau for t = s_ + 1 .. n - 1
            e = torch.cumprod(torch.cat([ones, wc[:, s_ + 1:n - 1]], 1), 1)
            a[:, s_ + 1:, s_] = (rc[:, s_ + 1:] * e * kc[:, s_, None]).sum(-1)
        outs.append(torch.einsum("btk,bkv->btv", rc * p_before, s)
                     + torch.einsum("bts,bsv->btv", a, vc))
        s = p[:, -1, :, None] * s + torch.einsum("bsk,bsv->bkv", kc * g, vc)
    o = torch.cat(outs, dim=1) if outs else r.new_zeros((bh, 0, dv))
    return o.to(dtype), s
