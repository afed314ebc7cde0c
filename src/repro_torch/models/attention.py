"""GQA attention with qk-norm, sliding window and a KV cache, through the
flash-attention kernel.

Held against ``src/repro/models/attention.py``.  The reference computes
attention with its own jnp flash loop (``blocked_attention``, and
``decode_attention`` for one query); the port computes the same function
with ``kernels/flash_attention`` in all three of its branches: prefill
without a cache, prefill into a cache and decode.  The first is also the
training call: its gradient is the ``flash_attention_bwd`` kernel
(``ops.flash_attention``); the cached branches take no gradient.

The cache keeps the reference's layout ``[B, max_seq, KV, Dh]`` and is
written in place.  Each batch row may sit at its own depth: ``positions``
is ``[S]`` or ``[B, S]``, row b's new K/V land at ``positions[b]``, and its
queries attend with offset ``positions[b, 0]``.  ``lanes`` (``i64[B]``)
names the cache row of each batch row, so a decode batch of running slots
reads and writes the slot pool where it lies (the reference gathers the
slots into a batch and scatters them back).  ``cache_index`` turns
positions and lanes into the index tensors once per forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, rms_norm, rope


def init_attn(gen, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    p = {
        "wq": init_dense(gen, (d, cfg.q_dim), dtype=dtype, device=device),
        "wk": init_dense(gen, (d, cfg.kv_dim), dtype=dtype, device=device),
        "wv": init_dense(gen, (d, cfg.kv_dim), dtype=dtype, device=device),
        "wo": init_dense(gen, (cfg.q_dim, d), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
        p["k_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    return p


def cache_index(positions, b: int, lanes=None):
    """What every layer's cached attention reads, made once per forward:
    (cache rows ``[B, 1]``, positions ``[B, S]`` of the new K/V,
    ``q_offset`` ``i32[B]`` (row b's queries start at ``positions[b, 0]``),
    ``kv_index`` ``i32[B]`` or None)."""
    rows = (torch.arange(b, device=positions.device) if lanes is None
            else lanes)
    pos = positions if positions.dim() == 2 else positions.expand(b, -1)
    return (rows[:, None], pos, pos[:, 0].to(torch.int32),
            None if lanes is None else lanes.to(torch.int32))


def attn_forward(p, x, positions, cfg: ModelConfig, *,
                 window: Optional[int] = None, cache=None, index=None):
    """x: [B, S, D].  With ``cache``: write the S new positions into it and
    attend over its whole timeline (causal, so positions past each row's
    own are masked and never read); ``index`` is then ``cache_index``'s
    result, made by the caller once for all layers."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).view(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        rows, pos, q_offset, kv_index = index
        ck[rows, pos] = k.to(ck.dtype)
        cv[rows, pos] = v.to(cv.dtype)
        out = flash_attention(
            q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
            causal=True, window=window, n_rep=n_rep, q_offset=q_offset,
            kv_index=kv_index)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=window, n_rep=n_rep)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return out @ p["wo"], cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device=None):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
