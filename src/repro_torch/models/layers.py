"""Shared neural-net layers: RMSNorm, RoPE, SwiGLU, embeddings.

Held against ``src/repro/models/layers.py``.  Weights keep the reference's
``[in, out]`` layout (``x @ W``).  ``rope`` also takes positions
``[B, S]``, so each decode lane rotates at its own depth.  ``init_dense``
draws from an explicit ``torch.Generator``: the same distribution as the
reference's, not JAX's bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import sharded_rows


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """x: [B, S, H, D]; positions: [S] or [B, S] (absolute, for the KV
    cache)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq            # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed(tokens, table):
    """The rows of ``table`` for ``tokens`` (``sharding.sharded_rows``: a
    vocab-sharded ``DTensor`` table is read where it lies)."""
    return sharded_rows(table, tokens)


def unembed(x, table):
    """Logits against the (possibly tied) embedding table [V, D]."""
    return x @ table.T


def init_dense(gen, shape, scale=None, dtype=torch.float32, device=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)
