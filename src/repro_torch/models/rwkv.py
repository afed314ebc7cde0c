"""RWKV6 "Finch" blocks: data-dependent-decay linear attention, through the
linear-scan kernel.

Held against ``src/repro/models/rwkv.py``.  Time-mix: token-shift lerp,
r/k/v/g projections, per-channel decay ``w = exp(-exp(w0 + lora(x)))``,
and the matrix-state recurrence with bonus u, which the reference runs as
its own ``chunked_scan`` and the port runs with ``kernels/linear_scan``
(f32, the carried ``wkv`` state in and the final state out, u per head).
Channel-mix: token-shift + squared-ReLU FFN.

State per layer: shift_tm/shift_cm: [B, D]; wkv: [B, H, Dk, Dv] (f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.models.sharding import (local_blocks, merge_heads, shard,
                                         split_heads)

LORA_R = 64


def n_rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head


def init_time_mix(gen, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    full = lambda v, dt=dtype: torch.full((d,), v, dtype=dt, device=device)
    dense = lambda shape, **kw: init_dense(gen, shape, dtype=dtype,
                                           device=device, **kw)
    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "w_r": dense((d, d)), "w_k": dense((d, d)), "w_v": dense((d, d)),
        "w_g": dense((d, d)), "w_o": dense((d, d)),
        "w0": full(-1.0, torch.float32),                # decay bias
        "w_lora_a": dense((d, LORA_R)),
        "w_lora_b": dense((LORA_R, d), scale=0.01),
        "u": init_dense(gen, (d,), scale=0.5, device=device),
        "ln_scale": full(0.0),
    }


def init_channel_mix(gen, cfg: ModelConfig, dtype, device=None):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "w_k": init_dense(gen, (d, f), dtype=dtype, device=device),
        "w_v": init_dense(gen, (f, d), dtype=dtype, device=device),
        "w_r": init_dense(gen, (d, d), dtype=dtype, device=device),
    }


def _token_shift(x, shift_state):
    """x[t-1] stream: prepend the carried last token (decode-composable)."""
    prev = torch.cat([shift_state.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    return prev, x[:, -1].float()


def time_mix_forward(p, x, cfg: ModelConfig, shift_state, wkv_state):
    b, s, d = x.shape
    h = n_rwkv_heads(cfg)
    hd = cfg.rwkv_head
    prev, new_shift = _token_shift(x, shift_state)

    def lerp(mu):
        return x + (prev - x) * mu

    r = lerp(p["mu_r"]) @ p["w_r"]
    k = lerp(p["mu_k"]) @ p["w_k"]
    v = lerp(p["mu_v"]) @ p["w_v"]
    g = lerp(p["mu_g"]) @ p["w_g"]
    # data-dependent decay (the "Finch" contribution)
    lora = torch.tanh(lerp(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + lora.float()))          # (0, 1)

    def heads(t):                          # [B, S, D] -> [B, H, S, hd]
        return split_heads(t.float(), h, hd).permute(0, 2, 1, 3)

    def scan(r, k, v, w, u, s0):           # rows: [B*H, ...]
        bl, hl = r.shape[:2]
        rows = lambda t: t.reshape(bl * hl, *t.shape[2:]).contiguous()
        y, wkv = linear_scan(rows(r), rows(k), rows(v), rows(w), u,
                             rows(s0))
        return y.view(bl, hl, s, hd), wkv.view(bl, hl, hd, hd)

    # one shard's batch rows and heads at a time under a placeholder mesh
    bh = ("batch", "state")
    y, wkv = local_blocks(scan, (heads(r), heads(k), heads(v), heads(w),
                                 p["u"].float().view(h, hd), wkv_state),
                          (bh, bh, bh, bh, ("state",), bh), (bh, bh))
    y = merge_heads(y.permute(0, 2, 1, 3))
    y = rms_norm(y.to(x.dtype), p["ln_scale"], cfg.norm_eps)
    y = y * F.silu(g)
    return shard(y @ p["w_o"], "batch", "seq", "embed"), new_shift, wkv


def channel_mix_forward(p, x, cfg: ModelConfig, shift_state):
    prev, new_shift = _token_shift(x, shift_state)
    xk = x + (prev - x) * p["mu_k"]
    xr = x + (prev - x) * p["mu_r"]
    k = torch.relu(xk @ p["w_k"]).square()
    r = torch.sigmoid(xr @ p["w_r"])
    return shard(r * (k @ p["w_v"]), "batch", "seq", "embed"), new_shift


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None):
    h = n_rwkv_heads(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return {"shift_tm": zeros(batch, cfg.d_model),
            "shift_cm": zeros(batch, cfg.d_model),
            "wkv": zeros(batch, h, cfg.rwkv_head, cfg.rwkv_head)}
