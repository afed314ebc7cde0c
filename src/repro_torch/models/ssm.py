"""Mamba-style selective-SSM heads (hymba's parallel-head hybrid), through
the linear-scan kernel.

Held against ``src/repro/models/ssm.py`` (``init_ssm``, ``_proj``,
``ssm_forward``).  Per head, state S: ``[n_state, head_dim]``,

    S_t = a_t * S_{t-1} + B_t^T x_t,   a_t = exp(-softplus(dt_t + a_log))
    y_t = C_t @ S_t,                   gated by silu(z_t)

with a scalar decay per head broadcast over the state.  The reference
evaluates a prefill as its chunked SSD form (``_ssd_chunked``), a length
that no chunk divides as a ``lax.scan``, and one decode token as the
plain step; the port runs every length through ``kernels/linear_scan``
(f32, BH = batch x heads, Dk = ``ssm_state``, Dv = ``head_dim``, the
carried state in as ``s0`` and the final state out), which computes the
same recurrence.  The kernel emits ``r_t S_{t-1}`` before its update, so
with r = C, k = B, v = x and w = a broadcast over Dk it gives
``o_t = C_t S_{t-1}``, and ``y_t = a_t o_t + (C_t . B_t) x_t`` completes
the step exactly: one launch over T steps, no shifted copy of the inputs.
The reference's ``shard`` annotations are no-ops without a model mesh
(ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense
from repro_torch.models.sharding import (local_blocks, merge_heads, shard,
                                         split_heads)


def init_ssm(gen, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    h, pdim, s = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    dense = lambda shape: init_dense(gen, shape, dtype=dtype, device=device)
    return {
        "w_x": dense((d, h * pdim)),
        "w_z": dense((d, h * pdim)),
        "w_b": dense((d, h * s)),
        "w_c": dense((d, h * s)),
        "w_dt": dense((d, h)),
        "w_out": dense((h * pdim, d)),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
    }


def _proj(p, x, cfg: ModelConfig):
    """x [B, T, D] -> xv, z [B, T, H, P]; B, C [B, T, H, S] (x's dtype);
    the decay a [B, T, H] in (0, 1), float32."""
    b, sq, _ = x.shape
    h, pdim, s = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    xv = split_heads(x @ p["w_x"], h, pdim)
    z = split_heads(x @ p["w_z"], h, pdim)
    bb = split_heads(x @ p["w_b"], h, s)
    cc = split_heads(x @ p["w_c"], h, s)
    dt = (x @ p["w_dt"]).float()
    decay = torch.exp(-F.softplus(dt + p["a_log"]))
    return xv, z, bb, cc, decay


def _heads(t):
    """[B, T, H, n] -> float32 [B * H, T, n], contiguous."""
    b, sq, h, n = t.shape
    return t.float().permute(0, 2, 1, 3).reshape(b * h, sq, n).contiguous()


def ssm_forward(p, x, cfg: ModelConfig, state=None):
    """x: [B, T, D] -> (y [B, T, D], new_state).  state: float32 ``[B, H,
    n_state, head_dim]`` (None: zeros)."""
    b, sq, _ = x.shape
    h, pdim, ns = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    xv, z, bb, cc, decay = _proj(p, x, cfg)
    if state is None:
        state = torch.zeros((b, h, ns, pdim), dtype=torch.float32,
                            device=x.device)
    r, k, v = _heads(cc), _heads(bb), _heads(xv)
    a = decay.permute(0, 2, 1).reshape(b * h, sq, 1)
    # one shard's rows at a time under a placeholder mesh
    rows = ("batch",)
    o, s_out = local_blocks(
        lambda r, k, v, a, s0: linear_scan(r, k, v, a, None, s0),
        (r, k, v, a.expand(b * h, sq, ns).contiguous(),
         state.reshape(b * h, ns, pdim).float().contiguous()),
        (rows,) * 5, (rows, rows))
    y = a * o + (r * k).sum(-1, keepdim=True) * v            # C_t S_t
    y = y.view(b, h, sq, pdim).permute(0, 2, 1, 3)
    y = merge_heads(y * F.silu(z.float()))
    return (shard(y.to(x.dtype) @ p["w_out"], "batch", "seq", "embed"),
            s_out.view(b, h, ns, pdim))
