"""int8 error-feedback gradient compression.

Held against ``src/repro/optim/compress.py``.  Before a cross-replica
gradient reduction each leaf is quantized to int8 with a per-tensor
scale; the quantization error is kept in a float32 residual and added back
next step.  With ``axis_name=None`` ``compressed_psum`` is the reference's
local round trip (quantize, dequantize, carry the error).  A named axis is
the reference's ``psum``/``pmax`` over a mesh axis: that waits for the
model mesh (ROADMAP.md queue 1 item 10) and raises here.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_residual(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads, residual) -> Tuple[Any, Any, Any]:
    """Returns (int8 grads, float32 scales, new residual)."""
    def one(g, r):
        g = g.float() + r
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale, g - q.float() * scale

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residual))]
    pick = lambda i: tree_unflatten(grads, [o[i] for o in out])
    return pick(0), pick(1), pick(2)


def decompress(q, scales) -> Any:
    return tree_map(lambda qq, s: qq.float() * s, q, scales)


def compressed_psum(grads, residual, axis_name=None):
    """Quantize -> (reduce over ``axis_name``) -> dequantize, with error
    feedback.  -> (float32 grads, new residual)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"compressed_psum over the mesh axis {axis_name!r} waits for "
            f"the model mesh (ROADMAP item 10)")
    q, s, residual = compress(grads, residual)
    return decompress(q, s), residual

