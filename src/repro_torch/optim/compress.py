"""int8 error-feedback gradient compression.

Held against ``src/repro/optim/compress.py``.  Before a cross-replica
gradient reduction each leaf is quantized to int8 with a per-tensor
scale; the quantization error is kept in a float32 residual and added back
next step.  With ``axis_name=None`` ``compressed_psum`` is the reference's
local round trip (quantize, dequantize, carry the error).  A named axis is
the reference's ``psum``/``pmax`` over a mesh axis of the installed host
mesh, with one gradient tree a replica.
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
    feedback.  -> (float32 grads, new residual).

    ``axis_name=None``: one tree, the local round trip.  A named axis of
    the installed host mesh (``launch.mesh.ModelMesh`` under
    ``sharding.use_rules``): one controller drives every replica along
    the axis, so ``grads`` and ``residual`` are lists with one tree per
    replica, in the axis's order.  The int8 values are summed as int32
    over the replicas and the scales take their maximum (the reference's
    ``psum`` and ``pmax``); -> (a list of the reduced float32 trees, each
    on its replica's device, the list of the replicas' new residuals)."""
    if axis_name is None:
        q, s, residual = compress(grads, residual)
        return decompress(q, s), residual
    from repro_torch.models.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.shape:
        raise ValueError(f"no installed mesh has the axis {axis_name!r}")
    n = mesh.shape[axis_name]
    if len(grads) != n or len(residual) != n:
        raise ValueError(f"axis {axis_name!r} has {n} replicas: pass one "
                         f"gradient tree and one residual each")
    parts = [compress(g, r) for g, r in zip(grads, residual)]
    home = tree_leaves(grads[0])[0].device if tree_leaves(grads[0]) else None
    q = [tree_leaves(p[0]) for p in parts]
    s = [tree_leaves(p[1]) for p in parts]
    q_sum = [sum(qi[j].to(home, torch.int32) for qi in q)
             for j in range(len(q[0]))]
    s_max = [torch.stack([si[j].to(home) for si in s]).amax()
             for j in range(len(s[0]))]
    dec = tree_unflatten(grads[0], [a.float() * b
                                    for a, b in zip(q_sum, s_max)])
    out = [tree_map(lambda x, like: x.to(like.device), dec, g)
           for g in grads]
    return out, [p[2] for p in parts]
