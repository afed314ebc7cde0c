"""Mixture-of-Experts FFN with the paper's two dispatch disciplines.

Held against ``src/repro/models/moe.py``.  A token routed to its top-k
experts is a multi-key tuple (Theorem 1 at model scale).

* ``dispatch="sn"``: the sort-based dispatch/combine.  Each (token,
  choice) pair is copied into its expert's capacity buffer (duplication =
  top_k), FIFO per expert by a stable sort; pairs past the capacity drop.
* ``dispatch="vsn"``: owner-computes.  Every expert observes the whole
  token block, takes the tokens routed to it (routed first, then in token
  order) up to its capacity, and the partial outputs meet in one sum.  The
  reference runs it as a ``shard_map`` over the model axis: each expert
  shard owns ``E / n`` experts, routes every token over all of them, and
  the shards' partials meet in one bfloat16 sum.  The port runs the same
  shard body over the installed mesh's model axis (``_vsn_moe``), or one
  shard holding every expert without a mesh.

Both count the pairs they drop (``dropped``, never silent); shared experts
(deepseek) are a dense SwiGLU added outside the dispatch.  The capacity of
both is ``max(int(top_k * n * capacity_factor / n_experts), 1)`` over the
``n`` tokens of a routing group: the whole ``[B, S]`` block, as the
reference's ``forward`` routes it, or, with ``per_row``, each batch row
alone, as the reference's serving engine routes each decode lane under its
``vmap``.  The expert products are plain batched matmuls (the reference
computes them outside any Pallas kernel).  Ties in the router's top-k
resolve to the lower expert index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, swiglu
from repro_torch.models.sharding import current_mesh, shard


def init_moe(gen, cfg: ModelConfig, dtype, device=None):
    """Router (float32), per-expert SwiGLU weights ``[E, ...]`` and the
    shared experts' dense SwiGLU, drawn from ``gen`` in that order."""
    m = cfg.moe
    d = cfg.d_model
    dense = lambda shape, dt=dtype: init_dense(gen, shape, dtype=dt,
                                               device=device)
    p = {"router": dense((d, m.n_experts), torch.float32),
         "wg": dense((m.n_experts, d, m.d_ff_expert)),
         "wu": dense((m.n_experts, d, m.d_ff_expert)),
         "wd": dense((m.n_experts, m.d_ff_expert, d))}
    if m.n_shared:
        f = m.d_ff_expert * m.n_shared
        p["shared_wg"] = dense((d, f))
        p["shared_wu"] = dense((d, f))
        p["shared_wd"] = dense((f, d))
    return p


def _route(x, router, top_k: int):
    """``x`` [..., D] -> (weights [..., k] float32, experts [..., k]): a
    float32 softmax, its top k (equal probabilities: lower index first),
    renormalized over the k with a 1e-9 floor."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :top_k], idx[..., :top_k]
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return w, idx


def _expert_ffn(xe, wg, wu, wd):
    """xe [E, C, D] through each expert's SwiGLU."""
    return torch.bmm(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)


def _capacity(cfg: ModelConfig, n: int) -> int:
    m = cfg.moe
    return max(int(m.top_k * n * m.capacity_factor / m.n_experts), 1)


def _per_expert(x, he_rows, cap: int):
    """``[G, E * cap, D]`` rows as ``[E, G * cap, D]`` (one batch a
    expert)."""
    g, _, d = x.shape
    return he_rows.reshape(g, -1, cap, d).transpose(0, 1).reshape(-1, g * cap,
                                                                  d)


def _combine(he, rows, w, idx):
    """The weighted sum of each token's expert outputs, float32: ``he``
    [G, R, D] expert output rows, ``rows`` / ``w`` / ``idx`` [G, n, k]
    each (token, choice)'s row, weight (0 where dropped) and expert.  A
    token's terms are added one at a time in ascending expert order, the
    order of the reference's scatter-add over expert-major rows; no
    atomics, so the card sums in the same order every run."""
    g, n, k = idx.shape
    d = he.shape[-1]
    _, perm = torch.sort(idx, dim=-1)
    rows, w = rows.gather(2, perm), w.gather(2, perm)
    y = torch.zeros((g, n, d), dtype=torch.float32, device=he.device)
    for j in range(k):
        y = y + he.gather(1, rows[:, :, j, None].expand(g, n, d)).float() \
            * w[:, :, j, None]
    return y


def _sn_moe(p, x, cfg: ModelConfig):
    """x [G, n, D]: per group, each (token, choice) pair copied into its
    expert's buffer in token order (stable sort), ``cap`` a expert."""
    m = cfg.moe
    g, n, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = _capacity(cfg, n)
    w, idx = _route(x, p["router"], k)                     # [G, n, k]
    nk = n * k
    flat_e = idx.reshape(g, nk)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=1, stable=True)      # FIFO per expert
    se = flat_e.gather(1, order)
    stok = flat_t[order]
    counts = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, 1) - counts               # exclusive prefix
    pos = torch.arange(nk, device=x.device) - start.gather(1, se)
    keep = pos < cap
    dropped = (nk - keep.sum(1)).to(torch.int32)            # a group
    slot = torch.where(keep, se * cap + pos, e * cap)      # e * cap: dropped
    xe = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe.scatter_(1, slot[..., None].expand(g, nk, d),
                x.gather(1, stok[..., None].expand(g, nk, d)))
    xe = shard(_per_expert(x, xe[:, :e * cap], cap), "experts", None,
               "embed")
    he = _expert_ffn(xe, p["wg"], p["wu"], p["wd"])        # [E, G * cap, D]
    he = shard(he, "experts", None, "embed")
    he = he.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    # each pair's row and keep flag, back in (token, choice) order
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    pair_keep = torch.empty_like(keep).scatter_(1, order, keep)
    y = _combine(he, pair_slot.clamp(max=e * cap - 1).reshape(g, n, k),
                 w * pair_keep.reshape(g, n, k), idx)
    return y.to(x.dtype), dropped


def _vsn_shard(x, router, wg, wu, wd, cfg: ModelConfig, lo: int):
    """The reference's ``_vsn_body`` for one expert shard: x [G, n, D]
    (every expert shard observes the whole token block), ``wg``/``wu``/
    ``wd`` the shard's ``[E_loc, ...]`` experts, global ids ``[lo, lo +
    E_loc)``.  Every token routes over all ``n_experts`` (global top-k);
    each of the shard's experts takes the first ``cap`` tokens routed to
    it (a stable sort of ``~hit``: routed first, in token order), ``cap``
    counted over the global ``n_experts``.  -> (the shard's partial output
    summed in float32 and rounded to bfloat16 [G, n, D], its pairs
    dropped [G])."""
    m = cfg.moe
    g, n, d = x.shape
    e_loc = wg.shape[0]
    cap = _capacity(cfg, n)
    w, idx = _route(x, router, m.top_k)                    # [G, n, k] global
    if e_loc == m.n_experts:                               # one shard
        local, sel = None, idx
        hit = F.one_hot(idx, e_loc).sum(dim=2).transpose(1, 2) > 0
    else:
        local = (idx >= lo) & (idx < lo + e_loc)
        sel = torch.where(local, idx - lo, e_loc)          # e_loc: elsewhere
        hit = F.one_hot(sel, e_loc + 1)[..., :e_loc].sum(dim=2).transpose(
            1, 2) > 0                                      # [G, E_loc, n]
    order = torch.argsort((~hit).to(torch.uint8), dim=2, stable=True)
    take = order[..., :cap]                                # [G, E_loc, C]
    c = take.shape[-1]
    took = hit.gather(2, take)
    dropped = (hit.sum((1, 2)) - took.sum((1, 2))).to(torch.int32)
    rows = take.reshape(g, e_loc * c)
    xe = x.gather(1, rows[..., None].expand(g, e_loc * c, d)) * took.reshape(
        g, e_loc * c, 1).to(x.dtype)
    he = _expert_ffn(_per_expert(x, xe, c), wg, wu, wd)
    he = he.reshape(e_loc, g, c, d).transpose(0, 1).reshape(g, e_loc * c, d)
    # where each token sits in each expert's buffer (-1: not taken)
    at = torch.full((g, e_loc, n), -1, dtype=torch.int64, device=x.device)
    at.scatter_(2, take, torch.where(took, torch.arange(
        c, device=x.device).expand(g, e_loc, c), -1))
    loc = sel if local is None else sel.clamp(max=e_loc - 1)
    pos = at.gather(1, loc.transpose(1, 2)).transpose(1, 2)  # [G, n, k]
    if local is not None:
        pos = torch.where(local, pos, -1)
    y = _combine(he, loc * c + pos.clamp(min=0), w * (pos >= 0), idx)
    return y.to(torch.bfloat16), dropped


def _on(t, dev, lo=None, n=None):
    """``t[lo:lo + n]`` (or ``t``) on ``dev``: a view where ``t`` lies
    there, else a copy made once and kept on ``t`` (an attribute, so it
    lives as long as the weight)."""
    part = t if lo is None else t[lo:lo + n]
    if part.device == dev:
        return part
    copies = t.__dict__.setdefault("_shard_copies", {})
    key = (dev, lo, n)
    if key not in copies:
        copies[key] = part.to(dev)
    return copies[key]


def _vsn_moe(p, x, cfg: ModelConfig, n_shards=None):
    """x [G, n, D] over the model axis's expert shards.  ``n_shards``
    given: that many shards, all on x's device.  Else the installed mesh
    decides: none, one shard; a host mesh (``launch.mesh.ModelMesh``),
    its ``model`` shards, shard j on the devices of column j, its
    ``data`` rows splitting the n tokens into contiguous blocks as the
    reference's ``P(dp)`` does; a placeholder mesh, ``_vsn_placeholder``.
    The shards' bfloat16 partials meet on x's device in one sum, added in
    shard order with each addition rounded to bfloat16: XLA's order and
    precision for the reference's ``psum`` of bfloat16 over the axis.
    ``dropped`` is summed over the shards."""
    mesh = current_mesh() if n_shards is None else None
    if getattr(mesh, "device_mesh", None) is not None:
        return _vsn_placeholder(p, x, cfg, mesh)
    grid = (mesh.devices if mesh is not None
            else ((x.device,) * (n_shards or 1),))
    n_model = len(grid[0])
    e = cfg.moe.n_experts
    if e % n_model:
        raise ValueError(f"{e} experts do not split over {n_model} shards")
    e_loc = e // n_model
    g, n, d = x.shape
    if n % len(grid):
        raise ValueError(f"{n} tokens do not split over {len(grid)} data "
                         f"shards")
    blk = n // len(grid)
    ys, dropped = [], None
    for i, devs in enumerate(grid):
        xi = x[:, i * blk:(i + 1) * blk]
        y = None
        for j, dev in enumerate(devs):
            lo = j * e_loc
            part, drop = _vsn_shard(
                xi.to(dev), _on(p["router"], dev),
                *(_on(p[k], dev, lo, e_loc) for k in ("wg", "wu", "wd")),
                cfg, lo)
            part = part.to(x.device)
            y = part if y is None else y + part
            drop = drop.to(x.device)
            dropped = drop if dropped is None else dropped + drop
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.to(x.dtype), dropped


def _vsn_placeholder(p, x, cfg: ModelConfig, mesh):
    """The reference's ``shard_map`` over a placeholder mesh: the shard
    body under ``local_map`` with the experts ``Shard(0)`` over "model"
    and x's token block replicated over it; each shard's bfloat16 partial
    leaves as ``Partial`` over "model" and is all-reduced in bfloat16
    (the one collective), ``dropped`` likewise."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = mesh.device_mesh
    axes = mesh.axis_names
    n_model = mesh.shape["model"]
    e_loc = cfg.moe.n_experts // n_model
    lo = dm.get_local_rank("model") * e_loc
    e_pl = [Shard(0) if a == "model" else Replicate() for a in axes]
    rep = [Replicate()] * len(axes)
    x_pl = list(x.placements)
    y_pl = [Partial() if a == "model" else pl for a, pl in zip(axes, x_pl)]
    # each data block drops its own pairs: their total is a sum over data
    d_pl = [Partial() if isinstance(pl, Shard) or a == "model" else pl
            for a, pl in zip(axes, x_pl)]
    body = local_map(
        lambda xl, r, wg, wu, wd: _vsn_shard(xl, r, wg, wu, wd, cfg, lo),
        out_placements=(y_pl, d_pl),
        in_placements=(x_pl, rep, e_pl, e_pl, e_pl), device_mesh=dm)
    y, dropped = body(x, p["router"], p["wg"], p["wu"], p["wd"])
    y = y.redistribute(dm, x_pl)
    return y.to(x.dtype), dropped


def moe_forward(p, x, cfg: ModelConfig, *, per_row: bool = False,
                live=None, n_shards: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], dropped: int32 pairs dropped).

    ``per_row`` routes each batch row as a group of its own (capacity per
    row); otherwise the B * S tokens form one group.  ``live`` (bool [B],
    with ``per_row``) names the rows whose drops count: the serving
    engine's pad rows route too, but drop nothing of a request.
    ``n_shards`` is the expert-axis width of ``dispatch="vsn"``: None
    takes the installed mesh's ``model`` axis (one shard without a mesh),
    a number that many shards on x's device."""
    b, s, d = x.shape
    m = cfg.moe
    if m.dispatch == "vsn":
        # the reference's shard_map takes the tokens as P(dp, None): each
        # data shard's block, whole over "model"
        x = shard(x, "batch", None, None)
    xg = x.reshape((b, s, d) if per_row else (1, b * s, d))
    if m.dispatch == "sn":
        y, dropped = _sn_moe(p, xg, cfg)
    elif m.dispatch == "vsn":
        y, dropped = _vsn_moe(p, xg, cfg, n_shards)
    else:
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}")
    if live is not None:
        if not per_row:
            raise ValueError("live names rows: it needs per_row")
        dropped = torch.where(live, dropped, 0)
    dropped = dropped.sum(dtype=torch.int32)
    y = y.reshape(b * s, d)
    if m.n_shared:
        y = y + swiglu(x.reshape(b * s, d), p["shared_wg"], p["shared_wu"],
                       p["shared_wd"])
    return y.reshape(b, s, d), dropped
