"""Mixture-of-Experts FFN with the paper's two dispatch disciplines.

Held against ``src/repro/models/moe.py``.  A token routed to its top-k
experts is a multi-key tuple (Theorem 1 at model scale).

* ``dispatch="sn"``: the sort-based dispatch/combine.  Each (token,
  choice) pair is copied into its expert's capacity buffer (duplication =
  top_k), FIFO per expert by a stable sort; pairs past the capacity drop.
* ``dispatch="vsn"``: owner-computes.  Every expert observes the whole
  token block, takes the tokens routed to it (routed first, then in token
  order) up to its capacity, and the partial outputs meet in one sum.  The
  reference runs it as a ``shard_map`` over the model axis; on one device
  that is one shard holding every expert, which is what is ported here.
  More than one shard waits for the model mesh (ROADMAP.md queue 1 item 10).

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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, swiglu


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
    he = _expert_ffn(_per_expert(x, xe[:, :e * cap], cap), p["wg"], p["wu"],
                     p["wd"])                              # [E, G * cap, D]
    he = he.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    # each pair's row and keep flag, back in (token, choice) order
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    pair_keep = torch.empty_like(keep).scatter_(1, order, keep)
    y = _combine(he, pair_slot.clamp(max=e * cap - 1).reshape(g, n, k),
                 w * pair_keep.reshape(g, n, k), idx)
    return y.to(x.dtype), dropped


def _vsn_moe(p, x, cfg: ModelConfig):
    """x [G, n, D]: the reference's ``_vsn_body`` with one shard holding
    all experts.  Each expert takes the first ``cap`` tokens routed to it
    (a stable sort of ``~hit``: routed first, in token order), the partial
    outputs are summed in float32 and rounded to bfloat16, the reference's
    dtype for its cross-shard sum (a no-op sum with one shard)."""
    m = cfg.moe
    g, n, d = x.shape
    e = m.n_experts
    cap = _capacity(cfg, n)
    w, idx = _route(x, p["router"], m.top_k)               # [G, n, k]
    hit = F.one_hot(idx, e).sum(dim=2).transpose(1, 2) > 0  # [G, E, n]
    order = torch.argsort((~hit).to(torch.uint8), dim=2, stable=True)
    take = order[..., :cap]                                # [G, E, C]
    c = take.shape[-1]
    took = hit.gather(2, take)
    dropped = (hit.sum((1, 2)) - took.sum((1, 2))).to(torch.int32)
    rows = take.reshape(g, e * c)
    xe = x.gather(1, rows[..., None].expand(g, e * c, d)) * took.reshape(
        g, e * c, 1).to(x.dtype)
    he = _expert_ffn(_per_expert(x, xe, c), p["wg"], p["wu"], p["wd"])
    he = he.reshape(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
    # where each token sits in each expert's buffer (-1: not taken)
    at = torch.full((g, e, n), -1, dtype=torch.int64, device=x.device)
    at.scatter_(2, take, torch.where(took, torch.arange(
        c, device=x.device).expand(g, e, c), -1))
    pos = at.gather(1, idx.transpose(1, 2)).transpose(1, 2)  # [G, n, k]
    y = _combine(he, idx * c + pos.clamp(min=0), w * (pos >= 0), idx)
    return y.to(torch.bfloat16).to(x.dtype), dropped


def moe_forward(p, x, cfg: ModelConfig, *, per_row: bool = False,
                live=None, n_shards: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], dropped: int32 pairs dropped).

    ``per_row`` routes each batch row as a group of its own (capacity per
    row); otherwise the B * S tokens form one group.  ``live`` (bool [B],
    with ``per_row``) names the rows whose drops count: the serving
    engine's pad rows route too, but drop nothing of a request.
    ``n_shards`` is the expert-axis width of ``dispatch="vsn"``; only 1 is
    ported."""
    b, s, d = x.shape
    m = cfg.moe
    if m.dispatch == "vsn" and n_shards != 1:
        raise NotImplementedError(
            f"dispatch='vsn' over {n_shards} expert shards needs the model "
            f"mesh, ROADMAP.md queue 1 item 10; the port runs one shard")
    xg = x.reshape((b, s, d) if per_row else (1, b * s, d))
    if m.dispatch == "sn":
        y, dropped = _sn_moe(p, xg, cfg)
    elif m.dispatch == "vsn":
        y, dropped = _vsn_moe(p, xg, cfg)
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
