"""Sharding annotations, decoupled from model code.

Held against ``src/repro/models/sharding.py``.  Model code calls
``shard(x, "batch", "seq", None)`` with *logical* axis names; a run
installs a mesh and logical->mesh rules (MaxText-style) with
``use_rules``.  Without an installed mesh the calls return their input,
so the same model runs on one device unchanged.

A spec (``PartitionSpec``, ``P``) is a tuple with one entry per dimension:
``None``, a mesh axis name, or a tuple of axis names, as a ``jax``
``PartitionSpec`` holds.  Two kinds of mesh are installed
(``launch/mesh.py``):

* a host mesh (``ModelMesh``): a ``(data, model)`` grid of real devices
  driven by one process.  ``shard`` returns its input: values are the
  same under any layout, as under GSPMD, and the one place the layout
  changes the computation, the ``vsn`` MoE's expert shards, reads the
  mesh itself (``models/moe.py``).
* a placeholder mesh (``ProductionMesh``): a ``DeviceMesh`` over a fake
  process group, which only the dry-run traces against with meta
  ``DTensor``s.  ``shard`` there is ``DTensor.redistribute`` to the
  resolved placements, the counterpart of ``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

_state = threading.local()

# default logical -> mesh-axis rules; pod is folded into data-parallel.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,            # long-context decode shards the KV timeline
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": "model",            # flattened H*Dh projection dim
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "vocab": "model",
    "state": "model",          # rwkv/ssm recurrent state channels
    "layers": None,
    "opt": "data",             # ZeRO-1 optimizer-state sharding axis
}


class PartitionSpec(tuple):
    """One entry per dimension: None, an axis name or a tuple of names (a
    tuple of one name is that name, as ``jax``'s ``PartitionSpec``
    holds it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: object
    spec: PartitionSpec


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[dict] = None):
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev
        if prev[1] is None:
            del _state.rules


def resolve(*logical: Optional[str]) -> PartitionSpec:
    """Logical axis names -> PartitionSpec under the current rules."""
    rules = current_rules()
    mesh = current_mesh()
    names = set(mesh.axis_names) if mesh is not None else set()
    out = []
    for ax in logical:
        r = rules.get(ax) if ax is not None else None
        if r is None:
            out.append(None)
        elif isinstance(r, tuple):
            keep = tuple(a for a in r if a in names)
            out.append(keep if keep else None)
        else:
            out.append(r if r in names else None)
    return P(*out)


def placements(mesh, spec, ndim: int) -> list:
    """``spec`` as DTensor placements over a placeholder mesh: ``Shard(i)``
    on each mesh axis that dimension i names (the names of one entry in
    their order, major first), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for i, ax in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[mesh.axis_names.index(a)] = Shard(i)
    return out


def shard(x, *logical: Optional[str]):
    """The layout constraint under the installed mesh (``x`` itself
    otherwise).

    A spec that resolves to all-None is treated as *no opinion* rather than
    "replicate": forcing replication on activations whose producer left
    them usefully sharded inserts giant all-gathers.  Under a host mesh the
    values do not depend on the layout, so ``x`` comes back as it is;
    under a placeholder mesh a ``DTensor`` is redistributed.  There a
    dimension that its axes do not divide (batch 1 over "data") is left
    as it is: GSPMD pads such a dimension, a ``DTensor`` would shard it
    unevenly, which its views cannot reshape."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = resolve(*logical)
    if all(ax is None for ax in spec):
        return x
    dm = getattr(mesh, "device_mesh", None)
    if dm is None or not hasattr(x, "redistribute"):
        return x
    return x.redistribute(dm, placements(mesh, _fit(mesh, spec, x.shape),
                                         x.dim()))


def _fit(mesh, spec, shape) -> list:
    """``spec`` with each entry whose axes do not divide its dimension
    dropped."""
    out = []
    for dim, ax in zip(shape, spec):
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= 1 if a is None else mesh.shape[a]
        out.append(ax if dim % size == 0 else None)
    return out


def _split(t, dim: int):
    """How the ``DTensor`` ``t`` splits ``dim``: (a flag a mesh axis, True
    where it shards ``dim``; the number of pieces; this shard's piece,
    the mesh axes major first)."""
    from torch.distributed.tensor import Shard
    dm = t.device_mesh
    flags = [isinstance(p, Shard) and p.dim == dim % t.dim()
             for p in t.placements]
    ways, piece = 1, 0
    for d, hit in enumerate(flags):
        if hit:
            ways *= dm.shape[d]
            piece = piece * dm.shape[d] + dm.get_local_rank(d)
    return flags, ways, piece


def split_heads(t, n_heads: int, head_dim: int):
    """``t`` ``[..., n_heads * head_dim]`` as ``[..., n_heads, head_dim]``.
    A ``DTensor`` whose last dimension is sharded over more shards than
    divide ``n_heads`` (qwen3-14b's 40 heads over 16) is gathered along it
    first: GSPMD reshards such a projection, a ``DTensor`` view cannot
    split it."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate
        last, ways, _ = _split(t, -1)
        if n_heads % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if hit else p
                for hit, p in zip(last, t.placements)])
    return t.view(*t.shape[:-1], n_heads, head_dim)


def merge_heads(t):
    """``t`` ``[..., H, n]`` as ``[..., H * n]``, ``split_heads``'
    inverse.  A ``DTensor`` is first gathered along a head dimension
    sharded unevenly or a sharded last dimension (a view cannot merge
    them), and the merged layout is pinned (redistributed to itself), so
    a gradient that arrives sharded along the merged dimension (a
    row-parallel product's) is gathered to it before the view's backward
    splits the heads."""
    if not hasattr(t, "device_mesh"):
        return t.reshape(*t.shape[:-2], -1)
    from torch.distributed.tensor import Replicate
    heads, ways, _ = _split(t, -2)
    last, _, _ = _split(t, -1)
    uneven = t.shape[-2] % ways != 0
    pl = [Replicate() if b or (h and uneven) else p
          for h, b, p in zip(heads, last, t.placements)]
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    out = t.reshape(*t.shape[:-2], -1)
    return out.redistribute(out.device_mesh, list(out.placements))


def local_blocks(fn, args, specs, out_specs):
    """``fn(*args)``; under a placeholder mesh once a shard on its local
    blocks (``local_map``), as a kernel runs: ``specs[i]`` names the
    logical axes of ``args[i]``'s leading dimensions (the rest are
    whole), ``out_specs`` those of the outputs (whose leading dimensions
    are ``args[0]``'s); each is resolved under the current rules and
    fitted to the tensor's shape.  A plain tensor argument is placed by
    its spec first.  The scans' call sites (rwkv's time mix, the SSM)
    run ``linear_scan`` through it, so the kernel sees local rows only;
    an attention kernel's call is split by ``attention_blocks``."""
    mesh = current_mesh()
    dm = getattr(mesh, "device_mesh", None)
    if dm is None or not any(hasattr(a, "device_mesh") for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    def fit(spec, shape):
        return placements(mesh, _fit(mesh, resolve(*spec), shape),
                          len(shape))
    in_pl = [None if a is None else fit(s, a.shape)
             for a, s in zip(args, specs)]
    args = [a if a is None else _placed(a, dm, pl)
            for a, pl in zip(args, in_pl)]
    out_pl = tuple(fit(s, args[0].shape[:len(s)]) for s in out_specs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     device_mesh=dm, redistribute_inputs=True)(*args)


def sharded_rows(table, idx):
    """``table[idx]``.  For a ``DTensor`` ``table`` sharded along its rows
    (a vocab-sharded embedding), under ``local_map`` each shard takes the
    ids in its block of rows and zeros the others, the output partial
    (summed) over the mesh axes that split the rows, as GSPMD partitions a
    gather from a sharded operand, where a ``DTensor`` would gather the
    table; ``idx`` keeps its placements."""
    if not hasattr(table, "device_mesh"):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = table.device_mesh
    rows, ways, piece = _split(table, 0)
    lo = piece * -(-table.shape[0] // ways)
    if not hasattr(idx, "device_mesh"):
        idx = _placed(idx, dm, [Replicate()] * dm.ndim)
    idx_pl = list(idx.placements)

    def body(i, t):
        local = i.long() - lo
        keep = (local >= 0) & (local < t.shape[0])
        return t[local.clamp(0, t.shape[0] - 1)] * keep[..., None].to(
            t.dtype)
    out_pl = [Partial() if hit else p for hit, p in zip(rows, idx_pl)]
    return local_map(body, out_placements=out_pl,
                     in_placements=(idx_pl, list(table.placements)),
                     device_mesh=dm)(idx, table)


def sharded_logprob(x, labels):
    """``log_softmax(x)`` at ``labels`` (``[..., 1]``) for float32 logits
    ``x``.  For a ``DTensor`` sharded along its last dimension (the
    vocab), under ``local_map`` each shard sums ``exp(x - m)`` over its
    block and picks the labels in it, both partial over the axes that
    split the vocab, so the softmax reduces with ``[..., 1]``-sized
    collectives (m is the detached maximum over the vocab), as GSPMD
    partitions the reference's; a ``DTensor`` ``log_softmax`` would
    gather the vocab and its backward would hold the whole vocab a
    device."""
    if not hasattr(x, "device_mesh"):
        return torch.log_softmax(x, dim=-1).gather(-1, labels)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = x.device_mesh
    split, ways, piece = _split(x, -1)
    lo = piece * -(-x.shape[-1] // ways)
    rows = [Replicate() if hit else p for hit, p in zip(split, x.placements)]
    m = x.amax(-1, keepdim=True).detach().redistribute(dm, rows)
    labels = _placed(labels, dm, rows)

    def body(xl, lab, ml):
        n = xl.shape[-1]
        local = lab.long() - lo
        keep = (local >= 0) & (local < n)
        pick = xl.gather(-1, local.clamp(0, n - 1)) * keep.to(xl.dtype)
        return (xl - ml).exp().sum(-1, keepdim=True), pick
    part = [Partial() if hit else p for hit, p in zip(split, rows)]
    sumexp, pick = local_map(body, out_placements=(part, part),
                             in_placements=(list(x.placements), rows, rows),
                             device_mesh=dm)(x, labels, m)
    return pick - (m + sumexp.log())


def write_positions(c, rows, pos, new, kv_index):
    """``c[rows, pos] = new`` in place (the reference's
    ``dynamic_update_slice`` of a cache).  A ``DTensor`` cache may be
    sharded along its timeline, where an indexed write has no sharding
    rule: each new position is written as an elementwise select over the
    timeline, which every shard does locally, as GSPMD partitions the
    update."""
    if not hasattr(c, "device_mesh"):
        c[rows, pos] = new.to(c.dtype)
        return
    if kv_index is not None:
        raise NotImplementedError("a slot pool (lanes) over a placeholder "
                                  "mesh")
    t = torch.arange(c.shape[1], device=c.device)
    for i in range(pos.shape[1]):
        hit = (pos[:, i, None] == t)[:, :, None, None]     # [B, S_kv, 1, 1]
        c.copy_(torch.where(hit, new[:, i:i + 1].to(c.dtype), c))


def attention_blocks(fn, args, kwargs):
    """``fn(*args, **kwargs)``, an attention kernel's call (q, k, v, then
    o, dO in the backward; ``[B, H, S, D]``).  On ``DTensor``s it runs as
    the card runs it: once a shard under ``local_map``, each shard
    holding whole (batch row, head) blocks, as a Pallas call runs under
    ``shard_map``.  The batch axis keeps q's sharding; the head axis keeps
    it where q's and k's heads are sharded alike and evenly, else it is
    gathered.  Per-row index vectors (``q_offset``, ``kv_index``) follow
    the batch.  A decode whose cache is sharded along its timeline
    (``kv_seq``) runs the plain version as ``DTensor`` operations
    instead, its heads gathered (one query row each): the reference's
    ``decode_attention`` there reduces its softmax with scalar-sized
    collectives rather than gather the cache."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map

    q, k = args[0], args[1]
    if not isinstance(q, DTensor):
        return fn(*args, **kwargs)
    dm = q.device_mesh
    if any(isinstance(p, Shard) and p.dim == 2 for p in k.placements):
        whole = lambda t: t.redistribute(dm, [
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in t.placements])
        return fn(*(whole(t) for t in args), **kwargs)
    sizes = dm.shape

    def dims01(t, heads):
        return [p if isinstance(p, Shard) and (p.dim == 0 or (
            p.dim == 1 and heads)) else Replicate() for p in t.placements]
    heads = list(q.placements) == list(k.placements) and all(
        q.shape[1] % n == 0 and k.shape[1] % n == 0
        for p, n in zip(q.placements, sizes)
        if isinstance(p, Shard) and p.dim == 1)
    q_pl, k_pl = dims01(q, heads), dims01(k, heads)
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in q_pl]
    names = [n for n, v in kwargs.items()
             if isinstance(v, torch.Tensor) and v.dim() == 1
             and v.shape[0] == q.shape[0]]
    dist = lambda v: v if isinstance(v, DTensor) else distribute_tensor(
        v, dm, row_pl)
    tensors = list(args) + [dist(kwargs[n]) for n in names]
    n_args = len(args)
    in_pl = tuple(q_pl if i == 0 or (n_args == 5 and i in (3, 4)) else
                  k_pl if i < n_args else row_pl
                  for i in range(len(tensors)))
    rest = {n: v for n, v in kwargs.items() if n not in names}
    lse = rest.get("return_lse", False)
    out_pl = ((q_pl, k_pl, k_pl) if n_args == 5 else
              (q_pl, q_pl) if lse else q_pl)

    def body(*ts):
        return fn(*ts[:n_args], **rest, **dict(zip(names, ts[n_args:])))
    return local_map(body, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=dm, redistribute_inputs=True)(*tensors)


def _placed(t, dm, pl):
    """``t`` as a ``DTensor`` with placements ``pl`` (a plain tensor is
    distributed, a ``DTensor`` redistributed)."""
    from torch.distributed.tensor import distribute_tensor
    if hasattr(t, "device_mesh"):
        return t.redistribute(dm, pl)
    return distribute_tensor(t, dm, pl)


def axis_resolves(logical: str) -> bool:
    """True if this logical axis maps to a real mesh axis under the
    current rules (lets model code skip constraints that would otherwise
    force replication)."""
    if current_mesh() is None:
        return False
    return resolve(logical)[0] is not None


def named_sharding(*logical: Optional[str]) -> Optional[NamedSharding]:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve(*logical))
