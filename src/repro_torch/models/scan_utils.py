"""Memory-bounded sequential scans (gradient checkpointing over time).

Held against ``src/repro/models/scan_utils.py``.  ``chunked_scan(f,
init, xs, chunk=C)`` is ``lax.scan(f, init, xs)`` run as T / C chunks, each
under non-reentrant ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of a chunk): the backward keeps one carry a chunk and
recomputes the chunk's steps, O(T / C + C) saved states instead of O(T).
The scan itself is a Python loop over the steps.  No port model calls it:
the RWKV and SSM recurrences run through the ``linear_scan`` kernel and
its backward kernel; it is here for a user's own recurrence.

A tree is a tensor, a tuple/list or a dict of them; ``f(carry, x) ->
(carry, y)`` with ``x`` the leaves of ``xs`` at one step, and ``ys`` comes
back stacked to ``[T, ...]``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.tree import tree_leaves, tree_map


def scan(f: Callable, init, xs):
    """``lax.scan`` as a Python loop: -> (carry, ys stacked on axis 0)."""
    t = tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(t):
        carry, y = f(carry, tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys:
        return carry, None
    return carry, tree_map(lambda *parts: torch.stack(parts), *ys)


def chunked_scan(f: Callable, init, xs, *, chunk: int, remat: bool = True):
    """Like ``scan(f, init, xs)`` with remat-per-chunk backward.

    xs leaves: [T, ...]; T % chunk == 0.  Returns (carry, ys) with ys
    stacked back to [T, ...]."""
    t = tree_leaves(xs)[0].shape[0]
    if chunk >= t:
        return scan(f, init, xs)
    assert t % chunk == 0, (t, chunk)
    n = t // chunk
    xs_c = tree_map(lambda a: a.reshape((n, chunk) + tuple(a.shape[1:])), xs)

    def run_chunk(carry, xc):
        return scan(f, carry, xc)

    if remat:
        plain = run_chunk

        def run_chunk(carry, xc):
            return torch.utils.checkpoint.checkpoint(
                plain, carry, xc, use_reentrant=False)

    carry, ys = scan(run_chunk, init, xs_c)
    ys = tree_map(lambda a: a.reshape((t,) + tuple(a.shape[2:])), ys)
    return carry, ys
