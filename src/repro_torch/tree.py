"""Structure maps over the port's state containers (stands in for ``jax.tree``).

A tree is a dataclass, a dict, a tuple, NamedTuple or list, or a leaf (a
tensor or anything else).  ``tree_leaves`` and ``tree_unflatten`` walk
the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")  # NamedTuple
                else type(tree)(items))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in ``tree_leaves``'
    order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
