"""Leaves of a training pytree in the JAX package's order: dict keys
sorted, tuples (NamedTuples included) in field order, ``None`` holding no
leaf.  The optimizer's global norm and the checkpoint's ``leaf_{i}``
numbering follow it, so both agree with ``jax.tree_util.tree_leaves``."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    out: List[Any] = []
    _walk(tree, out.append)
    return out


def _walk(tree, visit):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], visit)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _walk(t, visit)
    else:
        visit(tree)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in ``leaves`` order."""
    it = iter(new_leaves)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map_tree(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        items = [map_tree(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)
