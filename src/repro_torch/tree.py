"""Parameter trees without jax: the dicts, lists, tuples and NamedTuples the
reference's ``jax.tree`` functions walk.  Dict leaves are visited in sorted
key order, as jax flattens them; ``None`` is an empty node."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``tree`` rebuilt with each leaf ``x`` replaced by ``fn(x, *others)``,
    ``others`` the leaves of ``rest`` at the same place (each of ``tree``'s
    structure down to its leaves); ``fn`` meets the leaves in
    ``tree_leaves`` order."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's order (``jax.tree.leaves``)."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
