"""Trees of tensors: the port's parameter, gradient and moment trees.

A tree is a tensor, or a dict or list of trees (the port's parameters are
dicts with a list of per-layer dicts under ``layers``).  These helpers play
the part of ``jax.tree_util`` for the model and the training code; leaves
come in the dicts' insertion order.
"""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of the leaves at the same place in ``tree`` and each of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out
