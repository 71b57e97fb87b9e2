"""Nested containers of tensors (params, optimizer states) as JAX pytrees.

The JAX package's trees are dicts, tuples and NamedTuples of arrays;
``jax.tree_util`` walks a dict in sorted key order and a tuple in field
order, and treats None as an empty node.  These helpers walk the port's
trees the same way, so a tree's leaves come out in the reference's order
(which is what lets a checkpoint written by one package restore into the
other)."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def _children(x) -> List[Any]:
    if x is None:
        return []
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    return list(x)


def _rebuild(like, children):
    if like is None:
        return None
    if isinstance(like, dict):
        return dict(zip(sorted(like), children))
    if hasattr(like, "_fields"):        # NamedTuple
        return type(like)(*children)
    return type(like)(children)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if not _is_node(tree):
        return [tree]
    out: List[Any] = []
    for c in _children(tree):
        out.extend(tree_leaves(c))
    return out


def tree_paths(tree, prefix: tuple = ()) -> List[tuple]:
    """The path of every leaf of ``tree``, in `tree_leaves` order: a dict
    key or a sequence index per level."""
    if not _is_node(tree):
        return [prefix]
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree or ()))
    out: List[tuple] = []
    for k, c in zip(keys, _children(tree)):
        out.extend(tree_paths(c, prefix + (k,)))
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in a tree of that structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(k[i] for k in kids))
                           for i, c in enumerate(_children(tree))])


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
