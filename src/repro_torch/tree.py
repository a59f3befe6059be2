"""Parameter trees of the port: the counterpart of the reference's pytrees.

A tree is nested dicts, lists, tuples and NamedTuples of tensors (or numpy
arrays); ``None`` is an empty subtree and anything else is a leaf.  A leaf's
path is the tuple of dict keys, NamedTuple field names and list indices
that lead to it.  :func:`tree_leaves_with_path` visits dict keys in sorted
order, as jax flattens them, so leaf lists line up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any
Path = Tuple[str, ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       path: Path = ()) -> PyTree:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, rebuilding its structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, *xs, path=path + (name,))
                            for name, *xs in zip(tree._fields, tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, *xs, path=path + (str(i),))
                          for i, xs in enumerate(zip(tree, *rest)))
    return fn(path, tree, *rest)


def map_dicts(fn: Callable, node: PyTree, path: Path = ()) -> PyTree:
    """``node`` rebuilt top-down by ``fn(dict, path)``, which returns the
    dict's replacement, or None to recurse into it; dicts and lists are
    walked (list indices enter the path as strings), every other node is
    kept.  The walk for rewriting whole subtrees, such as a PEFT linear,
    where :func:`tree_map_with_path` rewrites leaves."""
    if isinstance(node, dict):
        out = fn(node, path)
        if out is not None:
            return out
        return {k: map_dicts(fn, v, path + (str(k),))
                for k, v in node.items()}
    if isinstance(node, list):
        return [map_dicts(fn, v, path + (str(i),))
                for i, v in enumerate(node)]
    return node


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); ``None`` stays ``None``."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_leaves_with_path(tree: PyTree, path: Path = ()
                          ) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [x for name, v in zip(tree._fields, tree)
                for x in tree_leaves_with_path(v, path + (name,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (str(i),))]
    return [(path, tree)]


def tree_leaves(tree: PyTree) -> List[Any]:
    """Leaves in the reference's flattening order (dict keys sorted)."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def stack_filled(n: int, one: Callable[[int], dict]) -> dict:
    """``one(i)``'s flat dict of tensors for ``i < n``, stacked on a new
    leading axis into outputs allocated once from ``one(0)`` and filled in
    place: no list of parts and no second copy (an expert stack's fp32
    intermediates are too large to hold twice)."""
    first = one(0)
    out = {k: v.new_empty((n,) + tuple(v.shape)) for k, v in first.items()}
    for i in range(n):
        part = first if i == 0 else one(i)
        for k, v in part.items():
            out[k][i].copy_(v)
        del part
    return out
