"""Walkers over the port's trees: nested dicts, lists and tuples with
tensors (or ``None``, or any other value) at the leaves.

Parameter, gradient, optimizer-state and cache trees are plain nested
containers, as in the reference, where ``jax.tree_util`` walks them. Most
are dicts; a hybrid model (RecurrentGemma) keeps the blocks past its last
whole pattern period as a *list*, ``params["tail"]``. Every module that
walks such a tree does it through these functions, so dicts and lists are
taken alike everywhere. A path is a tuple of keys: a dict's key or a
list's index. Traversal follows the dicts' insertion order unless
``sort`` asks for sorted keys (the reference's flatten order).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def children(tree, sort: bool = False) -> List[Tuple[Any, Any]]:
    """[(key, child)] of a dict (keys sorted with ``sort``) or a list/tuple
    (indices)."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else tree
        return [(k, tree[k]) for k in keys]
    return list(enumerate(tree))


def _child(tree, key):
    """``tree[key]`` where ``tree`` is a node, else None (a None or a leaf
    where another tree has a node stands for a tree of Nones)."""
    return tree[key] if is_node(tree) else None


def _rebuild(tree, items):
    if isinstance(tree, dict):
        return dict(items)
    return type(tree)(v for _, v in items)


def tree_map_with_path(f: Callable, tree, *rest, path: tuple = ()):
    """``f(path, leaf, *rest_leaves)`` over the leaves of ``tree``, with its
    nesting; ``rest`` are trees of the same nesting (or None)."""
    if is_node(tree):
        return _rebuild(tree, [
            (k, tree_map_with_path(f, v, *(_child(r, k) for r in rest),
                                   path=path + (k,)))
            for k, v in children(tree)])
    return f(path, tree, *rest)


def tree_map(f: Callable, tree, *rest):
    """``f(leaf, *rest_leaves)`` over the leaves of ``tree``, with its
    nesting; ``rest`` are trees of the same nesting (or None)."""
    return tree_map_with_path(lambda _, *leaves: f(*leaves), tree, *rest)


def _walk(tree, path, sort) -> Iterator[Tuple[tuple, Any]]:
    if is_node(tree):
        for k, v in children(tree, sort):
            yield from _walk(v, path + (k,), sort)
    else:
        yield path, tree


def leaves_with_paths(tree, *, sort: bool = False,
                      keep_none: bool = False) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in traversal order; None leaves skipped unless
    ``keep_none``."""
    return [(p, x) for p, x in _walk(tree, (), sort)
            if keep_none or x is not None]


def tree_leaves(tree, *, sort: bool = False, keep_none: bool = False):
    """The leaves of ``tree`` in traversal order (see
    :func:`leaves_with_paths`)."""
    return [x for _, x in leaves_with_paths(tree, sort=sort,
                                            keep_none=keep_none)]


def unflatten(tree, leaves, *, sort: bool = False):
    """``tree``'s nesting with its non-None leaves replaced, in
    :func:`tree_leaves` order (with the same ``sort``), by ``leaves``."""
    it = iter(leaves)

    def fill(t):
        if is_node(t):
            items = [(k, fill(v)) for k, v in children(t, sort)]
            if isinstance(t, dict):
                return {k: dict(items)[k] for k in t}
            return type(t)(v for _, v in items)
        return None if t is None else next(it)

    return fill(tree)


def path_str(path: tuple) -> str:
    """A path as ``"k1/k2/0/..."``."""
    return "/".join(str(k) for k in path)
