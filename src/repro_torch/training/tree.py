"""Nested parameter trees: dicts (and tuples, such as ``AdamWState``) of
tensors, the port's stand-in for ``jax.tree``.  Leaves are visited in
sorted-key order, the order ``jax.tree.flatten`` gives a dict."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf: dict keys in sorted order, a named
    tuple's fields by name, joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or \
            [str(i) for i in range(len(tree))]
        return [x for name, v in zip(names, tree)
                for x in tree_paths(v, prefix + (name,))]
    return [("/".join(prefix), tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in :func:`tree_paths` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_paths` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            items = [build(v) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") else \
                tuple(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_unzip(tree: Any, n: int) -> tuple:
    """A dict tree whose leaves are ``n``-tuples as ``n`` dict trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in parts} for i in range(n))
    return tuple(tree)
