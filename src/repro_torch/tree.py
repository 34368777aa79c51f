"""Trees of tensors in JAX's order — the port's stand-in for ``jax.tree``.

A tree is nested dicts, lists, tuples and NamedTuples with tensors at the
leaves; ``None`` is an empty subtree.  Dict keys are visited sorted and
NamedTuple fields in order, as ``jax.tree_util`` flattens them (another
tuple subclass, such as a ``PartitionSpec``, is a leaf, as in JAX), so
``leaves`` lists a tree's tensors in the reference's order and ``paths``
names them with the reference checkpoint's keys (``.params/layers/0/attn/bk``:
a NamedTuple field as ``.name``, a dict key as itself, a list index as its
number, joined by ``/``).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["paths", "leaves", "tree_map", "map_with_keys", "unflatten"]


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in JAX's order; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if type(node) in (list, tuple):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def paths(tree: Any) -> list[tuple[str, Any]]:
    """(key, leaf) for every leaf, in JAX's flattening order."""
    out: list[tuple[str, Any]] = []

    def walk(prefix: list[str], node: Any) -> None:
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix) or "leaf", node))
            return
        for key, child in kids:
            walk(prefix + [key], child)

    walk([], tree)
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure) → a tree of that structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if type(tree) in (list, tuple):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_keys(fn: Callable, tree: Any) -> Any:
    """``fn(keys, leaf)`` over the leaves of ``tree``, ``keys`` the dict keys
    on the path to the leaf (what ``jax.tree_util.tree_map_with_path``'s
    ``DictKey`` entries carry; list indices and NamedTuple fields are left
    out) → a tree of ``tree``'s structure."""

    def walk(keys: tuple, node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(keys + (k,), node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(walk(keys, getattr(node, f)) for f in node._fields))
        if type(node) in (list, tuple):
            return type(node)(walk(keys, v) for v in node)
        return fn(keys, node)

    return walk((), tree)


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in ``leaves`` order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out
