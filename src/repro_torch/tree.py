"""Pytrees of tensors, walked in the order ``jax.tree_util`` flattens them.

A tree is a nest of dicts (walked by sorted key), NamedTuples (by field),
lists and tuples (by index) over leaves (tensors, numpy arrays, scalars);
``None`` holds no leaf.  The checkpoint format names leaves by these paths,
and the optimiser and the gradient compression walk parameters in this
order, so that sums over leaves (the clip's norm, the byte counts) add in
the reference's order.
"""
from __future__ import annotations

__all__ = ["children", "flatten", "leaves", "tree_map", "unflatten"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node):
    """``(key, child)`` pairs of an inner node in flattening order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs of ``tree`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    kids = children(tree)
    if kids is None:
        return [(path, tree)]
    return [pair for key, child in kids for pair in flatten(child, path + (key,))]


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    return [leaf for _, leaf in flatten(tree)]


def unflatten(template, values):
    """``template``'s structure with its leaves taken in order from the
    iterable ``values``."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        kids = children(node)
        if kids is None:
            return next(it)
        built = [build(child) for _, child in kids]
        if isinstance(node, dict):
            return {key: v for (key, _), v in zip(kids, built)}
        if _is_namedtuple(node):
            return type(node)(*built)
        return type(node)(built)

    return build(template)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``,
    trees of the same structure), in a tree of ``tree``'s structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree), *others)])
