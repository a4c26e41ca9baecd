"""Nested containers of tensors (pytrees), shared by the models, the
training plane and gradient compression.

A tree is a dict, list, tuple or NamedTuple of subtrees; ``None`` is an
empty subtree and anything else is a leaf, as ``jax.tree`` treats them.
Dict keys are visited in sorted order, so leaves come out in the
reference's order (``jax.tree.leaves`` sorts them) and sums over leaves
(``optimizer.global_norm``) add in the same order.  Rebuilt dicts hold
their keys sorted, as JAX's do.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(node) -> list | None:
    """``[(key, child), ...]`` of a container, ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _make(node, keys: list, values: list):
    if isinstance(node, dict):
        return dict(zip(keys, values))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def leaves_with_paths(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf; a path holds dict keys, NamedTuple
    field names and sequence indices from the root down."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, child in kids:
        yield from leaves_with_paths(child, path + (k,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf
    order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("fewer leaves than the tree has")
            return leaf
        return _make(node, [k for k, _ in kids], [build(c) for _, c in kids])

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees differ in their leaf counts: "
                         f"{[len(f) for f in flat]}")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
