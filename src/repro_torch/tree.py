"""Nested containers of tensors ("trees") flattened in the JAX package's
order, so that the port's params, optimizer state and checkpoints line up
leaf for leaf with the reference's pytrees.

A tree is a dict (its keys visited in sorted order, as ``jax.tree_util``
does), a list or tuple (in order), ``None`` (no leaves) or a leaf.
``keystr`` paths read like ``jax.tree_util.keystr``: ``['opt']['mu'][0]``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, prefix + key)
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(template: Tree, new_leaves: list) -> Tree:
    """``template``'s structure with its leaves replaced, in flatten order,
    by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])


def treedef_str(tree: Tree) -> str:
    """The structure in ``jax.tree_util.tree_structure``'s notation,
    ``PyTreeDef({'a': *, 'b': [*, None]})``."""
    def fmt(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(fmt(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
