"""Minimal pytrees for the port: nested dicts, lists and tuples of leaves.

The JAX package maps over vertex and edge data with ``jax.tree``; the port's
data is plain dicts of tensors, so these few helpers stand in for it.
``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Pytree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not _is_namedtuple(x)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Applies ``fn`` leafwise over ``tree`` and same-shaped ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_node(tree):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_flatten(tree: Pytree, is_leaf: Callable = None
                 ) -> Tuple[List[Any], Any]:
    """(leaves in key order, treedef); ``tree_unflatten`` inverts it."""
    if tree is None:
        return [], None
    if is_leaf is not None and is_leaf(tree):
        return [tree], "*"
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k in tree:
            lv, d = tree_flatten(tree[k], is_leaf)
            leaves += lv
            defs.append((k, d, len(lv)))
        return leaves, ("dict", defs)
    if _is_node(tree):
        leaves, defs = [], []
        for t in tree:
            lv, d = tree_flatten(t, is_leaf)
            leaves += lv
            defs.append((None, d, len(lv)))
        return leaves, (type(tree), defs)
    return [tree], "*"


def tree_unflatten(treedef, leaves: List[Any]) -> Pytree:
    if treedef is None:
        return None
    if treedef == "*":
        return leaves[0]
    kind, defs = treedef
    pos, items = 0, []
    for key, d, cnt in defs:
        items.append((key, tree_unflatten(d, leaves[pos:pos + cnt])))
        pos += cnt
    if kind == "dict":
        return dict(items)
    return kind(v for _, v in items)


def tree_leaves(tree: Pytree) -> List[Any]:
    return tree_flatten(tree)[0]
