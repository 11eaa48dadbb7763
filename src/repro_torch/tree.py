"""Nested-dict pytrees: the port's stand-in for ``jax.tree``.

Params, gradients and optimizer state are nested ``dict``s of tensors.  Leaf
order is sorted-key order at every level, the order ``jax.tree.leaves`` uses
for dicts, so a flat ``(N,)`` buffer packs the leaves exactly as the
reference's ``ravel_pytree`` does and flat buffers carry over element for
element.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_map", "tree_paths", "keystr"]


def _is_node(x) -> bool:
    return isinstance(x, dict)


def tree_leaves(tree: Any) -> list:
    if _is_node(tree):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if _is_node(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def keystr(path: tuple) -> str:
    """``('embed', 'embedding')`` -> ``"['embed']['embedding']"``, the form of
    ``jax.tree_util.keystr`` (the reference checkpoint's array names)."""
    return "".join(f"[{k!r}]" for k in path)


def tree_paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in leaf order."""
    if _is_node(tree):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree
