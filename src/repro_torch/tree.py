"""Nested dicts of tensors ("trees"), as the reference package's pytrees
of parameters and optimizer states: mapped leaf by leaf and flattened to
`/`-joined keys in sorted key order, the order `jax.tree_util` walks a
dict in."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, _prefix: str = "") -> dict[str, Any]:
    """{"a/b": leaf, ...}: dict keys `/`-joined, each level sorted."""
    if not isinstance(tree, dict):
        return {_prefix: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{_prefix}/{k}" if _prefix else str(k)))
    return out


def leaves(tree) -> list:
    return list(flatten(tree).values())
