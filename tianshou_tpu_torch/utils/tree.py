"""Leaf-wise map over nested tensor containers (the port's ``jax.tree.map``),
and the leaves in order (``jax.tree.leaves``).

Handles ``Batch``, ``dict``, ``list``, ``tuple`` and ``NamedTuple`` nodes,
``None`` (passed through) and tensor leaves.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

from tianshou_tpu_torch.data.batch import Batch

__all__ = ["tree_leaves", "tree_map"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the matching leaves of ``tree`` and ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, Batch):
        return Batch({k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out
