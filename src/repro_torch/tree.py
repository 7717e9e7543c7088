"""Parameter-tree helpers: the port's stand-in for ``jax.tree``.

A tree is nested dicts, lists and tuples with tensors (or other leaves) at
the ends, as the parameter and optimiser-state trees are.  Dict keys are
walked in insertion order, the same on every tree built from the same
template, so `leaves` of matching trees line up.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The tree's leaves, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaf_paths(tree, prefix=()) -> List[tuple]:
    """(path, leaf) pairs in `leaves` order: the path holds the dict keys
    and the list positions (as strings) from the root."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaf_paths(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]
