"""Nested dict / list trees of tensors (the parameter, gradient and
optimizer trees), flattened in JAX's leaf order: dict keys sorted, lists
and tuples in order."""
from __future__ import annotations

from typing import Any, List, Tuple


def flatten_with_paths(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in leaf order; a path is the tuple of keys / indices
    from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` holding `new_leaves` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}        # keep the key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest) -> Any:
    """fn over matching leaves of trees of one structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
