"""Parameter and state trees: nested dicts, tuples and NamedTuples of
tensors, the shape of the JAX package's pytrees. ``leaves`` flattens in
JAX's order (dict keys sorted, sequences in order, ``None`` holds no
leaf), so a flat list here lines up with ``jax.tree.leaves`` of the same
tree."""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure, visiting
    the leaves in ``leaves`` order; the result has ``tree``'s structure
    (its dicts with sorted keys)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        mapped = (tree_map(fn, v, *(r[i] for r in rest))
                  for i, v in enumerate(tree))
        # a NamedTuple (a decode state: AttnState, RWKVState) takes its
        # fields as arguments
        return (type(tree)(*mapped) if hasattr(tree, "_fields")
                else type(tree)(mapped))
    return fn(tree, *rest)
