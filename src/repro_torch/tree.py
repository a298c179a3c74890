"""Parameter and state trees: nested dicts, tuples and NamedTuples of
tensors, the shape of the JAX package's pytrees. ``leaves`` flattens in
JAX's order (dict keys sorted, sequences in order, ``None`` holds no
leaf), so a flat list here lines up with ``jax.tree.leaves`` of the same
tree; ``leaves_with_paths`` names each leaf as the JAX package's
checkpoints do."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf in ``leaves`` order, the path JAX's
    ``tree_flatten_with_path`` keys joined by "/": a dict entry gives
    its key, a NamedTuple field its name, a sequence item its index
    (``repro/checkpoint/manager.py:41-57``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(key), tree[key]) for key in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        items = [(str(name), item) for name, item in zip(names, tree)]
    else:
        return [("", tree)]
    return [(f"{name}/{path}" if path else name, leaf)
            for name, sub in items for path, leaf in leaves_with_paths(sub)]


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
