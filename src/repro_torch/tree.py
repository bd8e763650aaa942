"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
stand-in for ``jax.tree_util``).  Dict keys are walked in sorted order, as
JAX flattens them, so a sum over the leaves runs in the JAX package's leaf
order wherever the two trees have the same structure."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order; a path joins the dict keys
    and sequence indices with "/"."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in items(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in items(v, join(i))]
    return [(prefix, tree)]


def map_(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure; the
    result has ``tree``'s structure (NamedTuples keep their type)."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)
