"""Nested containers of tensors, flattened in ``jax.tree_util``'s order.

The sharding rules match a leaf by its path (``block/wq/kernel``) and the
npz checkpoints store leaves as ``leaf_{i}`` in the order
``jax.tree_util.tree_flatten`` gives them, so both packages must agree on
paths and order: dicts by sorted key, lists and tuples by index, ``None``
holds no leaf, anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_paths(tree) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in flatten order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: Path) -> str:
    """A path as ``a/b/0/c``, as ``ray_tpu.parallel.sharding.path_str``
    renders a jax key path."""
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *other_leaves)`` over every leaf of ``tree`` (and
    the matching leaves of ``rest``, which share its structure)."""
    pairs = leaves_with_paths(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(pairs):
            raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(p, leaf, *(o[i] for o in others))
                            for i, (p, leaf) in enumerate(pairs)])
