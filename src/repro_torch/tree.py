"""Nested-dict trees of tensors, walked as JAX walks its pytrees: dict
keys in sorted order, list and tuple items by index. The optimizer sums
its global norm over leaves in that order, and the checkpoint names each
leaf by its path (`a|b|c`), so both agree with the JAX package's."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def leaves_with_path(tree: Tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf, in JAX's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Tree, flat: List[Any]) -> Tree:
    """`like`'s structure with its leaves, in JAX's order, replaced by `flat`."""
    it = iter(flat)
    order = {path: next(it) for path, _ in leaves_with_path(like)}

    def build(t, path):
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, path + (i,)) for i, v in enumerate(t))
        return order[path]

    return build(like, ())
