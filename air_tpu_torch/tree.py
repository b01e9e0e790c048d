"""Parameter trees: nested dicts and lists of tensors, walked in the JAX
package's order.

``jax.tree_util`` visits a dict's entries in sorted key order and a list's
in index order; the optimizer's leaf order in a checkpoint (``opt/<i>``)
and the global-norm sum follow that order, so the port walks its trees the
same way.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree; ``path`` is the tuple of dict keys and
    list indices from the root."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, (*path, i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], (*path, k))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, (*path, i))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` (given in
    ``tree_leaves`` order)."""
    paths = [p for p, _ in tree_leaves_with_path(template)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    by_path = dict(zip(paths, leaves))
    return tree_map_with_path(lambda p, _: by_path[p], template)


def path_name(path: tuple) -> str:
    """'a/b/0/w', the JAX package's name of a leaf."""
    return "/".join(str(p) for p in path)
