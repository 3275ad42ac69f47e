"""Trees of nested dicts: the port's stand-in for ``jax.tree_util``.

A tree is a dict whose values are trees or leaves (tensors, arrays,
scalars).  Flattening visits keys in sorted order, as jax flattens a
dict, so sums over leaves run in the reference's order, and a leaf's
path prints as jax's ``keystr`` does (``['params']['embed']``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the
    same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves), keys in sorted order."""
    paths: List[Path] = []
    leaves: List[Any] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def tree_unflatten(paths: List[Path], leaves: List[Any]):
    """The tree of ``leaves`` at ``paths`` (a lone leaf at the empty
    path is its own tree)."""
    if paths == [()]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def keystr(path: Path) -> str:
    """jax's ``keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)
