"""Parameter trees as the reference's ``jax.tree_util`` walks them:
dicts (keys in sorted order), tuples, lists and NamedTuples are nodes,
``None`` is an empty subtree, anything else is a leaf."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order; the path is
    the reference's key string joined by ``/``: ``['name']`` for a dict
    key, ``[i]`` for a tuple or list index, ``.field`` for a NamedTuple
    field (as ``jax.tree_util.tree_flatten_with_path`` prints them)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            items = [(f"[{k!r}]", node[k]) for k in sorted(node)]
        elif _is_namedtuple(node):
            items = [(f".{f}", getattr(node, f)) for f in node._fields]
        elif isinstance(node, (tuple, list)):
            items = [(f"[{i}]", c) for i, c in enumerate(node)]
        else:
            out.append(("/".join(path), node))
            return
        for key, child in items:
            walk(child, path + [key])

    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in :func:`leaves`' order;
    returns the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, c) for c in tree)
    return fn(tree)


def unflatten(like, values) -> Any:
    """The structure of ``like`` with its leaves replaced, in
    :func:`leaves`' order, by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def sq_norm(tree) -> torch.Tensor:
    """The sum of squares of every leaf, in f32."""
    return sum(torch.sum(torch.square(g.float())) for g in leaves(tree))
