"""Nested carries of tensors: a potential's ``aux`` may be None, a tensor,
or tuples / named tuples / lists of them (the solvated step carries (cell
buckets, cap offsets)).  The counterparts of ``jax.tree.map`` and
``jax.tree.leaves`` for those."""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, *trees) -> Any:
    """fn applied leaf by leaf (tensors, and any other non-container leaf)
    across trees of one structure; None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        if hasattr(t, "_fields"):
            return type(t)(*out)
        return type(t)(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves, depth first (None contributes none)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def tree_unflatten(template, leaves: list) -> Any:
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(tree_leaves(template))}")
    return out


def tree_clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def tree_copy_(dst, src) -> None:
    """Copy src's tensors into dst's, in place."""
    tree_map(lambda d, s: d.copy_(s) if isinstance(d, torch.Tensor) else None, dst, src)
