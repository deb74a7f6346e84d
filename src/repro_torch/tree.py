"""The port's params trees: nested dicts, lists and tuples of tensors.

One walk for every module that reads such a tree (the optimizer, the
train step's gradients, the checkpoint store, the carry from the
reference).  The leaf order is ``jax.tree.leaves``': dict keys sorted,
list and tuple items in order, ``None`` no leaf.
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``tree``'s structure with ``fn`` of each leaf; ``None`` stays."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_unflatten(like, leaves) -> object:
    """``leaves`` (in ``tree_leaves(like)``'s order) in ``like``'s
    structure, dict keys in ``like``'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
