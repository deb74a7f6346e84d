"""The port's params-tree walk (``repro_torch.tree``) against ``jax.tree``:
the same leaf order, map and rebuild over nested dicts, lists, tuples
and ``None``."""

import jax
import numpy as np
import pytest
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TREES = {
    "dict": {"b": np.arange(2), "a": {"z": np.ones(3), "c": np.zeros(1)}},
    "tuple": ({"w": np.ones(2)}, {"mu": {"w": np.zeros(2)}, "step": np.int32(3)}),
    "list_and_none": [np.ones(1), None, {"x": np.arange(3), "n": None}],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_leaves_in_jax_order(name):
    tree = TREES[name]
    got, want = tree_leaves(tree), jax.tree.leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is w


@pytest.mark.parametrize("name", sorted(TREES))
def test_map_and_unflatten_keep_the_structure(name):
    tree = TREES[name]
    doubled = tree_map(lambda a: 2 * np.asarray(a), tree)
    assert jax.tree.structure(doubled) == jax.tree.structure(tree)
    for g, w in zip(tree_leaves(doubled), tree_leaves(tree)):
        assert np.array_equal(g, 2 * np.asarray(w))
    rebuilt = tree_unflatten(tree, tree_leaves(doubled))
    assert jax.tree.structure(rebuilt) == jax.tree.structure(tree)
    for g, w in zip(tree_leaves(rebuilt), tree_leaves(doubled)):
        assert g is w


def test_unflatten_keeps_key_order_and_refuses_extra_leaves():
    like = {"b": torch.zeros(1), "a": torch.zeros(2)}
    out = tree_unflatten(like, [torch.ones(2), torch.ones(1)])
    assert list(out) == ["b", "a"] and out["a"].shape == (2,) and out["b"].shape == (1,)
    with pytest.raises(ValueError):
        tree_unflatten(like, [torch.ones(2), torch.ones(1), torch.ones(3)])
