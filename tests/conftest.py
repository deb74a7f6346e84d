"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device; only launch/dryrun.py forces 512 placeholders."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_blobs(rng, centers=((0.0, 0.0), (6.0, 0.0), (0.0, 6.0)), n_per=60, d=2, scale=0.4):
    """Well-separated Gaussian blobs + ground-truth labels."""
    pts, labels = [], []
    for i, c in enumerate(centers):
        c = np.asarray(c, dtype=np.float64)
        if c.shape[0] < d:
            c = np.concatenate([c, np.zeros(d - c.shape[0])])
        pts.append(rng.normal(loc=c, scale=scale, size=(n_per, d)))
        labels.append(np.full(n_per, i))
    X = np.concatenate(pts)
    y = np.concatenate(labels)
    perm = rng.permutation(X.shape[0])
    return X[perm], y[perm]


@pytest.fixture
def blobs(rng):
    return make_blobs(rng)


def assert_same_partition(a, b, msg=""):
    """Labelings equal up to permutation; noise (-1) must map to noise."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, f"{msg} shape {a.shape} != {b.shape}"
    fwd, bwd = {}, {}
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        assert (x == -1) == (y == -1), f"{msg} noise mismatch at {i}: {x} vs {y}"
        if x == -1:
            continue
        assert fwd.setdefault(x, y) == y, f"{msg} label {x} maps to {fwd[x]} and {y}"
        assert bwd.setdefault(y, x) == x, f"{msg} label {y} maps from {bwd[y]} and {x}"
