"""Synthetic datasets.

The paper's real datasets (PAMAP2, gas-sensor, KDD'99) are not
redistributable in this offline container; we generate *statistically
analogous* stand-ins (matched n, d, cluster structure, noise floor) and
say so in EXPERIMENTS.md.  The Gauss set (the paper's main scalability
workload) is generated exactly as described: Gaussian mixtures with a
bounded pairwise overlap (MixSim-style), 10-D.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy
only): the same seeds give the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np


def gaussian_mixtures(
    n: int,
    d: int = 10,
    k: int = 20,
    overlap: float = 0.10,
    noise_frac: float = 0.0,
    seed: int = 0,
):
    """MixSim-flavoured Gaussian mixtures: centers placed so the expected
    pairwise overlap (Bhattacharyya-ish, via center distance in units of
    combined std) stays below `overlap`.  Returns (X (n,d), labels (n,))."""
    rng = np.random.default_rng(seed)
    # separation required for the requested max overlap: two unit-σ
    # gaussians at distance Δ overlap ≈ exp(−Δ²/8); invert for Δ.
    delta = np.sqrt(-8.0 * np.log(max(overlap, 1e-6)))
    centers = np.zeros((k, d))
    placed = 0
    while placed < k:
        c = rng.uniform(-delta * k ** (1.0 / d), delta * k ** (1.0 / d), size=d)
        if placed == 0 or np.linalg.norm(centers[:placed] - c, axis=1).min() >= delta:
            centers[placed] = c
            placed += 1
    weights = rng.dirichlet(np.full(k, 5.0))
    counts = rng.multinomial(n, weights)
    X = np.empty((n, d))
    y = np.empty(n, dtype=np.int64)
    at = 0
    for i, c in enumerate(counts):
        scale = rng.uniform(0.7, 1.3)
        X[at : at + c] = rng.normal(loc=centers[i], scale=scale, size=(c, d))
        y[at : at + c] = i
        at += c
    n_noise = int(noise_frac * n)
    if n_noise:
        idx = rng.choice(n, size=n_noise, replace=False)
        lo, hi = X.min(axis=0), X.max(axis=0)
        X[idx] = rng.uniform(lo, hi, size=(n_noise, d))
        y[idx] = -1
    perm = rng.permutation(n)
    return X[perm], y[perm]


# Matched stand-ins for the paper's real datasets (n scaled down by the
# harness as needed; full sizes are the paper's).
DATASET_SPECS = {
    "gauss": dict(d=10, k=20, overlap=0.10, noise_frac=0.0, full_n=5_000_000),
    "pamap": dict(d=4, k=12, overlap=0.25, noise_frac=0.05, full_n=3_850_505),
    "chem": dict(d=16, k=8, overlap=0.30, noise_frac=0.10, full_n=4_178_504),
    "intrusion": dict(d=34, k=15, overlap=0.20, noise_frac=0.15, full_n=4_898_430),
}


def dataset(name: str, n: int, seed: int = 0):
    spec = dict(DATASET_SPECS[name])
    spec.pop("full_n")
    return gaussian_mixtures(n, seed=seed, **spec)


def sliding_window_workload(
    X: np.ndarray, window: int, slide: int
):
    """Paper §5.2 workload: yield (insert_block, delete_count) slides.
    The first slide fills the window; every later slide inserts `slide`
    new points and deletes the `slide` oldest (FIFO order — deletions by
    arrival, which together with arbitrary reorganization exercises the
    fully-dynamic path)."""
    n = X.shape[0]
    yield X[:window], 0
    at = window
    while at + slide <= n:
        yield X[at : at + slide], slide
        at += slide


def token_stream(vocab_size: int, batch: int, seq: int, seed: int = 0):
    """Infinite synthetic LM batches: Zipf-distributed tokens with a
    shifting topic mixture (so curation has real cluster structure)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    base = 1.0 / ranks ** 1.1
    step = 0
    while True:
        topic = rng.integers(0, 8)
        boost = np.ones(vocab_size)
        lo = (topic * vocab_size) // 8
        hi = ((topic + 1) * vocab_size) // 8
        boost[lo:hi] = 4.0
        p = base * boost
        p /= p.sum()
        toks = rng.choice(vocab_size, size=(batch, seq + 1), p=p)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "topic": topic,
            "step": step,
        }
        step += 1
