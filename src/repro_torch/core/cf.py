"""Clustering features (CF) — Definition 4 of the paper.

A CF summarizes a point set P by the tuple ``{LS, SS, n}`` where

  * ``LS = sum(p for p in P)``            (vector linear sum, shape (d,))
  * ``SS = sum(||p||^2 for p in P)``      (scalar squared sum)
  * ``n  = |P|``                          (weight)

The *additivity theorem* (Eq. 2) makes CFs mergeable: CF_i + CF_j is the CF
of the union of the underlying point sets.  All operations here are written
against numpy arrays of CFs (structure-of-arrays) so a table of L CFs is

  LS: (L, d) float64     SS: (L,) float64     n: (L,) float64

which is exactly the layout the offline pass (kernels/ops.py) consumes.
This module is the port's own copy of the JAX package's ``core/cf.py``
(numpy only).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CFTable",
    "cf_of_points",
    "cf_merge",
    "cf_add_point",
    "cf_remove_point",
    "cf_rep",
    "cf_extent",
    "cf_nn_dist",
]


@dataclasses.dataclass
class CFTable:
    """A dense table of L clustering features over R^d."""

    LS: np.ndarray  # (L, d)
    SS: np.ndarray  # (L,)
    n: np.ndarray  # (L,)

    @property
    def size(self) -> int:
        return int(self.LS.shape[0])

    @property
    def dim(self) -> int:
        return int(self.LS.shape[1])

    @staticmethod
    def empty(capacity: int, dim: int) -> "CFTable":
        return CFTable(
            LS=np.zeros((capacity, dim), dtype=np.float64),
            SS=np.zeros((capacity,), dtype=np.float64),
            n=np.zeros((capacity,), dtype=np.float64),
        )

    def rep(self) -> np.ndarray:
        """Representative points (Eq. 3), rows with n == 0 map to 0."""
        return cf_rep(self.LS, self.n)

    def extent(self) -> np.ndarray:
        """Extents (Eq. 4)."""
        return cf_extent(self.LS, self.SS, self.n)


def cf_of_points(X: np.ndarray, weights: np.ndarray | None = None):
    """CF of a point block ``X`` (m, d) -> (LS (d,), SS scalar, n scalar)."""
    X = np.asarray(X, dtype=np.float64)
    if weights is None:
        LS = X.sum(axis=0)
        SS = float(np.einsum("md,md->", X, X))
        n = float(X.shape[0])
    else:
        w = np.asarray(weights, dtype=np.float64)
        LS = (w[:, None] * X).sum(axis=0)
        SS = float(np.einsum("m,md,md->", w, X, X))
        n = float(w.sum())
    return LS, SS, n


def cf_merge(LS_i, SS_i, n_i, LS_j, SS_j, n_j):
    """Additivity theorem (Eq. 2): CF_i + CF_j."""
    return LS_i + LS_j, SS_i + SS_j, n_i + n_j


def cf_add_point(LS, SS, n, p):
    p = np.asarray(p, dtype=np.float64)
    return LS + p, SS + float(p @ p), n + 1.0


def cf_remove_point(LS, SS, n, p):
    """Inverse of :func:`cf_add_point` — CFs support exact removal because
    the statistics are sums (this is what makes *fully dynamic* maintenance
    possible, unlike e.g. max-based sketches)."""
    p = np.asarray(p, dtype=np.float64)
    return LS - p, SS - float(p @ p), n - 1.0


def cf_rep(LS: np.ndarray, n: np.ndarray) -> np.ndarray:
    """rep = LS / n (Eq. 3), vectorized over a CF table; 0 where n == 0."""
    n = np.asarray(n, dtype=np.float64)
    safe = np.maximum(n, 1.0)
    out = LS / safe[..., None]
    out[n == 0] = 0.0
    return out


def cf_extent(LS: np.ndarray, SS: np.ndarray, n: np.ndarray) -> np.ndarray:
    """extent = sqrt((2 n SS - 2 ||LS||^2) / (n (n - 1)))  (Eq. 4).

    This is sqrt(2) times the standard deviation radius: the average
    pairwise squared distance inside the bubble is
    2 (n*SS - ||LS||^2) / (n (n-1)).  CFs with n <= 1 have extent 0.
    Numerical noise can drive the radicand slightly negative; clamp.
    """
    LS = np.asarray(LS, dtype=np.float64)
    SS = np.asarray(SS, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    lsq = np.einsum("...d,...d->...", LS, LS)
    denom = np.maximum(n * (n - 1.0), 1.0)
    rad = (2.0 * n * SS - 2.0 * lsq) / denom
    rad = np.maximum(rad, 0.0)
    out = np.sqrt(rad)
    out = np.where(n <= 1.0, 0.0, out)
    return out


def cf_nn_dist(extent: np.ndarray, n: np.ndarray, k, dim: int) -> np.ndarray:
    """nnDist(k) = (k / n)^(1/d) * extent (Eq. 5).

    Estimates the distance from a bubble's representative to its k-th
    nearest member assuming points are uniformly distributed inside the
    extent radius.  ``k`` may be scalar or an array broadcastable with n.
    """
    n = np.maximum(np.asarray(n, dtype=np.float64), 1.0)
    k = np.minimum(np.asarray(k, dtype=np.float64), n)
    k = np.maximum(k, 0.0)
    return np.power(k / n, 1.0 / float(dim)) * extent
