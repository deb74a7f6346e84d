"""Data bubbles (Breunig et al. [5]) — the paper's offline post-processing.

A data bubble B = {rep, n, extent, nnDist} is derived from a clustering
feature (Def. 5, Eqs. 3–5).  The offline clustering runs static HDBSCAN on
bubbles with bubble-aware distances:

  cd(B)    = d(B, C) + C.nnDist(k)                      (Eq. 6)
  d_m(B,C) = max{cd(B), cd(C), d(B, C)}                 (Eq. 7)

where C is the bubble at which the cumulative represented weight of
bubbles ordered by distance from B first reaches minPts, and k is the
residual count taken from C.  Everything here is vectorized f64 numpy:
the port's own copy of the JAX package's ``core/bubbles.py``, and the
oracle of the device route (kernels/ops.py: the Eq. 6 and Eq. 7 kernels
over a mean-centred f32 table).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .cf import cf_extent, cf_nn_dist, cf_rep

__all__ = ["DataBubbles", "bubbles_from_cf", "bubble_core_distances", "bubble_mutual_reachability"]


@dataclasses.dataclass
class DataBubbles:
    rep: np.ndarray  # (L, d)
    n: np.ndarray  # (L,)
    extent: np.ndarray  # (L,)
    dim: int

    @property
    def size(self) -> int:
        return int(self.rep.shape[0])

    def nn_dist(self, k) -> np.ndarray:
        return cf_nn_dist(self.extent, self.n, k, self.dim)


def bubbles_from_cf(LS: np.ndarray, SS: np.ndarray, n: np.ndarray) -> DataBubbles:
    """CF table -> data bubbles (Eqs. 3–4); rows with n == 0 are dropped."""
    LS = np.asarray(LS, dtype=np.float64)
    SS = np.asarray(SS, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    keep = n > 0
    LS, SS, n = LS[keep], SS[keep], n[keep]
    return DataBubbles(
        rep=cf_rep(LS, n),
        n=n,
        extent=cf_extent(LS, SS, n),
        dim=int(LS.shape[1]),
    )


def bubble_core_distances(b: DataBubbles, min_pts: int) -> np.ndarray:
    """Eq. 6, vectorized over all L bubbles.

    For each bubble B: order the others by center distance, accumulate
    represented weights (starting with B's own n — a bubble containing
    >= minPts points has cd(B) = B.nnDist(minPts), the self term), find
    the bubble C where the cumulative weight reaches minPts, and take
    cd(B) = d(B, C) + C.nnDist(k) with k the residual weight drawn from C.
    """
    L = b.size
    rep = b.rep
    d = np.sqrt(
        np.maximum(
            np.einsum("id,id->i", rep, rep)[:, None]
            + np.einsum("jd,jd->j", rep, rep)[None, :]
            - 2.0 * rep @ rep.T,
            0.0,
        )
    )
    np.fill_diagonal(d, 0.0)
    order = np.argsort(d, axis=1, kind="stable")  # column 0 == self (d=0)
    d_sorted = np.take_along_axis(d, order, axis=1)
    n_sorted = b.n[order]
    csum = np.cumsum(n_sorted, axis=1)
    # first index where cumulative weight >= min_pts
    reach = csum >= float(min_pts)
    # bubbles whose total universe is < min_pts: clamp to the last bubble
    idx = np.where(reach.any(axis=1), np.argmax(reach, axis=1), L - 1)
    rows = np.arange(L)
    before = np.where(idx > 0, csum[rows, np.maximum(idx - 1, 0)], 0.0)
    k_resid = np.maximum(float(min_pts) - before, 1.0)
    C = order[rows, idx]
    nnd = cf_nn_dist(b.extent[C], b.n[C], k_resid, b.dim)
    return d_sorted[rows, idx] + nnd


def bubble_mutual_reachability(
    b: DataBubbles, min_pts: int, extent_adjusted: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Dense (L, L) mutual-reachability matrix over bubbles (Eq. 7).

    ``extent_adjusted=True`` replaces center distance with the
    surface-to-surface estimate max(0, d - extent_i - extent_j) from the
    original data-bubbles paper — a beyond-paper quality option (the paper
    itself uses plain center distance; default matches the paper).
    """
    rep = b.rep
    d = np.sqrt(
        np.maximum(
            np.einsum("id,id->i", rep, rep)[:, None]
            + np.einsum("jd,jd->j", rep, rep)[None, :]
            - 2.0 * rep @ rep.T,
            0.0,
        )
    )
    np.fill_diagonal(d, 0.0)
    if extent_adjusted:
        d = np.maximum(d - b.extent[:, None] - b.extent[None, :], 0.0)
    cd = bubble_core_distances(b, min_pts)
    m = np.maximum(d, np.maximum(cd[:, None], cd[None, :]))
    np.fill_diagonal(m, 0.0)
    return m, cd
