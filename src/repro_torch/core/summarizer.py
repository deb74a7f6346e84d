"""Online–offline orchestration (paper §4.2).

  1. *Dynamic data summarization* (online): point insertions/deletions on
     a Bubble-tree; at any time extract the L leaf clustering features.
  2. *Pre-processing* (offline): leaf CFs → data bubbles; assign original
     points to their closest bubble.
  3. *Clustering* (offline): static HDBSCAN over the bubbles using the
     bubble-aware distances (Eqs. 6–7), weighted flat extraction; original
     points inherit their bubble's label.

The port's counterpart of the JAX package's ``core/summarizer.py``.  The
offline pass's O(L²) part runs through a ``ClusterBackend``
(kernels/ops.py) resolved once from the summarizer's device: on ``cuda``
the Eq. 6 core distances and the (L, L) Eq. 7 matrix W come from the
bubble_cd and mutual_reach kernels over the mean-centred f32 table, W
comes home in one copy, the host HDBSCAN (core/hdbscan.py) takes it as
``precomputed``, and the points are assigned on the assign kernel.  On
``cpu`` the same calls take the kernels' plain versions.  The module
functions given no backend take the reference's f64 numpy route: the
oracle of the device route.

Each step of ``cluster`` runs through a ``stage`` hook (as the offline
pass of kernels/ops.py does), so a caller can time the very calls it makes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..device import to_numpy
from .bubble_tree import BubbleTree
from .bubbles import DataBubbles, bubble_mutual_reachability
from .hdbscan import HDBSCANResult, hdbscan

__all__ = ["OfflineResult", "cluster_bubbles", "assign_points", "BubbleTreeSummarizer"]


def _run_stage(name: str, fn, *args, **kw):
    return fn(*args, **kw)


@dataclasses.dataclass
class OfflineResult:
    bubbles: DataBubbles
    bubble_labels: np.ndarray  # (L,)
    point_ids: np.ndarray  # (N,) ids in the tree's point store
    point_labels: np.ndarray  # (N,)
    hdbscan: HDBSCANResult


def cluster_bubbles(
    b: DataBubbles,
    min_pts: int,
    min_cluster_size: float | None = None,
    extent_adjusted: bool = False,
    allow_single_cluster: bool = False,
    backend=None,
    stage=_run_stage,
) -> HDBSCANResult:
    """Static HDBSCAN on data bubbles (offline step 3).

    ``backend`` (a kernels.ops.ClusterBackend, resolved once by long-lived
    callers) computes W on its device; without one W is the f64 numpy
    matrix of core/bubbles.py (``extent_adjusted`` applies there only)."""
    if backend is not None:
        # d_m is translation-invariant; center before the f32 device path
        # (off-origin coordinates cancel in the ||x||²+||y||²−2xy tiles)
        rep = b.rep - (b.n @ b.rep / max(b.n.sum(), 1.0))[None, :]
        Wd = stage("bubble_mutual_reachability", backend.bubble_mutual_reachability, rep, b.n, b.extent, min_pts)
        (W,) = stage("w_to_host", to_numpy, Wd)
    else:
        W, _ = bubble_mutual_reachability(b, min_pts, extent_adjusted=extent_adjusted)
    eff_mcs = float(min_pts if min_cluster_size is None else min_cluster_size)
    return stage(
        "hdbscan",
        hdbscan,
        b.rep,
        min_pts=min_pts,
        min_cluster_size=eff_mcs,
        weights=b.n,
        precomputed=W,
        allow_single_cluster=allow_single_cluster,
    )


def assign_points(X: np.ndarray, b: DataBubbles, backend=None) -> np.ndarray:
    """Offline step 2: nearest-bubble assignment for original points."""
    if backend is not None:
        mu = b.rep.mean(axis=0)  # argmin is translation-invariant; see above
        (a,) = to_numpy(backend.assign(X - mu, b.rep - mu))
        return a
    sq = (
        np.einsum("id,id->i", X, X)[:, None]
        + np.einsum("jd,jd->j", b.rep, b.rep)[None, :]
        - 2.0 * X @ b.rep.T
    )
    return np.argmin(sq, axis=1)


class BubbleTreeSummarizer:
    """User-facing online–offline pipeline around a BubbleTree.

    ``device`` (None → ``cuda``, raising without a GPU; ``"cpu"`` for the
    plain versions) resolves the offline pass's ``ClusterBackend`` once,
    at construction (DESIGN.md §5).  Ingest is the host tree's own."""

    def __init__(
        self,
        dim: int,
        min_pts: int = 10,
        compression: float = 0.01,
        M: int = 10,
        device=None,
        **tree_kw,
    ):
        from ..kernels import ops  # ops imports core.hdbscan: keep the import cycle open

        self.backend = ops.get_backend(device)
        self.tree = BubbleTree(dim=dim, M=M, compression=compression, **tree_kw)
        self.min_pts = int(min_pts)

    # online ------------------------------------------------------------
    def insert(self, p) -> int:
        return self.tree.insert(p)

    def delete(self, pid: int):
        self.tree.delete(pid)

    def insert_block(self, X) -> list[int]:
        return self.tree.insert_block(X)

    def delete_block(self, pids):
        self.tree.delete_block(pids)

    # offline -----------------------------------------------------------
    def cluster(self, min_cluster_size: float | None = None, *, stage=_run_stage) -> OfflineResult:
        b = stage("to_bubbles", self.tree.to_bubbles)
        res = cluster_bubbles(
            b,
            self.min_pts,
            min_cluster_size=min_cluster_size,
            backend=self.backend,
            stage=stage,
        )
        pids, X = self.tree.alive_points()
        a = stage("assign_points", assign_points, X, b, backend=self.backend)
        return OfflineResult(
            bubbles=b,
            bubble_labels=res.labels,
            point_ids=pids,
            point_labels=res.labels[a],
            hdbscan=res,
        )
