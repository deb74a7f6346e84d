"""The offline plane's source of bubble tables (DESIGN.md §12).

The PyTorch counterpart of the host-tree half of the JAX package's
``core/device_table.py``: ``SnapshotDeviceTable`` over the host
``BubbleTree`` (the source of truth) hands out ``HostTableCapture``s — isolation copies of the alive-leaf CF
rows, O(L·d), safe for a background pass while the ingest thread keeps
editing the tree.  A capture runs the pass itself:

  ``capture.recluster(backend, min_pts=…, min_cluster_size=…)``
      → ``(OfflineClusterResult, rep, n_b, center)``

with ``rep``/``n_b``/``center`` the f64 serve-plane table.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels import ops

__all__ = ["HostTableCapture", "SnapshotDeviceTable"]


@dataclasses.dataclass(frozen=True)
class HostTableCapture:
    """Offline capture of host-side leaf CF rows; the f64 bubble-table
    derivation (Eqs. 3–4) happens at recluster time on whatever thread
    runs the pass."""

    ids: np.ndarray
    LS: np.ndarray
    SS: np.ndarray
    N: np.ndarray

    def table(self):
        """(rep, extent, n_b, center): the f64 bubble table of Eqs. 3–4."""
        return ops.bubble_table(self.LS, self.SS, self.N, self.ids)

    def recluster(self, backend, *, min_pts: int, min_cluster_size: float):
        rep, extent, n_b, center = self.table()
        res = backend.offline_recluster_from_table(
            rep, n_b, extent, min_pts, min_cluster_size=min_cluster_size)
        return res, rep, n_b, center


class SnapshotDeviceTable:
    """The host `BubbleTree` as an offline source: capture gathers the
    alive-leaf CF rows as isolation copies (the summary, never the raw
    points).  The device-resident sources of the JAX package (and their
    ready/sync protocol) come with ROADMAP queue 1, item 8."""

    def __init__(self, tree):
        self.tree = tree

    def capture(self, n_points: int) -> HostTableCapture:
        ids, LS, SS, N = self.tree.leaf_cf_buffers()
        # advanced indexing allocates fresh arrays — the isolation copy
        return HostTableCapture(ids=np.arange(len(ids)), LS=LS[ids], SS=SS[ids], N=N[ids])
