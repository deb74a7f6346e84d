"""The offline plane's sources of bubble tables (DESIGN.md §12).

The PyTorch counterpart of the JAX package's ``core/device_table.py``,
``DynamicStateCapture`` of the exact-dynamic path included.  Every source
the engine's offline plane reads has

  ``ready``        the source can serve a capture right now, without a
                   host reload;
  ``sync(tree)``   reconcile with the host tree (patch dirty rows, reload
                   when stale; a no-op when the tree itself is the source);
  ``capture(n)``   an isolation copy of the summary for ONE pass over a
                   population of ``n`` points, safe for a background pass
                   while the ingest thread keeps editing.

Two sources: ``SnapshotDeviceTable`` over the host ``BubbleTree`` hands out
``HostTableCapture``s (the alive-leaf CF rows, O(L·d)), and
``core.bubble_flat.BubbleFlat`` (device-online ingest) hands out
``FlatTableCapture``s (its device tensors cloned on the card).  The
exact-dynamic engine hands ``DynamicStateCapture``s of its maintained
point-level state to the same publish step.  A capture runs the pass
itself:

  ``capture.recluster(backend, min_pts=…, min_cluster_size=…)``
      → ``(OfflineClusterResult, rep, n_b, center)``

with ``rep``/``n_b``/``center`` the f64 serve-plane table.  ``mesh=``
(a ``launch/mesh.py::Mesh``) runs the pass's O(L²) stage sharded over it;
a flat table's captures carry the table's mesh, which a ``mesh`` given to
``recluster`` overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..kernels import ops

__all__ = ["HostTableCapture", "FlatTableCapture", "DynamicStateCapture", "SnapshotDeviceTable"]


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

    def recluster(self, backend, *, min_pts: int, min_cluster_size: float, mesh=None):
        rep, extent, n_b, center = self.table()
        res = backend.offline_recluster_from_table(
            rep, n_b, extent, min_pts, min_cluster_size=min_cluster_size, mesh=mesh)
        return res, rep, n_b, center


@dataclasses.dataclass(frozen=True)
class FlatTableCapture:
    """Offline capture of a `BubbleFlat`: its six device tensors cloned on
    the card, the f64 origin, and ``slots``, the populated slots in
    ascending order as the host knows them — so the pass uploads nothing
    of the summary and reads nothing of the device before its unwrap.
    ``n_points`` clamps ``min_pts`` (the flat table's mass equals the
    population by construction)."""

    view: tuple
    origin: np.ndarray
    n_points: int
    slots: np.ndarray
    mesh: Any = None

    def recluster(self, backend, *, min_pts: int, min_cluster_size: float, mesh=None):
        mp = max(1, min(int(min_pts), int(self.n_points)))
        return backend.offline_recluster_from_device_table(
            *self.view, self.origin, mp, min_cluster_size=min_cluster_size, slots=self.slots,
            mesh=self.mesh if mesh is None else mesh)


@dataclasses.dataclass(frozen=True)
class DynamicStateCapture:
    """Capture of the exact-dynamic device state (core/dynamic_torch.py):
    labels come from the maintained point-level MST through the hierarchy
    stages alone.  There is no O(L²) stage, so a ``mesh`` has nothing to
    shard and is refused."""

    state: Any
    dim: int

    def recluster(self, backend, *, min_pts: int, min_cluster_size: float, mesh=None):
        if mesh is not None:
            raise ValueError(
                "the exact-dynamic path maintains the point-level MST "
                "incrementally — there is no O(L²) stage for mesh= to shard")
        res, _, rep32 = backend.incremental_recluster(self.state, float(min_cluster_size))
        rep = np.asarray(rep32, dtype=np.float64)
        n_b = np.ones(rep.shape[0], dtype=np.float64)
        center = rep.mean(axis=0) if rep.size else np.zeros(self.dim)
        return res, rep, n_b, center


class SnapshotDeviceTable:
    """The host `BubbleTree` as an offline source: always ready (the tree
    IS the source of truth), ``sync`` a no-op, and capture gathers the
    alive-leaf CF rows as isolation copies (the summary, never the raw
    points)."""

    def __init__(self, tree):
        self.tree = tree

    @property
    def ready(self) -> bool:
        return True

    def sync(self, tree=None) -> None:
        return None

    def capture(self, n_points: int) -> HostTableCapture:
        ids, LS, SS, N = self.tree.leaf_cf_buffers()
        # advanced indexing allocates fresh arrays — the isolation copy
        return HostTableCapture(ids=np.arange(len(ids)), LS=LS[ids], SS=SS[ids], N=N[ids])
