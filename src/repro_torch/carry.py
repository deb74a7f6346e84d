"""Carry a running stream across from the JAX package.

``engine_from_reference_state`` takes the numpy dict that the JAX
package's ``StreamingClusterEngine.checkpoint_state()`` returns — keys
``cfg/*``, ``tree/*``, ``eng/*``, ``snap/*`` (``flat/*`` must be absent)
— and returns a port engine with the same Bubble-tree (free-list order
included, so point ids keep replaying identically), the same ε
accounting, the same version counter and the same published snapshot.
It is this system's counterpart of carrying a model's weights across:
it reads only numpy and never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .kernels.ops import OfflineClusterResult
from .serving.stream import ClusterSnapshot, StreamingClusterEngine

__all__ = ["engine_from_reference_state"]

_FORMAT = 1  # the reference checkpoint format this reader understands

_RESULT_FIELDS = (
    "labels", "stabilities", "weights", "point_parent", "point_lambda",
    "cluster_parent", "cluster_birth", "cluster_weight", "selected",
    "all_stabilities",
)


def _ragged_unpack(flat, off) -> list[list[int]]:
    return [flat[off[i] : off[i + 1]].tolist() for i in range(len(off) - 1)]


def engine_from_reference_state(state: dict, *, device=None, **engine_kw) -> StreamingClusterEngine:
    """A port engine resuming the reference engine's checkpointed state.

    ``engine_kw`` sets what the checkpoint does not record (``max_block``,
    ``async_offline``, ``min_offline_points``, the tree's fan-out …); the
    configuration it does record (dim, min_pts, min_cluster_size,
    compression, epsilon) comes from ``cfg/*``.  Raises ``ValueError`` on
    an unknown format, and ``NotImplementedError`` on an exact-mode
    engine or a live device-online flat table, which this slice does not
    carry."""
    if int(state["cfg/format"]) != _FORMAT:
        raise ValueError(f"unknown checkpoint format {int(state['cfg/format'])}")
    if bool(state["cfg/exact"]):
        raise NotImplementedError("exact=True engines are not ported yet (ROADMAP.md queue 1, item 11)")
    if bool(state.get("flat/has", False)):
        raise NotImplementedError(
            "a live device-online flat table is not ported yet (ROADMAP.md queue 1, item 8)")
    eng = StreamingClusterEngine(
        int(state["cfg/dim"]),
        min_pts=int(state["cfg/min_pts"]),
        min_cluster_size=float(state["cfg/min_cluster_size"]),
        compression=float(state["cfg/compression"]),
        epsilon=float(state["cfg/epsilon"]),
        device=device,
        **engine_kw,
    )
    t = eng.tree
    t.LS = np.array(state["tree/LS"], dtype=np.float64)
    t.SS = np.array(state["tree/SS"], dtype=np.float64)
    t.N = np.array(state["tree/N"], dtype=np.float64)
    t.parent = np.array(state["tree/parent"], dtype=np.int64)
    t.height = np.array(state["tree/height"], dtype=np.int64)
    t.node_alive = np.array(state["tree/node_alive"], dtype=bool)
    t.is_leaf = np.array(state["tree/is_leaf"], dtype=bool)
    t.children = _ragged_unpack(state["tree/children_flat"], state["tree/children_off"])
    t.leaf_points = _ragged_unpack(state["tree/leaf_points_flat"], state["tree/leaf_points_off"])
    if not (len(t.children) == len(t.leaf_points) == t.LS.shape[0]):
        raise ValueError("checkpoint tree arrays disagree on the node capacity")
    t._node_free = state["tree/node_free"].astype(int).tolist()
    t.PX = np.array(state["tree/PX"], dtype=np.float64)
    t.point_alive = np.array(state["tree/point_alive"], dtype=bool)
    t.point_leaf = np.array(state["tree/point_leaf"], dtype=np.int64)
    t._point_free = state["tree/point_free"].astype(int).tolist()
    t._struct_dirty = set(state["tree/struct_dirty"].astype(int).tolist())
    t.root = int(state["tree/root"])
    t.n_points = int(state["tree/n_points"])
    t.dirty_mass = float(state["tree/dirty_mass"])
    t.mutations = int(state["tree/mutations"])
    t._op_count = int(state["tree/op_count"])
    eng._settled_version = int(state["eng/settled_version"])
    snap = None
    if bool(state["snap/has"]):
        res = OfflineClusterResult(
            mst=(state["snap/mst_u"], state["snap/mst_v"], state["snap/mst_w"]),
            min_cluster_size=float(state["snap/res_min_cluster_size"]),
            **{f: np.asarray(state[f"snap/res_{f}"]) for f in _RESULT_FIELDS},
        )
        snap = ClusterSnapshot(
            version=int(state["snap/version"]),
            n_points=int(state["snap/n_points"]),
            bubble_rep=np.asarray(state["snap/bubble_rep"]),
            bubble_n=np.asarray(state["snap/bubble_n"]),
            center=np.asarray(state["snap/center"]),
            result=res,
            wall_seconds=float(state["snap/wall_seconds"]),
            dirty_consumed=float(state["snap/dirty_consumed"]),
        )
    with eng._snapshot_lock:
        eng._version = int(state["eng/version"])
        eng._snapshot = snap
    return eng
