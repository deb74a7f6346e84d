"""Carry a running stream across from the JAX package.

``engine_from_reference_state`` takes the numpy dict that the JAX
package's ``StreamingClusterEngine.checkpoint_state()`` returns — keys
``cfg/*``, ``tree/*``, ``eng/*``, ``snap/*`` and, from a device-online
engine, ``flat/*`` — and returns a port engine with the same Bubble-tree
(free-list order included, so point ids keep replaying identically), the
same ε accounting, the same version counter, the same published snapshot
and, device-online, the same flat leaf-CF table (origin, slot order, free
list and Kahan compensations).
It is this system's counterpart of carrying a model's weights across:
it reads only numpy and never imports the JAX package.  The fields load
through the engine's own loader, the one ``restore`` uses.
"""

from __future__ import annotations

from .serving.stream import StreamingClusterEngine

__all__ = ["engine_from_reference_state"]


def engine_from_reference_state(state: dict, *, device=None, **engine_kw) -> StreamingClusterEngine:
    """A port engine resuming the reference engine's checkpointed state.

    ``engine_kw`` sets what the checkpoint does not record (``max_block``,
    ``async_offline``, ``min_offline_points``, the tree's fan-out …); the
    configuration it does record (dim, min_pts, min_cluster_size,
    compression, epsilon, device_online) comes from ``cfg/*``.  Raises
    ``ValueError`` on an unknown format, and ``NotImplementedError`` on an
    exact-mode engine, which the port does not carry yet (ROADMAP.md
    queue 1, item 6)."""
    eng = StreamingClusterEngine(
        int(state["cfg/dim"]),
        min_pts=int(state["cfg/min_pts"]),
        min_cluster_size=float(state["cfg/min_cluster_size"]),
        compression=float(state["cfg/compression"]),
        epsilon=float(state["cfg/epsilon"]),
        device_online=bool(state["cfg/device_online"]),
        device=device,
        **engine_kw,
    )
    eng._load_state(state)
    return eng
