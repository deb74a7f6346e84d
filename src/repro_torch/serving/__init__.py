"""Serve plane, streaming engine and token serving engine of the PyTorch port.

Deadlock freedom is by construction: every nested acquisition follows
the declared total order below (checked by repro-lint RPL303), the same
order as the JAX package's serve plane.  An outer batcher dispatch may
resolve a tenant, which may publish or read a snapshot, which may
populate the version-keyed device cache — never the reverse.
"""
# lock-order: QueryBatcher._dispatch -> TenantRouter._lock -> StreamingClusterEngine._snapshot_lock -> SnapshotDeviceCache._lock

from .engine import Request, ServeEngine
from .query import QueryBatcher, QueryEngine, QueryResult, SnapshotDeviceCache
from .stream import ClusterSnapshot, StalenessPolicy, StreamingClusterEngine, Ticket, UpdatePolicy
from .tenants import TenantRouter

__all__ = [
    "ClusterSnapshot",
    "QueryBatcher",
    "QueryEngine",
    "QueryResult",
    "Request",
    "ServeEngine",
    "SnapshotDeviceCache",
    "StalenessPolicy",
    "StreamingClusterEngine",
    "TenantRouter",
    "Ticket",
    "UpdatePolicy",
]
