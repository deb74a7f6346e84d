"""Multi-tenant serve plane: many independent streams, one process
(DESIGN.md §11).

The PyTorch counterpart of the JAX package's ``serving/tenants.py``.  A
clustering service runs many small streams (one per customer, sensor
fleet or region), each with its own Bubble-tree, ε cadence and snapshot
history.  `TenantRouter` hosts N `StreamingClusterEngine`s behind shared
serve-plane machinery:

  shared device cache   ONE `SnapshotDeviceCache` for every tenant,
                        entries keyed ``(tenant, version)``: one LRU
                        budget bounds the device memory of all tenants
                        instead of N × keep entries.

  shared dispatch loop  ONE `QueryBatcher` fronts every tenant: requests
                        are tagged with the tenant name (`HostBatcher`'s
                        kind), so concurrent callers of the SAME tenant
                        coalesce into one fused device call while blocks
                        of different tenants stay separate, leader-death
                        fan-out included (serving/query.py).

  recovery              the Bubble-tree summary is the durable state.
                        With a ``checkpoint_root``, each tenant
                        checkpoints through its own `CheckpointStore`
                        under ``root/<name>/``, and `recover()` rebuilds
                        every tenant found there, bit for bit with a
                        worker that never died.

Ingestion stays per tenant (each engine's `poll()` drains its own queue;
the tree has a single writer thread); `poll()` with no name round-robins
every tenant.
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np

from ..checkpoint import CheckpointStore
from ..device import resolve_device
from .query import QueryBatcher, QueryResult, SnapshotDeviceCache
from .stream import StreamingClusterEngine

__all__ = ["TenantRouter"]

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class TenantRouter:
    """Route ingest/query traffic to per-tenant `StreamingClusterEngine`s
    behind one shared `QueryBatcher` and one `SnapshotDeviceCache`.

    Args:
      dim: feature dimensionality (default for every tenant; a tenant may
        override it at `create(name, dim=...)`).
      device: where every tenant's kernels and the shared cache live; None
        = ``cuda`` (raises without a GPU), ``"cpu"`` = the plain versions.
      cache_keep: shared LRU budget — device snapshot entries resident
        across ALL tenants.
      max_batch / poll_s: `QueryBatcher` coalescing knobs.
      checkpoint_root: directory for per-tenant checkpoint stores
        (``root/<name>/``); None disables `save`/`recover`.
      keep: checkpoints retained per tenant.
      spatial_index: every tenant's engine and the shared cache use the
        Morton grid (kernels/grid.py) for assignment, the offline pass and
        served queries; a tenant may override it at ``create``.
      **engine_kw: defaults for every tenant's engine constructor
        (compression, epsilon, min_pts, …).
    """

    def __init__(
        self,
        dim: int,
        *,
        device=None,
        cache_keep: int = 8,
        max_batch: int = 1024,
        poll_s: float = 0.002,
        checkpoint_root: str | None = None,
        keep: int = 3,
        spatial_index: bool = False,
        **engine_kw,
    ):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self.spatial_index = bool(spatial_index)
        self.engine_kw = dict(engine_kw)
        self.cache = SnapshotDeviceCache(self.device, keep=cache_keep, spatial=self.spatial_index)
        self.batcher = QueryBatcher(resolve=self.engine, max_batch=max_batch, poll_s=poll_s)
        self.checkpoint_root = checkpoint_root
        self.keep = int(keep)
        self._tenants: dict[str, StreamingClusterEngine] = {}  # guarded-by: _lock
        self._stores: dict[str, CheckpointStore] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- tenant lifecycle --------------------------------------------------

    def create(self, name: str, **overrides) -> StreamingClusterEngine:
        """Provision a tenant.  ``overrides`` beat the router defaults (its
        own ε, even its own dim); the device and the shared cache/batcher
        wiring are not overridable."""
        if not _NAME_RE.match(name):
            raise ValueError(f"tenant name {name!r} must match {_NAME_RE.pattern}")
        kw = {**self.engine_kw, **overrides}
        dim = int(kw.pop("dim", self.dim))
        kw.setdefault("spatial_index", self.spatial_index)
        eng = StreamingClusterEngine(dim, device=self.device, query_cache=self.cache,
                                     query_scope=name, **kw)
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already exists")
            self._tenants[name] = eng
        return eng

    def engine(self, name: str) -> StreamingClusterEngine:
        with self._lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(f"unknown tenant {name!r}") from None

    def drop(self, name: str):
        """Retire a tenant: its engine and checkpoint store detach (disk
        state stays for the operator — recovery must stay possible after
        an accidental drop)."""
        with self._lock:
            self._tenants.pop(name, None)
            store = self._stores.pop(name, None)
        if store is not None:
            store.close()

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    # -- request plane -----------------------------------------------------

    def submit_insert(self, name: str, X):
        return self.engine(name).submit_insert(X)

    def submit_delete(self, name: str, pids):
        return self.engine(name).submit_delete(pids)

    def ingest(self, name: str, X) -> list[int]:
        return self.engine(name).ingest(X)

    def retire(self, name: str, pids):
        return self.engine(name).retire(pids)

    def poll(self, name: str | None = None, max_blocks: int | None = None) -> int:
        """Drain one tenant's queue, or round-robin every tenant."""
        if name is not None:
            return self.engine(name).poll(max_blocks=max_blocks)
        return sum(self.engine(n).poll(max_blocks=max_blocks) for n in self.names())

    def flush(self, name: str | None = None):
        for n in [name] if name is not None else self.names():
            self.engine(n).flush()

    # -- serve plane -------------------------------------------------------

    def query(self, name: str, X) -> np.ndarray:
        return self.batcher.query(X, kind=name)

    def query_detailed(self, name: str, X) -> QueryResult:
        return self.batcher.query_detailed(X, kind=name)

    # -- recovery ----------------------------------------------------------

    def _store(self, name: str) -> CheckpointStore:
        if self.checkpoint_root is None:
            raise RuntimeError("TenantRouter built without checkpoint_root")
        with self._lock:
            store = self._stores.get(name)
            if store is None:
                store = CheckpointStore(os.path.join(self.checkpoint_root, name), keep=self.keep)
                self._stores[name] = store
        return store

    def save(self, name: str, *, blocking: bool = True) -> int:
        """Checkpoint one tenant (atomic publish; async when
        ``blocking=False`` — ingestion goes on during the write)."""
        return self.engine(name).save(self._store(name), blocking=blocking)

    def save_all(self, *, blocking: bool = True) -> dict[str, int]:
        return {n: self.save(n, blocking=blocking) for n in self.names()}

    def recover(self, **overrides) -> list[str]:
        """Rebuild every tenant with a published checkpoint under
        ``checkpoint_root`` — the killed-worker restart path.  Tenants are
        built from the router defaults (+ ``overrides``), then restored;
        mismatched modes raise from `StreamingClusterEngine.restore`.
        Returns the recovered names."""
        if self.checkpoint_root is None:
            raise RuntimeError("TenantRouter built without checkpoint_root")
        recovered = []
        if not os.path.isdir(self.checkpoint_root):
            return recovered
        for name in sorted(os.listdir(self.checkpoint_root)):
            if not _NAME_RE.match(name) or name in self:
                continue
            store = self._store(name)
            try:
                eng = self.create(name, **overrides)
                eng.restore(store)
            except FileNotFoundError:
                self.drop(name)  # a directory with no published step yet
                continue
            recovered.append(name)
        return recovered

    def close(self):
        """Flush the checkpoint writers (raising any latched async write
        error) and drop every tenant."""
        for name in self.names():
            self.drop(name)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Aggregated service counters and the shared plane's hit rates."""
        per = {n: dict(self.engine(n).stats) for n in self.names()}
        return {
            "tenants": len(per),
            "cache_hits": self.cache.hits,
            "cache_builds": self.cache.builds,
            "query_batches": self.batcher.batches,
            "query_fanned_out": self.batcher.fanned_out,
            "per_tenant": per,
        }
