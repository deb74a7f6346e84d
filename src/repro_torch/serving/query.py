"""Versioned, device-cached batched queries (serve plane, DESIGN.md §9).

The PyTorch counterpart of the JAX package's ``serving/query.py``:

  snapshot entry   `SnapshotDeviceCache` builds one immutable
                   `DeviceSnapshotEntry` per snapshot *version*: the
                   mean-centred f32 rep table, flat labels and the
                   per-bubble λ / per-cluster λ_max arrays, padded into a
                   power-of-two L-bucket with far rows that serve noise.
                   Entries are never patched in place — a reader holding
                   version v keeps a consistent view while v+1 publishes.

  fused query      `_fused_query`: nearest-rep assignment with the fused
                   distance (the assign kernel on the card), label gather,
                   membership strength

                     strength(q) = clip(min(1/r, λ_b) / λ_max(c), 0, 1)

                   for a query at distance r from bubble b of cluster c,
                   with λ_b the bubble's condensed-tree departure λ and
                   λ_max(c) the largest finite λ among c's members.
                   `_fused_query_grid` is the same epilogue after the
                   grid's assign (``spatial_index=True``): the entry then
                   carries a `GridIndex` built once per version over its
                   L real rows.

  micro-batching   `QueryBatcher` generalizes the request plane's
                   `HostBatcher` to the serve plane: concurrent callers
                   enqueue (X, ticket) pairs, a leader-elected caller
                   drains them into one fused dispatch, and results fan
                   back out by ticket — concurrent small callers ride one
                   device call instead of N.

Query rows are not padded to buckets: there is no compile cache to keep
warm, and the kernel masks the ragged edge itself.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..device import to_numpy
from ..kernels import grid as _grid_k
from ..kernels import ops
from .batcher import HostBatcher

__all__ = [
    "QueryResult",
    "DeviceSnapshotEntry",
    "SnapshotDeviceCache",
    "QueryEngine",
    "QueryBatcher",
    "validate_query",
    "query_percall",
]

_MIN_BUCKET = 8
_MAX_CHUNK = 1 << 14  # huge batches run in chunks
_EPS = 1e-12
_LAM_CEIL = 1e30  # finite stand-in for λ = ∞ (duplicate-heavy bubbles)


def _bucket(n: int) -> int:
    return max(_MIN_BUCKET, 1 << (max(n - 1, 1)).bit_length())


def validate_query(X, dim: int) -> np.ndarray:
    """Normalize query input to (n, dim) f64: zero-ROW inputs are 0
    points, a 1-D length-``dim`` vector is a single point, anything else
    — including n rows of the wrong feature count — raises."""
    X = np.asarray(X, dtype=np.float64)
    shape = X.shape
    if X.ndim == 1:
        if X.shape[0] == 0:
            return X.reshape(0, dim)
        if X.shape[0] != dim:
            raise ValueError(f"expected (n, {dim}) query points, got {shape}")
        X = X[None, :]
    if X.ndim != 2:
        raise ValueError(f"expected (n, {dim}) query points, got {shape}")
    if X.shape[0] == 0:
        return X.reshape(0, dim)
    if X.shape[1] != dim:
        raise ValueError(f"expected (n, {dim}) query points, got {shape}")
    return X


def _fused_query(xc, reps, labels, lam, lam_max):
    """assign (with distance) → label gather → membership strength.  ``xc``
    rows are mean-centred in the snapshot's frame."""
    idx, dist = ops.assign(xc, reps, with_dist=True)
    return _serve_epilogue(idx, dist, labels, lam, lam_max)


def _fused_query_grid(xc, grid, labels, lam, lam_max):
    """`_fused_query` with the grid's assign over the entry's `GridIndex`:
    each batch pays its own Morton sort and the tiles that can still beat
    its rows' nearest.  The grid excludes the bucket's pad rows, so the
    pad-hit guard of the caller never fires here."""
    idx, dist = _grid_k.grid_assign(grid, xc)
    idx = torch.clamp_max(idx, labels.shape[0] - 1)  # an empty grid answers Lp
    return _serve_epilogue(idx, dist, labels, lam, lam_max)


def _serve_epilogue(idx, dist, labels, lam, lam_max):
    i = idx.long()
    lbl = labels[i]
    lam_b = lam[i]
    lam_c = torch.clamp_min(lam_max[i], _EPS)
    lam_q = 1.0 / torch.clamp_min(dist, _EPS)
    strength = torch.clamp(torch.minimum(lam_q, lam_b) / lam_c, 0.0, 1.0)
    strength = torch.where(lbl >= 0, strength, 0.0)
    return idx, lbl, dist, strength


@dataclasses.dataclass(frozen=True)
class DeviceSnapshotEntry:
    """One snapshot version's device residency.  Immutable: swaps build a
    NEW entry under the next version key, never patch these tensors."""

    version: int
    n_bubbles: int
    bucket: int  # Lp — power-of-two row count of the device tensors
    center: np.ndarray  # (d,) f64 — subtract before the f32 program
    reps: torch.Tensor  # (Lp, d) f32 mean-centred representatives
    labels: torch.Tensor  # (Lp,) int32 flat labels, -1 noise/pad
    lam: torch.Tensor  # (Lp,) f32 per-bubble condensed-tree λ
    lam_max: torch.Tensor  # (Lp,) f32 λ_max of the bubble's cluster
    grid: _grid_k.GridIndex | None = None  # spatial index over the L real rows


def _build_entry(snap, device, spatial: bool = False) -> DeviceSnapshotEntry:
    """Host-side O(L·d) derivation + ONE upload per published snapshot
    (and, with ``spatial``, one grid build on the device)."""
    L = snap.n_bubbles
    d = int(snap.bubble_rep.shape[1])
    Lp = _bucket(L)
    # pad rows sit far away and carry label -1 / λ 0, so even a
    # pathological hit serves noise
    rep_c = np.full((Lp, d), ops._PAD_COORD, dtype=np.float32)
    rep_c[:L] = (snap.bubble_rep - snap.center[None, :]).astype(np.float32)
    lbl = np.full(Lp, -1, dtype=np.int32)
    lbl[:L] = snap.bubble_labels
    raw_lam = np.asarray(snap.result.point_lambda, dtype=np.float64)
    finite = np.isfinite(raw_lam)
    lam = np.zeros(Lp, dtype=np.float32)
    lam[:L] = np.where(finite, np.minimum(raw_lam, _LAM_CEIL), _LAM_CEIL)
    # per-cluster death λ: segment max of FINITE member λ only; λ = ∞
    # means membership probability 1 and must not poison the denominator
    # of its siblings; clusters whose members are all ∞ fall back to 1
    lam_max = np.ones(Lp, dtype=np.float32)
    member = lbl[:L] >= 0
    if member.any():
        acc = np.zeros(int(lbl[:L].max()) + 1, dtype=np.float64)
        contrib = member & finite
        if contrib.any():
            np.maximum.at(acc, lbl[:L][contrib], raw_lam[contrib])
        acc = np.where(acc > 0.0, acc, 1.0)
        lmx = np.ones(L, dtype=np.float64)
        lmx[member] = np.maximum(acc[lbl[:L][member]], _EPS)
        lam_max[:L] = lmx
    reps = torch.from_numpy(rep_c).to(device)
    grid = _grid_k.build_grid(reps, torch.arange(Lp, device=device) < L) if spatial else None
    return DeviceSnapshotEntry(
        version=int(snap.version),
        n_bubbles=L,
        bucket=Lp,
        center=np.asarray(snap.center, dtype=np.float64),
        reps=reps,
        labels=torch.from_numpy(lbl).to(device),
        lam=torch.from_numpy(lam).to(device),
        lam_max=torch.from_numpy(lam_max).to(device),
        grid=grid,
    )


class SnapshotDeviceCache:
    """Device entries keyed by snapshot VERSION — never patched in place.

    Builds are single-flight per key: the first caller of a fresh version
    builds the entry while racers wait on its event and reuse the result;
    a failed build releases the key so the next caller retries.  A small
    LRU on ACCESS keeps recent versions resident, so a version still being
    served outlives ``keep`` newer publishes.

    ``key`` scopes entries for shared use: the multi-tenant router passes
    ``(tenant, version)`` so independent engines pool ONE cache (and one
    device-memory budget) without their version counters colliding.
    ``spatial`` entries carry the grid of their table."""

    def __init__(self, device, keep: int = 4, spatial: bool = False):
        self.device = device
        self.keep = int(keep)
        self.spatial = bool(spatial)
        self._entries: dict = {}  # guarded-by: _lock
        self._order: list = []  # guarded-by: _lock
        # key -> Event of the in-flight build
        self._building: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.builds = 0  # guarded-by: _lock

    def entry(self, snap, key=None) -> DeviceSnapshotEntry:
        k = int(snap.version) if key is None else key
        while True:
            with self._lock:
                e = self._entries.get(k)
                if e is not None:
                    self.hits += 1
                    self._order.remove(k)
                    self._order.append(k)
                    return e
                ev = self._building.get(k)
                if ev is None:  # we are the builder
                    ev = threading.Event()
                    self._building[k] = ev
                    break
            # follower: wait for the builder, then re-check (entry
            # installed, or the build failed and the key is free)
            ev.wait()
        try:
            e = _build_entry(snap, self.device, self.spatial)  # unlocked: O(L·d) + upload
        except BaseException:
            with self._lock:
                del self._building[k]
            ev.set()
            raise
        with self._lock:
            self._entries[k] = e
            self._order.append(k)
            self.builds += 1
            del self._building[k]
            while len(self._order) > self.keep:
                self._entries.pop(self._order.pop(0), None)
        ev.set()
        return e


@dataclasses.dataclass
class QueryResult:
    """Per-query serve-plane output (`query_detailed`)."""

    labels: np.ndarray  # (n,) int64 flat labels, -1 noise
    bubble_index: np.ndarray  # (n,) int64 snapshot row of the nearest bubble
    distance: np.ndarray  # (n,) f64 distance to that representative
    strength: np.ndarray  # (n,) f64 membership strength in [0, 1]
    version: int  # snapshot version served (0 = none yet)

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def _empty_result(n: int, version: int) -> QueryResult:
    return QueryResult(
        labels=np.full(n, -1, dtype=np.int64),
        bubble_index=np.full(n, -1, dtype=np.int64),
        distance=np.full(n, np.inf, dtype=np.float64),
        strength=np.zeros(n, dtype=np.float64),
        version=int(version),
    )


class QueryEngine:
    """Batched queries against a `ClusterSnapshot` through the device
    cache.  The caller passes whichever snapshot object it captured, so
    labels, representatives and λ arrays come from that ONE snapshot."""

    def __init__(self, backend, dim: int, cache_keep: int = 4, *,
                 cache: SnapshotDeviceCache | None = None, scope=None):
        """``cache``/``scope`` support multi-tenant pooling: tenants share
        ONE SnapshotDeviceCache with entries keyed ``(scope, version)``
        so their independent version counters never collide."""
        self.backend = backend
        self.dim = int(dim)
        self.scope = scope
        self.cache = cache if cache is not None else SnapshotDeviceCache(
            backend.device, keep=cache_keep, spatial=getattr(backend, "spatial_index", False))

    def _cache_key(self, version: int):
        v = int(version)
        return v if self.scope is None else (self.scope, v)

    def query_detailed(self, snap, X) -> QueryResult:
        X = validate_query(X, self.dim)
        n = X.shape[0]
        if snap is None or snap.n_bubbles == 0 or n == 0:
            return _empty_result(n, 0 if snap is None else snap.version)
        entry = self.cache.entry(snap, key=self._cache_key(snap.version))
        parts = []
        for c0 in range(0, n, _MAX_CHUNK):
            Xr = X[c0 : c0 + _MAX_CHUNK]
            xc = torch.from_numpy((Xr - entry.center[None, :]).astype(np.float32))
            xc = xc.to(self.backend.device)
            if entry.grid is not None:
                out = _fused_query_grid(xc, entry.grid, entry.labels, entry.lam, entry.lam_max)
            else:
                out = _fused_query(xc, entry.reps, entry.labels, entry.lam, entry.lam_max)
            idx, lbl, dist, strength = to_numpy(*out)  # ONE host sync
            # a query out past _PAD_COORD can land on an L-bucket pad row:
            # it surfaces as "no bubble", never as a row ≥ n_bubbles
            pad_hit = idx >= entry.n_bubbles
            if pad_hit.any():
                idx[pad_hit] = -1
                lbl[pad_hit] = -1
                dist[pad_hit] = np.inf
                strength[pad_hit] = 0.0
            parts.append((idx, lbl, dist, strength))
        idx, lbl, dist, strength = (np.concatenate(a) for a in zip(*parts))
        return QueryResult(
            labels=lbl.astype(np.int64),
            bubble_index=idx.astype(np.int64),
            distance=dist.astype(np.float64),
            strength=strength.astype(np.float64),
            version=int(snap.version),
        )

    def query(self, snap, X) -> np.ndarray:
        return self.query_detailed(snap, X).labels


def _assign_pr4(x, reps, use_ref: bool):
    """The per-call path's assignment, frozen as the A/B baseline: an eager
    pairwise distance and a true argmin on the plain route, the assign
    kernel otherwise.  It must not inherit later kernel changes."""
    if not use_ref:
        return ops.assign(x, reps)
    from ..kernels import ref as _ref

    sq = _ref.pairwise_sqdist(x, reps)  # repro-lint: disable=RPL402 — the frozen dense baseline leg
    return torch.argmin(sq, dim=1).to(torch.int32)


def query_percall(backend, snap, X) -> np.ndarray:
    """The per-call serve path, kept as the A/B baseline and the parity
    oracle of the cached path: re-centres AND re-uploads the full (L, d)
    rep table on every call.  The plain route runs on a CPU backend, the
    assign kernel on the card."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    if snap is None or snap.n_bubbles == 0:
        return np.full(X.shape[0], -1, dtype=np.int64)
    dev = backend.device
    x = torch.from_numpy((X - snap.center).astype(np.float32)).to(dev)
    reps = torch.from_numpy((snap.bubble_rep - snap.center).astype(np.float32)).to(dev)
    (a,) = to_numpy(_assign_pr4(x, reps, dev.type == "cpu"))
    return snap.bubble_labels[a]


class _QueryTicket:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: QueryResult | None = None
        self.error: BaseException | None = None


class QueryBatcher:
    """Micro-batch concurrent `query()` callers into one fused dispatch.

    Callers push (X, ticket) pairs; whoever grabs the dispatch lock drains
    contiguous pending requests (point-counted, the same
    ``next_block(size=...)`` discipline as the ingest scheduler), runs ONE
    device-cached query over the concatenation, and fans the slices back
    out by ticket.  Followers wait on their ticket and re-contend for the
    lock every ``poll_s``, so a request pushed after the leader's last
    drain never strands.

    **Leader death**: a caller holding the dispatch lock executes OTHER
    callers' requests.  Any failure while it holds a drained block — the
    fused call raising, the concatenation, a malformed result — fans the
    exception out to every ticket of that block and re-raises at each
    ticket's caller; no follower waits forever on a ticket its dead
    leader popped.

    **Multi-tenant dispatch** (serving/tenants.py): requests carry a
    ``kind`` (the tenant name) and ``resolve(kind)`` maps each drained
    block to its engine.  `HostBatcher` only coalesces contiguous
    SAME-kind runs, so a block never mixes tenants.
    """

    def __init__(self, engine=None, max_batch: int = 1024,
                 poll_s: float = 0.002, resolve=None):
        if engine is None and resolve is None:
            raise ValueError("QueryBatcher needs an engine or a resolve(kind)")
        self.engine = engine  # anything with .query_detailed and ._query_engine
        self.poll_s = float(poll_s)
        self._resolve = resolve if resolve is not None else (lambda kind: self.engine)
        self._q = HostBatcher(max_block=int(max_batch))
        self._dispatch = threading.Lock()
        self.batches = 0  # guarded-by: _dispatch
        self.fanned_out = 0  # guarded-by: _dispatch

    def query_detailed(self, X, *, kind: str = "query") -> QueryResult:
        eng = self._resolve(kind)
        # validate in the CALLER so bad input raises here, not in a peer
        X = validate_query(X, eng._query_engine.dim)
        if X.shape[0] == 0:
            return eng.query_detailed(X)
        t = _QueryTicket()
        self._q.push((X, t), kind=kind)
        while True:
            if self._dispatch.acquire(blocking=False):
                try:
                    self._drain(own=t)
                except BaseException as e:  # noqa: BLE001 — leader died
                    # outside any block's fan-out (e.g. next_block itself):
                    # surface on our own ticket, never leave it pending
                    if not t.event.is_set():
                        t.error = e
                        t.event.set()
                finally:
                    self._dispatch.release()
            if t.event.wait(self.poll_s):
                break
        if t.error is not None:
            raise t.error
        return t.result

    def query(self, X, *, kind: str = "query") -> np.ndarray:
        return self.query_detailed(X, kind=kind).labels

    def _drain(self, own: _QueryTicket | None = None):  # holds: _dispatch
        """Service pending blocks; a leader stops once its OWN ticket is
        done (the rest are drained by their own pushers' acquire loops),
        so one unlucky caller never becomes a server thread with unbounded
        latency.  Called only with `_dispatch` held."""
        while self._q and not (own is not None and own.event.is_set()):
            kind, items = self._q.next_block(size=lambda it: it[0].shape[0])
            try:
                # everything between popping the block and completing its
                # tickets runs under the fan-out guard: once the items left
                # the queue, only this leader can complete them
                eng = self._resolve(kind)  # may-acquire: TenantRouter._lock
                X = np.concatenate([x for x, _ in items], axis=0)
                # may-acquire: StreamingClusterEngine._snapshot_lock, SnapshotDeviceCache._lock
                res = eng.query_detailed(X)
                if len(res) != X.shape[0]:
                    raise RuntimeError(
                        f"batched query returned {len(res)} rows for {X.shape[0]} requests")
                out = []
                off = 0
                for x, _ in items:
                    sl = slice(off, off + x.shape[0])
                    out.append(QueryResult(
                        labels=res.labels[sl],
                        bubble_index=res.bubble_index[sl],
                        distance=res.distance[sl],
                        strength=res.strength[sl],
                        version=res.version,
                    ))
                    off += x.shape[0]
            except BaseException as e:  # noqa: BLE001 — fanned out, not handled
                for _, t in items:
                    if not t.event.is_set():
                        t.error = e
                        t.event.set()
                continue
            # fan out only after EVERY slice exists: a failure above
            # poisons the whole block, never completes half of it
            for (_, t), r in zip(items, out):
                t.result = r
                t.event.set()
            self.batches += 1
            self.fanned_out += len(items)
