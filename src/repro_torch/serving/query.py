"""Versioned, device-cached batched queries (serve plane, DESIGN.md §9).

The PyTorch counterpart of the JAX package's ``serving/query.py``,
dense path:

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

Query rows are not padded to buckets: there is no compile cache to keep
warm, and the kernel masks the ragged edge itself.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..device import to_numpy
from ..kernels import ops

__all__ = [
    "QueryResult",
    "DeviceSnapshotEntry",
    "SnapshotDeviceCache",
    "QueryEngine",
    "validate_query",
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


def _build_entry(snap, device) -> DeviceSnapshotEntry:
    """Host-side O(L·d) derivation + ONE upload per published snapshot."""
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
    return DeviceSnapshotEntry(
        version=int(snap.version),
        n_bubbles=L,
        bucket=Lp,
        center=np.asarray(snap.center, dtype=np.float64),
        reps=torch.from_numpy(rep_c).to(device),
        labels=torch.from_numpy(lbl).to(device),
        lam=torch.from_numpy(lam).to(device),
        lam_max=torch.from_numpy(lam_max).to(device),
    )


class SnapshotDeviceCache:
    """Device entries keyed by snapshot VERSION — never patched in place.

    Builds are single-flight per key: the first caller of a fresh version
    builds the entry while racers wait on its event and reuse the result;
    a failed build releases the key so the next caller retries.  A small
    LRU on ACCESS keeps recent versions resident, so a version still being
    served outlives ``keep`` newer publishes."""

    def __init__(self, device, keep: int = 4):
        self.device = device
        self.keep = int(keep)
        self._entries: dict = {}  # guarded-by: _lock
        self._order: list = []  # guarded-by: _lock
        # key -> Event of the in-flight build
        self._building: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.builds = 0  # guarded-by: _lock

    def entry(self, snap) -> DeviceSnapshotEntry:
        k = int(snap.version)
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
            e = _build_entry(snap, self.device)  # unlocked: O(L·d) + upload
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

    def __init__(self, backend, dim: int, cache_keep: int = 4):
        self.backend = backend
        self.dim = int(dim)
        self.cache = SnapshotDeviceCache(backend.device, keep=cache_keep)

    def query_detailed(self, snap, X) -> QueryResult:
        X = validate_query(X, self.dim)
        n = X.shape[0]
        if snap is None or snap.n_bubbles == 0 or n == 0:
            return _empty_result(n, 0 if snap is None else snap.version)
        entry = self.cache.entry(snap)
        parts = []
        for c0 in range(0, n, _MAX_CHUNK):
            Xr = X[c0 : c0 + _MAX_CHUNK]
            xc = torch.from_numpy((Xr - entry.center[None, :]).astype(np.float32))
            out = _fused_query(xc.to(self.backend.device), entry.reps, entry.labels,
                               entry.lam, entry.lam_max)
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
