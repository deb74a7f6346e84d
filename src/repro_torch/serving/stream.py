"""Streaming clustering engine — the online–offline split as a service
(DESIGN.md §5), default mode.

The PyTorch counterpart of the JAX package's ``serving/stream.py``:

  request plane   `submit_insert` / `submit_delete` enqueue ops into a
                  `HostBatcher`; `poll()` drains them in contiguous
                  same-kind blocks into `BubbleTree.insert_block` /
                  `delete_block`.  On the card, the block's point → leaf
                  argmin runs through the assign kernel on rows centred
                  at the rep mean.

  offline plane   the tree tracks dirty mass; when dirty/total ≥ ε the
                  engine captures the alive-leaf CF rows and runs
                  `kernels.ops.offline_recluster_from_table` on the
                  device (Eq. 6 → Eq. 7 → Borůvka → hierarchy), sync or
                  in a background thread.

  serve plane     `query` / `query_detailed` / `labels` read the newest
                  published `ClusterSnapshot` through the versioned device
                  cache (serving/query.py); `QueryBatcher` coalesces
                  concurrent callers, `TenantRouter` hosts many engines
                  on one cache (serving/tenants.py).

  checkpoints     `checkpoint_state` / `save` / `restore` (DESIGN.md §11):
                  the JAX engine's format 1, key for key, through a
                  `CheckpointStore` (repro_torch/checkpoint) — the two
                  packages restore each other's checkpoints.

  device-online   with ``device_online=True`` the leaf CF table also lives
                  on the card (core/bubble_flat.py): each block runs the
                  assign kernel and the ``flat_scatter`` kernel there, the
                  host tree applies the assignment and its maintenance is
                  patched back, and ε-passes read the table straight from
                  the card (``ops.offline_recluster_from_device_table``).

  spatial index   with ``spatial_index=True`` ingest assignment, the
                  offline pass's Eq. 6 and Borůvka, and served queries go
                  through the Morton grid (kernels/grid.py): tile-pruned
                  exact searches, CUDA kernels on the card, the same
                  answers as the dense path and no (L, L) matrix.

  exact-dynamic   with ``exact=True`` (DESIGN.md §7) the engine maintains
                  the point-level MST itself (core/dynamic_torch.py): each
                  applied block goes through the paper's update rules
                  (Eqs. 11–12) on the card or, past the `UpdatePolicy`
                  crossover, marks the state for a rebuild; every poll
                  publishes labels from the maintained tree through the
                  hierarchy stages alone (``ops.incremental_recluster``).

  mesh            with ``mesh=`` (DESIGN.md §12: ``True`` for every visible
                  card, or a list of devices in this process) each
                  ε-pass runs its O(L²) stage — Eq. 6, the Eq. 7 strips,
                  Borůvka's row minima — in row strips, one shard per
                  device, gathered on the engine's device
                  (``ops._sharded_mst_stage``): bit for bit the unsharded
                  pass, host-table and device-online alike.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.bubble_flat import FlatFrameError
from ..core.bubble_tree import BubbleTree
from ..core.device_table import DynamicStateCapture, SnapshotDeviceTable
from ..device import to_numpy
from ..kernels import ops
from ..launch.mesh import resolve_mesh
from .batcher import HostBatcher
from .query import QueryEngine, QueryResult

__all__ = [
    "Ticket",
    "StalenessPolicy",
    "UpdatePolicy",
    "ClusterSnapshot",
    "QueryResult",
    "StreamingClusterEngine",
]

_CKPT_FORMAT = 1  # the JAX engine's checkpoint format, key for key

# OfflineClusterResult fields stored as snap/res_<field>
_RESULT_FIELDS = (
    "labels", "stabilities", "weights", "point_parent", "point_lambda",
    "cluster_parent", "cluster_birth", "cluster_weight", "selected",
    "all_stabilities",
)


def _ragged_pack(lists):
    """list of int lists → (flat, offsets) int64 arrays (CSR)."""
    off = np.zeros(len(lists) + 1, dtype=np.int64)
    for i, xs in enumerate(lists):
        off[i + 1] = off[i] + len(xs)
    flat = np.fromiter((p for xs in lists for p in xs), dtype=np.int64, count=int(off[-1]))
    return flat, off


def _ragged_unpack(flat, off) -> list[list[int]]:
    return [flat[off[i] : off[i + 1]].tolist() for i in range(len(off) - 1)]


@dataclasses.dataclass
class Ticket:
    """Handle for a queued insert block; `pids` is filled when the
    scheduler applies the block (needed to delete those points later)."""

    size: int
    pids: list | None = None

    @property
    def applied(self) -> bool:
        return self.pids is not None


@dataclasses.dataclass
class StalenessPolicy:
    """Re-cluster when the dirty mass (points inserted/deleted since the
    last offline pass) reaches ``epsilon`` × current population; below
    ``min_points`` there is nothing worth clustering."""

    epsilon: float = 0.1
    min_points: int = 32

    def stale(self, tree: BubbleTree, have_snapshot: bool, pending: float = 0.0) -> bool:
        """`pending` = dirty mass an in-flight pass has already captured."""
        if tree.n_points < self.min_points:
            return False
        if not have_snapshot:
            return True
        eff = max(0.0, tree.dirty_mass - pending)
        return eff / max(float(tree.n_points), 1.0) >= self.epsilon


@dataclasses.dataclass
class UpdatePolicy:
    """Crossover heuristic of the exact-dynamic path: where incremental
    maintenance stops beating a from-scratch pass (the paper's Fig. 3).
    Each applied block is routed

      * ``incremental`` — block points ≤ ``max_update_frac`` × current
        population: Eqs. 11–12 on the device, then labels through the
        hierarchy stages alone;
      * ``full`` — big blocks, small populations, or blocks that would grow
        the capacity bucket: the state is marked stale and the next refresh
        rebuilds it from the tree.

    A third, retroactive fallback lives in core/dynamic_torch.py: an
    RkNN/S' strip overflow flips the state's ``ok`` bit and the handle
    rebuilds."""

    max_update_frac: float = 0.05
    min_incremental_points: int = 64

    def route(self, n_before: int, block_points: int, grows: bool) -> str:
        if grows or n_before < self.min_incremental_points:
            return "full"
        if block_points > self.max_update_frac * max(n_before, 1):
            return "full"
        return "incremental"


@dataclasses.dataclass
class ClusterSnapshot:
    """Immutable result of one offline pass; the serve plane reads this."""

    version: int
    n_points: int
    bubble_rep: np.ndarray  # (L, d) representatives (serve-plane index)
    bubble_n: np.ndarray  # (L,) represented mass
    center: np.ndarray  # (d,) summary centroid — queries are centred
    #   before the f32 device kernel (off-origin cancellation, DESIGN.md §2)
    result: ops.OfflineClusterResult
    wall_seconds: float
    dirty_consumed: float = 0.0  # dirty mass this pass absorbed (settled
    #   against the tree by the MAIN thread — see _settle)

    @property
    def bubble_labels(self) -> np.ndarray:
        """(L,) flat cluster labels, -1 noise."""
        return self.result.labels

    @property
    def mst(self) -> tuple:
        """(u, v, w) MST edge arrays over bubbles."""
        return self.result.mst

    @property
    def n_bubbles(self) -> int:
        return int(self.bubble_rep.shape[0])

    @property
    def n_clusters(self) -> int:
        return len(set(self.bubble_labels.tolist()) - {-1})

    @property
    def stabilities(self) -> np.ndarray:
        return self.result.stabilities

    @property
    def condensed(self):
        """Host-layout CondensedTree, rebuilt on demand from the device
        arrays (the hot path never builds it)."""
        return self.result.to_condensed()

    @property
    def total_mst_weight(self) -> float:
        return float(np.sum(self.mst[2]))


def load_tree_state(t: BubbleTree, d: dict):
    """Install the ``tree/*`` fields of a format-1 state dict (the JAX
    engine's ``checkpoint_state()`` or the port's) into the Bubble-tree
    ``t`` field by field, free-list order and struct_dirty included.
    Raises ValueError when the arrays disagree on the node capacity."""
    t.LS = np.array(d["tree/LS"], dtype=np.float64)
    t.SS = np.array(d["tree/SS"], dtype=np.float64)
    t.N = np.array(d["tree/N"], dtype=np.float64)
    t.parent = np.array(d["tree/parent"], dtype=np.int64)
    t.height = np.array(d["tree/height"], dtype=np.int64)
    t.node_alive = np.array(d["tree/node_alive"], dtype=bool)
    t.is_leaf = np.array(d["tree/is_leaf"], dtype=bool)
    t.children = _ragged_unpack(d["tree/children_flat"], d["tree/children_off"])
    t.leaf_points = _ragged_unpack(d["tree/leaf_points_flat"], d["tree/leaf_points_off"])
    if not (len(t.children) == len(t.leaf_points) == t.LS.shape[0]):
        raise ValueError("checkpoint tree arrays disagree on the node capacity")
    t._node_free = d["tree/node_free"].astype(int).tolist()
    t.PX = np.array(d["tree/PX"], dtype=np.float64)
    t.point_alive = np.array(d["tree/point_alive"], dtype=bool)
    t.point_leaf = np.array(d["tree/point_leaf"], dtype=np.int64)
    t._point_free = d["tree/point_free"].astype(int).tolist()
    t._struct_dirty = set(d["tree/struct_dirty"].astype(int).tolist())
    t.root = int(d["tree/root"])
    t.n_points = int(d["tree/n_points"])
    t.dirty_mass = float(d["tree/dirty_mass"])
    t.mutations = int(d["tree/mutations"])
    t._op_count = int(d["tree/op_count"])


class StreamingClusterEngine:
    """Batched Bubble-tree ingestion + ε-triggered offline re-clustering.

    Args:
      dim: feature dimensionality.
      min_pts: HDBSCAN density parameter (offline phase).
      compression: Bubble-tree leaf steering factor (L ≈ compression × N).
      min_cluster_size: flat-extraction threshold (defaults to min_pts).
      epsilon: staleness threshold — re-cluster when ≥ this fraction of
        the population changed since the last pass.
      max_block: scheduler block cap (points coalesced per apply).
      device: where the kernels run; None = ``cuda`` (raises without a
        GPU), ``"cpu"`` = the plain PyTorch versions.
      async_offline: run offline passes in a background thread; `query`
        keeps serving the previous snapshot meanwhile.
      spatial_index: route ingest assignment, the offline pass's Eq. 6
        and Borůvka, and served queries through the Morton grid
        (kernels/grid.py): the same answers as the dense path, no (L, L)
        matrix; composes with ``device_online``.
      device_online: keep the leaf CF table on the device too (a flat
        slot table with compensated sums): block inserts and deletes run
        there as one assignment and one scatter, and ε-passes read it
        with no upload of the summary.  Incompatible with ``exact``.
      exact: the exact-dynamic path — maintain the point-level MST
        incrementally on the device (core/dynamic_torch.py) and refresh
        exact labels every poll through the hierarchy stages alone.
        Incompatible with ``device_online`` and ``async_offline``.
      update_policy: incremental-vs-full routing (exact mode only).
      exact_capacity: initial slot-capacity bucket of the dynamic state.
      mesh: the offline plane's devices (DESIGN.md §12): ``True`` = every
        visible device of the engine's type, led by ``device``; or a
        ``Mesh`` or a list of devices, the first of them ``device``, one
        may repeat.  ε-passes then run the O(L²) stage row-sharded over
        it, bit for bit the unsharded pass; snapshots, queries,
        checkpoints and ingest are untouched.  Incompatible with
        ``exact`` (the incremental path has no O(L²) stage).
      mesh_axis: the name of the mesh's axis.
      query_cache, query_scope: a shared `SnapshotDeviceCache` and this
        engine's scope in it — a `TenantRouter` pools one cache across
        engines with ``(tenant, version)`` keys.
      **tree_kw: forwarded to BubbleTree.
    """

    def __init__(
        self,
        dim: int,
        *,
        min_pts: int = 10,
        compression: float = 0.05,
        min_cluster_size: float | None = None,
        epsilon: float = 0.1,
        max_block: int = 512,
        device=None,
        async_offline: bool = False,
        min_offline_points: int = 32,
        spatial_index: bool = False,
        device_online: bool | None = None,
        exact: bool = False,
        update_policy: UpdatePolicy | None = None,
        exact_capacity: int = 256,
        mesh=None,
        mesh_axis: str = "data",
        query_cache=None,
        query_scope=None,
        **tree_kw,
    ):
        if device_online and exact:
            raise ValueError(
                "device_online summarizes into the flat leaf-CF state; "
                "exact=True bypasses bubble summarization entirely"
            )
        if exact and async_offline:
            raise ValueError("exact=True refreshes labels synchronously per poll; async_offline is not supported")
        self.backend = ops.get_backend(device, spatial_index=spatial_index)
        self.mesh = resolve_mesh(mesh, self.backend.device, str(mesh_axis))
        if self.mesh is not None and exact:
            raise ValueError(
                "mesh= shards the offline pass's O(L²) stage; exact=True "
                "maintains the point-level MST incrementally and has none"
            )
        assign_fn = None
        if self.backend.device.type == "cuda":
            # the ingest point→leaf argmin runs on the assign kernel (on the
            # CPU the tree's host f64 argmin is faster).  argmin is
            # translation-invariant; centre before the f32 kernel so
            # off-origin coordinates don't cancel (as the offline path does)
            def assign_fn(X, reps):
                mu = reps.mean(axis=0)
                return self.backend.assign(X - mu, reps - mu).cpu().numpy()
        self.tree = BubbleTree(  # owner: ingest thread (workers read captures)
            dim=dim, compression=compression, assign_fn=assign_fn, **tree_kw
        )
        self.min_pts = int(min_pts)
        self.min_cluster_size = float(
            min_pts if min_cluster_size is None else min_cluster_size
        )
        self.policy = StalenessPolicy(epsilon=float(epsilon), min_points=int(min_offline_points))
        self.batcher = HostBatcher(max_block=max_block)
        self.async_offline = bool(async_offline)
        self._snapshot: ClusterSnapshot | None = None  # guarded-by: _snapshot_lock
        self._snapshot_lock = threading.Lock()
        self._offline_thread: threading.Thread | None = None  # owner: ingest thread
        self._version = 0  # guarded-by: _snapshot_lock
        self._settled_version = 0  # owner: ingest thread (_settle)
        # dirty mass captured by the running pass
        self._inflight_consumed = 0.0  # owner: ingest thread
        # unsynchronized: single reference swap (GIL-atomic); the worker
        # writes once on failure, the ingest thread reads-and-clears
        self._offline_error: BaseException | None = None
        self._flat = (  # owner: ingest thread (workers read captures)
            self.backend.make_flat(dim, mesh=self.mesh) if device_online else None
        )
        # offline plane sources (core.device_table): the host tree is the
        # always-ready fallback; device_online prefers the flat table
        self._host_table = SnapshotDeviceTable(self.tree)  # owner: ingest thread
        self._table = self._flat if device_online else self._host_table  # owner: ingest thread
        self.exact = bool(exact)
        self.update_policy = update_policy if update_policy is not None else UpdatePolicy()
        self._dyn = (  # owner: ingest thread (exact mode is synchronous)
            self.backend.make_dynamic(self.min_pts, dim, capacity=int(exact_capacity)) if self.exact else None
        )
        # no incremental state until the first rebuild
        self._dyn_stale = True  # owner: ingest thread
        self._pid2slot: dict[int, int] = {}  # owner: ingest thread
        self._query_engine = QueryEngine(self.backend, dim, cache=query_cache, scope=query_scope)
        # unsynchronized: single-reference swap; readers take ONE read of
        # the (key, payload) tuple (see labels()) so entries never mix
        self._labels_cache: tuple | None = None
        # unsynchronized: best-effort observability counters (worker and
        # ingest thread both increment; a lost count is acceptable)
        self.stats = {
            "inserts": 0,
            "deletes": 0,
            "blocks_applied": 0,
            "recluster_count": 0,
            "recluster_skipped_busy": 0,
            "recluster_failures": 0,
            "offline_seconds_total": 0.0,
            "incremental_blocks": 0,
            "exact_full_blocks": 0,
            "exact_rebuilds": 0,
            "device_online_blocks": 0,
            "flat_loads": 0,
            "label_cache_hits": 0,
        }

    # -- request plane -----------------------------------------------------

    def submit_insert(self, X) -> Ticket:
        """Queue a block of points for insertion; returns a Ticket whose
        `pids` fill in once the scheduler applies the block.  The points
        are copied at submit time — callers may reuse their buffer."""
        X = np.array(X, dtype=np.float64, copy=True, ndmin=2)
        if X.size == 0:  # e.g. [] arrives as (1, 0); normalize to 0 points
            X = X.reshape(0, self.tree.dim)
        if X.ndim != 2 or X.shape[1] != self.tree.dim:
            # validate at submit time: a bad request deferred into poll()
            # would crash the drain loop and take coalesced siblings down
            raise ValueError(f"expected (n, {self.tree.dim}) points, got {X.shape}")
        t = Ticket(size=X.shape[0])
        self.batcher.push((X, t), kind="insert")
        return t

    def submit_delete(self, pids):
        """Queue point retirements (pids from an applied insert Ticket)."""
        pids = [int(p) for p in np.atleast_1d(np.asarray(pids)).ravel()]
        self.batcher.push(pids, kind="delete")

    def poll(self, max_blocks: int | None = None) -> int:
        """Drain the request queue: coalesce contiguous same-kind requests
        into blocks (≤ max_block points each), apply them to the tree, then
        consult the staleness policy.  Returns the number of ops applied."""
        applied = 0
        blocks = 0
        while self.batcher and (max_blocks is None or blocks < max_blocks):
            kind, items = self.batcher.next_block(size=self._point_count)
            if kind == "insert":
                X = np.concatenate([x for x, _ in items], axis=0)
                pids = self._apply_insert_block(X)
                self._exact_apply_insert(X, pids)
                off = 0
                for x, ticket in items:  # requests are never split: one fill
                    take = x.shape[0]
                    ticket.pids = pids[off : off + take]
                    off += take
                self.stats["inserts"] += X.shape[0]
                applied += X.shape[0]
            else:
                flat_pids = [p for chunk in items for p in chunk]
                try:
                    self._apply_delete_block(flat_pids)
                except KeyError:
                    # a bad request (dead/duplicate pid) must not take its
                    # coalesced siblings down: delete_block is atomic per
                    # call, so replay per request and surface the first
                    # failure — what sequential submission would do
                    done, err = 0, None
                    for chunk in items:
                        try:
                            self._apply_delete_block(chunk)
                            done += len(chunk)
                        except KeyError as e:
                            if err is None:
                                err = e
                        else:
                            self._exact_apply_delete(chunk)
                    self.stats["deletes"] += done
                    if err is not None:
                        raise err from None
                else:
                    self._exact_apply_delete(flat_pids)
                    self.stats["deletes"] += len(flat_pids)
                    applied += len(flat_pids)
            self.stats["blocks_applied"] += 1
            blocks += 1
        self.maybe_recluster()
        return applied

    @staticmethod
    def _point_count(item) -> int:
        """Points in one queued request: insert items are (X, Ticket),
        delete items are pid lists."""
        return item[0].shape[0] if isinstance(item, tuple) else len(item)

    def ingest(self, X) -> list[int]:
        """Synchronous convenience: submit + drain; returns the new pids."""
        t = self.submit_insert(X)
        self.poll()
        return t.pids

    def retire(self, pids):
        """Synchronous convenience: submit deletions + drain."""
        self.submit_delete(pids)
        self.poll()

    # -- device-online ingestion (core.bubble_flat, DESIGN.md §8) ----------

    def _apply_insert_block(self, X) -> list:
        """Apply one coalesced insert block: the device-online path runs
        the assignment and the CF scatter on the device, hands the tree the
        assignment and the overfull work-list, and patches the rows its
        maintenance touched back; otherwise the host `insert_block`."""
        if self._flat is None or self.tree.num_leaves <= 1:
            pids = self.tree.insert_block(X)
            if self._flat is not None:
                if self.tree.num_leaves > 1:
                    # bootstrap done: load eagerly so this poll's ε-pass
                    # already reads the device table
                    self._flat.load(self.tree)
                    self.stats["flat_loads"] = self._flat.loads
                else:
                    self._flat.stale = True
            return pids
        if self._flat.stale:
            self._flat.load(self.tree)
        cap = self.tree._leaf_cap_at(self.tree.n_points + X.shape[0])
        try:
            leaf_ids, work = self._flat.insert_block(X, cap)
        except FlatFrameError:
            # the dead-slot guard: the stream drifted outside the centred
            # frame, the table is stale (reloads at a fresh origin before
            # the next scatter or ε-pass) and the block takes the host path
            return self.tree.insert_block(X)
        except BaseException:
            # a kernel that failed to build or launch is the caller's to
            # see, never bypassed; the table may hold part of the block,
            # so it reloads from the tree before its next use
            self._flat.stale = True
            raise
        pids = self.tree.apply_assigned_block(X, leaf_ids, overfull_hint=work)
        self._flat.sync_struct(self.tree)
        self.stats["device_online_blocks"] += 1
        self.stats["flat_loads"] = self._flat.loads
        return pids

    def _apply_delete_block(self, pids):
        """Apply one coalesced delete block; the device-online path mirrors
        the per-leaf CF subtraction as a scatter (victim leaves are read
        from `point_leaf` BEFORE the tree mutates, and the device table is
        touched only after the tree's atomic validation passed)."""
        if self._flat is None or self._flat.stale:
            self.tree.delete_block(pids)
            return
        arr = np.asarray(pids, dtype=np.int64)
        ok = arr.size > 0 and bool(((arr >= 0) & (arr < self.tree.point_alive.shape[0])).all())
        leaves = self.tree.point_leaf[arr].copy() if ok else None
        Xv = self.tree.PX[arr].copy() if ok else None
        self.tree.delete_block(pids)  # raises before any mutation on bad pids
        if leaves is not None and len(leaves):
            try:
                self._flat.delete_block(leaves, Xv, self.tree.m)
            except BaseException:
                self._flat.stale = True  # reloads from the tree; the error is the caller's
                raise
        self._flat.sync_struct(self.tree)
        self.stats["device_online_blocks"] += 1
        self.stats["flat_loads"] = self._flat.loads

    # -- exact-dynamic path (core/dynamic_torch.py, DESIGN.md §7) -----------

    def _exact_apply_insert(self, X, pids):
        """Route one applied insert block through the incremental rules
        (Eq. 11), or mark the device state stale for a rebuild at the next
        refresh — the UpdatePolicy crossover."""
        if not self.exact:
            return
        route = self.update_policy.route(self._dyn.n, len(pids), self._dyn.would_grow(len(pids)))
        if self._dyn_stale or route == "full":
            self._dyn_stale = True
            self.stats["exact_full_blocks"] += 1
            return
        slots = self._dyn.insert_block(X)
        for p, s in zip(pids, slots):
            self._pid2slot[int(p)] = s
        self.stats["incremental_blocks"] += 1

    def _exact_apply_delete(self, pids):
        """Same, for deletions (Eq. 12).  An RkNN/S' overflow inside the
        update rebuilds the state in place (slots survive), so the mapping
        stays valid either way."""
        if not self.exact:
            return
        route = self.update_policy.route(self._dyn.n, len(pids), False)
        if self._dyn_stale or route == "full":
            self._dyn_stale = True
            self.stats["exact_full_blocks"] += 1
            for p in pids:
                self._pid2slot.pop(int(p), None)
            return
        self._dyn.delete_block([self._pid2slot.pop(int(p)) for p in pids])
        self.stats["incremental_blocks"] += 1

    def _rebuild_dyn(self):
        """Full pass: reload the device state from the tree's alive points
        (the authoritative store) and rebuild kNN, cd and MST from scratch."""
        pids, X = self.tree.alive_points()
        slots = self._dyn.load(X, slots=list(range(len(pids))), shrink=True)
        self._pid2slot = {int(p): s for p, s in zip(pids, slots)}
        self._dyn_stale = False
        self.stats["exact_rebuilds"] += 1

    def _exact_refresh(self, force: bool = False) -> bool:
        """The exact-mode maybe_recluster: every poll that left the tree
        dirty publishes a snapshot — incremental states pay the hierarchy
        stages only, stale or overflowed ones one rebuild first.  Snapshot
        rows are the alive slots in ascending order, their coordinates
        gathered on the device: ONE host read per refresh."""
        n = self.tree.n_points
        if n < 2 or (n < self.policy.min_points and not force):
            return False
        if self.tree.dirty_mass <= 0 and self.snapshot is not None and not force:
            return False
        t0 = time.perf_counter()
        dirty_captured = self.tree.dirty_mass
        if self._dyn_stale or not self._dyn.ok or self._dyn.n != n:
            self._rebuild_dyn()
        cap = DynamicStateCapture(state=self._dyn.state, dim=self.tree.dim)
        res, rep, n_b, center = cap.recluster(
            self.backend, min_pts=self.min_pts, min_cluster_size=self.min_cluster_size)
        self._publish_snapshot(res, rep, n_b, center, n, dirty_captured, t0)
        self._settle()
        return True

    # -- offline plane -----------------------------------------------------

    def _settle(self):
        """Consume a finished pass's dirty mass — on the MAIN thread only,
        so `tree.dirty_mass` has a single writer thread."""
        with self._snapshot_lock:
            snap = self._snapshot
        if snap is not None and snap.version > self._settled_version:
            self.tree.dirty_mass = max(0.0, self.tree.dirty_mass - snap.dirty_consumed)
            self._settled_version = snap.version
            self._inflight_consumed = 0.0

    def maybe_recluster(self, force: bool = False) -> bool:
        """Trigger an offline pass if the policy says the hierarchy is
        stale (or `force`).  Async mode returns immediately; a pass
        already in flight absorbs the trigger.  Exact mode refreshes from
        the maintained MST instead (every poll, never ε-deferred)."""
        if self.exact:
            return self._exact_refresh(force)
        self._raise_pending_offline_error()
        # liveness BEFORE settle: a pass landing in between is still
        # settled before any capture below, never double-settled
        busy = self._offline_thread is not None and self._offline_thread.is_alive()
        self._settle()
        pending = self._inflight_consumed if busy else 0.0
        have = self.snapshot is not None or busy
        if not force and not self.policy.stale(self.tree, have, pending=pending):
            return False
        if self.tree.n_points < 2:
            return False
        if busy:
            self.stats["recluster_skipped_busy"] += 1
            return False
        # capture: the dirty mass this pass consumes + an isolation copy of
        # the summary, through whichever source is ready — the flat table
        # when device_online and fresh (its tensors cloned on the card, no
        # upload of the summary), the host tree otherwise (the L gathered
        # CF rows) — so an async worker is immune to later blocks
        dirty_captured = self.tree.dirty_mass
        n_points = self.tree.n_points
        src = self._table if self._table.ready else self._host_table
        cap = src.capture(n_points)
        if self.async_offline:
            self._inflight_consumed = dirty_captured
            th = threading.Thread(
                target=self._offline_pass_guarded,
                args=(cap, n_points, dirty_captured),
                daemon=True,
            )
            self._offline_thread = th
            th.start()
        else:
            self._offline_pass(cap, n_points, dirty_captured)
            self._settle()
        return True

    def _offline_pass_guarded(self, *args):
        """Worker entry: capture failures for the main thread, which
        re-raises them from join()/poll()."""
        try:
            self._offline_pass(*args)
        except BaseException as e:  # noqa: BLE001 — transported, not handled
            self._offline_error = e
            self.stats["recluster_failures"] += 1

    def _raise_pending_offline_error(self):
        if self._offline_error is not None:
            err, self._offline_error = self._offline_error, None
            self._inflight_consumed = 0.0
            raise RuntimeError("async offline re-cluster pass failed") from err

    def _offline_pass(self, capture, n_points, dirty_captured):
        """One offline pass over a capture (through the mesh when the engine
        has one), published as ONE snapshot."""
        t0 = time.perf_counter()
        res, rep, n_b, center = capture.recluster(
            self.backend, min_pts=self.min_pts, min_cluster_size=self.min_cluster_size, mesh=self.mesh)
        return self._publish_snapshot(res, rep, n_b, center, n_points, dirty_captured, t0)

    def _publish_snapshot(self, res, rep, n_b, center, n_points, dirty_captured, t0):
        """Version bump and swap in ONE place: the ε-triggered offline
        plane and the exact path both publish here.  Settling the dirty
        mass is the main thread's (``_settle``)."""
        wall = time.perf_counter() - t0
        # version bump + swap under ONE lock hold
        with self._snapshot_lock:
            self._version += 1
            snap = ClusterSnapshot(
                version=self._version,
                n_points=int(n_points),
                bubble_rep=rep,
                bubble_n=n_b,
                center=center,
                result=res,
                wall_seconds=wall,
                dirty_consumed=float(dirty_captured),
            )
            self._snapshot = snap
        self.stats["recluster_count"] += 1
        self.stats["offline_seconds_total"] += wall
        return snap

    def flush(self) -> ClusterSnapshot | None:
        """Drain every queued request, finish any in-flight offline pass,
        and force one final pass if anything is still dirty."""
        while self.batcher:
            self.poll()
        self.join()
        if self.tree.n_points >= 2 and (
            self.snapshot is None or self.tree.dirty_mass > 0
        ):
            self.maybe_recluster(force=True)
            self.join()
        return self.snapshot

    def join(self):
        if self._offline_thread is not None:
            self._offline_thread.join()
            self._offline_thread = None
        self._settle()
        self._raise_pending_offline_error()

    # -- checkpointing (DESIGN.md §11) --------------------------------------

    def checkpoint_state(self) -> dict:
        """The engine's durable state as one flat dict of host arrays, in
        the JAX engine's format 1: the whole tree (CF arrays, topology,
        point store, free lists in order, so point ids replay bit for
        bit), the ε accounting and the last PUBLISHED snapshot.  Not
        captured: an in-flight async pass (recovery replays to the last
        published version and the pass re-triggers off the kept dirty
        mass), the exact-mode dynamic MST state (rebuilt from the tree at
        the next refresh), queued requests and the counters.  Call from the
        ingest thread, as `poll()`."""
        # ONE lock hold for (version, snapshot): separate reads could pair
        # version N with a version-N+1 snapshot, and the restored engine
        # would issue N+1 a second time
        with self._snapshot_lock:
            version = self._version
            snap = self._snapshot
        t = self.tree
        cap = t.LS.shape[0]
        ch_flat, ch_off = _ragged_pack(t.children[:cap])
        lp_flat, lp_off = _ragged_pack(t.leaf_points[:cap])
        state = {
            "cfg/format": np.int64(_CKPT_FORMAT),
            "cfg/dim": np.int64(t.dim),
            "cfg/min_pts": np.int64(self.min_pts),
            "cfg/min_cluster_size": np.float64(self.min_cluster_size),
            "cfg/compression": np.float64(t.compression),
            "cfg/epsilon": np.float64(self.policy.epsilon),
            "cfg/exact": np.bool_(self.exact),
            "cfg/device_online": np.bool_(self._flat is not None),
            "tree/LS": t.LS.copy(),
            "tree/SS": t.SS.copy(),
            "tree/N": t.N.copy(),
            "tree/parent": t.parent.copy(),
            "tree/height": t.height.copy(),
            "tree/node_alive": t.node_alive.copy(),
            "tree/is_leaf": t.is_leaf.copy(),
            "tree/children_flat": ch_flat,
            "tree/children_off": ch_off,
            "tree/leaf_points_flat": lp_flat,
            "tree/leaf_points_off": lp_off,
            "tree/node_free": np.asarray(t._node_free, dtype=np.int64),
            "tree/PX": t.PX.copy(),
            "tree/point_alive": t.point_alive.copy(),
            "tree/point_leaf": t.point_leaf.copy(),
            "tree/point_free": np.asarray(t._point_free, dtype=np.int64),
            "tree/struct_dirty": np.asarray(sorted(t._struct_dirty), dtype=np.int64),
            "tree/root": np.int64(t.root),
            "tree/n_points": np.int64(t.n_points),
            "tree/dirty_mass": np.float64(t.dirty_mass),
            "tree/mutations": np.int64(t.mutations),
            "tree/op_count": np.int64(t._op_count),
            "eng/version": np.int64(version),
            "eng/settled_version": np.int64(self._settled_version),
            "snap/has": np.bool_(snap is not None),
        }
        if snap is not None:
            state.update({
                "snap/version": np.int64(snap.version),
                "snap/n_points": np.int64(snap.n_points),
                "snap/bubble_rep": np.asarray(snap.bubble_rep),
                "snap/bubble_n": np.asarray(snap.bubble_n),
                "snap/center": np.asarray(snap.center),
                "snap/wall_seconds": np.float64(snap.wall_seconds),
                "snap/dirty_consumed": np.float64(snap.dirty_consumed),
                "snap/mst_u": np.asarray(snap.mst[0]),
                "snap/mst_v": np.asarray(snap.mst[1]),
                "snap/mst_w": np.asarray(snap.mst[2]),
            })
            for f in _RESULT_FIELDS:
                state[f"snap/res_{f}"] = np.asarray(getattr(snap.result, f))
            state["snap/res_min_cluster_size"] = np.float64(snap.result.min_cluster_size)
        flat_live = self._flat is not None and not self._flat.stale
        state["flat/has"] = np.bool_(flat_live)
        if flat_live:
            f = self._flat
            LS, LSe, SS, SSe, N, alive = (a.copy() for a in to_numpy(*f.device_view()))
            state.update({
                "flat/LS": LS,
                "flat/LSe": LSe,
                "flat/SS": SS,
                "flat/SSe": SSe,
                "flat/N": N,
                "flat/alive": alive,
                "flat/origin": f.origin.copy(),
                "flat/leaf_of_slot": f.leaf_of_slot.copy(),
                "flat/free": np.asarray(f._free, dtype=np.int64),
                "flat/hi": np.int64(f._hi),
                "flat/loads": np.int64(f.loads),
            })
        return state

    def save(self, store, step: int | None = None, *, blocking: bool = True) -> int:
        """Checkpoint through a `CheckpointStore` (atomic publish, async
        writes, retention).  ``step`` defaults to the tree's monotonic
        mutation counter, so successive saves of a live stream land under
        distinct, ordered steps.  Returns the step."""
        if step is None:
            step = int(self.tree.mutations)
        store.save(step, self.checkpoint_state(), blocking=blocking)
        return step

    def restore(self, store, step: int | None = None) -> int:
        """Load a checkpoint written by `save()` — by this package or the
        JAX one — into THIS engine (built with a compatible config): the
        killed-worker recovery path.  The summary, the accounting and the
        last published snapshot replay, so serving resumes at that version
        and the stream continues bit for bit.  Returns the step."""
        step, d = store.restore(step=step)
        self._load_state(d, same_mode=True)
        return step

    def _load_state(self, d: dict, *, same_mode: bool = False):
        """Install a format-1 state dict field by field: the tree (free-list
        order and struct_dirty included), the ε accounting, the version
        counter, the published snapshot and, device-online, the flat table.
        Raises as the JAX engine's restore does on an unknown format, a
        wrong dim or queued requests, and with ``same_mode`` on a
        checkpoint whose ``cfg/exact`` or ``cfg/device_online`` differs
        from this engine's (ValueError).  An exact-mode engine's dynamic
        state is not in the checkpoint: it is rebuilt from the restored
        tree at the next refresh."""
        if int(d["cfg/format"]) != _CKPT_FORMAT:
            raise ValueError(f"unknown checkpoint format {int(d['cfg/format'])}")
        if int(d["cfg/dim"]) != self.tree.dim:
            raise ValueError(f"checkpoint dim {int(d['cfg/dim'])} != engine dim {self.tree.dim}")
        if same_mode:
            for key, mine in (("cfg/exact", self.exact), ("cfg/device_online", self._flat is not None)):
                if bool(d[key]) != mine:
                    raise ValueError(
                        f"checkpoint {key}={bool(d[key])} does not match this engine ({mine}) — "
                        "construct the replacement worker with the same mode")
        if self.batcher:
            raise RuntimeError("restore() into an engine with queued requests")
        load_tree_state(self.tree, d)
        self._settled_version = int(d["eng/settled_version"])
        self._inflight_consumed = 0.0
        self._offline_thread = None
        self._offline_error = None
        self._labels_cache = None
        snap = None
        if bool(d["snap/has"]):
            res = ops.OfflineClusterResult(
                mst=(np.asarray(d["snap/mst_u"]), np.asarray(d["snap/mst_v"]),
                     np.asarray(d["snap/mst_w"])),
                min_cluster_size=float(d["snap/res_min_cluster_size"]),
                **{f: np.asarray(d[f"snap/res_{f}"]) for f in _RESULT_FIELDS},
            )
            snap = ClusterSnapshot(
                version=int(d["snap/version"]),
                n_points=int(d["snap/n_points"]),
                bubble_rep=np.asarray(d["snap/bubble_rep"]),
                bubble_n=np.asarray(d["snap/bubble_n"]),
                center=np.asarray(d["snap/center"]),
                result=res,
                wall_seconds=float(d["snap/wall_seconds"]),
                dirty_consumed=float(d["snap/dirty_consumed"]),
            )
        with self._snapshot_lock:
            self._version = int(d["eng/version"])
            self._snapshot = snap
        if self._flat is not None:
            if bool(d["flat/has"]):
                self._restore_flat(d)
            else:
                self._flat.stale = True
        if self.exact:
            # the dynamic MST state is not serialized: one rebuild from the
            # restored tree (the authoritative point store) at the next
            # refresh reproduces it
            self._dyn_stale = True
            self._pid2slot = {}

    def _restore_flat(self, d: dict):
        """Rebuild the device-resident flat table bit for bit: origin, slot
        order, free-list order and Kahan compensations all round-trip, so
        the next ε-pass compacts the same rows in the same order as the
        uninterrupted worker would have."""
        f = self._flat
        f._alloc(int(d["flat/LS"].shape[0]))
        for name in ("LS", "LSe", "SS", "SSe", "N"):  # torch.tensor copies: never alias the dict
            setattr(f, name, torch.tensor(np.asarray(d[f"flat/{name}"]), dtype=torch.float32, device=f.device))
        f.alive = torch.tensor(np.asarray(d["flat/alive"]), dtype=torch.bool, device=f.device)
        f.origin = np.array(d["flat/origin"], dtype=np.float64)
        f.leaf_of_slot = np.array(d["flat/leaf_of_slot"], dtype=np.int64)
        f.slot_of_leaf = {int(leaf): s for s, leaf in enumerate(f.leaf_of_slot) if leaf >= 0}
        f._free = d["flat/free"].astype(int).tolist()
        f._alive_host = np.array(d["flat/alive"], dtype=bool)
        f._hi = int(d["flat/hi"])
        f.loads = int(d["flat/loads"])
        f._tree = self.tree
        f.stale = False

    # -- serve plane -------------------------------------------------------

    @property
    def snapshot(self) -> ClusterSnapshot | None:
        with self._snapshot_lock:
            return self._snapshot

    def query(self, X) -> np.ndarray:
        """Cluster labels for query points from the newest snapshot
        (nearest bubble, label inherited); -1 for all points before the
        first pass."""
        return self.query_detailed(X).labels

    def query_detailed(self, X, *, snapshot: ClusterSnapshot | None = None) -> QueryResult:
        """Flat label, nearest-bubble row, distance to its representative
        and membership strength; ``snapshot`` pins the version served."""
        snap = self.snapshot if snapshot is None else snapshot
        return self._query_engine.query_detailed(snap, X)

    def labels(self) -> tuple[np.ndarray, np.ndarray]:
        """(pids, labels) for every alive point via the newest snapshot,
        memoized on (snapshot version, tree mutation counter)."""
        snap = self.snapshot
        key = (0 if snap is None else snap.version, self.tree.mutations)
        cache = self._labels_cache  # ONE read: never mix entries
        if cache is not None and cache[0] == key:
            pids, lab = cache[1]
            self.stats["label_cache_hits"] += 1
            return pids.copy(), lab.copy()
        pids, X = self.tree.alive_points()
        lab = self._query_engine.query(snap, X)
        self._labels_cache = (key, (pids, lab))
        return pids.copy(), lab.copy()
