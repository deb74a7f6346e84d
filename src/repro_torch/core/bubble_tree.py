"""Bubble-tree (paper §4.1) — fully-dynamic balanced CF tree with a
compression-factor-steered leaf count (Algorithm 1).

The port's own copy of the JAX package's ``core/bubble_tree.py`` (numpy
only), the data-bubble export ``to_bubbles`` (core/bubbles.py) included.

Layout: flat structure-of-arrays (DESIGN.md §2).  Node statistics
(LS/SS/n) live in dense numpy arrays indexed by node id, so the offline
phase extracts the leaf CF table as an array *view* with zero copies and
hands it to the device offline pass (kernels/ops.py).  Tree topology
(children lists, parent, height) is host-side — descent touches
height × M ≈ tens of CFs and is latency-bound, far below any device
dispatch threshold; the throughput path (`insert_block`) vectorizes
point→leaf assignment over the whole leaf table instead.

Properties maintained (paper Properties 1–4):
  1. root has 2..M children (or is a leaf while the tree is small),
  2. internal nodes have m..M children,
  3. leaf CFs summarize actual points; internal CFs summarize children,
  4. the number of leaves is steered to L = compression × N.

Differences vs. ClusTree (§2.3): no decay, deletions are exact (CFs are
sums), leaf count is *actively* rebalanced (split most-overfilled /
dissolve most-underfilled / reorganize), making the summary
order-independent — the property §5.1 demonstrates.
"""

from __future__ import annotations

import numpy as np

from .bubbles import DataBubbles, bubbles_from_cf
from .cf import CFTable

__all__ = ["BubbleTree"]


class BubbleTree:
    def __init__(
        self,
        dim: int,
        M: int = 10,
        m: int | None = None,
        compression: float = 0.01,
        min_leaves: int = 2,
        capacity: int = 256,
        reorg_every: int = 1,
        overfull_factor: float = 4.0,
        assign_fn=None,
    ):
        if m is None:
            m = max(2, M // 2 - 1)
        assert 2 * m <= M + 1, "fanout invariant 2m <= M+1"
        self.dim = dim
        self.M = int(M)
        self.m = int(m)
        self.compression = float(compression)
        self.min_leaves = int(min_leaves)
        self.reorg_every = int(reorg_every)
        self.overfull_factor = float(overfull_factor)
        self._op_count = 0
        self._assign_fn = assign_fn  # optional accelerated point->leaf argmin
        # dirty-mass accounting (DESIGN.md §5): points inserted/deleted
        # since the last offline pass — the staleness signal that steers
        # re-clustering the same way compression steers the leaf count.
        self.dirty_mass = 0.0
        # monotonic ingest/retire counter — unlike dirty_mass it is never
        # settled back, so serve-plane caches (engine.labels()) can key
        # on (snapshot version, mutations) and invalidate on any churn
        self.mutations = 0
        # leaves whose stats/liveness changed through *structural*
        # maintenance (splits, dissolves, reorg, sequential descent) —
        # changes a block-level device mirror (core.bubble_flat) cannot
        # reproduce from the block's own scatter; it patches these rows.
        self._struct_dirty: set[int] = set()

        # --- node SoA ---
        cap = capacity
        self.LS = np.zeros((cap, dim), dtype=np.float64)
        self.SS = np.zeros(cap, dtype=np.float64)
        self.N = np.zeros(cap, dtype=np.float64)
        self.parent = np.full(cap, -1, dtype=np.int64)
        self.height = np.zeros(cap, dtype=np.int64)  # leaves: 0
        self.node_alive = np.zeros(cap, dtype=bool)
        self.is_leaf = np.zeros(cap, dtype=bool)
        self.children: list[list[int]] = [[] for _ in range(cap)]
        self.leaf_points: list[list[int]] = [[] for _ in range(cap)]
        self._node_free = list(range(cap - 1, -1, -1))

        # --- point store ---
        pcap = capacity * 4
        self.PX = np.zeros((pcap, dim), dtype=np.float64)
        self.point_alive = np.zeros(pcap, dtype=bool)
        self.point_leaf = np.full(pcap, -1, dtype=np.int64)
        self._point_free = list(range(pcap - 1, -1, -1))
        self.n_points = 0

        self.root = self._new_node(leaf=True, height=0)

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------

    def _new_node(self, leaf: bool, height: int) -> int:
        if not self._node_free:
            cap = self.LS.shape[0]
            self.LS = np.concatenate([self.LS, np.zeros((cap, self.dim))])
            self.SS = np.concatenate([self.SS, np.zeros(cap)])
            self.N = np.concatenate([self.N, np.zeros(cap)])
            self.parent = np.concatenate([self.parent, np.full(cap, -1, dtype=np.int64)])
            self.height = np.concatenate([self.height, np.zeros(cap, dtype=np.int64)])
            self.node_alive = np.concatenate([self.node_alive, np.zeros(cap, dtype=bool)])
            self.is_leaf = np.concatenate([self.is_leaf, np.zeros(cap, dtype=bool)])
            self.children.extend([[] for _ in range(cap)])
            self.leaf_points.extend([[] for _ in range(cap)])
            self._node_free.extend(range(2 * cap - 1, cap - 1, -1))
        nid = self._node_free.pop()
        self.LS[nid] = 0.0
        self.SS[nid] = 0.0
        self.N[nid] = 0.0
        self.parent[nid] = -1
        self.height[nid] = height
        self.node_alive[nid] = True
        self.is_leaf[nid] = leaf
        self.children[nid] = []
        self.leaf_points[nid] = []
        return nid

    def _free_node(self, nid: int):
        self.node_alive[nid] = False
        self.children[nid] = []
        self.leaf_points[nid] = []
        self._node_free.append(nid)

    def _grow_point_store(self):
        """Double the point store; newly-freed ids extend the free list so
        they pop in ascending order (insertion-order pids on a fresh
        store — offline consumers map point_ids to dataset rows by it)."""
        cap = self.PX.shape[0]
        self.PX = np.concatenate([self.PX, np.zeros((cap, self.dim))])
        self.point_alive = np.concatenate([self.point_alive, np.zeros(cap, dtype=bool)])
        self.point_leaf = np.concatenate([self.point_leaf, np.full(cap, -1, dtype=np.int64)])
        self._point_free.extend(range(2 * cap - 1, cap - 1, -1))

    def _new_point(self, p: np.ndarray) -> int:
        if not self._point_free:
            self._grow_point_store()
        pid = self._point_free.pop()
        self.PX[pid] = p
        self.point_alive[pid] = True
        self.point_leaf[pid] = -1
        return pid

    def _new_points(self, P: np.ndarray) -> list[int]:
        """Bulk point allocation: chunked slices off the free list plus
        one fancy-indexed store (the per-point path costs a Python
        round-trip per row on the throughput paths).  Semantics match n
        repeated ``_new_point`` calls EXACTLY — grow only when the free
        list is exhausted, never preemptively — because on a fresh store
        that yields pids in insertion order, a property offline consumers
        rely on to map point_ids back to their dataset rows."""
        n = P.shape[0]
        pids: list[int] = []
        while len(pids) < n:
            if not self._point_free:
                self._grow_point_store()
            take = min(len(self._point_free), n - len(pids))
            pids.extend(self._point_free[-take:][::-1])  # == `take` pop()s
            del self._point_free[-take:]
        ids = np.asarray(pids, dtype=np.int64)
        self.PX[ids] = P
        self.point_alive[ids] = True
        self.point_leaf[ids] = -1
        return pids

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def num_leaves(self) -> int:
        return int(np.sum(self.node_alive & self.is_leaf))

    @property
    def target_L(self) -> int:
        return max(self.min_leaves, int(round(self.compression * self.n_points)))

    def _leaf_cap_at(self, n_points: int) -> int:
        target = max(self.min_leaves, int(round(self.compression * n_points)))
        mean = n_points / max(target, 1)
        return max(2 * self.m, int(np.ceil(self.overfull_factor * mean)))

    @property
    def leaf_cap(self) -> int:
        """Leaf-size invariant (paper §5.1 balance): block maintenance
        runs until no alive leaf holds more than
        ``max(2m, ceil(overfull_factor × n / target_L))`` points.
        ``check_invariants`` allows one doubling of slack because the
        sequential single-op paths rebalance one step per op."""
        return self._leaf_cap_at(self.n_points)

    def consume_struct_dirty(self) -> set[int]:
        """Drain the set of leaves touched by structural maintenance
        since the last call (see ``_struct_dirty``); the device mirror
        patches exactly these rows from the host f64 truth."""
        dirty, self._struct_dirty = self._struct_dirty, set()
        return dirty

    def alive_leaf_ids(self) -> np.ndarray:
        return np.nonzero(self.node_alive & self.is_leaf)[0]

    def leaf_cfs(self) -> CFTable:
        ids = self.alive_leaf_ids()
        return CFTable(LS=self.LS[ids], SS=self.SS[ids], n=self.N[ids])

    def to_bubbles(self) -> DataBubbles:
        t = self.leaf_cfs()
        return bubbles_from_cf(t.LS, t.SS, t.n)

    def alive_points(self):
        ids = np.nonzero(self.point_alive)[0]
        return ids, self.PX[ids]

    def leaf_cf_buffers(self):
        """(ids, LS, SS, N) where LS/SS/N are the FULL SoA buffers (true
        array views — zero copies) and ids selects the alive, non-empty
        leaf rows.  The offline pass (ops.bubble_table) gathers just
        those L rows — O(L·d), the summary, never the raw points — and
        derives the bubble table in f64 before dispatching to device."""
        ids = self.alive_leaf_ids()
        ids = ids[self.N[ids] > 0]
        return ids, self.LS, self.SS, self.N

    def dirty_fraction(self) -> float:
        """Fraction of the current mass touched since `mark_clean()`."""
        return self.dirty_mass / max(float(self.n_points), 1.0)

    def mark_clean(self):
        self.dirty_mass = 0.0

    def insert(self, p) -> int:
        """Single-point insertion (paper §4.1 insertion algorithm)."""
        p = np.asarray(p, dtype=np.float64)
        pid = self._new_point(p)
        self._insert_point_into_tree(pid)
        self.n_points += 1
        self.dirty_mass += 1.0
        self.mutations += 1
        self._maintain()
        return pid

    def delete(self, pid: int):
        """Single-point deletion (exact — CFs are subtractable sums)."""
        if not (0 <= pid < self.point_alive.shape[0]) or not self.point_alive[pid]:
            raise KeyError(f"point {pid} not alive")
        leaf = int(self.point_leaf[pid])
        p = self.PX[pid]
        self.leaf_points[leaf].remove(pid)
        self._struct_dirty.add(leaf)
        self._cf_update_path(leaf, -p, -float(p @ p), -1.0)
        self.point_alive[pid] = False
        self.point_leaf[pid] = -1
        self._point_free.append(pid)
        self.n_points -= 1
        self.dirty_mass += 1.0
        self.mutations += 1
        if len(self.leaf_points[leaf]) < self.m and self.num_leaves > 1:
            self._dissolve_leaf(leaf)
        self._maintain()

    def insert_block(self, X) -> list[int]:
        """Throughput path: vectorized point→leaf assignment for a block,
        then CF bulk update + maintenance to fixpoint.  Matches repeated
        insert() up to maintenance scheduling (CF additivity makes the
        stats identical)."""
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0:
            return []
        # bootstrap sequentially until structure exists — a flat loop:
        # the old tail recursion re-paid this check per M-sized chunk and
        # exhausted the recursion limit on huge blocks when the tree was
        # slow to grow past one leaf (e.g. duplicate-heavy data)
        pids: list[int] = []
        i = 0
        while i < X.shape[0] and (self.n_points == 0 or self.num_leaves <= 1):
            pids.append(self.insert(X[i]))
            i += 1
        if i == X.shape[0]:
            return pids
        rest = X[i:]
        leaf_ids = self.alive_leaf_ids()
        reps = self.LS[leaf_ids] / np.maximum(self.N[leaf_ids], 1.0)[:, None]
        if self._assign_fn is not None:
            assign = np.asarray(self._assign_fn(rest, reps))
        else:
            # center exactly like the engine's device assign_fn: argmin is
            # translation-invariant, and the ‖x‖²+‖r‖²−2xr expansion
            # cancels catastrophically off-origin (even f64 runs out of
            # mantissa once coordinates dwarf the separations)
            mu = reps.mean(axis=0)
            Xc = rest - mu
            Rc = reps - mu
            sq = (
                np.einsum("id,id->i", Xc, Xc)[:, None]
                + np.einsum("jd,jd->j", Rc, Rc)[None, :]
                - 2.0 * Xc @ Rc.T
            )
            assign = np.argmin(sq, axis=1)
        return pids + self.apply_assigned_block(rest, leaf_ids[assign])

    def apply_assigned_block(self, X, leaf_per_row, overfull_hint=None) -> list[int]:
        """Bulk bookkeeping for a block whose point→leaf assignment was
        already computed (host argmin above, or the device flat path,
        core.bubble_flat): allocate pids, extend membership grouped per
        touched leaf, ONE CF update per leaf + ancestor rebuild, then
        block maintenance to fixpoint.  ``overfull_hint`` is the device
        work-list (leaf ids the scatter saw cross ``leaf_cap``) — when it
        is provided, empty, and the leaf count already matches target,
        the fixpoint scan is skipped outright."""
        X = np.asarray(X, dtype=np.float64)
        leaf_per_row = np.asarray(leaf_per_row, dtype=np.int64)
        n = X.shape[0]
        assert leaf_per_row.shape == (n,)
        pids = self._new_points(X)
        pid_arr = np.asarray(pids, dtype=np.int64)
        self.point_leaf[pid_arr] = leaf_per_row
        # segment-reduce the CF deltas: one reduceat per statistic beats a
        # Python loop over touched leaves by ~an order of magnitude
        order = np.argsort(leaf_per_row, kind="stable")
        sorted_leaves = leaf_per_row[order]
        uniq, starts = np.unique(sorted_leaves, return_index=True)
        Xs = X[order]
        self.LS[uniq] += np.add.reduceat(Xs, starts, axis=0)
        self.SS[uniq] += np.add.reduceat(np.einsum("nd,nd->n", Xs, Xs), starts)
        counts = np.diff(np.append(starts, n))
        self.N[uniq] += counts
        sorted_pids = pid_arr[order]
        off = 0
        for leaf, cnt in zip(uniq, counts):
            self.leaf_points[int(leaf)].extend(sorted_pids[off : off + cnt].tolist())
            off += int(cnt)
        self._recompute_internal_cfs()
        self.n_points += n
        self.dirty_mass += float(n)
        self.mutations += 1
        if (
            overfull_hint is not None
            and len(overfull_hint) == 0
            and self.num_leaves == self.target_L
        ):
            return pids
        self._maintain_to_fixpoint()
        return pids

    def delete_block(self, pids):
        """Throughput path for deletions, mirroring insert_block: group the
        victims per leaf, retire them with ONE CF subtraction per touched
        leaf, rebuild ancestor CFs bottom-up, then dissolve underfilled
        leaves and run the maintenance deficit loop.  CF additivity makes
        the resulting statistics identical to repeated delete() — only the
        maintenance schedule differs."""
        pids = [int(p) for p in pids]
        if not pids:
            return
        if len(pids) == 1:
            self.delete(pids[0])
            return
        seen: set[int] = set()
        for pid in pids:  # validate before any mutation: reject whole block
            if not (0 <= pid < self.point_alive.shape[0]) or not self.point_alive[pid]:
                raise KeyError(f"point {pid} not alive")
            if pid in seen:
                raise KeyError(f"point {pid} duplicated in delete block")
            seen.add(pid)
        by_leaf: dict[int, list[int]] = {}
        for pid in pids:
            by_leaf.setdefault(int(self.point_leaf[pid]), []).append(pid)
            self.point_alive[pid] = False
        for leaf, victims in by_leaf.items():
            gone = set(victims)
            self.leaf_points[leaf] = [q for q in self.leaf_points[leaf] if q not in gone]
            P = self.PX[np.asarray(victims, dtype=np.int64)]
            self.LS[leaf] -= P.sum(axis=0)
            self.SS[leaf] -= float(np.einsum("nd,nd->", P, P))
            self.N[leaf] -= float(len(victims))
            for pid in victims:
                self.point_leaf[pid] = -1
                self._point_free.append(pid)
        self._recompute_internal_cfs()
        self.n_points -= len(pids)
        self.dirty_mass += float(len(pids))
        self.mutations += 1
        for leaf in list(by_leaf):
            if (
                self.node_alive[leaf]
                and self.is_leaf[leaf]
                and len(self.leaf_points[leaf]) < self.m
                and self.num_leaves > 1
            ):
                self._dissolve_leaf(leaf)
        self._maintain_to_fixpoint()

    # ------------------------------------------------------------------
    # insertion internals
    # ------------------------------------------------------------------

    def _choose_child(self, nid: int, p: np.ndarray) -> int:
        kids = self.children[nid]
        ids = np.asarray(kids, dtype=np.int64)
        reps = self.LS[ids] / np.maximum(self.N[ids], 1.0)[:, None]
        diff = reps - p[None, :]
        j = int(np.argmin(np.einsum("kd,kd->k", diff, diff)))
        return kids[j]

    def _descend_to_height(self, p: np.ndarray, h: int) -> int:
        nid = self.root
        while self.height[nid] > h:
            nid = self._choose_child(nid, p)
        return nid

    def _cf_update_path(self, nid: int, dLS, dSS: float, dN: float):
        while nid != -1:
            self.LS[nid] += dLS
            self.SS[nid] += dSS
            self.N[nid] += dN
            nid = int(self.parent[nid])

    def _insert_point_into_tree(self, pid: int):
        p = self.PX[pid]
        leaf = self._descend_to_height(p, 0)
        self.leaf_points[leaf].append(pid)
        self.point_leaf[pid] = leaf
        self._struct_dirty.add(leaf)
        self._cf_update_path(leaf, p, float(p @ p), 1.0)

    def _attach_node(self, child: int, target_parent: int):
        self.children[target_parent].append(child)
        self.parent[child] = target_parent
        self._cf_update_path(
            target_parent, self.LS[child].copy(), float(self.SS[child]), float(self.N[child])
        )
        if len(self.children[target_parent]) > self.M:
            self._split_internal(target_parent)

    def _insert_node_at_height(self, child: int):
        """Reinsert a detached subtree at its proper depth (R*-style)."""
        want_parent_h = int(self.height[child]) + 1
        if self.height[self.root] < want_parent_h:
            # tree shrank below the subtree height: graft by raising a root
            self._raise_root(want_parent_h)
        rep = self.LS[child] / max(float(self.N[child]), 1.0)
        nid = self.root
        while self.height[nid] > want_parent_h:
            nid = self._choose_child(nid, rep)
        self._attach_node(child, nid)

    def _raise_root(self, h: int):
        while self.height[self.root] < h:
            new_root = self._new_node(leaf=False, height=int(self.height[self.root]) + 1)
            self.children[new_root] = [self.root]
            self.parent[self.root] = new_root
            self.LS[new_root] = self.LS[self.root].copy()
            self.SS[new_root] = self.SS[self.root]
            self.N[new_root] = self.N[self.root]
            self.root = new_root

    # ------------------------------------------------------------------
    # splits
    # ------------------------------------------------------------------

    @staticmethod
    def _two_seeds(P: np.ndarray) -> tuple[int, int]:
        """Approximate farthest pair: farthest-from-centroid, then
        farthest-from-seed1 (linear-time; paper uses farthest pair)."""
        c = P.mean(axis=0)
        d0 = np.einsum("nd,nd->n", P - c, P - c)
        s1 = int(np.argmax(d0))
        d1 = np.einsum("nd,nd->n", P - P[s1], P - P[s1])
        s2 = int(np.argmax(d1))
        if s1 == s2:
            s2 = (s1 + 1) % P.shape[0]
        return s1, s2

    def _partition_by_seeds(self, P: np.ndarray, min_each: int):
        s1, s2 = self._two_seeds(P)
        d1 = np.einsum("nd,nd->n", P - P[s1], P - P[s1])
        d2 = np.einsum("nd,nd->n", P - P[s2], P - P[s2])
        # enforce minimum group sizes by moving boundary entries
        margin = d1 - d2
        order = np.argsort(margin)  # most side-1-ish first
        side = np.zeros(P.shape[0], dtype=bool)
        if np.any(margin != 0.0):
            n1 = max(min_each, int((d1 <= d2).sum()))
            n1 = min(n1, P.shape[0] - min_each)
        else:
            # degenerate split (duplicate-heavy leaf): every margin ties,
            # so halve instead of peeling min_each — an unbalanced peel
            # makes the overfull-leaf fixpoint oscillate (split m out,
            # count-steering dissolves them right back in)
            n1 = P.shape[0] // 2
        side[order[:n1]] = True
        return side

    def _split_leaf(self, leaf: int) -> int | None:
        pts = self.leaf_points[leaf]
        if len(pts) < 2 * self.m:
            return None
        P = self.PX[np.asarray(pts, dtype=np.int64)]
        side = self._partition_by_seeds(P, self.m)
        keep = [pid for pid, s in zip(pts, side) if s]
        move = [pid for pid, s in zip(pts, side) if not s]
        sib = self._new_node(leaf=True, height=0)
        self.leaf_points[sib] = move
        for pid in move:
            self.point_leaf[pid] = sib
        self.leaf_points[leaf] = keep
        self._struct_dirty.update((leaf, sib))
        Pm = self.PX[np.asarray(move, dtype=np.int64)]
        mLS = Pm.sum(axis=0)
        mSS = float(np.einsum("nd,nd->", Pm, Pm))
        mN = float(len(move))
        self.LS[sib] = mLS
        self.SS[sib] = mSS
        self.N[sib] = mN
        # shrink the original leaf and its ancestors by the moved mass
        self._cf_update_path(leaf, -mLS, -mSS, -mN)
        # attach sibling (restores the mass from the split point upward)
        par = int(self.parent[leaf])
        if par == -1:
            new_root = self._new_node(leaf=False, height=1)
            self.children[new_root] = [leaf]
            self.parent[leaf] = new_root
            self.LS[new_root] = self.LS[leaf].copy()
            self.SS[new_root] = self.SS[leaf]
            self.N[new_root] = self.N[leaf]
            self.root = new_root
            par = new_root
        self._attach_node(sib, par)
        return sib

    def _split_internal(self, nid: int):
        kids = list(self.children[nid])
        ids = np.asarray(kids, dtype=np.int64)
        reps = self.LS[ids] / np.maximum(self.N[ids], 1.0)[:, None]
        side = self._partition_by_seeds(reps, self.m)
        keep = [k for k, s in zip(kids, side) if s]
        move = [k for k, s in zip(kids, side) if not s]
        sib = self._new_node(leaf=False, height=int(self.height[nid]))
        self.children[sib] = move
        for k in move:
            self.parent[k] = sib
        self.children[nid] = keep
        mids = np.asarray(move, dtype=np.int64)
        mLS = self.LS[mids].sum(axis=0)
        mSS = float(self.SS[mids].sum())
        mN = float(self.N[mids].sum())
        self.LS[sib] = mLS
        self.SS[sib] = mSS
        self.N[sib] = mN
        self._cf_update_path(nid, -mLS, -mSS, -mN)
        par = int(self.parent[nid])
        if par == -1:
            new_root = self._new_node(leaf=False, height=int(self.height[nid]) + 1)
            self.children[new_root] = [nid]
            self.parent[nid] = new_root
            self.LS[new_root] = self.LS[nid].copy()
            self.SS[new_root] = self.SS[nid]
            self.N[new_root] = self.N[nid]
            self.root = new_root
            par = new_root
        self._attach_node(sib, par)

    # ------------------------------------------------------------------
    # dissolution / condensation
    # ------------------------------------------------------------------

    def _detach_child(self, nid: int):
        par = int(self.parent[nid])
        if par == -1:
            return
        self.children[par].remove(nid)
        self._cf_update_path(par, -self.LS[nid], -float(self.SS[nid]), -float(self.N[nid]))
        self.parent[nid] = -1
        # condense upward
        if par != self.root and len(self.children[par]) < self.m:
            orphans = list(self.children[par])
            self.children[par] = []
            self._detach_child(par)
            self._free_node(par)
            for o in orphans:
                self._insert_node_at_height(o)
        elif par == self.root and not self.is_leaf[par] and len(self.children[par]) == 1:
            only = self.children[par][0]
            self.children[par] = []
            self._free_node(par)
            self.parent[only] = -1
            self.root = only

    def _dissolve_leaf(self, leaf: int):
        pts = list(self.leaf_points[leaf])
        self.leaf_points[leaf] = []
        self._struct_dirty.add(leaf)
        self._cf_update_path(
            leaf,
            -self.LS[leaf].copy(),
            -float(self.SS[leaf]),
            -float(self.N[leaf]),
        )
        # the path update zeroed this leaf's own stats too via first hop
        self._detach_child(leaf)
        self._free_node(leaf)
        for pid in pts:
            self._insert_point_into_tree(pid)

    # ------------------------------------------------------------------
    # Algorithm 1 — MaintainCompression
    # ------------------------------------------------------------------

    def _most_underfilled(self) -> int:
        ids = self.alive_leaf_ids()
        return int(ids[np.argmin(self.N[ids])])

    def _most_overfilled(self) -> int:
        ids = self.alive_leaf_ids()
        return int(ids[np.argmax(self.N[ids])])

    def _maintain_step(self) -> bool:
        """One Algorithm-1 rebalance step; True iff structure changed.

        Priority order: the leaf-size invariant first (an overfull leaf
        degrades summary quality at ANY leaf count — §5.1 — and pure
        count steering never splits once ``num_leaves >= target_L``),
        then leaf-count steering in either direction."""
        L = self.target_L
        nl = self.num_leaves
        ids = self.alive_leaf_ids()
        o = int(ids[np.argmax(self.N[ids])])
        if self.N[o] > self.leaf_cap and len(self.leaf_points[o]) >= 2 * self.m:
            return self._split_leaf(o) is not None
        if nl > L and nl > 1:
            self._dissolve_leaf(int(ids[np.argmin(self.N[ids])]))
            return True
        if nl < L:
            return self._split_leaf(o) is not None
        return False

    def _maintain_to_fixpoint(self):
        """Block-op maintenance: run Algorithm-1 steps until no leaf
        exceeds ``leaf_cap`` AND the leaf count matches ``target_L`` (or
        provably cannot — every candidate too small to split).

        Replaces the old ``abs(target_L - num_leaves) + 2`` deficit cap,
        which starved exactly when a concentrated block landed in a leaf
        without moving the count deficit (the leaf stayed arbitrarily
        overfull, silently).  The safety cap is generous — shattering
        every point into fresh leaves costs well under ``n/m`` splits —
        and raises instead of silently stopping."""
        budget = 4 * (self.n_points + self.num_leaves) + 64
        for _ in range(budget):
            if not self._maintain_step():
                return
        raise RuntimeError(
            f"Bubble-tree maintenance did not reach a fixpoint within "
            f"{budget} steps (n={self.n_points}, leaves={self.num_leaves}, "
            f"target={self.target_L}, cap={self.leaf_cap})"
        )

    def _maintain(self) -> bool:
        """One application of Algorithm 1 (the sequential single-op
        cadence).  Returns True if a structural change was made."""
        self._op_count += 1
        if self._maintain_step():
            return True
        if self.reorg_every and (self._op_count % self.reorg_every == 0):
            # dynamic reorganization: extract + reinsert m farthest points
            # of the most overfilled leaf
            o = self._most_overfilled()
            pts = self.leaf_points[o]
            if len(pts) >= 2 * self.m:
                ids = np.asarray(pts, dtype=np.int64)
                rep = self.LS[o] / max(float(self.N[o]), 1.0)
                diff = self.PX[ids] - rep[None, :]
                far = np.argsort(-np.einsum("nd,nd->n", diff, diff))[: self.m]
                far_pids = [pts[int(j)] for j in far]
                self._struct_dirty.add(o)
                for pid in far_pids:
                    self.leaf_points[o].remove(pid)
                    p = self.PX[pid]
                    self._cf_update_path(o, -p, -float(p @ p), -1.0)
                    self.point_leaf[pid] = -1
                for pid in far_pids:
                    self._insert_point_into_tree(pid)
                return True
        return False

    # ------------------------------------------------------------------
    # consistency checking (tests)
    # ------------------------------------------------------------------

    def _recompute_internal_cfs(self):
        order = np.nonzero(self.node_alive & ~self.is_leaf)[0]
        order = order[np.argsort(self.height[order])]
        for nid in order:
            ids = np.asarray(self.children[nid], dtype=np.int64)
            self.LS[nid] = self.LS[ids].sum(axis=0)
            self.SS[nid] = float(self.SS[ids].sum())
            self.N[nid] = float(self.N[ids].sum())

    def check_invariants(self):
        assert self.node_alive[self.root]
        total = 0
        # leaf-size invariant: block maintenance fixpoints at leaf_cap;
        # sequential single-op paths rebalance one step per op, so allow
        # them one doubling of slack before calling it a violation
        size_cap = 2 * self.leaf_cap
        for leaf in self.alive_leaf_ids():
            pts = self.leaf_points[int(leaf)]
            total += len(pts)
            assert len(pts) <= size_cap, (
                f"leaf {int(leaf)} holds {len(pts)} points > {size_cap} "
                f"(2 x leaf_cap; maintenance starvation)"
            )
            ids = np.asarray(pts, dtype=np.int64)
            P = self.PX[ids] if len(pts) else np.zeros((0, self.dim))
            np.testing.assert_allclose(self.LS[leaf], P.sum(axis=0), atol=1e-6)
            np.testing.assert_allclose(
                self.SS[leaf], float(np.einsum("nd,nd->", P, P)), atol=1e-6
            )
            assert self.N[leaf] == len(pts)
            assert self.height[leaf] == 0
        assert total == self.n_points, (total, self.n_points)
        # internal fanout + CF consistency + uniform leaf depth
        for nid in np.nonzero(self.node_alive & ~self.is_leaf)[0]:
            kids = self.children[int(nid)]
            assert kids, f"internal node {nid} with no children"
            if nid != self.root:
                assert self.m <= len(kids) <= self.M, (nid, len(kids))
            else:
                assert len(kids) <= self.M
            ids = np.asarray(kids, dtype=np.int64)
            np.testing.assert_allclose(self.LS[nid], self.LS[ids].sum(axis=0), atol=1e-6)
            assert all(self.parent[k] == nid for k in kids)
            assert all(self.height[k] == self.height[nid] - 1 for k in kids)
