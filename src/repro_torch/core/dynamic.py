"""Exact fully-dynamic HDBSCAN — paper §3 (Algorithms 5 & 6).

Maintains, under point insertions and deletions:
  * the point set (growable arrays + free list),
  * per-point kNN tables (indices + distances, k = minPts),
  * core distances (Def. 1),
  * the MST of the mutual-reachability graph.

Array-oriented reformulation (DESIGN.md §2): the paper uses an SS-tree +
link-cut tree; both are pointer-serial.  We exploit the paper's own
reduction/contraction rules to express every update as *dense linear
algebra + a small explicit-edge MST pass*:

  insert (Eq. 11):  T' = MST( T ∪ E_inserted ∪ E_modified )
      — Kruskal over ~2n + minPts² explicit edges, weights recomputed
        from the *current* core distances (any stale-weight T edge is
        re-weighted for free since we store raw distances separately).

  delete (Eq. 12):  F = T \\ (E_deleted ∪ E_modified);  T' = Borůvka(F)
      — component-constrained vectorized Borůvka over the dense mutual
        reachability weights of the survivors.

RkNN queries (Appendix A) become masked predicates over one distance row:
``RkNN(p) = { q : d(p,q) < cd(q) }``.  Correctness (not complexity) is
identical to the paper's; the feasibility *benchmark* (fig3) reproduces the
paper's finding that per-update cost approaches static recomputation as
the update fraction grows.

The port's own copy of the JAX package's ``core/dynamic.py`` (host f64
numpy): the exact oracle.  The card's exact-dynamic engine is
core/dynamic_torch.py (``exact=True``).
"""

from __future__ import annotations

import numpy as np

from .hdbscan import pairwise_sqdist
from .mst import UnionFind, kruskal_edges

__all__ = ["DynamicHDBSCAN"]


class DynamicHDBSCAN:
    """Exact dynamic maintenance of HDBSCAN's MST (paper §3.2)."""

    def __init__(self, min_pts: int, dim: int, capacity: int = 1024):
        self.min_pts = int(min_pts)
        self.dim = int(dim)
        cap = max(capacity, 16)
        self.X = np.zeros((cap, dim), dtype=np.float64)
        self.alive = np.zeros(cap, dtype=bool)
        # kNN tables over *other* alive points (self excluded, so column 0
        # is the nearest neighbour); cd uses min_pts-1 others per the
        # self-inclusive convention of hdbscan.core_distances.
        self.knn_idx = np.full((cap, self.min_pts), -1, dtype=np.int64)
        self.knn_dst = np.full((cap, self.min_pts), np.inf, dtype=np.float64)
        self.cd = np.zeros(cap, dtype=np.float64)
        # MST as explicit arrays of (u, v, raw_distance); mutual-reach
        # weights are derived on demand: w = max(cd[u], cd[v], raw)
        self.mst_u = np.zeros(0, dtype=np.int64)
        self.mst_v = np.zeros(0, dtype=np.int64)
        self.mst_d = np.zeros(0, dtype=np.float64)
        self._free: list[int] = list(range(cap - 1, -1, -1))
        self.n = 0
        # instrumentation for the feasibility benchmark (paper Fig. 3b–d)
        self.stats = {
            "knn_time": 0.0,
            "mst_time": 0.0,
            "rknn_sizes": [],
            "boruvka_components": [],
        }

    # -- helpers ----------------------------------------------------------

    def _grow(self):
        cap = self.X.shape[0]
        new = cap * 2
        self.X = np.concatenate([self.X, np.zeros((cap, self.dim))])
        self.alive = np.concatenate([self.alive, np.zeros(cap, dtype=bool)])
        self.knn_idx = np.concatenate([self.knn_idx, np.full((cap, self.min_pts), -1, dtype=np.int64)])
        self.knn_dst = np.concatenate([self.knn_dst, np.full((cap, self.min_pts), np.inf)])
        self.cd = np.concatenate([self.cd, np.zeros(cap)])
        self._free.extend(range(new - 1, cap - 1, -1))

    def _alive_ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]

    def _dists_to(self, p: np.ndarray, ids: np.ndarray) -> np.ndarray:
        diff = self.X[ids] - p[None, :]
        return np.sqrt(np.maximum(np.einsum("nd,nd->n", diff, diff), 0.0))

    def _core_from_knn(self, i: int) -> float:
        """Self-inclusive cd: distance to the (min_pts-1)-th other point."""
        k = self.min_pts - 1
        if k <= 0:
            return 0.0
        row = self.knn_dst[i]
        if not np.isfinite(row[k - 1]):
            return float(row[np.isfinite(row)].max(initial=0.0))
        return float(row[k - 1])

    def _mst_weights(self) -> np.ndarray:
        return np.maximum(self.mst_d, np.maximum(self.cd[self.mst_u], self.cd[self.mst_v]))

    def total_weight(self) -> float:
        return float(self._mst_weights().sum())

    def mst_edges(self):
        return self.mst_u.copy(), self.mst_v.copy(), self._mst_weights()

    # -- insertion (Algorithm 5) ------------------------------------------

    def insert(self, p) -> int:
        import time

        p = np.asarray(p, dtype=np.float64)
        if not self._free:
            self._grow()
        i = self._free.pop()
        ids = self._alive_ids()
        t0 = time.perf_counter()
        d = self._dists_to(p, ids) if ids.size else np.zeros(0)

        # kNN of p (other points only)
        k = self.min_pts
        if ids.size:
            top = np.argsort(d, kind="stable")[: k]
            self.knn_idx[i, : top.size] = ids[top]
            self.knn_dst[i, : top.size] = d[top]
            self.knn_idx[i, top.size:] = -1
            self.knn_dst[i, top.size:] = np.inf
        self.X[i] = p
        self.alive[i] = True
        self.n += 1
        self.cd[i] = self._core_from_knn(i)

        # RkNN(p): alive q with d(p,q) < current kNN horizon of q
        # (q's horizon = its current k-th other distance; p entering within
        # it shifts q's list and may shrink cd(q))
        if ids.size:
            horizon = self.knn_dst[ids, k - 1]
            rknn = ids[d < horizon]
        else:
            rknn = np.zeros(0, dtype=np.int64)
        self.stats["rknn_sizes"].append(int(rknn.size))
        # update each reverse neighbour's kNN table by sorted insertion of p
        for q in rknn:
            dq = float(np.linalg.norm(self.X[q] - p))
            row_d = self.knn_dst[q]
            row_i = self.knn_idx[q]
            pos = int(np.searchsorted(row_d, dq))
            if pos < k:
                row_d[pos + 1:] = row_d[pos:-1]
                row_i[pos + 1:] = row_i[pos:-1]
                row_d[pos] = dq
                row_i[pos] = i
                self.cd[q] = self._core_from_knn(int(q))
        self.stats["knn_time"] += time.perf_counter() - t0

        # --- MST update via reduction rule (Eq. 11) ---
        t1 = time.perf_counter()
        cand_u = [self.mst_u]
        cand_v = [self.mst_v]
        cand_d = [self.mst_d]
        if ids.size:
            cand_u.append(np.full(ids.size, i, dtype=np.int64))  # E_inserted
            cand_v.append(ids)
            cand_d.append(d)
        # E_modified: edges (r, r') for r in RkNN(p), r' in N_k(r)
        for r in rknn:
            nbr = self.knn_idx[r]
            ok = nbr >= 0
            cand_u.append(np.full(int(ok.sum()), r, dtype=np.int64))
            cand_v.append(nbr[ok])
            cand_d.append(self.knn_dst[r][ok])
        u = np.concatenate(cand_u)
        v = np.concatenate(cand_v)
        raw = np.concatenate(cand_d)
        w = np.maximum(raw, np.maximum(self.cd[u], self.cd[v]))
        # compact node ids for the Kruskal pass
        nodes = self._alive_ids()
        remap = np.full(self.X.shape[0], -1, dtype=np.int64)
        remap[nodes] = np.arange(nodes.size)
        mu, mv, mw = kruskal_edges(remap[u], remap[v], w, nodes.size)
        # recover raw distances of chosen edges: they are either w (if the
        # distance dominated) or re-derived from geometry
        self.mst_u = nodes[mu]
        self.mst_v = nodes[mv]
        diff = self.X[self.mst_u] - self.X[self.mst_v]
        self.mst_d = np.sqrt(np.maximum(np.einsum("nd,nd->n", diff, diff), 0.0))
        self.stats["mst_time"] += time.perf_counter() - t1
        return i

    # -- deletion (Algorithm 6) -------------------------------------------

    def delete(self, i: int):
        import time

        if not self.alive[i]:
            raise KeyError(f"point {i} is not alive")
        k = self.min_pts
        t0 = time.perf_counter()
        self.alive[i] = False
        self.n -= 1
        self._free.append(int(i))
        ids = self._alive_ids()
        # RkNN(p): alive q currently listing i in their kNN table
        rknn = ids[(self.knn_idx[ids] == i).any(axis=1)] if ids.size else np.zeros(0, dtype=np.int64)
        self.stats["rknn_sizes"].append(int(rknn.size))
        # recompute their kNN rows densely (batched — one (U, n) tile)
        if rknn.size and ids.size > 1:
            sq = pairwise_sqdist(self.X[rknn], self.X[ids])
            # mask self-distances
            for row, q in enumerate(rknn):
                sq[row, np.searchsorted(ids, q)] = np.inf
            dst = np.sqrt(np.maximum(sq, 0.0))
            order = np.argsort(dst, axis=1, kind="stable")[:, :k]
            self.knn_idx[rknn] = ids[order]
            self.knn_dst[rknn] = np.take_along_axis(dst, order, axis=1)
            short = ids.size - 1 < k  # fewer others than k
            if short:
                for row, q in enumerate(rknn):
                    m = ids.size - 1
                    self.knn_idx[q, m:] = -1
                    self.knn_dst[q, m:] = np.inf
            for q in rknn:
                self.cd[q] = self._core_from_knn(int(q))
        elif rknn.size:
            self.knn_idx[rknn] = -1
            self.knn_dst[rknn] = np.inf
            self.cd[rknn] = 0.0
        self.knn_idx[i] = -1
        self.knn_dst[i] = np.inf
        self.stats["knn_time"] += time.perf_counter() - t0

        # --- contraction rule (Eq. 12) ---
        t1 = time.perf_counter()
        drop = (self.mst_u == i) | (self.mst_v == i)
        drop |= np.isin(self.mst_u, rknn) | np.isin(self.mst_v, rknn)
        keep_u = self.mst_u[~drop]
        keep_v = self.mst_v[~drop]
        if ids.size == 0:
            self.mst_u = np.zeros(0, dtype=np.int64)
            self.mst_v = np.zeros(0, dtype=np.int64)
            self.mst_d = np.zeros(0, dtype=np.float64)
            self.stats["mst_time"] += time.perf_counter() - t1
            return
        # component-constrained reconnection. Every crossing edge of the
        # cut forest has >= 1 endpoint outside the largest component, so the
        # candidate set (S x all) with S = non-largest-component nodes
        # covers all possible T' completions (dual-tree Borůvka's pruning,
        # flattened to one dense (|S|, n) mutual-reachability tile).
        remap = np.full(self.X.shape[0], -1, dtype=np.int64)
        remap[ids] = np.arange(ids.size)
        uf = UnionFind(ids.size)
        for a, b in zip(remap[keep_u], remap[keep_v]):
            uf.union(int(a), int(b))
        self.stats["boruvka_components"].append(int(uf.n_components))
        if uf.n_components > 1:
            labels = uf.labels()
            uniq, counts = np.unique(labels, return_counts=True)
            biggest = uniq[np.argmax(counts)]
            S = np.nonzero(labels != biggest)[0]  # compact ids
            sq = pairwise_sqdist(self.X[ids[S]], self.X[ids])
            d = np.sqrt(np.maximum(sq, 0.0))
            w = np.maximum(
                d, np.maximum(self.cd[ids[S]][:, None], self.cd[ids][None, :])
            )
            w[np.arange(S.size), S] = np.inf  # self-edges
            eu = np.repeat(S, ids.size)
            ev = np.tile(np.arange(ids.size), S.size)
            ew = w.reshape(-1)
            fin = np.isfinite(ew)
            au, av, aw = kruskal_edges(eu[fin], ev[fin], ew[fin], ids.size, uf=uf)
            self.mst_u = np.concatenate([keep_u, ids[au]])
            self.mst_v = np.concatenate([keep_v, ids[av]])
        else:
            self.mst_u = keep_u
            self.mst_v = keep_v
        diff = self.X[self.mst_u] - self.X[self.mst_v]
        self.mst_d = np.sqrt(np.maximum(np.einsum("nd,nd->n", diff, diff), 0.0))
        self.stats["mst_time"] += time.perf_counter() - t1

    # -- bulk ops ----------------------------------------------------------

    def insert_batch(self, X) -> list[int]:
        return [self.insert(p) for p in np.asarray(X, dtype=np.float64)]

    def delete_batch(self, ids):
        for i in ids:
            self.delete(int(i))
