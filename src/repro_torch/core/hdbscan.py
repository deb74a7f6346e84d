"""Static HDBSCAN (Campello–Moulavi–Sander) on points or data bubbles.

Pipeline (paper §2.1):
  1. core distances  cd(p) = dist to minPts-th nearest neighbour (Def. 1)
  2. mutual reachability d_m(p,q) = max{cd(p), cd(q), d(p,q)}   (Def. 2/Eq. 1)
  3. MST of the (implicit, complete) mutual reachability graph   (Def. 3)
  4. dendrogram: single-linkage merge tree from ascending MST edges
  5. condensed tree (min_cluster_size) + stability-based flat extraction
     ("excess of mass"), cluster weights = summed point/bubble weights
     (the paper's weighted extraction for bubbles, §2.2 last paragraph)

The port's own copy of the JAX package's ``core/hdbscan.py``: the host
f64 numpy HDBSCAN, bit for bit the reference's.  Weighted variants serve
the summarizer's offline phase on data bubbles (§4.2, core/summarizer.py),
whose d_m matrix comes from the device (kernels/ops.py) as ``precomputed``;
the tree condensation (steps 4–5) is index-chasing over exactly n-1 merge
records and stays on the host.  ``CondensedTree`` is also the layout that
``OfflineClusterResult.to_condensed`` emits from the device hierarchy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .mst import UnionFind, boruvka_dense

__all__ = [
    "core_distances",
    "mutual_reachability",
    "mst_of_points",
    "SingleLinkageTree",
    "single_linkage",
    "CondensedTree",
    "condense_tree",
    "extract_clusters",
    "hdbscan_labels",
    "HDBSCANResult",
    "hdbscan",
]


# --------------------------------------------------------------------------
# steps 1–3: distances + MST (numpy reference; the device path is in ops)
# --------------------------------------------------------------------------

def pairwise_sqdist(X: np.ndarray, Y: np.ndarray | None = None) -> np.ndarray:
    """||x - y||² via the matmul expansion, in f64."""
    X = np.asarray(X, dtype=np.float64)
    Y = X if Y is None else np.asarray(Y, dtype=np.float64)
    xx = np.einsum("id,id->i", X, X)
    yy = np.einsum("jd,jd->j", Y, Y)
    sq = xx[:, None] + yy[None, :] - 2.0 * (X @ Y.T)
    return np.maximum(sq, 0.0)


def core_distances(X: np.ndarray, min_pts: int) -> np.ndarray:
    """cd(p) = distance to the min_pts-th nearest neighbour.

    Convention (matches scikit-learn / hdbscan): the neighbourhood of p
    includes p itself, so ``min_pts=1`` gives cd == 0 and ``min_pts=k``
    uses the (k-1)-th other point.
    """
    n = X.shape[0]
    k = min(min_pts, n)
    sq = pairwise_sqdist(X)
    part = np.partition(sq, k - 1, axis=1)[:, k - 1]
    return np.sqrt(part)


def mutual_reachability(X: np.ndarray, cd: np.ndarray) -> np.ndarray:
    """Dense d_m matrix (Eq. 1)."""
    d = np.sqrt(pairwise_sqdist(X))
    m = np.maximum(d, np.maximum(cd[:, None], cd[None, :]))
    np.fill_diagonal(m, 0.0)
    return m


def mst_of_points(X: np.ndarray, min_pts: int):
    """(u, v, w) MST edges of the mutual reachability graph."""
    cd = core_distances(X, min_pts)
    W = mutual_reachability(X, cd)
    np.fill_diagonal(W, np.inf)
    return boruvka_dense(W), cd


# --------------------------------------------------------------------------
# step 4: single-linkage dendrogram
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SingleLinkageTree:
    """Merge records in scipy ``linkage`` layout over weighted leaves.

    merges[i] = (left_id, right_id, distance, merged_weight); new node ids
    are n + i.  ``weights`` are leaf weights (1.0 for raw points, bubble
    ``n`` for the offline phase).
    """

    merges: np.ndarray  # (n-1, 4) float64
    weights: np.ndarray  # (n,) leaf weights
    n_leaves: int


def single_linkage(u, v, w, n: int, weights: np.ndarray | None = None) -> SingleLinkageTree:
    """Dendrogram from MST edges (sorted ascending = HDBSCAN hierarchy)."""
    if weights is None:
        weights = np.ones(n, dtype=np.float64)
    order = np.argsort(np.asarray(w, dtype=np.float64), kind="stable")
    uf = UnionFind(n)
    # track the current dendrogram node id for each union-find root
    node_of_root = np.arange(n, dtype=np.int64)
    node_weight = np.concatenate([weights, np.zeros(len(order))])
    merges = np.zeros((len(order), 4), dtype=np.float64)
    nxt = n
    for k, i in enumerate(order):
        a, b = int(u[i]), int(v[i])
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:  # MST edges never cycle; guard anyway
            continue
        na, nb = node_of_root[ra], node_of_root[rb]
        uf.union(a, b)
        r = uf.find(a)
        merges[k] = (na, nb, float(w[i]), node_weight[na] + node_weight[nb])
        node_weight[nxt] = node_weight[na] + node_weight[nb]
        node_of_root[r] = nxt
        nxt += 1
    return SingleLinkageTree(merges=merges, weights=np.asarray(weights, dtype=np.float64), n_leaves=n)


# --------------------------------------------------------------------------
# step 5: condensed tree + flat extraction
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CondensedTree:
    """Rows (parent, child, lambda_val, child_weight); cluster ids >= n."""

    parent: np.ndarray
    child: np.ndarray
    lambda_val: np.ndarray
    child_weight: np.ndarray
    n_leaves: int

    def cluster_ids(self) -> np.ndarray:
        return np.unique(self.parent)


def condense_tree(slt: SingleLinkageTree, min_cluster_size: float = 5.0) -> CondensedTree:
    """Collapse the dendrogram: a split only creates new clusters when both
    sides carry >= min_cluster_size weight; otherwise points "fall out" of
    the surviving cluster at lambda = 1/distance.

    Weighted generalization: sizes are summed leaf weights, so the offline
    bubble phase condenses by *represented point counts* (paper §2.2).
    A single leaf can then be "big" (a bubble representing >= mcs points);
    structurally it is still one vertex, so it never *spawns* a condensed
    cluster — it is recorded as a member of the surviving cluster at the
    split's lambda.  Mass conservation: every leaf is emitted exactly once
    (asserted by tests: point-row weights sum to the total weight).
    """
    n = slt.n_leaves
    merges = slt.merges
    n_nodes = n + merges.shape[0]
    # children of each internal node
    left = merges[:, 0].astype(np.int64)
    right = merges[:, 1].astype(np.int64)
    dist = merges[:, 2]
    node_weight = np.concatenate([slt.weights, merges[:, 3]])

    root = n_nodes - 1
    rows_parent, rows_child, rows_lambda, rows_weight = [], [], [], []
    next_label = n + 1

    def emit_leaves(node: int, cparent: int, lam: float):
        sub = [node]
        while sub:
            s = sub.pop()
            if s < n:
                rows_parent.append(cparent)
                rows_child.append(s)
                rows_lambda.append(lam)
                rows_weight.append(node_weight[s])
            else:
                j = s - n
                sub.append(int(left[j]))
                sub.append(int(right[j]))

    if root < n:  # degenerate: single leaf
        return CondensedTree(
            parent=np.asarray([n], dtype=np.int64),
            child=np.asarray([root], dtype=np.int64),
            lambda_val=np.asarray([np.inf]),
            child_weight=np.asarray([node_weight[root]]),
            n_leaves=n,
        )

    # iterative DFS: (node, condensed_parent_label, lambda_entered)
    stack = [(root, n, 0.0)]
    while stack:
        node, cparent, lam_in = stack.pop()
        if node < n:
            # a leaf continuing a cluster: member until the split above it
            rows_parent.append(cparent)
            rows_child.append(node)
            rows_lambda.append(lam_in)
            rows_weight.append(node_weight[node])
            continue
        i = node - n
        lc, rc = int(left[i]), int(right[i])
        lam = 1.0 / dist[i] if dist[i] > 0 else np.inf
        wl, wr = node_weight[lc], node_weight[rc]
        # a side can found a new condensed cluster only if it is both heavy
        # enough and structurally a subtree (internal node)
        l_cluster = (wl >= min_cluster_size) and (lc >= n)
        r_cluster = (wr >= min_cluster_size) and (rc >= n)
        if l_cluster and r_cluster:
            for ch, wch in ((lc, wl), (rc, wr)):
                lbl = next_label
                next_label += 1
                rows_parent.append(cparent)
                rows_child.append(lbl)
                rows_lambda.append(lam)
                rows_weight.append(wch)
                stack.append((ch, lbl, lam))
        elif l_cluster or r_cluster:
            # exactly one structural heavy side: it continues cparent;
            # the other side falls out here (heavy leaves as single
            # members, light subtrees leaf-by-leaf)
            cont = lc if l_cluster else rc
            other = rc if l_cluster else lc
            stack.append((cont, cparent, lam))
            emit_leaves(other, cparent, lam)
        else:
            # no structural heavy side: everything falls out; if one side
            # is a heavy *leaf* it is still a member record at this lambda
            emit_leaves(lc, cparent, lam)
            emit_leaves(rc, cparent, lam)
    return CondensedTree(
        parent=np.asarray(rows_parent, dtype=np.int64),
        child=np.asarray(rows_child, dtype=np.int64),
        lambda_val=np.asarray(rows_lambda, dtype=np.float64),
        child_weight=np.asarray(rows_weight, dtype=np.float64),
        n_leaves=n,
    )


def _stabilities(ct: CondensedTree) -> dict[int, float]:
    """stability(C) = Σ_children (λ_child − λ_birth(C)) · weight_child."""
    births: dict[int, float] = {}
    for p, c, lam in zip(ct.parent, ct.child, ct.lambda_val):
        if c >= ct.n_leaves:
            births[int(c)] = float(lam)
    root = int(ct.parent.min()) if ct.parent.size else ct.n_leaves
    births.setdefault(root, 0.0)
    stab: dict[int, float] = {}
    for p, lam, w in zip(ct.parent, ct.lambda_val, ct.child_weight):
        p = int(p)
        birth = births.get(p, 0.0)
        lam = min(float(lam), 1e308)
        stab[p] = stab.get(p, 0.0) + (lam - birth) * float(w)
    return stab


def extract_clusters(
    ct: CondensedTree,
    method: str = "eom",
    allow_single_cluster: bool = False,
) -> list[int]:
    """Select flat clusters.

    eom: bottom-up excess-of-mass — a cluster is selected iff its stability
    exceeds the sum of its selected descendants'.  leaf: all leaves of the
    condensed tree.
    """
    stab = _stabilities(ct)
    cluster_rows = ct.child >= ct.n_leaves
    children: dict[int, list[int]] = {}
    for p, c in zip(ct.parent[cluster_rows], ct.child[cluster_rows]):
        children.setdefault(int(p), []).append(int(c))
    root = int(ct.parent.min()) if ct.parent.size else ct.n_leaves
    all_clusters = sorted(stab.keys())
    if method == "leaf":
        leaves = [c for c in all_clusters if c not in children and (c != root or allow_single_cluster)]
        return leaves or ([root] if allow_single_cluster else [])
    # EOM: process deepest-first (ids increase with depth by construction)
    selected: dict[int, bool] = {}
    subtree_stab: dict[int, float] = {}
    for c in sorted(all_clusters, reverse=True):
        kids = children.get(c, [])
        kid_sum = sum(subtree_stab.get(k, 0.0) for k in kids)
        s = stab.get(c, 0.0)
        if not kids:
            selected[c] = True
            subtree_stab[c] = s
        elif s >= kid_sum:
            selected[c] = True
            subtree_stab[c] = s
        else:
            selected[c] = False
            subtree_stab[c] = kid_sum
    # deselect descendants of selected clusters (top-down)
    out: list[int] = []

    def walk(c: int, blocked: bool):
        sel = selected.get(c, False) and not blocked
        if sel and (c != root or allow_single_cluster):
            out.append(c)
            blocked = True
        elif c == root and selected.get(c, False) and not allow_single_cluster:
            blocked = False  # root not allowed: recurse into children
        for k in children.get(c, []):
            walk(k, blocked)

    walk(root, False)
    if not out and allow_single_cluster:
        out = [root]
    return sorted(out)


def hdbscan_labels(ct: CondensedTree, selected: list[int]) -> np.ndarray:
    """Point labels from selected condensed clusters (-1 = noise)."""
    n = ct.n_leaves
    label_of_cluster = {c: i for i, c in enumerate(selected)}
    # map every condensed cluster to its nearest selected ancestor-or-self
    parent_of: dict[int, int] = {}
    for p, c in zip(ct.parent, ct.child):
        if c >= n:
            parent_of[int(c)] = int(p)
    resolved: dict[int, int] = {}

    def resolve(c: int) -> int:
        if c in resolved:
            return resolved[c]
        if c in label_of_cluster:
            resolved[c] = label_of_cluster[c]
        elif c in parent_of:
            resolved[c] = resolve(parent_of[c])
        else:
            resolved[c] = -1
        return resolved[c]

    labels = np.full(n, -1, dtype=np.int64)
    point_rows = ct.child < n
    for p, c in zip(ct.parent[point_rows], ct.child[point_rows]):
        # nearest selected ancestor-or-self of the point's condensed parent;
        # points attached above every selected cluster resolve to -1 (noise)
        labels[int(c)] = resolve(int(p))
    return labels


@dataclasses.dataclass
class HDBSCANResult:
    labels: np.ndarray  # (n,) flat labels, -1 noise
    mst: tuple  # (u, v, w)
    core_dists: np.ndarray
    slt: SingleLinkageTree
    condensed: CondensedTree
    selected: list[int]

    @property
    def total_mst_weight(self) -> float:
        return float(np.sum(self.mst[2]))


def hdbscan(
    X: np.ndarray,
    min_pts: int = 5,
    min_cluster_size: float | None = None,
    weights: np.ndarray | None = None,
    precomputed: np.ndarray | None = None,
    method: str = "eom",
    allow_single_cluster: bool = False,
) -> HDBSCANResult:
    """Full static HDBSCAN.

    Args:
      X: (n, d) points (or bubble representatives).
      min_pts: density parameter.
      min_cluster_size: defaults to min_pts.
      weights: per-row weights (bubble sizes) for weighted extraction.
      precomputed: optional dense mutual-reachability matrix — used by the
        offline bubble phase whose d_m comes from Eqs. 6–7 instead of raw
        point geometry.
    """
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    if min_cluster_size is None:
        min_cluster_size = float(min_pts)
    if precomputed is not None:
        W = np.array(precomputed, dtype=np.float64, copy=True)
        cd = np.zeros(n)
        np.fill_diagonal(W, np.inf)
        (u, v, w) = boruvka_dense(W)
    else:
        (u, v, w), cd = mst_of_points(X, min_pts)
    slt = single_linkage(u, v, w, n, weights=weights)
    ct = condense_tree(slt, min_cluster_size=min_cluster_size)
    selected = extract_clusters(ct, method=method, allow_single_cluster=allow_single_cluster)
    labels = hdbscan_labels(ct, selected)
    return HDBSCANResult(labels=labels, mst=(u, v, w), core_dists=cd, slt=slt, condensed=ct, selected=selected)
