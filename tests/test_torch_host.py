"""The port's host layer against the JAX package's numpy modules, bit for
bit: the same seeded inputs through both packages give the same arrays.

Covers ``data/synthetic.py``, ``core/metrics.py``, the host MST of
``core/mst.py`` (``UnionFind``, ``kruskal_edges``, ``boruvka_dense``),
every function of ``core/hdbscan.py`` on ``tests/test_hdbscan.py``'s cases,
``core/bubbles.py``, ``BubbleTree.to_bubbles``, the baselines of
``core/baselines.py``, ``core/dynamic.py``'s ``DynamicHDBSCAN`` on
``tests/test_dynamic.py``'s workloads, and ``carry.dynamic_hdbscan_from_
reference``.  Equality is ``np.array_equal`` (dtypes too) throughout: the
port's copies are the reference's code.
"""

import importlib

import numpy as np
import pytest
from conftest import make_blobs

import repro.core.baselines as R_base
import repro.core.bubble_tree as R_tree
import repro.core.bubbles as R_bub
import repro.core.dynamic as R_dyn
import repro.core.metrics as R_met
import repro.core.mst as R_mst
import repro.data.synthetic as R_syn
import repro_torch.core.baselines as T_base
import repro_torch.core.bubble_tree as T_tree
import repro_torch.core.bubbles as T_bub
import repro_torch.core.dynamic as T_dyn
import repro_torch.core.metrics as T_met
import repro_torch.core.mst as T_mst
import repro_torch.data.synthetic as T_syn
from repro_torch.carry import DYNAMIC_HDBSCAN_FIELDS, dynamic_hdbscan_from_reference

# the packages export the function ``hdbscan`` under the module's name
R_h = importlib.import_module("repro.core.hdbscan")
T_h = importlib.import_module("repro_torch.core.hdbscan")


def same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{msg} dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{msg} shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f"{msg} values differ"


def same_edges(r, t, msg=""):
    for x, y, name in zip(r, t, "uvw"):
        same(x, y, f"{msg} {name}")


# --------------------------------------------------------------------------
# data/synthetic.py
# --------------------------------------------------------------------------

class TestSynthetic:
    @pytest.mark.parametrize("n,d,k,overlap,noise,seed", [
        (500, 10, 20, 0.10, 0.0, 0), (300, 4, 5, 0.05, 0.0, 7), (400, 2, 3, 0.20, 0.1, 3),
        (200, 34, 15, 0.20, 0.15, 1), (64, 16, 8, 0.30, 0.10, 11)])
    def test_gaussian_mixtures(self, n, d, k, overlap, noise, seed):
        rx, ry = R_syn.gaussian_mixtures(n, d=d, k=k, overlap=overlap, noise_frac=noise, seed=seed)
        tx, ty = T_syn.gaussian_mixtures(n, d=d, k=k, overlap=overlap, noise_frac=noise, seed=seed)
        same(rx, tx, "X")
        same(ry, ty, "labels")

    @pytest.mark.parametrize("name", sorted(R_syn.DATASET_SPECS))
    def test_dataset(self, name):
        assert T_syn.DATASET_SPECS[name] == R_syn.DATASET_SPECS[name]
        for a, b in zip(R_syn.dataset(name, 300, seed=2), T_syn.dataset(name, 300, seed=2)):
            same(a, b, name)

    @pytest.mark.parametrize("window,slide", [(100, 25), (64, 64), (250, 7)])
    def test_sliding_window_workload(self, window, slide):
        X, _ = T_syn.gaussian_mixtures(400, d=3, k=4, seed=5)
        r = list(R_syn.sliding_window_workload(X, window, slide))
        t = list(T_syn.sliding_window_workload(X, window, slide))
        assert len(r) == len(t)
        for (rb, rc), (tb, tc) in zip(r, t):
            same(rb, tb)
            assert rc == tc

    @pytest.mark.parametrize("seed", [0, 5])
    def test_token_stream(self, seed):
        rs, ts = R_syn.token_stream(64, 2, 8, seed=seed), T_syn.token_stream(64, 2, 8, seed=seed)
        for _ in range(4):
            r, t = next(rs), next(ts)
            assert r.keys() == t.keys() and r["topic"] == t["topic"] and r["step"] == t["step"]
            same(r["tokens"], t["tokens"])
            same(r["labels"], t["labels"])


# --------------------------------------------------------------------------
# core/metrics.py
# --------------------------------------------------------------------------

class TestMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("average", ["arithmetic", "geometric", "max"])
    def test_nmi(self, seed, average):
        rng = np.random.default_rng(seed)
        a = rng.integers(-1, 5, size=300)
        b = np.where(rng.random(300) < 0.7, a, rng.integers(-1, 7, size=300))
        assert T_met.nmi(a, b, average=average) == R_met.nmi(a, b, average=average)
        assert T_met.nmi(a, a, average=average) == R_met.nmi(a, a, average=average)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ari_and_contingency(self, seed):
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 4, size=200)
        b = np.where(rng.random(200) < 0.5, a, rng.integers(0, 3, size=200))
        assert T_met.ari(a, b) == R_met.ari(a, b)
        same(R_met.contingency(a, b), T_met.contingency(a, b))

    def test_degenerate(self):
        for a, b in (([], []), ([0, 0], [1, 1]), ([0, 1], [0, 0])):
            assert T_met.nmi(a, b) == R_met.nmi(a, b)
            assert T_met.ari(a, b) == R_met.ari(a, b)


# --------------------------------------------------------------------------
# core/mst.py (host engines), on tests/test_mst.py's cases
# --------------------------------------------------------------------------

def _random_metric_matrix(rng, n):
    X = rng.normal(size=(n, 3))
    d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    return d


class TestHostMST:
    def test_union_find(self):
        rng = np.random.default_rng(4)
        r, t = R_mst.UnionFind(40), T_mst.UnionFind(40)
        for a, b in rng.integers(0, 40, size=(60, 2)):
            assert r.union(int(a), int(b)) == t.union(int(a), int(b))
            assert r.find(int(a)) == t.find(int(a))
        assert r.n_components == t.n_components
        same(r.parent, t.parent)
        same(r.size, t.size)
        same(r.labels(), t.labels())

    @pytest.mark.parametrize("n", [2, 3, 17, 64, 150])
    def test_boruvka_dense(self, n):
        W = _random_metric_matrix(np.random.default_rng(n), n)
        same_edges(R_mst.boruvka_dense(W), T_mst.boruvka_dense(W), f"n={n}")

    def test_boruvka_dense_from_forest(self):
        W = _random_metric_matrix(np.random.default_rng(30), 30)
        u0, v0, w0 = R_mst.boruvka_dense(W)
        keep = np.argsort(w0)[:-5]
        forest = (u0[keep], v0[keep], w0[keep])
        same_edges(R_mst.boruvka_dense(W, forest=forest), T_mst.boruvka_dense(W, forest=forest))

    def test_boruvka_dense_ties_and_disconnected(self):
        W = np.ones((6, 6))
        np.fill_diagonal(W, np.inf)
        same_edges(R_mst.boruvka_dense(W), T_mst.boruvka_dense(W), "ties")
        W = _random_metric_matrix(np.random.default_rng(8), 12)
        W[:6, 6:] = W[6:, :6] = np.inf
        same_edges(R_mst.boruvka_dense(W), T_mst.boruvka_dense(W), "two components")

    def test_component_min_outgoing(self):
        W = _random_metric_matrix(np.random.default_rng(9), 25)
        labels = np.arange(25) // 4
        for a, b in zip(R_mst._component_min_outgoing(W, labels), T_mst._component_min_outgoing(W, labels)):
            same(a, b)

    @pytest.mark.parametrize("n,seed", [(5, 0), (17, 1), (40, 2), (33, 3)])
    def test_kruskal(self, n, seed):
        W = _random_metric_matrix(np.random.default_rng(seed), n)
        iu, iv = np.triu_indices(n, k=1)
        same_edges(R_mst.kruskal_edges(iu, iv, W[iu, iv], n), T_mst.kruskal_edges(iu, iv, W[iu, iv], n))

    def test_kruskal_forest_and_seeded(self):
        u, v, w = np.array([0, 1, 3]), np.array([1, 2, 4]), np.array([1.0, 2.0, 3.0])
        same_edges(R_mst.kruskal_edges(u, v, w, 5), T_mst.kruskal_edges(u, v, w, 5), "forest")
        ru, tu = R_mst.UnionFind(5), T_mst.UnionFind(5)
        ru.union(0, 4)
        tu.union(0, 4)
        same_edges(R_mst.kruskal_edges(u, v, w, 5, uf=ru), T_mst.kruskal_edges(u, v, w, 5, uf=tu), "seeded")
        same(ru.parent, tu.parent)


# --------------------------------------------------------------------------
# core/hdbscan.py, on tests/test_hdbscan.py's cases
# --------------------------------------------------------------------------

def _same_result(r, t):
    same(r.labels, t.labels, "labels")
    same_edges(r.mst, t.mst, "mst")
    same(r.core_dists, t.core_dists, "core_dists")
    same(r.slt.merges, t.slt.merges, "merges")
    same(r.slt.weights, t.slt.weights, "leaf weights")
    for f in ("parent", "child", "lambda_val", "child_weight"):
        same(getattr(r.condensed, f), getattr(t.condensed, f), f)
    assert r.condensed.n_leaves == t.condensed.n_leaves
    assert r.selected == t.selected
    assert r.total_mst_weight == t.total_mst_weight


def _hdbscan_cases():
    rng = np.random.default_rng(0)
    X, _ = make_blobs(rng)
    noisy = np.concatenate([X, rng.uniform(-10, 16, size=(20, 2))])
    one = np.random.default_rng(1).normal(size=(50, 2))
    pairs = np.array([[0.0, 0], [0.1, 0], [5, 0], [5.1, 0]])
    return {
        "blobs": (X, dict(min_pts=5)),
        "noise": (noisy, dict(min_pts=5)),
        "single_cluster": (one, dict(min_pts=5, allow_single_cluster=True)),
        "leaf": (X, dict(min_pts=5, method="leaf")),
        "leaf_single": (one, dict(min_pts=5, method="leaf", allow_single_cluster=True)),
        "weighted": (pairs, dict(min_pts=2, min_cluster_size=60, weights=np.full(4, 50.0))),
        "tiny": (np.zeros((2, 2)), dict(min_pts=2)),
        "one_point": (np.zeros((1, 3)), dict(min_pts=2)),
        "min_pts_1": (one[:10], dict(min_pts=1)),
        "min_pts_over_n": (one[:5], dict(min_pts=100)),
        "mcs": (noisy, dict(min_pts=4, min_cluster_size=12.5)),
    }


HDBSCAN_CASES = _hdbscan_cases()


class TestHDBSCAN:
    @pytest.mark.parametrize("k", [1, 7, 100])
    def test_core_distances(self, k):
        X = np.random.default_rng(k).normal(size=(50, 4))
        same(R_h.core_distances(X, k), T_h.core_distances(X, k))
        same(R_h.pairwise_sqdist(X), T_h.pairwise_sqdist(X))
        same(R_h.pairwise_sqdist(X, X[:7]), T_h.pairwise_sqdist(X, X[:7]))

    def test_mutual_reachability_and_mst(self):
        X = np.random.default_rng(3).normal(size=(80, 5))
        cd = R_h.core_distances(X, 5)
        same(R_h.mutual_reachability(X, cd), T_h.mutual_reachability(X, cd))
        (ru, rcd), (tu, tcd) = R_h.mst_of_points(X, 5), T_h.mst_of_points(X, 5)
        same_edges(ru, tu)
        same(rcd, tcd)

    @pytest.mark.parametrize("case", sorted(HDBSCAN_CASES))
    def test_hdbscan(self, case):
        X, kw = HDBSCAN_CASES[case]
        _same_result(R_h.hdbscan(X, **kw), T_h.hdbscan(X, **kw))

    def test_precomputed(self):
        X, kw = HDBSCAN_CASES["blobs"]
        W = R_h.mutual_reachability(X, R_h.core_distances(X, 5))
        _same_result(R_h.hdbscan(X, min_pts=5, precomputed=W), T_h.hdbscan(X, min_pts=5, precomputed=W))

    @pytest.mark.parametrize("mcs", [2.0, 5.0, 15.5])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_stages(self, mcs, weighted):
        """Each stage fed the reference's previous output: merges,
        condensed rows, stabilities, selection (both methods, with and
        without allow_single_cluster) and labels."""
        rng = np.random.default_rng(int(mcs * 10) + weighted)
        X = rng.normal(size=(60, 2))
        w = rng.uniform(0.5, 4.0, size=60) if weighted else None
        (u, v, wt), _ = R_h.mst_of_points(X, 4)
        rs, ts = R_h.single_linkage(u, v, wt, 60, weights=w), T_h.single_linkage(u, v, wt, 60, weights=w)
        same(rs.merges, ts.merges)
        same(rs.weights, ts.weights)
        rc, tc = R_h.condense_tree(rs, min_cluster_size=mcs), T_h.condense_tree(rs, min_cluster_size=mcs)
        for f in ("parent", "child", "lambda_val", "child_weight"):
            same(getattr(rc, f), getattr(tc, f), f)
        same(rc.cluster_ids(), tc.cluster_ids())
        assert R_h._stabilities(rc) == T_h._stabilities(rc)
        for method in ("eom", "leaf"):
            for single in (False, True):
                sel = R_h.extract_clusters(rc, method=method, allow_single_cluster=single)
                assert T_h.extract_clusters(rc, method=method, allow_single_cluster=single) == sel
                same(R_h.hdbscan_labels(rc, sel), T_h.hdbscan_labels(rc, sel))


# --------------------------------------------------------------------------
# core/bubbles.py and BubbleTree.to_bubbles
# --------------------------------------------------------------------------

def _cf_table(seed, L=40, d=3):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 30, size=L).astype(np.float64)
    n[::7] = 0.0  # empty rows are dropped
    pts = [rng.normal(loc=rng.normal(scale=5.0, size=d), size=(int(k), d)) for k in n]
    LS = np.stack([p.sum(0) if len(p) else np.zeros(d) for p in pts])
    SS = np.array([(p * p).sum() for p in pts])
    return LS, SS, n


class TestBubbles:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bubbles_from_cf(self, seed):
        r, t = R_bub.bubbles_from_cf(*_cf_table(seed)), T_bub.bubbles_from_cf(*_cf_table(seed))
        for f in ("rep", "n", "extent"):
            same(getattr(r, f), getattr(t, f), f)
        assert r.dim == t.dim and r.size == t.size
        same(r.nn_dist(3.0), t.nn_dist(3.0))

    @pytest.mark.parametrize("min_pts", [1, 5, 40, 100_000])
    def test_core_and_mutual_reachability(self, min_pts):
        b = R_bub.bubbles_from_cf(*_cf_table(2))
        tb = T_bub.DataBubbles(rep=b.rep, n=b.n, extent=b.extent, dim=b.dim)
        same(R_bub.bubble_core_distances(b, min_pts), T_bub.bubble_core_distances(tb, min_pts))
        for adj in (False, True):
            (rw, rcd), (tw, tcd) = (R_bub.bubble_mutual_reachability(b, min_pts, extent_adjusted=adj),
                                    T_bub.bubble_mutual_reachability(tb, min_pts, extent_adjusted=adj))
            same(rw, tw, f"W adjusted={adj}")
            same(rcd, tcd)


def _stream(seed, n=600, d=3):
    """One insert/delete stream: blocks, single inserts, block and single
    deletes (ids in the order each tree returned them)."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(loc=c, size=(n // 3, d)) for c in (0.0, 6.0, -6.0)])
    return X[rng.permutation(X.shape[0])], rng


@pytest.mark.parametrize("seed", [0, 1])
def test_to_bubbles_after_a_stream(seed):
    X, rng = _stream(seed)
    trees = [R_tree.BubbleTree(dim=3, compression=0.05), T_tree.BubbleTree(dim=3, compression=0.05)]
    ids = [t.insert_block(X[:300]) + [t.insert(p) for p in X[300:350]] + t.insert_block(X[350:]) for t in trees]
    assert ids[0] == ids[1]
    drop = rng.choice(len(ids[0]), size=200, replace=False)
    for t in trees:
        t.delete_block([ids[0][j] for j in drop[:150]])
        for j in drop[150:]:
            t.delete(ids[0][j])
    r, b = (t.to_bubbles() for t in trees)
    assert type(b).__module__ == "repro_torch.core.bubbles"
    for f in ("rep", "n", "extent"):
        same(getattr(r, f), getattr(b, f), f)
    assert r.dim == b.dim and b.size == trees[1].num_leaves


class TestBaselines:
    @pytest.mark.parametrize("decay", [0.0, 0.05])
    def test_clustree(self, decay):
        X, _ = _stream(3, n=300, d=2)
        r, t = R_base.ClusTreeLite(dim=2, max_height=5, decay_lambda=decay), T_base.ClusTreeLite(
            dim=2, max_height=5, decay_lambda=decay)
        for p in X:
            r.insert(p)
            t.insert(p)
        assert r.num_leaves == t.num_leaves
        rb, tb = r.to_bubbles(), t.to_bubbles()
        for f in ("rep", "n", "extent"):
            same(getattr(rb, f), getattr(tb, f), f)

    @pytest.mark.parametrize("compression", [0.05, 0.1])
    def test_incremental_bubbles(self, compression):
        X, _ = _stream(4, n=300, d=2)
        r, t = R_base.IncrementalBubbles(dim=2, compression=compression), T_base.IncrementalBubbles(
            dim=2, compression=compression)
        for p in X:
            r.insert(p)
            t.insert(p)
        for p in X[:100]:
            r.delete_nearest(p)
            t.delete_nearest(p)
        assert r.num_leaves == t.num_leaves and r.target_L == t.target_L
        rb, tb = r.to_bubbles(), t.to_bubbles()
        for f in ("rep", "n", "extent"):
            same(getattr(rb, f), getattr(tb, f), f)


# --------------------------------------------------------------------------
# core/dynamic.py, on tests/test_dynamic.py's workloads
# --------------------------------------------------------------------------

def _same_dynamic(r, t):
    for name in DYNAMIC_HDBSCAN_FIELDS:
        if name != "_free":
            same(getattr(r, name), getattr(t, name), name)
    assert r._free == t._free and r.n == t.n
    assert r.total_weight() == t.total_weight()
    same_edges(r.mst_edges(), t.mst_edges(), "mst_edges")


def _mixed(dyns, seed, min_pts, steps=None):
    """tests/test_dynamic.py's mixed workload, the same ops on every
    structure of ``dyns``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps or rng.integers(20, 60)):
        alive = np.nonzero(dyns[0].alive)[0]
        if alive.size > min_pts + 2 and rng.random() < 0.35:
            i = int(rng.choice(alive))
            for d in dyns:
                d.delete(i)
        else:
            p = rng.normal(size=dyns[0].dim) * rng.choice([0.5, 3.0])
            assert len({d.insert(p) for d in dyns}) == 1


class TestDynamic:
    @pytest.mark.parametrize("seed,min_pts", [(0, 2), (1, 3), (7, 5), (42, 6), (99, 4)])
    def test_mixed_workload(self, seed, min_pts):
        dyns = [R_dyn.DynamicHDBSCAN(min_pts=min_pts, dim=2), T_dyn.DynamicHDBSCAN(min_pts=min_pts, dim=2)]
        _mixed(dyns, seed, min_pts)
        _same_dynamic(*dyns)
        assert dyns[0].stats["rknn_sizes"] == dyns[1].stats["rknn_sizes"]
        assert dyns[0].stats["boruvka_components"] == dyns[1].stats["boruvka_components"]

    def test_growth_hub_and_empty(self):
        rng = np.random.default_rng(3)
        X = np.concatenate([np.zeros((1, 2)), rng.normal(size=(40, 2)) * 5.0])
        dyns = [R_dyn.DynamicHDBSCAN(min_pts=3, dim=2, capacity=16), T_dyn.DynamicHDBSCAN(
            min_pts=3, dim=2, capacity=16)]
        ids = [[d.insert(p) for p in X] for d in dyns]  # grows past 16
        assert ids[0] == ids[1]
        for d in dyns:
            d.delete(ids[0][0])  # the hub
        _same_dynamic(*dyns)
        # down to empty at min_pts 2 (both packages raise when a kNN row
        # is recomputed over fewer than min_pts survivors)
        dyns = [R_dyn.DynamicHDBSCAN(min_pts=2, dim=2), T_dyn.DynamicHDBSCAN(min_pts=2, dim=2)]
        ids = [[d.insert(p) for p in X[:6]] for d in dyns]
        for i in ids[0]:
            for d in dyns:
                d.delete(i)
            _same_dynamic(*dyns)
        assert dyns[1].n == 0 and dyns[1].total_weight() == 0.0

    def test_batches_on_blobs(self):
        X, _ = make_blobs(np.random.default_rng(0))
        dyns = [R_dyn.DynamicHDBSCAN(min_pts=5, dim=2), T_dyn.DynamicHDBSCAN(min_pts=5, dim=2)]
        ids = [d.insert_batch(X[:120]) for d in dyns]
        assert ids[0] == ids[1]
        for d in dyns:
            d.delete_batch(ids[0][:20])
        _same_dynamic(*dyns)


@pytest.mark.parametrize("seed,min_pts", [(5, 3), (11, 5)])
def test_dynamic_hdbscan_from_reference(seed, min_pts):
    """The carried structure continues the reference's stream identically:
    every array, the MST weight and the flat partition of its MST."""
    ref = R_dyn.DynamicHDBSCAN(min_pts=min_pts, dim=2, capacity=32)
    _mixed([ref], seed, min_pts, steps=50)
    port = dynamic_hdbscan_from_reference({k: np.asarray(getattr(ref, k)) for k in DYNAMIC_HDBSCAN_FIELDS})
    assert isinstance(port, T_dyn.DynamicHDBSCAN)
    _same_dynamic(ref, port)
    _mixed([ref, port], seed + 1, min_pts, steps=40)
    _same_dynamic(ref, port)
    alive = np.nonzero(port.alive)[0]
    remap = np.full(port.X.shape[0], -1)
    remap[alive] = np.arange(alive.size)
    labels = []
    for mod, dyn in ((R_h, ref), (T_h, port)):
        u, v, w = dyn.mst_edges()
        ct = mod.condense_tree(mod.single_linkage(remap[u], remap[v], w, alive.size), min_cluster_size=min_pts)
        labels.append(mod.hdbscan_labels(ct, mod.extract_clusters(ct)))
    same(*labels)
