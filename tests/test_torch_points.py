"""The port's point-level kernel API against the JAX package's, on the CPU.

``repro_torch.kernels.ops``'s ``knn``, ``core_distances``,
``pairwise_sqdist`` and point-level ``mutual_reachability`` (on a CPU
tensor, the plain versions their kernel wrappers take) are held against
``repro.kernels.ops`` with its Pallas kernels in interpret mode, against
the jnp oracles of ``repro.kernels.ref``, and core distances against the
f64 ``repro.core.hdbscan.core_distances`` (Def. 1), on the same numpy
inputs from a seed.  So are the port's ``ClusterBackend`` methods against
the JAX ``ClusterBackend("pallas")``, and its ``offline_recluster``
against ``ops.offline_recluster(..., use_ref=True)``.

Tolerances: knn indices identical on rows without near-ties; distances,
squared distances and Eq. 7 values within 1e-5 relative plus ``ATOL``,
the f32 cancellation of the expanded form at unit scale (the two sides
sum in different orders); the offline pass gives the same partition and
an MST weight within 1e-6 relative.  The TF32 probes hold every distance
kernel's plain version to f64 within 2e-5 on inputs where TF32 products
would miss by up to 4e-4.
"""

import numpy as np
import pytest
import torch

from conftest import assert_same_partition, make_blobs
from repro.core.hdbscan import core_distances as np_core_distances
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.bubble_tree import BubbleTree
from repro_torch.kernels import assign as t_assign
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import knn as t_knn
from repro_torch.kernels import mutual_reach as t_mr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise as t_pw
from repro_torch.kernels import ref as tref

DIMS = [2, 8, 16, 34]
WIDE_DIMS = [129, 200]  # past the warp-select core's d <= 128
RTOL = 1e-5
ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _centred(rng, n, d):
    X = rng.normal(size=(n, d))
    return (X - X.mean(axis=0)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tie_free_rows(x, y, k):
    """Rows whose k + 1 nearest squared distances (f64) are pairwise apart
    by more than 64× the f32 rounding of the expanded form."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    sq = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    top = np.sort(sq, axis=1)[:, : k + 1]
    noise = 64 * EPS32 * ((x64**2).sum(1) + (y64**2).sum(1).max())
    return (np.diff(top, axis=1) > noise[:, None]).all(1)


def _isolated_entries(x, y, k):
    """(n, k) mask of the knn entries whose f64 squared distance is apart
    from both neighbours in the sorted row by more than 64× the f32
    rounding of the expanded form: no rounding can move their index."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    sq = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    top = np.sort(sq, axis=1)[:, : k + 1]
    noise = 64 * EPS32 * ((x64**2).sum(1) + (y64**2).sum(1).max())
    gap = np.diff(top, axis=1) > noise[:, None]  # gap[:, t]: between entries t and t + 1
    before = np.concatenate([np.ones_like(gap[:, :1]), gap[:, : k - 1]], axis=1)
    return before & gap


def _tf32_probe(rng, n=64, m=80, d=4):
    """x with full 24-bit mantissas against rows c·e_j, c a multiple of
    1/8 (exact in TF32): x·y is c·x_j to within f32 rounding, and off by
    up to 2^-11 relative where the product runs in TF32.  Returns f32 x,
    y and the f64 squared distances."""
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    c = rng.choice([-7, -5, -3, -1, 1, 3, 5, 7], size=(m, 1)) / 8.0
    y = (c * np.eye(d)[rng.integers(0, d, size=m)]).astype(np.float32)
    sq = ((x.astype(np.float64)[:, None, :] - y.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    return x, y, sq


class TestKnn:
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("k", [1, 5, 16, 64])
    def test_matches_pallas_and_reference(self, rng, d, k):
        X = _centred(rng, 29, d)
        Y = _centred(rng, 67, d)  # a multiple of no block or chunk size
        dist, idx = tops.knn(_t(X), _t(Y), k)
        assert dist.shape == idx.shape == (29, k) and idx.dtype == torch.int32
        pd, pi = (np.asarray(a) for a in jops.knn(X, Y, k, use_ref=False))
        rd, ri = (np.asarray(a) for a in jref.knn(X, Y, k))
        np.testing.assert_allclose(dist.numpy(), pd, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dist.numpy(), rd, rtol=RTOL, atol=ATOL)
        keep = _tie_free_rows(X, Y, k)
        assert keep.sum() >= 10
        np.testing.assert_array_equal(idx.numpy()[keep], pi[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], ri[keep])

    def test_large_m_against_reference(self, rng):
        """m above the JAX kernel's VMEM cap (16,384): the port has no cap."""
        X = _centred(rng, 6, 4)
        Y = _centred(rng, 16_448, 4)
        dist, idx = tops.knn(_t(X), _t(Y), 10)
        rd, ri = (np.asarray(a) for a in jref.knn(X, Y, 10))
        np.testing.assert_allclose(dist.numpy(), rd, rtol=RTOL, atol=ATOL)
        keep = _tie_free_rows(X, Y, 10)
        assert keep.sum() >= 3
        np.testing.assert_array_equal(idx.numpy()[keep], ri[keep])

    @pytest.mark.parametrize("k", [4, 12])
    def test_all_zeros_table_takes_the_first_columns(self, k):
        X = np.zeros((12, 3), np.float32)
        dist, idx = tops.knn(_t(X), _t(X), k)
        assert (dist.numpy() == 0).all()
        np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(k), (12, k)))
        _, pi = jops.knn(X, X, k, use_ref=False)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))

    def test_k_clamped_to_m(self, rng):
        X, Y = _centred(rng, 5, 3), _centred(rng, 7, 3)
        dist, idx = tops.knn(_t(X), _t(Y), 50)
        assert dist.shape == (5, 7)
        np.testing.assert_array_equal(np.sort(idx.numpy(), axis=1), np.broadcast_to(np.arange(7), (5, 7)))

    def test_k_above_64_raises(self, rng):
        """Named for the former bound of 64, which then moved to 1024: knn
        and core_distances take any k <= m on every device now (the card
        takes the strip route above 1024), and only the per-lane oracle
        still raises, above 64."""
        X = _t(_centred(rng, 1100, 3))
        with pytest.raises(ValueError, match="k <= 64"):
            t_knn.knn_lane(X, X, 65)
        dist, idx = t_knn.knn(X, X, 1025)
        pd, pi = tref.knn(X, X, 1025)
        assert torch.equal(dist, pd) and torch.equal(idx, pi)
        assert torch.equal(tops.core_distances(X, 1025), pd[:, 1024])
        assert tops.knn(X, X, 1024)[0].shape == (1100, 1024)
        assert tops.knn(X, X, 65)[0].shape == (1100, 65)

    @pytest.mark.parametrize("k", [1025, 1100])
    def test_k_above_1024_matches_reference(self, rng, k):
        """k past the warp-select core's 1024 (the strip route on the card):
        ops.knn and ops.core_distances against the JAX package's jnp path
        and oracle, which have no bound on k."""
        X = _centred(rng, 40, 3)
        Y = _centred(rng, 1200, 3)
        dist, idx = tops.knn(_t(X), _t(Y), k)
        assert dist.shape == idx.shape == (40, k)
        ud, ui = (np.asarray(a) for a in jops.knn(X, Y, k, use_ref=True))
        rd, ri = (np.asarray(a) for a in jref.knn(X, Y, k))
        np.testing.assert_allclose(dist.numpy(), ud, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dist.numpy(), rd, rtol=RTOL, atol=ATOL)
        keep = _isolated_entries(X, Y, k)
        assert keep.sum() > keep.size // 2
        np.testing.assert_array_equal(idx.numpy()[keep], ui[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], ri[keep])
        got = tops.core_distances(_t(Y), k).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.core_distances(Y, k)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np_core_distances(Y.astype(np.float64), k), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("k", [65, 100, 257])
    def test_large_k_matches_pallas_and_reference(self, rng, k):
        """k past the former bound of 64: ops.knn and ops.core_distances
        against the JAX package's (its Pallas kernel takes any k)."""
        X = _centred(rng, 40, 8)
        Y = _centred(rng, 300, 8)
        dist, idx = tops.knn(_t(X), _t(Y), k)
        assert dist.shape == idx.shape == (40, k)
        pd, pi = (np.asarray(a) for a in jops.knn(X, Y, k, use_ref=False))
        rd, ri = (np.asarray(a) for a in jref.knn(X, Y, k))
        np.testing.assert_allclose(dist.numpy(), pd, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dist.numpy(), rd, rtol=RTOL, atol=ATOL)
        keep = _isolated_entries(X, Y, k)
        assert keep.sum() > keep.size // 2
        np.testing.assert_array_equal(idx.numpy()[keep], pi[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], ri[keep])
        got = tops.core_distances(_t(Y), k).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.core_distances(Y, k)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np_core_distances(Y.astype(np.float64), k), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", DIMS)
    def test_core_distances(self, rng, d):
        X = _centred(rng, 61, d)
        got = tops.core_distances(_t(X), 7).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.core_distances(X, 7)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np_core_distances(X.astype(np.float64), 7), rtol=RTOL, atol=ATOL)

    def test_core_distances_min_pts_above_n(self, rng):
        X = _centred(rng, 9, 3)
        got = tops.core_distances(_t(X), 20).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.core_distances(X, 20)), rtol=RTOL, atol=ATOL)


class TestPairwise:
    @pytest.mark.parametrize("d", DIMS)
    def test_matches_pallas_and_reference(self, rng, d):
        X, Y = _centred(rng, 37, d), _centred(rng, 53, d)
        got = tops.pairwise_sqdist(_t(X), _t(Y)).numpy()
        assert got.shape == (37, 53)
        np.testing.assert_allclose(got, np.asarray(jops.pairwise_sqdist(X, Y, use_ref=False)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jref.pairwise_sqdist(X, Y)), rtol=RTOL, atol=ATOL)
        assert (got >= 0).all()

    def test_rejects_bad_input(self):
        with pytest.raises(TypeError):
            t_pw.pairwise_sqdist(torch.zeros(3, 2, dtype=torch.float64), torch.zeros(4, 2))
        with pytest.raises(ValueError):
            t_pw.pairwise_sqdist(torch.zeros(3, 2), torch.zeros(4, 3))


class TestPointMutualReachability:
    @pytest.mark.parametrize("zero_diag", [True, False])
    @pytest.mark.parametrize("d", [2, 16])
    def test_non_square_matches_pallas(self, rng, d, zero_diag):
        X, Y = _centred(rng, 37, d), _centred(rng, 53, d)
        cx = rng.uniform(0.1, 1.0, size=37).astype(np.float32)
        cy = rng.uniform(0.1, 1.0, size=53).astype(np.float32)
        got = tops.mutual_reachability(_t(X), _t(Y), _t(cx), _t(cy), zero_diag=zero_diag).numpy()
        want = np.asarray(jops.mutual_reachability(X, Y, cx, cy, zero_diag=zero_diag, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, np.asarray(jref.mutual_reachability(X, Y, cx, cy, zero_diag=zero_diag)), rtol=RTOL, atol=ATOL)
        assert (np.diag(got) == 0).all() == zero_diag

    def test_def2_on_core_distances(self, rng):
        """Def. 2 on raw points: core distances then the (n, n) matrix."""
        X = _centred(rng, 40, 3)
        cd = tops.core_distances(_t(X), 5)
        got = tops.mutual_reachability(_t(X), _t(X), cd, cd).numpy()
        jcd = jops.core_distances(X, 5)
        want = np.asarray(jops.mutual_reachability(X, X, jcd, jcd, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class TestWideRows:
    """d past the warp-select core's 128 (the strip route and the sliced
    tile kernels on the card): the point-level API against the JAX
    package's Pallas kernels in interpret mode (d padded to 256 there) and
    its jnp oracles."""

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_knn_and_core_distances(self, rng, d):
        X, Y = _centred(rng, 29, d), _centred(rng, 67, d)
        dist, idx = tops.knn(_t(X), _t(Y), 5)
        pd, pi = (np.asarray(a) for a in jops.knn(X, Y, 5, use_ref=False))
        rd, ri = (np.asarray(a) for a in jref.knn(X, Y, 5))
        np.testing.assert_allclose(dist.numpy(), pd, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dist.numpy(), rd, rtol=RTOL, atol=ATOL)
        keep = _tie_free_rows(X, Y, 5)
        assert keep.sum() >= 10
        np.testing.assert_array_equal(idx.numpy()[keep], pi[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], ri[keep])
        got = tops.core_distances(_t(Y), 7).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.core_distances(Y, 7)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np_core_distances(Y.astype(np.float64), 7), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_pairwise(self, rng, d):
        X, Y = _centred(rng, 37, d), _centred(rng, 53, d)
        got = tops.pairwise_sqdist(_t(X), _t(Y)).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.pairwise_sqdist(X, Y, use_ref=False)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jref.pairwise_sqdist(X, Y)), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_mutual_reachability(self, rng, d):
        X, Y = _centred(rng, 37, d), _centred(rng, 53, d)
        cx = rng.uniform(0.1, 1.0, size=37).astype(np.float32)
        cy = rng.uniform(0.1, 1.0, size=53).astype(np.float32)
        got = tops.mutual_reachability(_t(X), _t(Y), _t(cx), _t(cy)).numpy()
        want = np.asarray(jops.mutual_reachability(X, Y, cx, cy, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jref.mutual_reachability(X, Y, cx, cy)), rtol=RTOL, atol=ATOL)


class TestTf32Probe:
    """Fails if a distance kernel's plain version drops IEEE f32 products
    (e.g. a lowered float32 matmul precision)."""

    @pytest.mark.parametrize("kernel", ["assign", "knn", "pairwise", "mutual_reach", "bubble_cd"])
    def test_ieee_products(self, kernel):
        x, y, sq = _tf32_probe(np.random.default_rng(9))
        xt, yt = _t(x), _t(y)
        if kernel == "bubble_cd":
            # unit masses, no extent, min_pts 2: the distance to the nearest other row
            rep = torch.cat([xt, yt])
            L = rep.shape[0]
            cd = t_bcd.bubble_core_distances(rep, torch.ones(L), torch.zeros(L), min_pts=2, dim=4)
            got = cd.double().numpy() ** 2
            r64 = rep.double().numpy()
            want = ((r64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(want, np.inf)
            want = want.min(1)
        elif kernel == "assign":
            idx, dist = t_assign.assign(xt, yt, with_dist=True)
            got = dist.double().numpy() ** 2
            want = sq[np.arange(x.shape[0]), idx.numpy()]
            assert (want <= sq.min(1) + 2e-5).all()
        elif kernel == "knn":
            dist, idx = t_knn.knn(xt, yt, 5)
            got = dist.double().numpy() ** 2
            want = np.take_along_axis(sq, idx.long().numpy(), 1)
        elif kernel == "pairwise":
            got, want = t_pw.pairwise_sqdist(xt, yt).double().numpy(), sq
        else:
            zx, zy = torch.zeros(x.shape[0]), torch.zeros(y.shape[0])
            got = t_mr.mutual_reachability(xt, yt, zx, zy, zero_diag=False).double().numpy() ** 2
            want = sq
        assert np.abs(got - want).max() < 2e-5


def _bubbles(rng, L, d):
    rep = _centred(rng, L, d)
    n_b = rng.integers(1, 6, size=L).astype(np.float32)
    extent = rng.uniform(0.05, 0.5, size=L).astype(np.float32)
    return rep, n_b, extent


class TestBackend:
    """The port's ClusterBackend on the CPU against the JAX backend's
    Pallas kernels in interpret mode."""

    @pytest.mark.parametrize("method", ["pairwise_sqdist", "knn", "assign", "assign_with_dist",
                                        "bubble_core_distances", "bubble_mutual_reachability"])
    def test_method_matches_jax_backend(self, rng, method):
        port, jax_be = tops.get_backend("cpu"), jops.get_backend("pallas")
        if method.startswith("bubble"):
            args = (*_bubbles(rng, 37, 5), 6)
        elif method == "knn":
            args = (_centred(rng, 29, 5), _centred(rng, 41, 5), 6)
        else:
            R = _centred(rng, 41, 5)
            Q = _centred(rng, 200, 5)
            args = (Q[_tie_free_rows(Q, R, 1)][:29], R)
        got = getattr(port, method)(*args)
        want = getattr(jax_be, method)(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            if g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("offset", [0.0, 1e4])
    def test_offline_recluster_matches_reference(self, rng, offset):
        X, _ = make_blobs(rng, n_per=120, d=3)
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X + offset)
        ids, LS, SS, N = tree.leaf_cf_buffers()
        got = tops.get_backend("cpu").offline_recluster(LS, SS, N, ids, 8, min_cluster_size=8.0)
        want = jops.offline_recluster(LS, SS, N, ids, 8, min_cluster_size=8.0, use_ref=True)
        assert got.n_clusters == want.n_clusters > 1
        assert_same_partition(got.labels, want.labels)
        assert float(np.sum(got.mst[2])) == pytest.approx(float(np.sum(want.mst[2])), rel=1e-6)

    @pytest.mark.parametrize("method", ["make_dynamic", "incremental_recluster"])
    def test_unported_paths_raise(self, method, rng):
        """Once refused as not ported, the exact-dynamic backend methods now
        run: ``make_dynamic`` hands out a handle on the backend's device and
        ``incremental_recluster`` labels its state like static HDBSCAN."""
        from repro.core.hdbscan import hdbscan
        from repro_torch.core.dynamic_torch import DynamicTorchHDBSCAN

        be = tops.get_backend("cpu")
        dev = be.make_dynamic(4, 3, capacity=32)
        assert isinstance(dev, DynamicTorchHDBSCAN) and dev.state.X.device == be.device
        X, _ = make_blobs(rng, n_per=20, d=3)
        slots = dev.insert_block(X)
        if method == "make_dynamic":
            assert dev.ok and dev.n == len(X)
            assert dev.total_weight() == pytest.approx(hdbscan(X, min_pts=4).total_mst_weight, rel=1e-6)
        else:
            res, got_slots, rep = be.incremental_recluster(dev.state, 4.0)
            np.testing.assert_array_equal(got_slots, np.sort(slots))
            np.testing.assert_array_equal(rep, X[np.argsort(slots)].astype(np.float32))
            assert_same_partition(res.labels, hdbscan(X[np.argsort(slots)], min_pts=4,
                                                       min_cluster_size=4.0).labels)

    def test_make_flat_feeds_the_device_table_pass(self, rng):
        """``make_flat`` hands out a flat table on the backend's device, and
        ``offline_recluster_from_device_table`` over its view gives the
        partition of the host-table pass on the same tree."""
        be = tops.get_backend("cpu")
        X, _ = make_blobs(rng, n_per=120, d=3)
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X + 40.0)
        flat = be.make_flat(3)
        flat.load(tree)
        got, rep, n_b, center = be.offline_recluster_from_device_table(*flat.device_view(), flat.origin, 8,
                                                                       min_cluster_size=8.0,
                                                                       slots=flat.alive_slots())
        ids, LS, SS, N = tree.leaf_cf_buffers()
        want = be.offline_recluster(LS, SS, N, ids, 8, min_cluster_size=8.0)
        assert got.n_clusters == want.n_clusters > 1
        assert_same_partition(got.labels, want.labels)  # load puts leaf ids in ascending slots
        np.testing.assert_allclose(rep, LS[ids] / N[ids][:, None], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(n_b, N[ids])
        np.testing.assert_allclose(center, LS[ids].sum(0) / N[ids].sum(), rtol=1e-6)
