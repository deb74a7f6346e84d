"""The port's offline pass against the JAX package's, on the CPU.

Borůvka (``repro_torch.core.mst.boruvka``) must write the same edge
buffers as ``repro.core.mst.boruvka_jax`` on a shared W — the composite
(w, canonical edge id) key makes every choice exact, ties included — and
so the same MST weight (held to 1e-6 relative).  The hierarchy stages,
fed the same edge buffers, must match every field of the reference's
``SingleLinkageArrays``/``CondensedArrays``/``ExtractionArrays``: integer
fields exactly, λ, weights and stabilities within 1e-5 relative.  The
whole pass (``offline_recluster_from_table``) must give the reference's
partition (``conftest.assert_same_partition``) on blobs, moons, uniform
and duplicate-heavy tables, with MST weight within 1e-5 relative (f32
distances summed in different orders on the two sides).  Duplicate rows
are the exception to that weight tolerance: the f32 expansion puts the
distance between two copies of a row anywhere in [0, √(4ε·‖x‖²)] (the
square root of a rounding error), so each zero-length edge may differ by
that much between the two sides — and the stability of a cluster of
copies, a sum of 1/length over such edges, is not determined at all, so
only its count is compared there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_same_partition, make_blobs
from repro.core import hierarchy_jax as hj
from repro.core.mst import boruvka_jax
from repro.kernels import ops as jops
from repro_torch.core import hierarchy as th
from repro_torch.core.bubble_tree import BubbleTree
from repro_torch.core.mst import boruvka, mst_total_weight
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_hierarchy_cuda import edge_buffers

try:
    from sklearn.datasets import make_moons

    HAVE_SKLEARN = True
except ModuleNotFoundError:
    HAVE_SKLEARN = False

STAB_CEILING = 1e10  # below MAX_LAMBDA: the finite-stability comparison zone


def _dataset(name, rng):
    """(X, min_pts, min_cluster_size) per input family (as in
    tests/test_hierarchy_parity.py)."""
    if name == "blobs":
        X, _ = make_blobs(rng, n_per=70)
        return X, 8, 8.0
    if name == "moons":
        if not HAVE_SKLEARN:
            pytest.skip("moons generator needs scikit-learn")
        X, _ = make_moons(n_samples=200, noise=0.06, random_state=3)
        return np.asarray(X, dtype=np.float64), 8, 10.0
    if name == "uniform":
        return rng.uniform(size=(150, 3)), 6, 8.0
    base = rng.normal(size=(30, 2))
    return base[rng.integers(0, 30, size=160)], 5, 6.0


def _padded_W(name, rng):
    """A shared (Lp, Lp) f32 W built the way the offline pass builds it:
    centred points as unit bubbles, pads at +inf."""
    X, mp, mcs = _dataset(name, rng)
    n = X.shape[0]
    Lp = max(8, 1 << (n - 1).bit_length())
    rep = np.full((Lp, X.shape[1]), 1e6)
    rep[:n] = X - X.mean(axis=0)
    nb = np.zeros(Lp)
    nb[:n] = 1.0
    W = tref.bubble_mutual_reachability(
        torch.tensor(rep, dtype=torch.float32), torch.tensor(nb, dtype=torch.float32),
        torch.zeros(Lp), mp, n_valid=n)
    return W, n, nb.astype(np.float32), mcs


_boruvka_jit = jax.jit(boruvka_jax)
_hierarchy_jit = jax.jit(hj.hierarchy_fixed, static_argnames=("method", "allow_single_cluster"))

DATASETS = ["blobs", "moons", "uniform", "dups"]


class TestBoruvka:
    @pytest.mark.parametrize("name", DATASETS)
    def test_edge_buffers_match_reference(self, rng, name):
        W, n, _, _ = _padded_W(name, rng)
        got = [a.numpy() for a in boruvka(W)]
        want = [np.asarray(a) for a in _boruvka_jit(jnp.asarray(W.numpy()))]
        for g, w, field in zip(got, want, ("eu", "ev", "ew", "valid")):
            np.testing.assert_array_equal(g, w, err_msg=field)
        assert int(got[3].sum()) == n - 1
        np.testing.assert_allclose(
            mst_total_weight(got[2][got[3]]), mst_total_weight(want[2][want[3]]), rtol=1e-6)

    def test_all_ties(self):
        """A constant W: every edge ties, the canonical edge id decides."""
        W = torch.ones(16, 16)
        got = [a.numpy() for a in boruvka(W)]
        want = [np.asarray(a) for a in _boruvka_jit(jnp.ones((16, 16), jnp.float32))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _assert_fields(got, want, exact):
    for field in want._fields:
        g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if field in exact:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=field)


# (Lp, n_valid, edge_buffers options, min_cluster_size)
CORNERS = {
    "ties": (64, 64, {"ties": True}, 5.0),
    "zero distances": (64, 50, {"zeros": 0.3}, 5.0),
    "disconnected": (64, 60, {"drop": 6}, 5.0),
    "one valid leaf": (8, 1, {}, 5.0),
    "full bucket": (512, 512, {"masses": "frac"}, 12.0),
    "half bucket": (512, 257, {}, 8.0),
    "mcs below every weight": (64, 64, {"masses": "frac"}, 0.25),
    "mcs above the total": (64, 64, {}, 1e6),
}


class TestHierarchy:
    @pytest.mark.parametrize("name", DATASETS)
    @pytest.mark.parametrize("method,allow_single", [("eom", False), ("leaf", False), ("eom", True)])
    def test_every_field_matches_reference(self, rng, name, method, allow_single):
        W, n, nb, mcs = _padded_W(name, rng)
        eu, ev, ew, valid = _boruvka_jit(jnp.asarray(W.numpy()))
        want = _hierarchy_jit(eu, ev, ew, valid, n, jnp.asarray(nb), mcs,
                              method=method, allow_single_cluster=allow_single)
        got = th.hierarchy_fixed(
            *(torch.from_numpy(np.array(a)) for a in (eu, ev, ew, valid)), n,
            torch.from_numpy(nb), mcs, method=method, allow_single_cluster=allow_single)
        _assert_fields(got[0], want[0], exact={"left", "right"})
        _assert_fields(got[1], want[1], exact={"point_parent", "cluster_parent", "n_labels"})
        _assert_fields(got[2], want[2], exact={"selected", "labels", "n_clusters"})

    @pytest.mark.parametrize("name", list(CORNERS))
    @pytest.mark.parametrize("method,allow_single", [("eom", False), ("eom", True), ("leaf", False), ("leaf", True)])
    def test_corners_match_reference(self, name, method, allow_single):
        """The plain loops (the card kernels' oracle) on the corners the
        card's tests use, from seeded spanning-tree buffers: tied edge
        weights, zero distances (λ = MAX_LAMBDA), a disconnected buffer
        (rejected merges: skipped rows, a loaded trash node), a lone valid
        leaf, a full bucket, min_cluster_size below every weight and above
        the total."""
        Lp, nv, opts, mcs = CORNERS[name]
        bufs = edge_buffers(Lp, nv, 7, **opts)
        want = _hierarchy_jit(*(jnp.asarray(a) for a in bufs[:4]), nv, jnp.asarray(bufs[4]), mcs,
                              method=method, allow_single_cluster=allow_single)
        got = th.hierarchy_fixed(*(torch.from_numpy(a) for a in bufs[:4]), nv, torch.from_numpy(bufs[4]), mcs,
                                 method=method, allow_single_cluster=allow_single)
        _assert_fields(got[0], want[0], exact={"left", "right"})
        _assert_fields(got[1], want[1], exact={"point_parent", "cluster_parent", "n_labels"})
        _assert_fields(got[2], want[2], exact={"selected", "labels", "n_clusters"})
        if name == "disconnected":
            assert int((got[0].left == 2 * Lp - 1).sum()) == opts["drop"] and float(got[0].node_weight[-1]) > 0



def _assert_results_match(got, want, dup_floor: float = 0.0):
    """``dup_floor``: the per-edge f32 noise of zero-length edges
    (duplicate rows), √(4ε·max‖x‖²); 0 for data without duplicates."""
    assert_same_partition(got.labels, want.labels)
    np.testing.assert_allclose(
        mst_total_weight(got.mst[2]), mst_total_weight(want.mst[2]), rtol=1e-5,
        atol=dup_floor * len(got.mst[2]))
    g, w = np.sort(got.stabilities), np.sort(want.stabilities)
    assert g.shape == w.shape
    if dup_floor:
        return
    lo_g, lo_w = g < STAB_CEILING, w < STAB_CEILING
    np.testing.assert_array_equal(lo_g, lo_w)
    np.testing.assert_allclose(g[lo_g], w[lo_w], rtol=1e-5, atol=1e-5)


class TestOfflinePass:
    @pytest.mark.parametrize("name", DATASETS)
    def test_points_as_unit_bubbles(self, rng, name):
        X, mp, mcs = _dataset(name, rng)
        n = X.shape[0]
        args = (X, np.ones(n), np.zeros(n), mp)
        got = tops.offline_recluster_from_table(*args, min_cluster_size=mcs, device="cpu")
        want = jops.offline_recluster_from_table(*args, min_cluster_size=mcs, use_ref=True)
        Xc = X - X.mean(axis=0)
        floor = np.sqrt(4 * np.finfo(np.float32).eps * (Xc**2).sum(1).max()) if name == "dups" else 0.0
        _assert_results_match(got, want, floor)

    @pytest.mark.parametrize("offset", [0.0, 1e4])
    def test_weighted_bubbles_from_tree(self, rng, offset):
        """A Bubble-tree summary (masses > 1, extents > 0), on and off
        the origin: the host centring keeps the f32 pass exact."""
        X, _ = make_blobs(rng, n_per=150, d=3)
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X + offset)
        rep, extent, n_b, _ = tops.bubble_table(*tree.leaf_cf_buffers()[1:], tree.leaf_cf_buffers()[0])
        got = tops.offline_recluster_from_table(rep, n_b, extent, 10, device="cpu")
        want = jops.offline_recluster_from_table(rep, n_b, extent, 10, use_ref=True)
        _assert_results_match(got, want)

    def test_min_pts_100(self, rng):
        """min_pts = 100, past the former kernel bound of 64, on a weighted
        Bubble-tree summary: the ROADMAP tiers (same partition, MST weight
        within 1e-6, stabilities within 1e-5)."""
        X, _ = make_blobs(rng, n_per=300, d=3)
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X)
        rep, extent, n_b, _ = tops.bubble_table(*tree.leaf_cf_buffers()[1:], tree.leaf_cf_buffers()[0])
        assert n_b.sum() > 100
        got = tops.offline_recluster_from_table(rep, n_b, extent, 100, device="cpu")
        want = jops.offline_recluster_from_table(rep, n_b, extent, 100, use_ref=True)
        assert_same_partition(got.labels, want.labels)
        np.testing.assert_allclose(mst_total_weight(got.mst[2]), mst_total_weight(want.mst[2]), rtol=1e-6)
        g, w = np.sort(got.stabilities), np.sort(want.stabilities)
        assert g.shape == w.shape
        lo_g, lo_w = g < STAB_CEILING, w < STAB_CEILING
        np.testing.assert_array_equal(lo_g, lo_w)
        np.testing.assert_allclose(g[lo_g], w[lo_w], rtol=1e-5, atol=1e-5)

    def test_min_pts_above_mass(self):
        """A summary lighter than min_pts clamps min_pts to its mass."""
        rep = np.array([[0.0, 0.0], [1.0, 0.0], [5.0, 5.0]])
        n_b, extent = np.array([2.0, 2.0, 3.0]), np.array([0.1, 0.1, 0.2])
        got = tops.offline_recluster_from_table(rep, n_b, extent, 50, min_cluster_size=2.0, device="cpu")
        want = jops.offline_recluster_from_table(rep, n_b, extent, 50, min_cluster_size=2.0, use_ref=True)
        _assert_results_match(got, want)


def _pass_dict(buffers, ct, ex):
    """The fixed-size buffers an offline pass hands to its unwrap."""
    eu, ev, ew, valid = buffers
    return {
        "eu": eu, "ev": ev, "ew": ew, "valid": valid,
        "labels": ex.labels, "stability": ex.stability, "selected": ex.selected,
        "point_parent": ct.point_parent, "point_lambda": ct.point_lambda,
        "cluster_parent": ct.cluster_parent, "cluster_birth": ct.cluster_birth,
        "cluster_weight": ct.cluster_weight, "n_labels": ct.n_labels,
    }


class TestCondensedAndW:
    """``to_condensed()`` against the reference's on the four families,
    each side's result unwrapped from its own hierarchy over one shared W
    and one set of edge buffers (as in TestHierarchy): parent and child
    exact, λ and weights within 1e-5 relative.  ``return_w``'s W against
    the reference's within the mutual_reach parity tolerance of
    tests/test_torch_kernels.py (1e-5 relative plus 1e-5; for duplicate
    rows plus the f32 floor above, as far as copies sit apart)."""

    @pytest.mark.parametrize("name", DATASETS)
    def test_to_condensed_matches_reference(self, rng, name):
        W, n, nb, mcs = _padded_W(name, rng)
        buffers = _boruvka_jit(jnp.asarray(W.numpy()))
        want_h = _hierarchy_jit(*buffers, n, jnp.asarray(nb), mcs, method="eom", allow_single_cluster=False)
        tb = [torch.from_numpy(np.array(a)) for a in buffers]
        got_h = th.hierarchy_fixed(*tb, n, torch.from_numpy(nb), mcs)
        weights = nb[:n].astype(np.float64)
        want = jops._unwrap_result(_pass_dict(buffers, *want_h[1:]), n, mcs, weights).to_condensed()
        got = tops._unwrap_result(_pass_dict(tb, *got_h[1:]), n, mcs, weights).to_condensed()
        assert got.n_leaves == want.n_leaves == n
        np.testing.assert_array_equal(got.parent, want.parent)
        np.testing.assert_array_equal(got.child, want.child)
        for field in ("lambda_val", "child_weight"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=field)
        np.testing.assert_array_equal(got.cluster_ids(), want.cluster_ids())

    @pytest.mark.parametrize("name", DATASETS)
    def test_return_w_matches_reference(self, rng, name):
        X, mp, mcs = _dataset(name, rng)
        n = X.shape[0]
        Xc = X - X.mean(axis=0)
        floor = np.sqrt(4 * np.finfo(np.float32).eps * (Xc**2).sum(1).max()) if name == "dups" else 0.0
        args = (X, np.ones(n), np.zeros(n), mp)
        W, res = tops.offline_recluster_from_table(*args, min_cluster_size=mcs, device="cpu", return_w=True)
        W_ref, res_ref = jops.offline_recluster_from_table(*args, min_cluster_size=mcs, use_ref=True,
                                                           return_w=True)
        assert W.shape == (n, n) and W.dtype == np.float32
        np.testing.assert_allclose(W, np.asarray(W_ref), rtol=1e-5, atol=1e-5 + floor)
        assert_same_partition(res.labels, res_ref.labels)

    def test_condensed_of_the_pass_is_its_snapshot_layout(self, rng):
        """The whole pass's tree: one row per leaf and per non-root label,
        leaf mass conserved, cluster ids from L on."""
        X, _ = make_blobs(rng, n_per=40)
        n = len(X)
        res = tops.offline_recluster_from_table(X, np.ones(n), np.zeros(n), 6, device="cpu")
        ct = res.to_condensed()
        K = res.cluster_parent.shape[0]
        assert ct.parent.shape == ct.child.shape == (n + K - 1,)
        np.testing.assert_array_equal(np.sort(ct.child[K - 1 :]), np.arange(n))
        assert ct.child_weight[K - 1 :].sum() == n
        assert ct.parent.min() == n and ct.child[: K - 1].min() > n

    def test_backend_return_w_is_the_pass_without_it(self, rng):
        X, _ = make_blobs(rng, n_per=40)
        be = tops.get_backend("cpu")
        W, res = be.offline_recluster_from_table(X, np.ones(len(X)), np.zeros(len(X)), 6, return_w=True)
        plain = be.offline_recluster_from_table(X, np.ones(len(X)), np.zeros(len(X)), 6)
        np.testing.assert_array_equal(res.labels, plain.labels)
        np.testing.assert_array_equal(np.diag(W), 0.0)
        np.testing.assert_array_equal(W, W.T)
