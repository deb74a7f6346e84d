"""The port's kernels against the JAX package's, on the CPU.

Each plain PyTorch version (``repro_torch.kernels.ref``, which is what a
CPU tensor runs through the kernel wrappers) is held against the JAX
package's jnp oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode (``repro.kernels.ops`` with ``use_ref=False``), on the same
numpy inputs from a seed: mean-centred tables, d ∈ {2, 8, 16} plus a
non-power-of-two d, and an L that is not a multiple of 8.

Tolerances: assignment indices identical on tie-free centred data, and
on duplicate-row ties identical to the Pallas kernel (the port follows
its clamped ‖x‖²+‖r‖²−2x·r form); distances, Eq. 6 core distances and
W within 1e-5 relative, with W's diagonal exactly 0.  The data is
unit-scale and centred: the f32 expansion's absolute error on a distance
r is about ε·max‖x‖²/r, a few 1e-6 here, which ``ATOL`` covers — the
two sides sum in different orders.

The hand-written CUDA kernels run only on a card: tests/test_torch_cuda.py
holds each against its plain version there.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import assign as t_assign
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import mutual_reach as t_mr
from repro_torch.kernels import ops as tops

DIMS = [2, 8, 16, 5]
WIDE_DIMS = [129, 200]  # past the warp-select core's d <= 128
L_ROWS = 37  # not a multiple of 8 (nor of any kernel chunk)
RTOL = 1e-5
ATOL = 1e-5  # f32 cancellation bound at unit scale (see above)


def _centred(rng, n, d, scale=1.0):
    X = rng.normal(size=(n, d)) * scale
    return (X - X.mean(axis=0)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tie_free_queries(rng, reps, n, d):
    """Queries whose best and second-best squared distances differ by
    more than 1e-3 relative (no near-ties for f32 rounding to flip)."""
    Q = _centred(rng, 4 * n, d)
    Q64, R64 = Q.astype(np.float64), reps.astype(np.float64)
    sq = (Q64**2).sum(1)[:, None] + (R64**2).sum(1)[None, :] - 2.0 * Q64 @ R64.T
    two = np.sort(sq, axis=1)[:, :2]
    keep = (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 1]
    return np.ascontiguousarray(Q[keep][:n])


class TestAssign:
    @pytest.mark.parametrize("d", DIMS)
    def test_indices_match_reference_and_pallas(self, rng, d):
        R = _centred(rng, L_ROWS, d)
        Q = _tie_free_queries(rng, R, 29, d)
        got = t_assign.assign(_t(Q), _t(R)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jref.assign(Q, R)))
        np.testing.assert_array_equal(got, np.asarray(jops.assign(Q, R, use_ref=False)))

    @pytest.mark.parametrize("d", DIMS)
    def test_distance_matches_pallas(self, rng, d):
        R = _centred(rng, L_ROWS, d)
        Q = _tie_free_queries(rng, R, 29, d)
        idx, dist = t_assign.assign(_t(Q), _t(R), with_dist=True)
        pidx, pdist = jops.assign(Q, R, use_ref=False, with_dist=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(pdist), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", DIMS)
    def test_duplicate_rows_tie_like_pallas(self, rng, d):
        """Each site repeated at several rows: the lowest row of the
        nearest site wins, as in the Pallas kernel, for queries on and
        off the table."""
        sites = _centred(rng, 6, d)
        R = np.ascontiguousarray(sites[rng.integers(0, 6, size=L_ROWS)])
        Q = np.concatenate([R, _centred(rng, 20, d)]).astype(np.float32)
        got = t_assign.assign(_t(Q), _t(R)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jops.assign(Q, R, use_ref=False)))
        first = {tuple(r): i for i, r in reversed(list(enumerate(R.tolist())))}
        on_table = got[:L_ROWS]
        np.testing.assert_array_equal(on_table, [first[tuple(r)] for r in R.tolist()])

    def test_rejects_bad_input(self):
        with pytest.raises(TypeError):
            t_assign.assign(torch.zeros(3, 2, dtype=torch.float64), torch.zeros(4, 2))
        with pytest.raises(ValueError):
            t_assign.assign(torch.zeros(3, 2), torch.zeros(4, 3))
        with pytest.raises(ValueError):
            t_assign.assign(torch.zeros(3, 2), torch.zeros(0, 2))


def _bubble_table(rng, L, d):
    rep = _centred(rng, L, d)
    n_b = rng.integers(1, 6, size=L).astype(np.float32)
    extent = rng.uniform(0.05, 0.5, size=L).astype(np.float32)
    return rep, n_b, extent


class TestBubbleCoreDistances:
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("min_pts", [1, 4, 10])
    def test_matches_reference_and_pallas(self, rng, d, min_pts):
        rep, n_b, extent = _bubble_table(rng, L_ROWS, d)
        got = tops.bubble_core_distances(_t(rep), _t(n_b), _t(extent), min_pts).numpy()
        want = np.asarray(jref.bubble_core_distances(rep, n_b, extent, min_pts, d))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        pallas = np.asarray(jops.bubble_core_distances(rep, n_b, extent, min_pts, use_ref=False))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", [2, 16])
    def test_min_pts_clamped_to_mass(self, rng, d):
        """min_pts above the represented mass clamps to it, as in the
        reference's ops wrapper."""
        rep, n_b, extent = _bubble_table(rng, 5, d)
        got = tops.bubble_core_distances(_t(rep), _t(n_b), _t(extent), 1000).numpy()
        pallas = np.asarray(jops.bubble_core_distances(rep, n_b, extent, 1000, use_ref=False))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        assert np.isfinite(got).all() and (got < 1e3).all()

    @pytest.mark.parametrize("min_pts", [65, 100])
    @pytest.mark.parametrize("L", [30, 160])
    def test_large_min_pts(self, rng, min_pts, L):
        """min_pts past the former kernel bound of 64, with masses >= 1:
        the 30-row table's mass lies between 65 and 100, so min_pts = 100
        reaches the ops clamp there; the 160-row table never does."""
        rep, n_b, extent = _bubble_table(rng, L, 8)
        assert (n_b.sum() < min_pts) == (L == 30 and min_pts == 100)
        got = tops.bubble_core_distances(_t(rep), _t(n_b), _t(extent), min_pts).numpy()
        want = np.asarray(jref.bubble_core_distances(rep, n_b, extent, min(min_pts, int(n_b.sum())), 8))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        pallas = np.asarray(jops.bubble_core_distances(rep, n_b, extent, min_pts, use_ref=False))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)

    def test_min_pts_clamp_reached(self, rng):
        """A table lighter than min_pts = 100: both sides clamp to its
        mass, and every row's walk ends at the whole table."""
        rep, n_b, extent = _bubble_table(rng, 20, 8)
        assert n_b.sum() < 100
        got = tops.bubble_core_distances(_t(rep), _t(n_b), _t(extent), 100).numpy()
        pallas = np.asarray(jops.bubble_core_distances(rep, n_b, extent, 100, use_ref=False))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        assert np.isfinite(got).all()

    def test_min_pts_bound(self):
        rep = torch.zeros(8, 2)
        with pytest.raises(ValueError):
            t_bcd.bubble_core_distances(rep, torch.ones(8), torch.zeros(8), min_pts=0, dim=2)


class TestWideRows:
    """d past 128 (on the card: the assign kernel's feature slices, the
    strip route of Eq. 6, the sliced tile kernel): each bubble-level op
    against the JAX package's Pallas kernels in interpret mode (d padded
    to 256 there) and its jnp oracles."""

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_assign(self, rng, d):
        R = _centred(rng, L_ROWS, d)
        Q = _tie_free_queries(rng, R, 29, d)
        got = t_assign.assign(_t(Q), _t(R)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jref.assign(Q, R)))
        np.testing.assert_array_equal(got, np.asarray(jops.assign(Q, R, use_ref=False)))
        idx, dist = t_assign.assign(_t(Q), _t(R), with_dist=True)
        pidx, pdist = jops.assign(Q, R, use_ref=False, with_dist=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(pdist), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_bubble_core_distances(self, rng, d):
        rep, n_b, extent = _bubble_table(rng, L_ROWS, d)
        got = tops.bubble_core_distances(_t(rep), _t(n_b), _t(extent), 6).numpy()
        want = np.asarray(jref.bubble_core_distances(rep, n_b, extent, 6, d))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        pallas = np.asarray(jops.bubble_core_distances(rep, n_b, extent, 6, use_ref=False))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("d", WIDE_DIMS)
    def test_bubble_mutual_reachability(self, rng, d):
        rep, n_b, extent = _bubble_table(rng, L_ROWS, d)
        got = tops.bubble_mutual_reachability(_t(rep), _t(n_b), _t(extent), 6).numpy()
        want = np.asarray(jops.bubble_mutual_reachability(rep, n_b, extent, 6, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert (np.diag(got) == 0.0).all()


class TestMutualReach:
    @pytest.mark.parametrize("d", DIMS)
    def test_matches_reference_and_pallas(self, rng, d):
        X = _centred(rng, L_ROWS, d)
        cd = rng.uniform(0.1, 1.0, size=L_ROWS).astype(np.float32)
        got = t_mr.mutual_reachability(_t(X), _t(X), _t(cd), _t(cd)).numpy()
        want = np.asarray(jref.mutual_reachability(X, X, cd, cd))
        pallas = np.asarray(jops.mutual_reachability(X, X, cd, cd, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        assert (np.diag(got) == 0.0).all()

    @pytest.mark.parametrize("d", [2, 16])
    def test_bubble_matrix_matches_reference(self, rng, d):
        rep, n_b, extent = _bubble_table(rng, L_ROWS, d)
        got = tops.bubble_mutual_reachability(_t(rep), _t(n_b), _t(extent), 6).numpy()
        want = np.asarray(jops.bubble_mutual_reachability(rep, n_b, extent, 6, use_ref=False))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, got.T)

    def test_pad_mask(self, rng):
        """Rows and columns at or past n_valid come out +inf, the
        diagonal inside stays 0 — the offline pass's pad contract."""
        X = _centred(rng, 16, 3)
        cd = np.zeros(16, np.float32)
        W = t_mr.mutual_reachability(_t(X), _t(X), _t(cd), _t(cd), n_valid=11).numpy()
        assert np.isinf(W[11:]).all() and np.isinf(W[:, 11:]).all()
        assert (np.diag(W)[:11] == 0.0).all() and np.isfinite(W[:11, :11]).all()
