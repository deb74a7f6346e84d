"""The port's grid (spatial_index=True) against the JAX package's, on the CPU.

The Morton grid (``repro_torch.kernels.grid``) and the plain versions of
its three searches (``repro_torch.kernels.ref.grid_assign``,
``grid_core_distances``, ``grid_round_minima``, which the CPU runs and the
card's kernels are held to) against ``repro.kernels.grid`` and
``repro.core.mst.boruvka_grid_jax``, on the reference suite's table shapes
(tests/test_grid_pruning.py): L = 120 rows padded to Lp = 128, the kinds
``blobs``, ``uniform``, ``dup`` and ``collinear``, d ∈ {2, 8, 16}.

The tables are mean-centred and scaled to unit RMS norm: the two packages
round the expanded distance ‖x‖² + ‖y‖² − 2x·y in different orders, and
its absolute f32 error on a distance r is about ε·max‖x‖²/r (the
reference's own tables, spread over ±10, differ between the packages by
up to 1e-3 relative through that cancellation alone).  Values are held to
1e-5 relative plus 1e-5 plus that allowance, δ(r) = min(√δ(r²),
δ(r²)/2r) with δ(r²) = 16ε·max‖x‖², as in tests/test_torch_cuda.py: it
matters only for the smallest distances.  Tolerances:

* ``build_grid``: ``orig``, ``valid``, tile boxes and ``gdims`` identical;
* assignment indices identical on tie-free queries, distances within
  that tolerance;
* core distances within that tolerance on the kinds without
  duplicate rows, on the rows whose Eq. 6 crossing is clear (the crossing
  row's distance apart from its neighbours' in the walk by more than the
  f32 rounding: on the line of ``collinear`` the left and right neighbours
  of a row are often that close, and rounding then picks the other one as
  the crossing bubble); on ``dup`` two copies of a row are anywhere in
  [0, √(4ε‖x‖²)] apart in f32, so that kind is held at result level;
* partitions equal; MST weight within 1e-5 relative where the two sides
  compute their own f32 distances (the contract of the whole offline pass
  in tests/test_torch_offline.py, plus √(4ε‖x‖²) per edge on ``dup``),
  within 1e-6 between the port's grid and dense Borůvka.

The port's plain grid functions are also held to its own plain dense ones,
and the reference suite's structural properties are checked on the port's
grid: the Morton order is a bijection, a tile's lower bound never exceeds
a member's distance, invalid rows contribute nothing whatever they hold,
and a larger bucket changes nothing.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro.core.mst import boruvka_grid_jax
from repro.kernels import grid as jgrid
from repro.kernels import ops as jops
from repro_torch.core.bubble_flat import BubbleFlat
from repro_torch.core.bubble_tree import BubbleTree
from repro_torch.core.mst import boruvka, boruvka_grid
from repro_torch.kernels import grid as tgrid
from repro_torch.kernels import grid_variants
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

L = 120  # off-bucket: Lp = 128
LP = 128
MIN_PTS = 5
DIMS = [2, 8, 16]
KINDS = ["blobs", "uniform", "dup", "collinear"]
TIE_FREE = ["blobs", "uniform", "collinear"]
RTOL = ATOL = 1e-5


def _dataset(kind, d, seed, n=L):
    """The reference suite's four kinds, mean-centred at unit RMS norm."""
    rng = np.random.default_rng(seed)
    if kind == "blobs":
        centers = rng.normal(0.0, 5.0, (4, d))
        X = centers[rng.integers(0, 4, n)] + rng.normal(0.0, 0.4, (n, d))
    elif kind == "uniform":
        X = rng.uniform(-4.0, 4.0, (n, d))
    elif kind == "dup":
        base = rng.normal(0.0, 3.0, (max(n // 6, 1), d))
        X = base[rng.integers(0, base.shape[0], n)]
    else:  # collinear: rank-1, most grid dims carry no range
        t = rng.uniform(-5.0, 5.0, (n, 1))
        X = t * rng.normal(0.0, 1.0, (1, d)) + rng.normal(0.0, 1.0, (1, d))
    X = X - X.mean(axis=0)
    return (X / np.sqrt((X**2).sum(1).mean())).astype(np.float32)


def _table(kind, d, seed=3, n=L):
    rng = np.random.default_rng(seed + 1000)
    rep = _dataset(kind, d, seed, n)
    n_b = rng.integers(1, 8, n).astype(np.float32)  # integral masses
    extent = np.abs(rng.normal(0.02, 0.005, n)).astype(np.float32)
    return rep, n_b, extent


def _padded(rep, n_b, extent, Lp=LP):
    n, d = rep.shape
    repp = np.full((Lp, d), tops._PAD_COORD, np.float32)
    repp[:n] = rep
    nbp, extp = np.zeros(Lp, np.float32), np.zeros(Lp, np.float32)
    nbp[:n], extp[:n] = n_b, extent
    return repp, nbp, extp, np.arange(Lp) < n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grids(repp, valid):
    return jgrid.build_grid(jnp.asarray(repp), jnp.asarray(valid)), tgrid.build_grid(_t(repp), _t(valid))


def _tie_free_queries(rep, n, seed):
    """Queries whose nearest rep is apart from the second by 1e-3 relative."""
    rng = np.random.default_rng(seed)
    Q = (rng.normal(size=(4 * n, rep.shape[1])) * 0.8).astype(np.float32)
    sq = ((Q.astype(np.float64)[:, None, :] - rep.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(sq, axis=1)[:, :2]
    return np.ascontiguousarray(Q[(two[:, 1] - two[:, 0]) > 1e-3 * two[:, 1]][:n])


def _clear_crossings(rep, n_b, min_pts):
    """Rows whose Eq. 6 crossing is apart from its neighbours in the
    (distance, index) walk by more than 64× the f32 rounding of the
    expanded form, in f64."""
    r = rep.astype(np.float64)
    sq = ((r[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    order = np.argsort(sq, axis=1, kind="stable")
    v = np.take_along_axis(sq, order, 1)
    c = np.argmax(np.cumsum(n_b[order], axis=1) >= min_pts, axis=1)[:, None]
    noise = 64 * np.finfo(np.float32).eps * (2 * (r * r).sum(1).max())
    at = np.take_along_axis(v, c, 1)[:, 0]
    lo = np.take_along_axis(v, np.maximum(c - 1, 0), 1)[:, 0]
    hi = np.take_along_axis(v, np.minimum(c + 1, v.shape[1] - 1), 1)[:, 0]
    return ((at - lo > noise) | (c[:, 0] == 0)) & (hi - at > noise)


def _allowance(rep, r):
    """ATOL plus δ(r) for distances r between rows of norm up to max‖rep‖."""
    dsq = 16 * np.finfo(np.float32).eps * float((rep.astype(np.float64) ** 2).sum(1).max())
    return ATOL + np.minimum(np.sqrt(dsq), dsq / (2 * np.maximum(r, 1e-30)))


def _dup_floor(rep):
    return float(np.sqrt(4 * np.finfo(np.float32).eps * (rep.astype(np.float64) ** 2).sum(1).max()))


def _mst_weight(ew, valid):
    return float(np.asarray(ew, np.float64)[np.asarray(valid)].sum())


class TestBuildGrid:
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_matches_reference(self, kind, d):
        repp, _, _, valid = _padded(*_table(kind, d))
        gj, gt = _grids(repp, valid)
        np.testing.assert_array_equal(gt.orig.numpy(), np.asarray(gj.orig))
        np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
        np.testing.assert_array_equal(gt.tile_lo.numpy(), np.asarray(gj.tile_lo))
        np.testing.assert_array_equal(gt.tile_hi.numpy(), np.asarray(gj.tile_hi))
        np.testing.assert_array_equal(gt.gdims.numpy(), np.asarray(gj.gdims))
        np.testing.assert_array_equal(gt.pts.numpy(), np.asarray(gj.pts))
        assert int(gt.n_valid) == L and gt.tile == 32


class TestWrappers:
    @pytest.mark.parametrize("case", ["assign_width", "cd_rows", "round_rows", "views_dtype", "tile_rows",
                                      "round_rows_v1", "views_dtype_v1", "round_cluster", "assign_width_v1",
                                      "assign_cluster", "cd_cluster"])
    def test_bad_shapes_raise(self, case):
        """The assign and round cases for both wrappers of each:
        ``grid_assign`` / ``grid_round_minima`` and their first kernels',
        ``grid_assign_v1`` / ``grid_round_minima_v1`` (the ``_v1`` cases); a
        cluster size the kernels are not built for."""
        repp, nbp, extp, valid = _padded(*_table("blobs", 8))
        g = tgrid.build_grid(_t(repp), _t(valid))
        views = tgrid._block_views(g)
        z = torch.zeros(LP)
        round_fn = tgrid.grid_round_minima_v1 if case.endswith("_v1") else tgrid.grid_round_minima
        assign_fn = tgrid.grid_assign_v1 if case.endswith("_v1") else tgrid.grid_assign
        with pytest.raises(ValueError):
            if case.startswith("assign_width"):
                assign_fn(g, torch.zeros(4, 3))
            elif case == "assign_cluster":
                tgrid.grid_assign(g, torch.zeros(4, 8), cluster=3)
            elif case == "cd_cluster":
                tgrid.grid_core_distances(g, _t(nbp), _t(extp), MIN_PTS, 8, views, cluster=3)
            elif case == "cd_rows":
                tgrid.grid_core_distances(g, _t(nbp[:-1]), _t(extp), MIN_PTS, 8)
            elif case.startswith("round_rows"):
                round_fn(g, views, z[:-1], torch.arange(LP), z.bool())
            elif case.startswith("views_dtype"):
                bad = tgrid.GridViews(order=views.order.long(), lbs=views.lbs, block=views.block)
                round_fn(g, bad, z, torch.arange(LP), z.bool())
            elif case == "round_cluster":
                tgrid.grid_round_minima(g, views, z, torch.arange(LP), z.bool(), cluster=3)
            else:
                tgrid.build_grid(torch.zeros(100, 2), torch.ones(100, dtype=torch.bool))

    def test_round_wrappers_first_round(self):
        """Borůvka's first round (every row its own label, none hopeless) on
        the ``blobs`` table at d = 8: both round wrappers take the plain
        version on the CPU, bit for bit; against the JAX package's
        ``_grid_round_minima`` fed the same core distances, each row's w
        within the distance tolerance and its edge id equal."""
        from repro.core.mst import _grid_round_minima

        rep, nb, ext = _table("blobs", 8)
        repp, nbp, extp, valid = _padded(rep, nb, ext)
        gj, gt = _grids(repp, valid)
        views = tgrid._block_views(gt)
        cd = tgrid.grid_core_distances(gt, _t(nbp), _t(extp), MIN_PTS, 8, views)
        labels, hopeless = torch.arange(LP), torch.zeros(LP, dtype=torch.bool)
        want = tref.grid_round_minima(gt, views, cd, labels, hopeless)
        for fn in (tgrid.grid_round_minima, tgrid.grid_round_minima_v1):
            got = fn(gt, views, cd, labels, hopeless)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), fn.__name__
        NT = gt.tile_lo.shape[0]
        bws, bes = _grid_round_minima(gj, jnp.asarray(cd.numpy()), jnp.arange(LP, dtype=jnp.int32),
                                      jnp.zeros(LP, dtype=bool), jgrid._block_views(gj, 64), NT, LP // NT, LP, 64)
        jw, je = np.empty(LP, np.float32), np.empty(LP, np.int32)
        jw[np.asarray(gj.orig)], je[np.asarray(gj.orig)] = np.asarray(bws).reshape(-1), np.asarray(bes).reshape(-1)
        tw, te = want[0].numpy(), want[1].numpy()
        assert np.isfinite(tw[:L]).all() and np.isinf(tw[L:]).all() and np.isinf(jw[L:]).all()
        np.testing.assert_array_less(np.abs(tw[:L] - jw[:L]), RTOL * jw[:L] + _allowance(rep, jw[:L]))
        np.testing.assert_array_equal(te, je)

    @pytest.mark.parametrize("B", [1, 63, 65, 130])
    def test_assign_wrappers(self, B):
        """Both assign wrappers (``grid_assign``, on the card
        ``csrc/grid_assign.cu``, and ``grid_assign_v1``, its first kernel in
        ``csrc/grid.cu``) take the plain version on the CPU: bit for bit
        ``ref.grid_assign`` over the Morton-sorted queries and their visit
        lists, idx and dist, on the ``blobs`` table at d = 8 with a ragged
        query count (blocks of 64), at every cluster size."""
        rep, nb, ext = _table("blobs", 8)
        repp, _, _, valid = _padded(rep, nb, ext)
        g = tgrid.build_grid(_t(repp), _t(valid))
        Q = _t((np.random.default_rng(B).normal(size=(B, 8)) * 0.8).astype(np.float32))
        xs, qperm, views = tgrid._query_views(g, Q)
        pidx, psq = tref.grid_assign(g, xs, views)
        want_idx, want_dist = torch.empty_like(pidx), torch.empty_like(psq)
        want_idx[qperm], want_dist[qperm] = pidx, torch.sqrt(psq)
        assert bool((want_idx < L).all()) and bool(valid[want_idx.long()].all())
        got = [tgrid.grid_assign_v1(g, Q)] + [tgrid.grid_assign(g, Q, cluster=c) for c in tgrid.CLUSTERS]
        for idx, dist in got:
            assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)

    def test_assign_wrappers_no_valid_row(self):
        """A table with no valid row: every query gets ``Lp`` and +inf from
        both wrappers (every tile's bound is +inf, nothing is visited)."""
        repp, _, _, valid = _padded(*_table("blobs", 8))
        g = tgrid.build_grid(_t(repp), _t(np.zeros_like(valid)))
        Q = _t(_dataset("blobs", 8, 9, n=70))
        for idx, dist in (tgrid.grid_assign(g, Q), tgrid.grid_assign_v1(g, Q)):
            assert bool((idx == LP).all()) and bool(torch.isinf(dist).all())

    @pytest.mark.parametrize("k", [16, 17, 1030])
    def test_core_distances_wrappers(self, k):
        """Both Eq. 6 wrappers (``grid_core_distances``, on the card
        ``csrc/grid_cd.cu``, at every cluster size, and
        ``grid_core_distances_v1``, its first kernel in ``csrc/grid.cu``) take
        the plain version on the CPU: bit for bit ``ref.grid_core_distances``,
        whole and over block ranges, at min_pts on both sides of the new
        kernel's register route (k <= 16) and past the warp-select queue's
        1024 (a 1088-row table, 1060 valid, unit masses: a second round of
        selection; block ranges only, the plain top-k at k = 1030 being
        slow)."""
        if k <= 17:
            rep, nb, ext = _table("blobs", 8)
            repp, nbp, extp, valid = _padded(rep, nb, ext)
            ranges = [None, (0, 1), (1, 2), (0, 2)]
        else:
            rng = np.random.default_rng(7)
            rep = _dataset("uniform", 2, 7, n=1060)
            repp, nbp, extp, valid = _padded(rep, np.ones(1060, np.float32),
                                             rng.uniform(0.05, 0.5, 1060).astype(np.float32), Lp=1088)
            ranges = [(0, 1), (16, 17)]
        g = tgrid.build_grid(_t(repp), _t(valid))
        views = tgrid._block_views(g)
        d = repp.shape[1]
        for blocks in ranges:
            want = tref.grid_core_distances(g, views, _t(nbp), _t(extp), k, d, blocks=blocks)
            got = [tgrid.grid_core_distances_v1(g, _t(nbp), _t(extp), k, d, views, blocks=blocks)]
            got += [tgrid.grid_core_distances(g, _t(nbp), _t(extp), k, d, views, blocks=blocks, cluster=c)
                    for c in tgrid.CLUSTERS]
            assert bool(torch.isfinite(want).all()) and bool((want > 0).any())
            for c, out in zip(("v1",) + tgrid.CLUSTERS, got):
                assert torch.equal(out, want), (blocks, c)

    @pytest.mark.parametrize("name", list(grid_variants.CD_VARIANTS))
    def test_cd_variant_patches_apply(self, name):
        """Every text patch of the Eq. 6 kernel's variants in ``python -m
        repro_torch.kernels.grid_variants cd`` matches the shipped
        ``csrc/grid_cd.cu`` exactly once."""
        src = (Path(tgrid.__file__).with_name("csrc") / "grid_cd.cu").read_text()
        out = grid_variants._apply(name, src, grid_variants.CD_VARIANTS[name])
        assert (out == src) == (not grid_variants.CD_VARIANTS[name])

    @pytest.mark.parametrize("name", list(grid_variants.ASSIGN_VARIANTS))
    def test_assign_variant_patches_apply(self, name):
        """Every text patch of the assign kernel's variants in ``python -m
        repro_torch.kernels.grid_variants`` matches the shipped
        ``csrc/grid_assign.cu`` exactly once."""
        src = (Path(tgrid.__file__).with_name("csrc") / "grid_assign.cu").read_text()
        out = grid_variants._apply(name, src, grid_variants.ASSIGN_VARIANTS[name])
        assert (out == src) == (not grid_variants.ASSIGN_VARIANTS[name])

    @pytest.mark.parametrize("name", list(grid_variants.VARIANTS))
    def test_variant_patches_apply(self, name):
        """Every text patch of ``python -m repro_torch.kernels.grid_variants``
        matches the shipped ``csrc/grid_round.cu`` exactly once."""
        src = (Path(tgrid.__file__).with_name("csrc") / "grid_round.cu").read_text()
        out = grid_variants._apply(name, src, grid_variants.VARIANTS[name])
        assert (out == src) == (not grid_variants.VARIANTS[name])


class TestAgainstReference:
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("kind", TIE_FREE)
    def test_assign(self, kind, d):
        rep, _, _ = _table(kind, d)
        repp, _, _, valid = _padded(rep, *_table(kind, d)[1:])
        gj, gt = _grids(repp, valid)
        Q = _tie_free_queries(rep, 64, 5)
        ji, jm = jgrid.grid_assign(gj, jnp.asarray(Q))
        ti, td = tgrid.grid_assign(gt, _t(Q))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        jd = np.sqrt(np.maximum((Q.astype(np.float32) ** 2).sum(1) + np.asarray(jm), 0.0))
        np.testing.assert_array_less(np.abs(td.numpy() - jd), RTOL * jd + _allowance(np.vstack([rep, Q]), jd))

    @pytest.mark.parametrize("min_pts", [MIN_PTS, 16, 17])
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("kind", TIE_FREE)
    def test_core_distances(self, kind, d, min_pts):
        """Also at min_pts 16 and 17, the edge of the card kernel's register
        route (``csrc/grid_cd.cu``)."""
        rep, n_b, extent = _table(kind, d)
        repp, nbp, extp, valid = _padded(rep, n_b, extent)
        gj, gt = _grids(repp, valid)
        want = np.asarray(jgrid.grid_core_distances(gj, jnp.asarray(nbp), jnp.asarray(extp), min_pts, d))
        got = tgrid.grid_core_distances(gt, _t(nbp), _t(extp), min_pts, d).numpy()
        keep = _clear_crossings(rep, n_b, min_pts)
        assert keep.sum() > L // 2
        w = want[:L][keep]
        np.testing.assert_array_less(np.abs(got[:L][keep] - w), RTOL * w + _allowance(rep, w))
        assert (got[L:] == 0).all()

    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_boruvka(self, kind, d):
        """The same core distances into both Borůvkas: L − 1 edges, MST
        weight within 1e-5 relative (plus the duplicate floor per edge)."""
        rep, nb, ext = _table(kind, d)
        repp, nbp, extp, valid = _padded(rep, nb, ext)
        gj, gt = _grids(repp, valid)
        cd = tgrid.grid_core_distances(gt, _t(nbp), _t(extp), MIN_PTS, d)
        ju, jv, jw, jva = (np.asarray(a) for a in boruvka_grid_jax(gj, jnp.asarray(cd.numpy())))
        tu, tv, tw, tva = (a.numpy() for a in boruvka_grid(gt, cd))
        assert tva.sum() == jva.sum() == L - 1
        floor = _dup_floor(rep) * (L - 1) if kind == "dup" else 0.0
        np.testing.assert_allclose(_mst_weight(tw, tva), _mst_weight(jw, jva), rtol=1e-5, atol=floor)

    @pytest.mark.parametrize("kind", KINDS)
    def test_offline_pass(self, kind):
        """The whole spatial pass from the table: partition equal, MST
        weight within 1e-5 relative (plus the duplicate floor per edge)."""
        rep, n_b, extent = _table(kind, 8)
        want = jops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, use_ref=True, spatial_index=True)
        got = tops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device="cpu", spatial_index=True)
        assert_same_partition(got.labels, want.labels)
        floor = _dup_floor(rep) * (L - 1) if kind == "dup" else 0.0
        np.testing.assert_allclose(got.mst[2].sum(), want.mst[2].sum(), rtol=1e-5, atol=floor)
        assert got.n_clusters == want.n_clusters

    def test_assign_with_dead_rows(self):
        """``ops.assign(..., spatial_index=True, valid=...)``: a masked row
        is never picked, as in the reference."""
        rep, _, _ = _table("blobs", 8)
        live = np.random.default_rng(2).random(L) < 0.6
        Q = _tie_free_queries(rep[live], 64, 6)
        want = np.asarray(jops.assign(Q, rep, spatial_index=True, valid=jnp.asarray(live)))
        got = tops.assign(_t(Q), _t(rep), spatial_index=True, valid=_t(live)).numpy()
        np.testing.assert_array_equal(got, want)
        assert live[got].all()


class TestAgainstDensePlain:
    """The port's plain grid functions against its plain dense ones."""

    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("kind", TIE_FREE)
    def test_assign_and_core_distances(self, kind, d):
        rep, n_b, extent = _table(kind, d)
        repp, nbp, extp, valid = _padded(rep, n_b, extent)
        gt = tgrid.build_grid(_t(repp), _t(valid))
        Q = _tie_free_queries(rep, 64, 7)
        gi, gd = tgrid.grid_assign(gt, _t(Q))
        di, dd = tref.assign_with_dist(_t(Q), _t(rep))
        np.testing.assert_array_equal(gi.numpy(), di.numpy())
        np.testing.assert_allclose(gd.numpy(), dd.numpy(), rtol=RTOL, atol=ATOL)
        gcd = tgrid.grid_core_distances(gt, _t(nbp), _t(extp), MIN_PTS, d)[:L]
        dcd = tref.bubble_core_distances(_t(rep), _t(n_b), _t(extent), MIN_PTS, d)
        np.testing.assert_allclose(gcd.numpy(), dcd.numpy(), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("kind", KINDS)
    def test_boruvka(self, kind):
        repp, nbp, extp, valid = _padded(*_table(kind, 16))
        gt = tgrid.build_grid(_t(repp), _t(valid))
        cd = tgrid.grid_core_distances(gt, _t(nbp), _t(extp), MIN_PTS, 16)
        gu, gv, gw, gva = boruvka_grid(gt, cd)
        W = tref.mutual_reachability(_t(repp), _t(repp), cd, cd, zero_diag=True, n_valid=L)
        du, dv, dw, dva = boruvka(W)
        assert int(gva.sum()) == int(dva.sum()) == L - 1
        np.testing.assert_allclose(_mst_weight(gw, gva), _mst_weight(dw, dva), rtol=1e-6)


class TestGridProperties:
    @pytest.mark.parametrize("frac_invalid", [0.0, 0.2, 0.6])
    @pytest.mark.parametrize("d", [2, 8])
    def test_every_rep_in_exactly_one_tile(self, d, frac_invalid):
        rng = np.random.default_rng(11)
        pts = rng.normal(0, 1, (LP, d)).astype(np.float32)
        valid = rng.random(LP) >= frac_invalid
        g = tgrid.build_grid(_t(pts), _t(valid))
        orig = g.orig.numpy()
        assert np.array_equal(np.sort(orig), np.arange(LP))
        np.testing.assert_array_equal(g.pts.numpy(), pts[orig])
        assert int(g.valid.sum()) == valid.sum() and g.valid.numpy()[: valid.sum()].all()
        T = g.tile
        p3, v3 = g.pts.numpy().reshape(-1, T, d), g.valid.numpy().reshape(-1, T)
        for t in range(p3.shape[0]):
            if v3[t].any():
                assert (p3[t][v3[t]] >= g.tile_lo.numpy()[t]).all()
                assert (p3[t][v3[t]] <= g.tile_hi.numpy()[t]).all()
            else:
                assert np.isinf(g.tile_lo.numpy()[t]).all()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("d", [2, 8])
    def test_tile_lower_bounds_never_exceed_member_distances(self, seed, d):
        rng = np.random.default_rng(seed)
        pts = rng.normal(0, 1, (LP, d)).astype(np.float32)
        g = tgrid.build_grid(_t(pts), _t(rng.random(LP) >= 0.2))
        views = tgrid._block_views(g, 32)
        ps, vs = g.pts.double().numpy(), g.valid.numpy()
        T, bn = g.tile, views.block
        order, lbs = views.order.numpy(), views.lbs.numpy()
        for b in range(order.shape[0]):
            brows = ps[b * bn : (b + 1) * bn][vs[b * bn : (b + 1) * bn]]
            if brows.shape[0] == 0:
                assert np.isinf(lbs[b]).all()
                continue
            assert (np.diff(lbs[b]) >= 0).all()
            for r, t in enumerate(order[b]):
                trows = ps[t * T : (t + 1) * T][vs[t * T : (t + 1) * T]]
                if trows.shape[0] == 0:
                    assert np.isinf(lbs[b, r])
                    continue
                true_min = np.sqrt(((brows[:, None, :] - trows[None, :, :]) ** 2).sum(-1)).min()
                assert lbs[b, r] <= true_min

    @pytest.mark.parametrize("frac_invalid", [0.3, 0.7])
    def test_invalid_rows_contribute_nothing(self, frac_invalid):
        d = 8
        rng = np.random.default_rng(4)
        pts = rng.normal(0, 1, (LP, d)).astype(np.float32)
        valid = rng.random(LP) >= frac_invalid
        x = _t(rng.normal(0, 1, (40, d)).astype(np.float32))
        n_b = _t(np.where(valid, rng.integers(1, 6, LP), 0).astype(np.float32))
        extent = _t(np.abs(rng.normal(0.02, 0.005, LP)).astype(np.float32))
        mp = min(MIN_PTS, int(n_b.sum()))
        pts2 = pts.copy()
        pts2[~valid] = rng.normal(3e5, 1e5, (int((~valid).sum()), d)).astype(np.float32)
        outs = []
        for p in (pts, pts2):
            g = tgrid.build_grid(_t(p), _t(valid))
            idx, dist = tgrid.grid_assign(g, x)
            cd = tgrid.grid_core_distances(g, n_b, extent, mp, d)
            _, _, ew, ok = boruvka_grid(g, cd)
            outs.append((idx, dist, cd[_t(valid)], ew[ok]))
        assert valid[outs[0][0].numpy()].all(), "an assignment landed on an invalid row"
        for a, b in zip(*outs):
            assert torch.equal(a, b)

    def test_bucket_padding_changes_nothing(self):
        rep, n_b, extent = _table("blobs", 8)
        Q = _t(_tie_free_queries(rep, 64, 8))
        outs = []
        for Lp in (LP, 2 * LP):
            repp, nbp, extp, valid = _padded(rep, n_b, extent, Lp)
            g = tgrid.build_grid(_t(repp), _t(valid))
            cd = tgrid.grid_core_distances(g, _t(nbp), _t(extp), MIN_PTS, 8)
            idx, dist = tgrid.grid_assign(g, Q)
            _, _, ew, ok = boruvka_grid(g, cd)
            outs.append((cd[:L], idx, dist, ew[ok].sort().values))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


class TestSpatialFlat:
    def test_dead_slots_are_never_candidates(self):
        """The flat table's spatial assign takes the live slots as its valid
        rows: a block far outside the centred frame lands on a live slot
        instead of tripping the dense path's dead-slot guard."""
        rng = np.random.default_rng(5)
        X = rng.normal(size=(400, 3))
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X)
        far = X[:16] + 5e6
        flats = []
        for spatial in (False, True):
            flat = BubbleFlat(3, device="cpu", spatial_index=spatial)
            flat.load(tree)
            flats.append(flat)
        with pytest.raises(Exception, match="dead slot"):
            flats[0].insert_block(far, cap=1e9)
        leaf_ids, _ = flats[1].insert_block(far, cap=1e9)
        assert (leaf_ids >= 0).all()
        assert all(tree.node_alive[leaf] and tree.is_leaf[leaf] for leaf in leaf_ids)
