"""The hand-written CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip on a machine without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
The warp-select knn and bubble_cd kernels are also held bit for bit
(``torch.equal``) against the per-lane kernels they replaced
(``knn_lane``, ``bubble_cd_lane``, k and min_pts <= 64), which compute
the same distances in the same (d, j) order; so is the assign kernel
against ``assign_lane`` (d <= 128), the distance panel of pairwise and
mutual_reach against the tile kernels it replaced (``pairwise_tile``,
``mutual_reach_tile``) at any d, and the strip routes of knn and
bubble_cd against the warp-select kernels at their bounds (k = min_pts =
1024, d = 128).  A d = 300 table whose features from 128 on are zero gives
results ``torch.equal`` to the same table cut to d = 128 in every distance
kernel: the feature slices keep one ascending FMA chain.  The grid's
three kernels (``csrc/grid.cu``) are held bit for bit to their dense
counterparts on the valid rows: ``grid_assign`` to assign,
``grid_core_distances`` to bubble_cd on either route, ``boruvka_grid`` to
dense Borůvka on the panel's W of the same core distances.  The sharded
offline pass's strip launches (``-k Mesh``: bubble_cd over row ranges on
both routes, the panel with a global ``row0``, the grid kernels over
block ranges) are held bit for bit to the same rows of the whole launch,
and the pass on ``("cuda:0",) * k`` to the unsharded pass.  The redesigned
assign and round kernels (``csrc/grid_assign.cu``, ``csrc/grid_round.cu``)
are held bit for bit to their first kernels in ``csrc/grid.cu``
(``grid_assign_v1``, ``grid_round_minima_v1``) at every cluster size, and
so is the redesigned Eq. 6 kernel (``csrc/grid_cd.cu``) to
``grid_core_distances_v1``.
Tolerances: indices identical on tie-free centred data; values within
1e-5 relative plus the f32 cancellation allowance of the expanded
distance form, which the kernel and the plain version round in different
orders: δ(r²) = 8ε(max‖x‖² + max‖y‖²) on a squared distance, hence
δ(r) = min(√δ(r²), δ(r²)/2r) on a distance r — large only for the
near-zero distances of queries that sit on a representative.  Attention:
f32 within rtol 1e-4 / atol 2e-4, bf16 within atol 3e-2 (as in
tests/test_flash_attention.py); the CUDA-core route's kernel
(``csrc/flash_attention_panel.cu``) also within the same limits of the
earlier kernel it replaced (``flash_attention_scalar``); the tensor-core
route's cases and the CUDA-core route's bf16 cases are held to
chip_smoke.py's relative bf16 readings instead: per element
|o − want| / (2e-3 + 1e-2·|want|) ≤ 1 and per row ‖o − want‖ / ‖want‖
≤ 1e-2, since one bf16 rounding of the output is at most 2^-8 relative
and P's rounding to bf16 before PV adds about as much again.
"""

import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro_torch.kernels import assign as t_assign
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import knn as t_knn
from repro_torch.kernels import mutual_reach as t_mr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise as t_pw
from repro_torch.kernels import ref as tref

RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _centred(rng, n, d):
    X = rng.normal(size=(n, d))
    return (X - X.mean(axis=0)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tie_free_queries(rng, reps, n, d):
    Q = _centred(rng, 4 * n, d)
    Q64, R64 = Q.astype(np.float64), reps.astype(np.float64)
    sq = (Q64**2).sum(1)[:, None] + (R64**2).sum(1)[None, :] - 2.0 * Q64 @ R64.T
    two = np.sort(sq, axis=1)[:, :2]
    keep = (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 1]
    return np.ascontiguousarray(Q[keep][:n])


def _bubble_table(rng, L, d):
    rep = _centred(rng, L, d)
    n_b = rng.integers(1, 6, size=L).astype(np.float32)
    extent = rng.uniform(0.05, 0.5, size=L).astype(np.float32)
    return rep, n_b, extent


def _dist_allowance(x, y, r):
    """δ(r) for distances r between rows of x and y (see the docstring)."""
    dsq = 8 * EPS32 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    return torch.minimum(torch.full_like(r, dsq**0.5), dsq / (2 * r.clamp_min(1e-30)))


def _tf32_probe(rng, n, m, d=4, width=None):
    """x with full 24-bit mantissas against rows c·e_j, c a multiple of
    1/8 (exact in TF32): x·y is c·x_j to within f32 rounding, and off by
    up to 2^-11 relative where the product runs in TF32 (x_j loses its low
    13 bits).  With ``width``, the d probe features are the last d of
    ``width`` (the rest zero): past 128, in the kernels' second feature
    slice.  Returns f32 x, y and the f64 squared distances."""
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    c = rng.choice([-7, -5, -3, -1, 1, 3, 5, 7], size=(m, 1)) / 8.0
    y = (c * np.eye(d)[rng.integers(0, d, size=m)]).astype(np.float32)
    sq = ((x.astype(np.float64)[:, None, :] - y.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    if width is not None:
        x, y = (np.pad(a, ((0, 0), (width - d, 0))) for a in (x, y))
    return x, y, sq


def _isolated_entries(x, y, k):
    """(n, k) mask of the knn entries whose squared distance is apart from
    both neighbours in the sorted row by more than 64× the f32 rounding of
    the expanded form: no rounding can move such an entry's index."""
    sq = tref.pairwise_sqdist(x, y)
    top = torch.sort(sq, dim=1).values[:, : k + 1]
    noise = 64 * EPS32 * ((x * x).sum(1) + float((y * y).sum(1).max()))
    gap = (top[:, 1:] - top[:, :-1]) > noise[:, None]  # gap[:, t]: between entries t and t + 1
    before = torch.cat([torch.ones_like(gap[:, :1]), gap[:, : k - 1]], dim=1)
    return before & gap


def _knn_table(case, rng):
    """(x, y) for the bitwise cases: random centred rows at d in {2, 16,
    17, 128} (m = 1001 is a multiple of no ring chunk, n = 700 of no
    block of rows), the all-zeros table, and a table of copies of 40 sites."""
    if case == "zeros":
        z = np.zeros((300, 3), np.float32)
        return z, z
    if case == "duplicates":
        X = _centred(rng, 40, 8)[rng.integers(0, 40, size=2000)]
        return X, X
    d = int(case[1:])
    return _centred(rng, 700, d), _centred(rng, 1001, d)


def _bubble_case(case, rng):
    """(rep, n_b, extent) for the bitwise cases: a random table at d, the
    all-zeros table, and copies of 40 sites with masses and extents per
    row (so Eq. 6 depends on which copy crosses min_pts)."""
    if case == "zeros":
        L = 300
        rep = np.zeros((L, 3), np.float32)
    elif case == "duplicates":
        L = 1500
        rep = _centred(rng, 40, 8)[rng.integers(0, 40, size=L)]
    else:
        return _bubble_table(rng, 1001, int(case[1:]))
    n_b = rng.integers(1, 6, size=L).astype(np.float32)
    extent = rng.uniform(0.05, 0.5, size=L).astype(np.float32)
    return rep, n_b, extent


def _clear_crossings(rep, n_b, min_pts):
    """Rows whose Eq. 6 crossing is unambiguous: the crossing entry's
    squared distance is apart from its neighbours in the sorted row by
    more than 64× the f32 rounding of the expanded form, so no rounding
    can change the crossing bubble or the mass ahead of it."""
    sq = tref.pairwise_sqdist(rep, rep).double().fill_diagonal_(0.0)
    v, order = torch.sort(sq, dim=1, stable=True)
    csum = torch.cumsum(n_b.double()[order], dim=1)
    c = torch.argmax((csum >= min_pts).to(torch.int8), dim=1)[:, None]
    noise = 64 * EPS32 * ((rep * rep).sum(1).double() + float((rep * rep).sum(1).max()))
    at = v.gather(1, c)[:, 0]
    lo = v.gather(1, (c - 1).clamp_min(0))[:, 0]
    hi = v.gather(1, (c + 1).clamp_max(v.shape[1] - 1))[:, 0]
    return ((at - lo > noise) | (c[:, 0] == 0)) & (hi - at > noise)


def _assign_case(table, d, n, L, rng):
    """(queries, reps) for the bitwise assign cases: random centred rows,
    an all-zeros rep table (every row ties at index 0), or copies of 40
    sites queried half on the table and half off it."""
    if table == "zeros":
        return _centred(rng, n, d), np.zeros((L, d), np.float32)
    if table == "duplicates":
        R = _centred(rng, 40, d)[rng.integers(0, 40, size=L)]
        on = rng.random(n) < 0.5
        Q = np.where(on[:, None], R[rng.integers(0, L, size=n)], _centred(rng, n, d))
        return Q.astype(np.float32), R
    return _centred(rng, n, d), _centred(rng, L, d)


def _flash_reading(o, want):
    """chip_smoke.py's bf16 attention readings (each passes while <= 1)."""
    o, want = o.float(), want.float()
    d = o - want
    elem = float((d.abs() / (2e-3 + 1e-2 * want.abs())).max())
    row = float((d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max()) / 1e-2
    return elem, row


def _fa_counts():
    return t_fa.launches_mma, t_fa.launches_simt


def _reset_fa_counts():
    t_fa.launches = t_fa.launches_mma = t_fa.launches_simt = 0


def _panel_case(table, d, n, m, rng):
    """(x, y) for the panel's bitwise cases: random centred rows, all
    zeros, or copies of 40 sites (exact duplicates across both tables)."""
    if table == "zeros":
        return np.zeros((n, d), np.float32), np.zeros((m, d), np.float32)
    if table == "duplicates":
        sites = _centred(rng, 40, d)
        return sites[rng.integers(0, 40, size=n)], sites[rng.integers(0, 40, size=m)]
    return _centred(rng, n, d), _centred(rng, m, d)


def _core_distances(rng, n, m):
    return (rng.uniform(0.1, 1.0, size=k).astype(np.float32) for k in (n, m))


def _assert_within(got, want, allowance):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    err = (got[fin] - want[fin]).abs()
    bound = RTOL * want[fin].abs() + allowance[fin]
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    """Each hand-written kernel against its plain version on the card."""

    @pytest.mark.parametrize("d", [2, 16, 5])
    def test_assign(self, cuda_device, d):
        rng = np.random.default_rng(1)
        R = _centred(rng, 1000, d)
        Q = _tie_free_queries(rng, R, 3000, d)
        x, r = _t(Q).to(cuda_device), _t(R).to(cuda_device)
        idx, dist = t_assign.assign(x, r, with_dist=True)
        pidx, pdist = tref.assign_with_dist(x, r)
        assert torch.equal(idx, pidx)
        _assert_within(dist, pdist, _dist_allowance(x, r, pdist))

    @pytest.mark.parametrize("d", [2, 16, 5])
    def test_bubble_cd(self, cuda_device, d):
        rng = np.random.default_rng(2)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 1001, d))
        got = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=10, dim=d)
        want = tref.bubble_core_distances(rep, n_b, extent, 10, d)
        # the crossing sits at least at the row's nearest other bubble
        r1 = tref.pairwise_sqdist(rep, rep).fill_diagonal_(float("inf")).amin(1).sqrt()
        _assert_within(got, want, _dist_allowance(rep, rep, r1))

    @pytest.mark.parametrize("case", ["d2", "d16", "d17", "d128", "zeros", "duplicates"])
    @pytest.mark.parametrize("min_pts", [1, 10, 32, 33, 64])
    def test_bubble_cd_equals_lane_kernel(self, cuda_device, case, min_pts):
        """The warp-select kernel against the per-lane kernel it replaces,
        bit for bit: the same distances, order and f32 mass sums."""
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_case(case, np.random.default_rng(17)))
        dim = rep.shape[1]
        t_bcd.launches = t_bcd.launches_lane = 0
        got = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=dim)
        want = t_bcd.bubble_cd_lane(rep, n_b, extent, min_pts=min_pts, dim=dim)
        assert (t_bcd.launches, t_bcd.launches_lane) == (1, 1)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("d", [3, 16, 128])
    @pytest.mark.parametrize("min_pts", [65, 100, 1000, 1024])
    def test_bubble_cd_large_min_pts(self, cuda_device, d, min_pts):
        """Against the plain version on the rows whose crossing is not a
        near-tie (within the allowance of the nearest other bubble)."""
        rng = np.random.default_rng(18)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 1500, d))
        got = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
        want = tref.bubble_core_distances(rep, n_b, extent, min_pts, d)
        keep = _clear_crossings(rep, n_b, min_pts)
        assert int(keep.sum()) > 1500 // 2
        r1 = tref.pairwise_sqdist(rep, rep).fill_diagonal_(float("inf")).amin(1).sqrt()
        _assert_within(got[keep], want[keep], _dist_allowance(rep, rep, r1)[keep])
        assert bool(torch.isfinite(got).all())

    @pytest.mark.parametrize("d", [2, 16, 5])
    def test_mutual_reach(self, cuda_device, d):
        rng = np.random.default_rng(3)
        X = _t(_centred(rng, 1001, d)).to(cuda_device)
        cd = _t(rng.uniform(0.1, 1.0, size=1001).astype(np.float32)).to(cuda_device)
        got = t_mr.mutual_reachability(X, X, cd, cd, n_valid=990)
        want = tref.mutual_reachability(X, X, cd, cd, n_valid=990)
        dist = tref.pairwise_sqdist(X, X).sqrt()
        _assert_within(got, want, _dist_allowance(X, X, dist))
        assert bool((got.diagonal()[:990] == 0).all())

    @pytest.mark.parametrize("d", [2, 16, 5])
    @pytest.mark.parametrize("k", [1, 10, 64])
    def test_knn(self, cuda_device, d, k):
        rng = np.random.default_rng(4)
        x = _t(_centred(rng, 3000, d)).to(cuda_device)
        y = _t(_centred(rng, 4001, d)).to(cuda_device)
        dist, idx = t_knn.knn(x, y, k)
        pdist, pidx = tref.knn(x, y, k)
        _assert_within(dist, pdist, _dist_allowance(x, y, pdist))
        keep = _isolated_entries(x, y, k)
        assert int(keep.sum()) > keep.numel() // 10
        assert torch.equal(idx[keep], pidx[keep])

    def test_knn_duplicates_lowest_index_first(self, cuda_device):
        """Copies of a row are exactly 0 apart in the kernel, so each
        row's nearest are its site's copies in index order; on the
        all-zeros table, the first k columns."""
        rng = np.random.default_rng(5)
        zeros = torch.zeros(300, 3, device=cuda_device)
        dist, idx = t_knn.knn(zeros, zeros, 12)
        assert bool((dist == 0).all())
        assert torch.equal(idx, torch.arange(12, dtype=torch.int32, device=cuda_device).expand(300, 12))
        site = rng.integers(0, 40, size=2000)
        X = _t(_centred(rng, 40, 8)[site]).to(cuda_device)
        dist, idx = t_knn.knn(X, X, 10)
        for i in range(0, 2000, 97):
            copies = np.flatnonzero(site == site[i])[:10]
            assert idx[i, : len(copies)].tolist() == copies.tolist()
            assert bool((dist[i, : len(copies)] == 0).all())

    def test_core_distances(self, cuda_device):
        rng = np.random.default_rng(6)
        x = _t(_centred(rng, 5000, 16)).to(cuda_device)
        cd = tops.core_distances(x, 10)
        assert torch.equal(cd, t_knn.knn(x, x, 10)[0][:, 9])
        want = tref.knn(x, x, 10)[0][:, 9]
        _assert_within(cd, want, _dist_allowance(x, x, want))

    def test_knn_k_bound(self, cuda_device):
        """k has no bound but m: 1025 takes the strip route and matches the
        plain version; the per-lane oracle still raises above 64."""
        x = _t(_centred(np.random.default_rng(19), 8, 2)).to(cuda_device)
        y = torch.zeros(1100, 2, device=cuda_device)
        with pytest.raises(ValueError):
            t_knn.knn_lane(x, y, 65)
        assert t_knn.knn(x, y, 1024)[1].shape == (8, 1024)
        t_knn.launches = t_knn.launches_ws = t_knn.launches_strip = 0
        dist, idx = t_knn.knn(x, y, 1025)
        assert (t_knn.launches, t_knn.launches_ws, t_knn.launches_strip) == (1, 0, 1)
        pdist, pidx = tref.knn(x, y, 1025)
        assert torch.equal(idx, torch.arange(1025, dtype=torch.int32, device=cuda_device).expand(8, 1025))
        assert torch.equal(idx, pidx)
        _assert_within(dist, pdist, _dist_allowance(x, y, pdist))

    @pytest.mark.parametrize("case", ["d2", "d16", "d17", "d128", "zeros", "duplicates"])
    @pytest.mark.parametrize("k", [1, 10, 32, 33, 64])
    def test_knn_equals_lane_kernel(self, cuda_device, case, k):
        """The warp-select kernel against the per-lane kernel it replaces,
        bit for bit: the same arithmetic and the same (d, j) order."""
        x, y = (_t(a).to(cuda_device) for a in _knn_table(case, np.random.default_rng(15)))
        t_knn.launches = t_knn.launches_lane = 0
        dist, idx = t_knn.knn(x, y, k)
        ldist, lidx = t_knn.knn_lane(x, y, k)
        assert (t_knn.launches, t_knn.launches_lane) == (1, 1)
        assert torch.equal(dist, ldist) and torch.equal(idx, lidx)

    @pytest.mark.parametrize("d", [3, 16, 128])
    @pytest.mark.parametrize("k", [65, 100, 300, 1000, 1024])
    def test_knn_large_k(self, cuda_device, d, k):
        rng = np.random.default_rng(16)
        x = _t(_centred(rng, 300, d)).to(cuda_device)
        y = _t(_centred(rng, 2001, d)).to(cuda_device)
        dist, idx = t_knn.knn(x, y, k)
        pdist, pidx = tref.knn(x, y, k)
        _assert_within(dist, pdist, _dist_allowance(x, y, pdist))
        keep = _isolated_entries(x, y, k)
        assert int(keep.sum()) > keep.numel() // 10
        assert torch.equal(idx[keep], pidx[keep])
        assert bool((dist[:, 1:] >= dist[:, :-1]).all())

    @pytest.mark.parametrize("d", [2, 16, 5])
    def test_pairwise(self, cuda_device, d):
        rng = np.random.default_rng(7)
        x = _t(_centred(rng, 1001, d)).to(cuda_device)
        y = _t(_centred(rng, 777, d)).to(cuda_device)
        got = t_pw.pairwise_sqdist(x, y)
        want = tref.pairwise_sqdist(x, y)
        dsq = 8 * EPS32 * float((x * x).sum(1).max() + (y * y).sum(1).max())
        _assert_within(got, want, torch.full_like(want, dsq))

    def test_pairwise_and_mutual_reach_share_bits(self, cuda_device):
        """Both kernels run one tile code: with zero core distances and no
        diagonal, mutual_reach is exactly the root of pairwise."""
        rng = np.random.default_rng(8)
        x = _t(_centred(rng, 999, 16)).to(cuda_device)
        y = _t(_centred(rng, 1201, 16)).to(cuda_device)
        sq = t_pw.pairwise_sqdist(x, y)
        zx, zy = torch.zeros(999, device=cuda_device), torch.zeros(1201, device=cuda_device)
        W = t_mr.mutual_reachability(x, y, zx, zy, zero_diag=False)
        assert torch.equal(W, sq.sqrt())

    @pytest.mark.parametrize("kernel", ["assign", "knn", "pairwise", "mutual_reach", "bubble_cd"])
    def test_tf32_probe(self, cuda_device, kernel):
        """Fails if any distance kernel drops IEEE f32 products."""
        x, y, sq = _tf32_probe(np.random.default_rng(9), 256, 300)
        xt, yt = _t(x).to(cuda_device), _t(y).to(cuda_device)
        if kernel == "bubble_cd":
            # unit masses, no extent, min_pts 2: the distance to the nearest other row
            rep = torch.cat([xt, yt])
            L = rep.shape[0]
            ones, zeros = torch.ones(L, device=cuda_device), torch.zeros(L, device=cuda_device)
            cd = t_bcd.bubble_core_distances(rep, ones, zeros, min_pts=2, dim=4)
            got = cd.double().cpu().numpy() ** 2
            r64 = rep.double().cpu().numpy()
            want = ((r64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(want, np.inf)
            want = want.min(1)
        elif kernel == "assign":
            idx, dist = t_assign.assign(xt, yt, with_dist=True)
            got = dist.double().cpu().numpy() ** 2
            want = sq[np.arange(256), idx.cpu().numpy()]
            assert (want <= sq.min(1) + 2e-5).all()
        elif kernel == "knn":
            dist, idx = t_knn.knn(xt, yt, 5)
            got = dist.double().cpu().numpy() ** 2
            want = np.take_along_axis(sq, idx.long().cpu().numpy(), 1)
        elif kernel == "pairwise":
            got, want = t_pw.pairwise_sqdist(xt, yt).double().cpu().numpy(), sq
        else:
            z0, z1 = torch.zeros(256, device=cuda_device), torch.zeros(300, device=cuda_device)
            got = t_mr.mutual_reachability(xt, yt, z0, z1, zero_diag=False).double().cpu().numpy() ** 2
            want = sq
        assert np.abs(got - want).max() < 2e-5

    @pytest.mark.parametrize("kernel", ["assign", "knn", "pairwise", "mutual_reach", "bubble_cd"])
    def test_tf32_probe_wide(self, cuda_device, kernel):
        """The TF32 probe at d = 200, its features in the second slice."""
        x, y, sq = _tf32_probe(np.random.default_rng(9), 256, 300, width=200)
        xt, yt = _t(x).to(cuda_device), _t(y).to(cuda_device)
        if kernel == "bubble_cd":
            rep = torch.cat([xt, yt])
            L = rep.shape[0]
            ones, zeros = torch.ones(L, device=cuda_device), torch.zeros(L, device=cuda_device)
            got = t_bcd.bubble_core_distances(rep, ones, zeros, min_pts=2, dim=4).double().cpu().numpy() ** 2
            r64 = rep.double().cpu().numpy()
            want = ((r64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(want, np.inf)
            want = want.min(1)
        elif kernel == "assign":
            idx, dist = t_assign.assign(xt, yt, with_dist=True)
            got = dist.double().cpu().numpy() ** 2
            want = sq[np.arange(256), idx.cpu().numpy()]
            assert (want <= sq.min(1) + 2e-5).all()
        elif kernel == "knn":
            dist, idx = t_knn.knn(xt, yt, 5)
            got = dist.double().cpu().numpy() ** 2
            want = np.take_along_axis(sq, idx.long().cpu().numpy(), 1)
        elif kernel == "pairwise":
            got, want = t_pw.pairwise_sqdist(xt, yt).double().cpu().numpy(), sq
        else:
            z0, z1 = torch.zeros(256, device=cuda_device), torch.zeros(300, device=cuda_device)
            got = t_mr.mutual_reachability(xt, yt, z0, z1, zero_diag=False).double().cpu().numpy() ** 2
            want = sq
        assert np.abs(got - want).max() < 2e-5

    @pytest.mark.parametrize("table", ["random", "zeros", "duplicates"])
    @pytest.mark.parametrize("d", [2, 5, 16, 17, 40, 128])
    @pytest.mark.parametrize("n", [1, 4096, 8192])
    @pytest.mark.parametrize("L", [1, 31, 8192 - 192])
    def test_assign_equals_lane_kernel(self, cuda_device, table, d, n, L):
        """The assign kernel against the per-lane kernel it replaces, bit
        for bit, with and without the distance: the (n, L) pairs cross one
        slice of L and splits of 2 to 31 slices with their combine."""
        q, r = (_t(a).to(cuda_device) for a in _assign_case(table, d, n, L, np.random.default_rng(20)))
        t_assign.launches = t_assign.launches_lane = 0
        idx, dist = t_assign.assign(q, r, with_dist=True)
        lidx, ldist = t_assign.assign_lane(q, r, with_dist=True)
        assert torch.equal(idx, lidx) and torch.equal(dist, ldist)
        assert torch.equal(t_assign.assign(q, r), lidx)
        assert (t_assign.launches, t_assign.launches_lane) == (2, 1)
        if table == "zeros":
            assert bool((idx == 0).all())

    @pytest.mark.parametrize("table", ["random", "zeros", "duplicates"])
    @pytest.mark.parametrize("d", [1, 2, 5, 16, 17, 64, 65, 129, 200])
    @pytest.mark.parametrize("n,m", [(1001, 777), (300, 1024), (129, 1023)])
    def test_panel_equals_tile_kernel(self, cuda_device, table, d, n, m):
        """pairwise and mutual_reach's distance panel against the tile
        kernels it replaced, bit for bit: n and m not multiples of the
        128-row tile, m % 4 in {1, 0, 3} (scalar and 16-byte stores), d
        across the 16-feature slices."""
        x, y = (_t(a).to(cuda_device) for a in _panel_case(table, d, n, m, np.random.default_rng(24)))
        cx, cy = (_t(a).to(cuda_device) for a in _core_distances(np.random.default_rng(25), n, m))
        t_pw.launches = t_pw.launches_tile = t_mr.launches = t_mr.launches_tile = 0
        assert torch.equal(t_pw.pairwise_sqdist(x, y), t_pw.pairwise_tile(x, y))
        assert torch.equal(t_mr.mutual_reachability(x, y, cx, cy), t_mr.mutual_reach_tile(x, y, cx, cy))
        assert (t_pw.launches, t_pw.launches_tile, t_mr.launches, t_mr.launches_tile) == (1, 1, 1, 1)

    @pytest.mark.parametrize("n_valid", [0, 127, 128, 129, 256, 500, 2000])
    @pytest.mark.parametrize("zero_diag", [True, False])
    @pytest.mark.parametrize("n,m", [(700, 700), (700, 301), (257, 900)])
    def test_mutual_reach_panel_mask_equals_tile_kernel(self, cuda_device, n_valid, zero_diag, n, m):
        """The pad mask inside, on and past a tile edge (128, 256), and the
        diagonal on and off at n != m: tiles wholly past n_valid are only
        written, the rest compared per element; bit for bit the tile
        kernel's."""
        rng = np.random.default_rng(26)
        x, y = (_t(_centred(rng, k, 16)).to(cuda_device) for k in (n, m))
        cx, cy = (_t(a).to(cuda_device) for a in _core_distances(rng, n, m))
        got = t_mr.mutual_reachability(x, y, cx, cy, zero_diag=zero_diag, n_valid=n_valid)
        assert torch.equal(got, t_mr.mutual_reach_tile(x, y, cx, cy, zero_diag=zero_diag, n_valid=n_valid))
        nv = min(n_valid, max(n, m))
        assert bool(torch.isinf(got[nv:]).all()) and bool(torch.isinf(got[:, nv:]).all())

    @pytest.mark.parametrize("d", [3, 16, 200])
    @pytest.mark.parametrize("m", [999, 1000])
    def test_sq_into_strip_slice_equals_tile_kernel(self, cuda_device, d, m):
        """sq_into from an offset row slice of x into an offset row slice of
        a strip (the strip routes' call): the tile kernel's bits, and the
        strip's other rows untouched."""
        rng = np.random.default_rng(27)
        x, y = (_t(_centred(rng, k, d)).to(cuda_device) for k in (1000, m))
        strip = torch.full((700, m), -1.0, device=cuda_device)
        t_pw.launches = 0
        t_pw.sq_into(x[301:601], y, strip[101:401])
        assert t_pw.launches == 0
        assert torch.equal(strip[101:401], t_pw.pairwise_tile(x[301:601].contiguous(), y))
        assert bool((strip[:101] == -1).all()) and bool((strip[401:] == -1).all())

    @pytest.mark.parametrize("d", [129, 256, 300])
    def test_wide_rows(self, cuda_device, d):
        """Every distance kernel past d = 128 against its plain version:
        assign and knn indices identical on tie-free rows / isolated
        entries, values within the allowances above."""
        rng = np.random.default_rng(21)
        R = _centred(rng, 777, d)
        x, r = _t(_tie_free_queries(rng, R, 1001, d)).to(cuda_device), _t(R).to(cuda_device)
        idx, dist = t_assign.assign(x, r, with_dist=True)
        pidx, pdist = tref.assign_with_dist(x, r)
        assert torch.equal(idx, pidx)
        _assert_within(dist, pdist, _dist_allowance(x, r, pdist))
        t_knn.launches_strip = 0
        kd, ki = t_knn.knn(x, r, 10)
        assert t_knn.launches_strip == 1
        pkd, pki = tref.knn(x, r, 10)
        _assert_within(kd, pkd, _dist_allowance(x, r, pkd))
        keep = _isolated_entries(x, r, 10)
        assert int(keep.sum()) > keep.numel() // 10
        assert torch.equal(ki[keep], pki[keep])
        sq = t_pw.pairwise_sqdist(x, r)
        want = tref.pairwise_sqdist(x, r)
        dsq = 8 * EPS32 * float((x * x).sum(1).max() + (r * r).sum(1).max())
        _assert_within(sq, want, torch.full_like(want, dsq))
        cx = _t(rng.uniform(0.1, 1.0, size=1001).astype(np.float32)).to(cuda_device)
        cr = _t(rng.uniform(0.1, 1.0, size=777).astype(np.float32)).to(cuda_device)
        W = t_mr.mutual_reachability(x, r, cx, cr, n_valid=700)
        pW = tref.mutual_reachability(x, r, cx, cr, n_valid=700)
        _assert_within(W, pW, _dist_allowance(x, r, want.sqrt()))
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 1001, d))
        t_bcd.launches_strip = 0
        cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=10, dim=d)
        assert t_bcd.launches_strip == 1
        pcd = tref.bubble_core_distances(rep, n_b, extent, 10, d)
        keep = _clear_crossings(rep, n_b, 10)
        assert int(keep.sum()) > 1001 // 2
        r1 = tref.pairwise_sqdist(rep, rep).fill_diagonal_(float("inf")).amin(1).sqrt()
        _assert_within(cd[keep], pcd[keep], _dist_allowance(rep, rep, r1)[keep])

    def test_zero_features_change_nothing(self, cuda_device):
        """A d = 300 table whose features from 128 on are zero against the
        same table cut to d = 128, bit for bit, in all five distance kernels
        (wide assign vs the register tile; knn and bubble_cd's strip route
        vs the warp-select kernels; the sliced tile vs one slice)."""
        rng = np.random.default_rng(22)
        narrow = [_centred(rng, n, 128) for n in (1500, 900)]
        wide = [np.pad(a, ((0, 0), (0, 172))) for a in narrow]
        (x, y), (xw, yw) = ([_t(a).to(cuda_device) for a in t] for t in (narrow, wide))
        nb = _t(rng.integers(1, 6, size=900).astype(np.float32)).to(cuda_device)
        ext = _t(rng.uniform(0.05, 0.5, size=900).astype(np.float32)).to(cuda_device)
        cx, cy = (_t(rng.uniform(0.1, 1.0, size=n).astype(np.float32)).to(cuda_device) for n in (1500, 900))
        for a, b in zip(t_assign.assign(x, y, with_dist=True), t_assign.assign(xw, yw, with_dist=True)):
            assert torch.equal(a, b)
        for a, b in zip(t_knn.knn(x, y, 20), t_knn.knn(xw, yw, 20)):
            assert torch.equal(a, b)
        assert torch.equal(t_pw.pairwise_sqdist(x, y), t_pw.pairwise_sqdist(xw, yw))
        assert torch.equal(t_mr.mutual_reachability(x, y, cx, cy, zero_diag=False),
                           t_mr.mutual_reachability(xw, yw, cx, cy, zero_diag=False))
        assert torch.equal(t_bcd.bubble_core_distances(y, nb, ext, min_pts=10, dim=128),
                           t_bcd.bubble_core_distances(yw, nb, ext, min_pts=10, dim=128))

    @pytest.mark.parametrize("case", ["d2", "d128", "zeros", "duplicates"])
    def test_strip_route_equals_warp_select_at_the_bound(self, cuda_device, case):
        """The strip routes forced at k = min_pts = 1024 (the warp-select
        kernels' bound) against those kernels, bit for bit."""
        rng = np.random.default_rng(23)
        if case == "zeros":
            x = y = torch.zeros(1100, 3, device=cuda_device)
        elif case == "duplicates":
            x, y = (_t(a).to(cuda_device) for a in _knn_table(case, rng))
        else:
            d = int(case[1:])
            x, y = (_t(_centred(rng, n, d)).to(cuda_device) for n in (500, 1500))
        for a, b in zip(t_knn.knn(x, y, 1024), t_knn.knn_strip(x, y, 1024)):
            assert torch.equal(a, b)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_case(case, rng))
        dim = rep.shape[1]
        t_bcd.launches_ws = t_bcd.launches_strip = 0
        ws = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=1024, dim=dim)
        strip = t_bcd.bubble_cd_strip(rep, n_b, extent, min_pts=1024, dim=dim)
        assert (t_bcd.launches_ws, t_bcd.launches_strip) == (1, 1)
        assert torch.equal(ws, strip)

    @pytest.mark.parametrize("d", [16, 200])
    @pytest.mark.parametrize("k", [1025, 2000])
    def test_knn_above_1024(self, cuda_device, d, k):
        rng = np.random.default_rng(24)
        x = _t(_centred(rng, 300, d)).to(cuda_device)
        y = _t(_centred(rng, 2500, d)).to(cuda_device)
        t_knn.launches_strip = 0
        dist, idx = t_knn.knn(x, y, k)
        assert t_knn.launches_strip == 1
        pdist, pidx = tref.knn(x, y, k)
        _assert_within(dist, pdist, _dist_allowance(x, y, pdist))
        keep = _isolated_entries(x, y, k)
        assert int(keep.sum()) > keep.numel() // 10
        assert torch.equal(idx[keep], pidx[keep])

    @pytest.mark.parametrize("d", [16, 200])
    @pytest.mark.parametrize("min_pts", [1025, 2000])
    def test_bubble_cd_above_1024(self, cuda_device, d, min_pts):
        rng = np.random.default_rng(25)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 3000, d))
        t_bcd.launches_strip = 0
        got = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
        assert t_bcd.launches_strip == 1
        want = tref.bubble_core_distances(rep, n_b, extent, min_pts, d)
        keep = _clear_crossings(rep, n_b, min_pts)
        assert int(keep.sum()) > 3000 // 2
        r1 = tref.pairwise_sqdist(rep, rep).fill_diagonal_(float("inf")).amin(1).sqrt()
        _assert_within(got[keep], want[keep], _dist_allowance(rep, rep, r1)[keep])
        assert bool(torch.isfinite(got).all())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,S,H,KV,D,window", [
        (2, 300, 6, 2, 120, None), (1, 257, 4, 4, 64, 33), (1, 130, 3, 1, 256, None), (2, 64, 2, 1, 8, 5)])
    def test_flash(self, cuda_device, dtype, B, S, H, KV, D, window):
        gen = torch.Generator(device=cuda_device).manual_seed(10)
        q = torch.randn(B, H, S, D, generator=gen, device=cuda_device).to(dtype)
        k = torch.randn(B, KV, S + 11, D, generator=gen, device=cuda_device).to(dtype)
        v = torch.randn(B, KV, S + 11, D, generator=gen, device=cuda_device).to(dtype)
        qpos = torch.arange(S, device=cuda_device, dtype=torch.int32).expand(B, S).contiguous() + 11
        kpos = torch.arange(S + 11, device=cuda_device, dtype=torch.int32).expand(B, S + 11).contiguous()
        kpos[:, -7:] = -1  # a dead tail
        kpos[0, :20] = -1  # batch 0: the first query rows see no live key
        got = t_fa.flash_attention(q, k, v, qpos, kpos, causal=True, window=window)
        want = tref.gqa_flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos.cpu(), kpos.cpu(), True, window)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)
        else:
            assert float((got.cpu().float() - want.float()).abs().max()) <= 3e-2

    def test_flash_model_layout(self, cuda_device):
        gen = torch.Generator(device=cuda_device).manual_seed(11)
        q = torch.randn(2, 100, 6, 24, generator=gen, device=cuda_device)
        k = torch.randn(2, 100, 3, 24, generator=gen, device=cuda_device)
        v = torch.randn(2, 100, 3, 24, generator=gen, device=cuda_device)
        got = tops.flash_attention(q, k, v, window=17)
        want = tops.flash_attention(q.cpu(), k.cpu(), v.cpu(), window=17)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)

    @pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,dead_head,dead_tail", [
        (1, 300, 311, 3, 1, 8, True, None, 0, 0),
        (2, 300, 311, 6, 1, 64, True, None, 20, 7),
        (1, 300, 311, 4, 4, 120, True, 33, 0, 9),
        (2, 300, 311, 6, 2, 128, True, 100, 20, 7),
        (1, 300, 311, 6, 2, 128, True, None, 0, 0),
        (1, 333, 333, 4, 2, 112, True, None, 0, 0),
        (1, 200, 515, 4, 1, 112, False, None, 30, 30),
        (2, 257, 1500, 6, 6, 64, False, None, 0, 0),
        (2, 129, 700, 3, 3, 32, True, 64, 40, 0),
        (2, 100, 311, 4, 2, 64, False, None, 0, 9),
        (1, 70, 33_000, 2, 1, 64, True, 40_000, 0, 5),
        (1, 70, 70_000, 2, 1, 128, True, None, 0, 5),
    ])
    def test_flash_mma(self, cuda_device, B, Sq, Sk, H, KV, D, causal, window, dead_head, dead_tail):
        """bf16 through the tensor-core route (``csrc/flash_attention_wgmma.cu``):
        D in {8, 32, 64, 112, 120, 128} padded to 64 or 128, Sq and Sk not
        multiples of the 128-row block or the 128-key tile, Sq != Sk (cross
        calls), G in {1, 2, 3, 4, 6}, windows, no causal mask, dead keys at
        the head (rows with no live key) and the tail, Sk past 65,536 keys
        (the tile pre-scan's second chunk); held to the plain version and to
        the first tensor-core kernel (``flash_attention_mma_v1``) under
        chip_smoke.py's bf16 readings, and its ``lse`` to the plain
        log-sum-exp."""
        gen = torch.Generator(device=cuda_device).manual_seed(12)
        q = torch.randn(B, H, Sq, D, generator=gen, device=cuda_device).bfloat16()
        k = torch.randn(B, KV, Sk, D, generator=gen, device=cuda_device).bfloat16()
        v = torch.randn(B, KV, Sk, D, generator=gen, device=cuda_device).bfloat16()
        qpos = torch.arange(Sq, device=cuda_device, dtype=torch.int32).expand(B, Sq).contiguous() + (Sk - Sq)
        kpos = torch.arange(Sk, device=cuda_device, dtype=torch.int32).expand(B, Sk).contiguous()
        kpos[:, :dead_head] = -1
        kpos[:, Sk - dead_tail:] = -1
        _reset_fa_counts()
        t_fa.launches_mma_v1 = 0
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda_device)
        got = t_fa.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window, lse=lse)
        old = t_fa.flash_attention_mma_v1(q, k, v, qpos, kpos, causal=causal, window=window)
        torch.cuda.synchronize()
        assert _fa_counts() == (1, 0) and t_fa.launches_mma_v1 == 1
        want = tref.gqa_flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos.cpu(), kpos.cpu(), causal, window)
        live = (kpos[:, None, :] >= 0) & ((kpos[:, None, :] <= qpos[:, :, None]) | (not causal))
        assert bool((~live.any(-1)).any()) == (causal and dead_head > Sk - Sq)
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
        elem, row = _flash_reading(got.cpu(), want)
        assert elem <= 1 and row <= 1, (elem, row)
        elem, row = _flash_reading(got, old)
        assert elem <= 1 and row <= 1, ("against flash_attention_mma_v1", elem, row)
        want_lse = tref.gqa_flash_lse(q, k, qpos, kpos, causal, window)
        fin = torch.isfinite(want_lse)
        assert torch.equal(torch.isinf(lse), ~fin) and bool((lse[~fin] > 0).all())
        assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-5 * max(1.0, float(want_lse[fin].abs().max()))

    @pytest.mark.parametrize("D,window", [(120, 50), (64, None), (128, 70)])
    def test_flash_mma_model_layout(self, cuda_device, D, window):
        """ops.flash_attention in bf16 at Dh 120 (danube's width), 64 and
        128: the model layout reaches the tensor-core route through strides
        (TMA reads the (B, S, heads, D) views in place); held to the plain
        version and to the first tensor-core kernel on the same views."""
        gen = torch.Generator(device=cuda_device).manual_seed(13)
        q, k, v = (torch.randn(2, 200, h, D, generator=gen, device=cuda_device).bfloat16() for h in (8, 2, 2))
        _reset_fa_counts()
        got = tops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert _fa_counts() == (1, 0)
        want = tops.flash_attention(q.cpu(), k.cpu(), v.cpu(), window=window)
        elem, row = _flash_reading(got.cpu(), want)
        assert elem <= 1 and row <= 1, (elem, row)
        pos = torch.arange(200, device=cuda_device, dtype=torch.int32).expand(2, 200).contiguous()
        old = t_fa.flash_attention_mma_v1(*(t.transpose(1, 2) for t in (q, k, v)), pos, pos, causal=True,
                                          window=window).transpose(1, 2)
        elem, row = _flash_reading(got, old)
        assert elem <= 1 and row <= 1, ("against flash_attention_mma_v1", elem, row)

    def test_flash_bf16_odd_stride_takes_simt(self, cuda_device):
        """A bf16 view whose sequence stride is not a multiple of 8 cannot
        be read by 16-byte copies: it takes the CUDA-core route."""
        gen = torch.Generator(device=cuda_device).manual_seed(14)
        q = torch.randn(1, 4, 150, 68, generator=gen, device=cuda_device).bfloat16()[..., :64]
        k, v = (torch.randn(1, 2, 150, 64, generator=gen, device=cuda_device).bfloat16() for _ in range(2))
        qpos = torch.arange(150, device=cuda_device, dtype=torch.int32)[None].contiguous()
        assert q.stride(2) == 68
        _reset_fa_counts()
        got = t_fa.flash_attention(q, k, v, qpos, qpos.clone(), causal=True)
        torch.cuda.synchronize()
        assert _fa_counts() == (0, 1)
        want = tref.gqa_flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos.cpu(), qpos.cpu(), True, None)
        elem, row = _flash_reading(got.cpu(), want)
        assert elem <= 1 and row <= 1, (elem, row)

    @pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window,dead_head,dead_tail", [
        (1, 300, 311, 3, 1, True, None, 0, 0),
        (2, 300, 311, 6, 1, True, None, 20, 7),
        (1, 200, 311, 4, 4, True, 33, 0, 9),
        (2, 129, 700, 6, 2, False, None, 40, 0),
        (1, 70, 17_000, 2, 1, True, 20_000, 0, 5),
    ])
    @pytest.mark.parametrize("D", [1, 8, 24, 64, 120, 128, 129, 200, 256])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_flash_panel(self, cuda_device, dtype, D, B, Sq, Sk, H, KV, causal, window, dead_head, dead_tail):
        """The CUDA-core route (csrc/flash_attention_panel.cu) against the
        plain version and against the earlier kernel on the same inputs:
        every head-dim bucket (D padded to 32, 64, 128, 256), Sq and Sk not
        multiples of the 64-row block or the 32-key tile, Sk past the
        pre-scan's 16,384-key chunk, G in {1, 3, 6}, windows, no causal
        mask, dead keys at the head (rows with no live key) and the tail.
        bf16 comes as views with sequence stride D + 1, which the
        tensor-core route refuses; f32 at D % 4 == 0 takes the 16-byte
        copies, the rest the 4-byte ones."""
        gen = torch.Generator(device=cuda_device).manual_seed(15)
        pad = 1 if dtype == torch.bfloat16 else 0
        q = torch.randn(B, H, Sq, D + pad, generator=gen, device=cuda_device).to(dtype)[..., :D]
        k = torch.randn(B, KV, Sk, D + pad, generator=gen, device=cuda_device).to(dtype)[..., :D]
        v = torch.randn(B, KV, Sk, D + pad, generator=gen, device=cuda_device).to(dtype)[..., :D]
        qpos = torch.arange(Sq, device=cuda_device, dtype=torch.int32).expand(B, Sq).contiguous() + (Sk - Sq)
        kpos = torch.arange(Sk, device=cuda_device, dtype=torch.int32).expand(B, Sk).contiguous()
        kpos[:, :dead_head] = -1
        kpos[:, Sk - dead_tail:] = -1
        _reset_fa_counts()
        t_fa.launches_scalar = 0
        got = t_fa.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window)
        old = t_fa.flash_attention_scalar(q, k, v, qpos, kpos, causal=causal, window=window)
        torch.cuda.synchronize()
        assert _fa_counts() == (0, 1) and t_fa.launches == 1 and t_fa.launches_scalar == 1
        live = (kpos[:, None, :] >= 0) & ((kpos[:, None, :] <= qpos[:, :, None]) | (not causal))
        assert bool((~live.any(-1)).any()) == (causal and dead_head > Sk - Sq)
        want = tref.gqa_flash_attention(q.cpu(), k.cpu(), v.cpu(), qpos.cpu(), kpos.cpu(), causal, window)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)
            torch.testing.assert_close(got, old, rtol=1e-4, atol=2e-4)
        else:
            for ref_out in (want, old.cpu()):
                elem, row = _flash_reading(got.cpu(), ref_out)
                assert elem <= 1 and row <= 1, (elem, row)

    @pytest.mark.parametrize("D", [24, 128])
    def test_flash_panel_model_layout_and_strided_out(self, cuda_device, D):
        """f32 model-layout views through ops.flash_attention (the kernel
        reads (B, S, H, D) through strides), and ``out=`` into a strided
        view whose rows are not 16-byte aligned."""
        gen = torch.Generator(device=cuda_device).manual_seed(16)
        q, k, v = (torch.randn(2, 150, h, D, generator=gen, device=cuda_device) for h in (6, 2, 2))
        _reset_fa_counts()
        got = tops.flash_attention(q, k, v, window=40)
        torch.cuda.synchronize()
        assert _fa_counts() == (0, 1)
        want = tops.flash_attention(q.cpu(), k.cpu(), v.cpu(), window=40)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        pos = torch.arange(150, device=cuda_device, dtype=torch.int32)[None].expand(2, 150).contiguous()
        buf = torch.full((2, 150, 6, D + 3), float("nan"), device=cuda_device)
        out = buf[..., 1 : D + 1].transpose(1, 2)
        res = t_fa.flash_attention(qh, kh, vh, pos, pos, causal=True, window=40, out=out)
        torch.cuda.synchronize()
        assert res.data_ptr() == out.data_ptr() and _fa_counts() == (0, 2)
        torch.testing.assert_close(buf[..., 1 : D + 1].cpu(), want, rtol=1e-4, atol=2e-4)
        assert bool(buf[..., 0].isnan().all()) and bool(buf[..., D + 1 :].isnan().all())

    def test_tf32_off(self, cuda_device):
        from repro_torch.device import resolve_device

        resolve_device(cuda_device)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


def _serving_blocks(seed, n_blocks, n_per=400, d=4):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(6, d)) * 6.0
    return [rng.normal(size=(n_per, d)) * 0.7 + centres[rng.integers(0, 6, size=n_per)] + 3.0
            for _ in range(n_blocks)]


def _card_engine(cuda_device, **kw):
    from repro_torch import StreamingClusterEngine

    return StreamingClusterEngine(4, min_pts=8, compression=0.05, epsilon=0.2, min_offline_points=8,
                                  device=cuda_device, **kw)


def _drive_card(eng, blocks):
    for i, b in enumerate(blocks):
        pids = eng.ingest(b)
        if i % 3 == 2:
            eng.retire(pids[::4])
    eng.flush()


@pytest.mark.cuda
class TestCudaServing:
    """The serve plane's remainder and checkpoint replay on the card."""

    def test_batcher_matches_direct_queries(self, cuda_device):
        import threading

        from repro_torch import QueryBatcher

        eng = _card_engine(cuda_device)
        _drive_card(eng, _serving_blocks(3, 6))
        rng = np.random.default_rng(4)
        chunks = [rng.normal(size=(int(rng.integers(1, 300)), 4)) * 5.0 + 3.0 for _ in range(24)]
        qb = QueryBatcher(eng, max_batch=1024)
        got, errors = [None] * len(chunks), []

        def worker(i):
            try:
                got[i] = qb.query_detailed(chunks[i])
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        for c, g in zip(chunks, got):
            w = eng.query_detailed(c)
            for f in ("labels", "bubble_index"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            np.testing.assert_allclose(g.distance, w.distance, rtol=1e-6, atol=0)
            np.testing.assert_allclose(g.strength, w.strength, rtol=1e-6, atol=0)
        assert qb.fanned_out == len(chunks) and 1 <= qb.batches <= len(chunks)

    def test_drill_replays_bit_for_bit(self, cuda_device, tmp_path):
        from repro_torch import CheckpointStore

        blocks = _serving_blocks(5, 8)
        oracle, victim = _card_engine(cuda_device), _card_engine(cuda_device)
        for eng in (oracle, victim):
            _drive_card(eng, blocks[:4])
        store = CheckpointStore(str(tmp_path), keep=2)
        victim.save(store)
        del victim
        recovered = _card_engine(cuda_device)
        recovered.restore(store)
        store.close()
        for eng in (oracle, recovered):
            _drive_card(eng, blocks[4:])
        a, b = oracle.snapshot, recovered.snapshot
        assert a.version == b.version > 1
        for u, v in zip(a.mst, b.mst):
            np.testing.assert_array_equal(u, v)
        for f in ("labels", "stabilities", "point_parent", "point_lambda", "cluster_parent",
                  "cluster_birth", "cluster_weight", "selected", "all_stabilities"):
            np.testing.assert_array_equal(getattr(a.result, f), getattr(b.result, f), err_msg=f)
        q = blocks[0][:500]
        ra, rb = oracle.query_detailed(q), recovered.query_detailed(q)
        for f in ("labels", "bubble_index", "distance", "strength"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))

    def test_return_w_on_the_card(self, cuda_device):
        """``return_w`` on the card: the pass's own W (the valid corner of
        the device matrix) against the bubble d_m computed alone on the
        same centred table (within the mutual_reach parity tolerance,
        1e-5 relative plus 1e-5 at this unit scale), and the result the
        pass gives without it."""
        rng = np.random.default_rng(6)
        rep, n_b, extent = _bubble_table(rng, 700, 16)
        W, res = tops.offline_recluster_from_table(rep, n_b, extent, 10, device=cuda_device, return_w=True)
        plain = tops.offline_recluster_from_table(rep, n_b, extent, 10, device=cuda_device)
        assert W.shape == (700, 700) and W.dtype == np.float32
        np.testing.assert_array_equal(res.labels, plain.labels)
        for u, v in zip(res.mst, plain.mst):
            np.testing.assert_array_equal(u, v)
        r64, m64 = rep.astype(np.float64), n_b.astype(np.float64)
        c = r64 - (m64 @ r64) / m64.sum()
        alone = tops.bubble_mutual_reachability(*(torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
                                                  for a in (c, n_b, extent)), 10)
        np.testing.assert_allclose(W, alone.cpu().numpy(), rtol=1e-5, atol=1e-5)


def _flat_case(rng, Lp, Bp, d, slots, err_scale=1e-6):
    """A flat table with nonzero compensation words and a block of rows."""
    dev = torch.device("cuda")
    state = [rng.normal(size=(Lp, d)) * 50.0, rng.normal(size=(Lp, d)) * err_scale,
             rng.random(Lp) * 1e3, rng.normal(size=Lp) * err_scale, rng.integers(0, 60, size=Lp)]
    state = [torch.tensor(a, dtype=torch.float32, device=dev) for a in state]
    alive = torch.tensor(rng.random(Lp) < 0.9, device=dev)
    X = torch.tensor(rng.normal(size=(Bp, d)), dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.random(Bp) < 0.95, device=dev)
    return state, alive, X, torch.tensor(slots, dtype=torch.int32, device=dev), valid


@pytest.mark.cuda
class TestCudaFlat:
    """The flat table's block scatter (``csrc/flat_scatter.cu``) bit for bit
    its plain version (the same ascending row order, no contraction), and
    device-online ingest on the card."""

    @pytest.mark.parametrize("case", ["spread", "ties", "ragged", "small", "wide", "zero"])
    @pytest.mark.parametrize("sign", [1, -1])
    def test_scatter_matches_plain(self, cuda_device, case, sign):
        from repro_torch.kernels import flat_scatter as t_fs

        rng = np.random.default_rng(7)
        Lp, Bp, d = {"spread": (16384, 8192, 16), "ties": (1024, 8192, 16), "ragged": (4096, 8192 + 1000, 16),
                     "small": (64, 300, 3), "wide": (256, 2000, 200), "zero": (2048, 8192, 16)}[case]
        slots = {"ties": rng.integers(0, 4, Bp), "zero": rng.integers(0, Lp // 8, Bp)}.get(case, rng.integers(0, Lp, Bp))
        state, alive, X, slot, valid = _flat_case(rng, Lp, Bp, d, slots)
        thresh = 40.0 if sign > 0 else 20.0
        want = tref.flat_scatter(*state, alive, X, slot, valid, thresh, sign)
        runs = []
        for _ in range(2):
            got = [t.clone() for t in state]
            flags = t_fs.flat_scatter(*got, alive, X, slot, valid, thresh, sign=sign)
            torch.cuda.synchronize()
            runs.append((got, flags))
        for got, flags in runs:
            for name, g, w in zip(("LS", "LSe", "SS", "SSe", "N"), got, want[:5]):
                assert torch.equal(g, w), name
            assert torch.equal(flags, want[5])
        if case == "zero":  # slots no row reached still took the compensated add
            untouched = torch.ones(Lp, dtype=torch.bool, device=cuda_device)
            untouched[slot[valid].long()] = False
            assert not torch.equal(runs[0][0][0][untouched], state[0][untouched])

    def test_device_online_engine_replays(self, cuda_device, tmp_path):
        """A device-online engine on the card: CF parity against its host
        tree after every block, every pass's partition equal to the
        host-table pass on the same tree, and a kill-and-recover drill bit
        for bit."""
        from conftest import assert_same_partition
        from repro_torch import CheckpointStore

        blocks = _serving_blocks(8, 8)
        oracle, victim = (_card_engine(cuda_device, device_online=True) for _ in range(2))
        for i, b in enumerate(blocks[:4]):
            for eng in (oracle, victim):
                pids = eng.ingest(b)
                if i % 3 == 2:
                    eng.retire(pids[::4])
            leaf_ids, LS, SS, N = oracle._flat.host_cfs()
            order, srt = np.argsort(leaf_ids), np.sort(leaf_ids)
            np.testing.assert_array_equal(N[order], oracle.tree.N[srt])
            np.testing.assert_allclose(LS[order], oracle.tree.LS[srt], rtol=1e-6,
                                       atol=1e-6 * np.abs(oracle.tree.LS[srt]).max())
            if not oracle._flat.stale and oracle.snapshot is not None:
                ids, tLS, tSS, tN = oracle.tree.leaf_cf_buffers()
                host = oracle.backend.offline_recluster(tLS, tSS, tN, ids, 8)
                cap = oracle._flat.capture(oracle.tree.n_points)
                res, _, _, _ = cap.recluster(oracle.backend, min_pts=8, min_cluster_size=8.0)
                pos = {int(leaf): k for k, leaf in enumerate(ids)}
                rows = [pos[int(leaf)] for leaf in oracle._flat.leaf_of_slot[cap.slots]]
                assert_same_partition(res.labels, host.labels[rows])
        assert oracle.stats["device_online_blocks"] > 0
        store = CheckpointStore(str(tmp_path), keep=2)
        victim.save(store)
        recovered = _card_engine(cuda_device, device_online=True)
        recovered.restore(store)
        store.close()
        for eng in (oracle, recovered):
            _drive_card(eng, blocks[4:])
        a, b = oracle.snapshot, recovered.snapshot
        assert a.version == b.version > 1
        for u, v in zip(a.mst, b.mst):
            np.testing.assert_array_equal(u, v)
        for f in ("bubble_rep", "bubble_n", "center"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.result.labels, b.result.labels)


def _grid_case(case, rng, L, d):
    """A centred table for the grid's bitwise cases: random rows, copies of
    40 sites (distance ties everywhere), rank-1 rows, or all zeros (every
    row in one cell)."""
    if case == "dup":
        return _centred(rng, 40, d)[rng.integers(0, 40, size=L)]
    if case == "collinear":
        X = rng.uniform(-1.5, 1.5, size=(L, 1)) * rng.normal(size=(1, d))
        return (X - X.mean(axis=0)).astype(np.float32)
    if case == "zeros":
        return np.zeros((L, d), np.float32)
    return _centred(rng, L, d)


def _padded_grid(rep, *cols):
    """The table padded to a power of two with far invalid rows (as the
    offline pass pads it), its grid, and each of ``cols`` padded with 0."""
    from repro_torch.kernels import grid as t_grid

    L, d = rep.shape
    Lp = max(8, 1 << (L - 1).bit_length())
    rep_p = torch.cat([rep, torch.full((Lp - L, d), 1e6, device=rep.device)])
    valid = torch.arange(Lp, device=rep.device) < L
    padded = [torch.cat([c, torch.zeros(Lp - L, device=c.device)]) for c in cols]
    return rep_p, t_grid.build_grid(rep_p, valid), padded


@pytest.mark.cuda
class TestCudaGrid:
    """The grid's three kernels (``csrc/grid.cu``) bit for bit their dense
    counterparts on the valid rows: ``grid_assign`` the assign kernel,
    ``grid_core_distances`` the Eq. 6 kernels (warp-select and strip
    routes), ``boruvka_grid`` dense Borůvka on the panel's W of the same
    core distances.  L = 1001 is a multiple of no tile or block."""

    @pytest.mark.parametrize("case", ["spread", "dup", "collinear", "zeros"])
    @pytest.mark.parametrize("d", [2, 16, 200])
    def test_assign_equals_dense(self, cuda_device, case, d):
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(31)
        rep = _t(_grid_case(case, rng, 1001, d)).to(cuda_device)
        on = rep[torch.as_tensor(rng.integers(0, 1001, size=350), device=cuda_device)]
        q = torch.cat([on, _t(_centred(rng, 350, d)).to(cuda_device)])
        _, g, _ = _padded_grid(rep)
        t_grid.launches["grid_assign"] = 0
        idx, dist = t_grid.grid_assign(g, q)
        assert t_grid.launches["grid_assign"] == 1
        didx, ddist = t_assign.assign(q, rep, with_dist=True)
        assert torch.equal(idx, didx), int((idx != didx).sum())
        assert torch.equal(dist, ddist)

    @pytest.mark.parametrize("case", ["spread", "dup", "collinear"])
    @pytest.mark.parametrize("d", [2, 16, 200])
    @pytest.mark.parametrize("min_pts", [10, 100])
    def test_core_distances_equal_dense(self, cuda_device, case, d, min_pts):
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(32)
        rep = _t(_grid_case(case, rng, 1001, d)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=1001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=1001).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        got = t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, d)
        want = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
        assert torch.equal(got[:1001], want)
        assert bool((got[1001:] == 0).all())

    @pytest.mark.parametrize("d,min_pts", [(16, 1024), (16, 2000), (200, 2000), (3, 1500)])
    def test_core_distances_large_min_pts(self, cuda_device, d, min_pts):
        """Unit masses: the crossing is the min_pts-th row, so above 1024 the
        kernel's second round of selection carries the walk (the dense side
        is the strip route there)."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(33)
        rep = _t(_centred(rng, 3001, d)).to(cuda_device)
        ones = torch.ones(3001, device=cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=3001).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, ones, extent)
        got = t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, d)
        want = t_bcd.bubble_core_distances(rep, ones, extent, min_pts=min_pts, dim=d)
        assert torch.equal(got[:3001], want)

    @pytest.mark.parametrize("case", ["spread", "dup", "collinear", "zeros"])
    @pytest.mark.parametrize("d", [2, 16, 200])
    def test_boruvka_equals_dense(self, cuda_device, case, d):
        from repro_torch.core.mst import boruvka, boruvka_grid
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(34)
        rep = _t(_grid_case(case, rng, 1001, d)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=1001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=1001).astype(np.float32)).to(cuda_device)
        cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=5, dim=d)
        rep_p, g, (cd_p,) = _padded_grid(rep, cd)
        W = t_mr.mutual_reachability(rep_p, rep_p, cd_p, cd_p, zero_diag=True, n_valid=1001)
        want = boruvka(W)
        t_grid.launches["grid_round_minima"] = t_grid.launches["grid_round_minima_v1"] = 0
        got = boruvka_grid(g, cd_p)
        assert t_grid.launches["grid_round_minima"] == 11  # ceil(log2 1024) + 1 rounds
        assert t_grid.launches["grid_round_minima_v1"] == 0
        for name, a, b in zip(("eu", "ev", "ew", "valid"), got, want):
            assert torch.equal(a, b), name
        assert int(got[3].sum()) == 1000

    @pytest.mark.parametrize("L", [1, 5, 20, 33])
    def test_small_tables(self, cuda_device, L):
        """Tiles of fewer than 32 rows (Lp = 8, 16, 32) and a lone row: all
        three kernels bit for bit their dense counterparts."""
        from repro_torch.core.mst import boruvka, boruvka_grid
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(35)
        rep = _t(_centred(rng, L, 3)).to(cuda_device)
        n_b = torch.full((L,), 4.0, device=cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=L).astype(np.float32)).to(cuda_device)
        q = _t(_centred(rng, 70, 3)).to(cuda_device)
        rep_p, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        idx, dist = t_grid.grid_assign(g, q)
        didx, ddist = t_assign.assign(q, rep, with_dist=True)
        assert torch.equal(idx, didx) and torch.equal(dist, ddist)
        cd = t_grid.grid_core_distances(g, nb_p, ext_p, 3, 3)
        assert torch.equal(cd[:L], t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=3, dim=3))
        W = t_mr.mutual_reachability(rep_p, rep_p, cd, cd, zero_diag=True, n_valid=L)
        for a, b in zip(boruvka_grid(g, cd), boruvka(W)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("kernel", ["grid_assign", "grid_core_distances", "grid_round_minima"])
    def test_tf32_probe(self, cuda_device, kernel):
        """Fails if a grid kernel drops IEEE f32 products."""
        from repro_torch.kernels import grid as t_grid

        x, y, sq = _tf32_probe(np.random.default_rng(9), 256, 300)
        xt, yt = _t(x).to(cuda_device), _t(y).to(cuda_device)
        rep = torch.cat([xt, yt])
        r64 = rep.double().cpu().numpy()
        self_sq = ((r64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(self_sq, np.inf)
        if kernel == "grid_assign":
            _, g, _ = _padded_grid(yt)
            idx, dist = t_grid.grid_assign(g, xt)
            got = dist.double().cpu().numpy() ** 2
            want = sq[np.arange(256), idx.cpu().numpy()]
            assert (want <= sq.min(1) + 2e-5).all()
        elif kernel == "grid_core_distances":
            L = rep.shape[0]
            _, g, (ones, zeros) = _padded_grid(rep, torch.ones(L, device=cuda_device),
                                               torch.zeros(L, device=cuda_device))
            got = t_grid.grid_core_distances(g, ones, zeros, 2, 4)[:L].double().cpu().numpy() ** 2
            want = self_sq.min(1)
        else:
            L = rep.shape[0]
            _, g, (cd,) = _padded_grid(rep, torch.zeros(L, device=cuda_device))
            Lp = cd.shape[0]
            labels = torch.arange(Lp, device=cuda_device)
            hopeless = torch.zeros(Lp, dtype=torch.bool, device=cuda_device)
            w, _ = t_grid.grid_round_minima(g, t_grid._block_views(g), cd, labels, hopeless)
            got = w[:L].double().cpu().numpy() ** 2
            want = self_sq.min(1)
        assert np.abs(got - want).max() < 2e-5


def _round_case(case, rng, d):
    """(grid, core distances in original order) for the round kernels'
    cases: ``_grid_case``'s tables at L = 1001 padded as the offline pass
    pads them, and ``sparse``, a 1024-row table of which 300 rows, spread
    over the Morton order, are valid."""
    from repro_torch.kernels import grid as t_grid

    if case == "sparse":
        rep = _t(_centred(rng, 1024, d)).cuda()
        valid = torch.as_tensor(rng.permutation(1024) < 300).cuda()
        g = t_grid.build_grid(rep, valid)
        cd = _t(rng.uniform(0.0, 0.3, size=1024).astype(np.float32)).cuda()
        return g, cd
    rep = _t(_grid_case(case, rng, 1001, d)).cuda()
    n_b = _t(rng.integers(1, 6, size=1001).astype(np.float32)).cuda()
    extent = _t(rng.uniform(0.05, 0.5, size=1001).astype(np.float32)).cuda()
    cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=5, dim=d)
    _, g, (cd_p,) = _padded_grid(rep, cd)
    return g, cd_p


@pytest.mark.cuda
class TestCudaGridRound:
    """The Borůvka round's redesigned kernel (``csrc/grid_round.cu``, a
    prefetched tile ring and the walk split across a cluster) bit for bit
    its first kernel (``csrc/grid.cu``, ``grid_round_minima_v1``) in w and
    eid: in every round of ``boruvka_grid``'s passes, at every cluster size,
    with most rows invalid, in an all-hopeless round, at each compiled width
    (d = 2, 5, 16: 16 features; 17: 32; 40: 64; 100: 128; 200: two slices of
    128), and with the cluster's ranks visiting tiles past the order's end
    (tiny tables)."""

    @pytest.mark.parametrize("case,d", [(c, d) for c in ("spread", "dup", "collinear", "zeros", "sparse")
                                        for d in (2, 16, 200)]
                             + [("spread", d) for d in (5, 17, 40, 100)])
    def test_every_round_equals_v1(self, cuda_device, monkeypatch, case, d):
        from repro_torch.core.mst import boruvka_grid
        from repro_torch.kernels import grid as t_grid

        g, cd = _round_case(case, np.random.default_rng(36), d)
        want = boruvka_grid(g, cd)
        search, seen = t_grid.grid_round_minima, []

        def both(grid, views, cd, labels, hopeless, blocks=None):
            got = search(grid, views, cd, labels, hopeless, blocks=blocks)
            old = t_grid.grid_round_minima_v1(grid, views, cd, labels, hopeless, blocks=blocks)
            for c in (1, 2, 4):
                other = search(grid, views, cd, labels, hopeless, blocks, cluster=c)
                assert all(torch.equal(a, b) for a, b in zip(other, old)), (len(seen), c)
            assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1]), len(seen)
            seen.append(int((grid.valid & ~hopeless[grid.orig.long()]).sum()))
            return got

        monkeypatch.setattr(t_grid, "grid_round_minima", both)
        got = boruvka_grid(g, cd)
        assert len(seen) == 11 and seen[-1] == 0, seen  # the last rounds have no live row
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("d", [16, 200])
    def test_all_hopeless_round(self, cuda_device, d):
        from repro_torch.kernels import grid as t_grid

        g, cd = _round_case("spread", np.random.default_rng(37), d)
        views = t_grid._block_views(g)
        Lp = cd.shape[0]
        labels = torch.zeros(Lp, dtype=torch.int64, device=cuda_device)
        hopeless = torch.ones(Lp, dtype=torch.bool, device=cuda_device)
        t_grid.track_visits(True, torch.device(cuda_device))
        try:
            w, e = t_grid.grid_round_minima(g, views, cd, labels, hopeless)
            visits = t_grid.visit_counts()
        finally:
            t_grid.track_visits(False)
        assert bool(torch.isinf(w).all()) and bool((e == 2**31 - 1).all())
        assert visits["grid_round_minima"] == 0 and visits["grid_round_longest"] == 0
        ow, oe = t_grid.grid_round_minima_v1(g, views, cd, labels, hopeless)
        assert torch.equal(w, ow) and torch.equal(e, oe)

    @pytest.mark.parametrize("L", [1, 5, 20, 33, 100])
    def test_small_tables(self, cuda_device, L):
        """One to four tiles of fewer than 32 rows: the ranks of a cluster of
        up to 8 start past the order's end."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(38)
        rep = _t(_centred(rng, L, 3)).to(cuda_device)
        _, g, (cd,) = _padded_grid(rep, _t(rng.uniform(0.0, 0.2, size=L).astype(np.float32)).to(cuda_device))
        Lp = cd.shape[0]
        views = t_grid._block_views(g)
        labels = torch.as_tensor(rng.integers(0, 3, size=Lp), device=cuda_device)
        hopeless = torch.zeros(Lp, dtype=torch.bool, device=cuda_device)
        want = t_grid.grid_round_minima_v1(g, views, cd, labels, hopeless)
        for c in (1, 2, 4, 8):
            got = t_grid.grid_round_minima(g, views, cd, labels, hopeless, None, cluster=c)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), c

    def test_visits_at_one_cta_equal_v1(self, cuda_device):
        """At a cluster of one the kernel walks as the first kernel does: the
        same row-tile visits; a larger cluster visits at least as many."""
        from repro_torch.kernels import grid as t_grid

        g, cd = _round_case("spread", np.random.default_rng(39), 16)
        views = t_grid._block_views(g)
        Lp = cd.shape[0]
        labels = torch.arange(Lp, device=cuda_device)
        hopeless = torch.zeros(Lp, dtype=torch.bool, device=cuda_device)
        counts = {}
        for name, c in (("v1", None), ("c1", 1), ("c4", 4)):
            t_grid.track_visits(True, torch.device(cuda_device))
            try:
                if c is None:
                    t_grid.grid_round_minima_v1(g, views, cd, labels, hopeless)
                else:
                    t_grid.grid_round_minima(g, views, cd, labels, hopeless, None, cluster=c)
                counts[name] = t_grid.visit_counts()
            finally:
                t_grid.track_visits(False)
        assert counts["c1"]["grid_round_minima"] == counts["v1"]["grid_round_minima"] > 0
        assert counts["c4"]["grid_round_minima"] >= counts["c1"]["grid_round_minima"]
        assert 0 < counts["c4"]["grid_round_longest"] <= counts["c1"]["grid_round_longest"]


def _assign_visits(fn):
    """(row-tile visits, longest walk of a CTA) of the assign kernels during
    one call of ``fn``."""
    from repro_torch.kernels import grid as t_grid

    t_grid.track_visits(True, torch.device("cuda"))
    try:
        fn()
        got = t_grid.visit_counts()
    finally:
        t_grid.track_visits(False)
    return got["grid_assign"], got["grid_assign_longest"]


@pytest.mark.cuda
class TestCudaGridAssign:
    """The spatial index's redesigned nearest-rep search
    (``csrc/grid_assign.cu``: a thread a row, a prefetched tile ring that
    carries the tile's columns, the walk split across a cluster) bit for bit
    its first kernel (``csrc/grid.cu``, ``grid_assign_v1``) and the dense
    assign kernel, idx and dist: at every cluster size, each compiled width
    (d = 2: 4-byte copies, 16 in registers, 40: 64 from shared memory, 200:
    two slices of 128), ragged query counts, a table with no valid row, and
    its visits and longest walk at one CTA a block equal to the first
    kernel's."""

    @pytest.mark.parametrize("case", ["spread", "dup", "collinear", "zeros"])
    @pytest.mark.parametrize("d", [2, 16, 40, 200])
    def test_equals_v1_and_dense(self, cuda_device, case, d):
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(41)
        rep = _t(_grid_case(case, rng, 1001, d)).to(cuda_device)
        on = rep[torch.as_tensor(rng.integers(0, 1001, size=350), device=cuda_device)]
        q = torch.cat([on, _t(_centred(rng, 350, d)).to(cuda_device)])
        _, g, _ = _padded_grid(rep)
        didx, ddist = t_assign.assign(q, rep, with_dist=True)
        oidx, odist = t_grid.grid_assign_v1(g, q)
        assert torch.equal(oidx, didx) and torch.equal(odist, ddist)
        for c in t_grid.CLUSTERS:
            t_grid.launches["grid_assign"] = t_grid.launches["grid_assign_v1"] = 0
            idx, dist = t_grid.grid_assign(g, q, cluster=c)
            assert t_grid.launches["grid_assign"] == 1 and t_grid.launches["grid_assign_v1"] == 0
            assert torch.equal(idx, oidx), (c, int((idx != oidx).sum()))
            assert torch.equal(dist, odist), c

    @pytest.mark.parametrize("B", [1, 63, 65, 4097])
    def test_ragged_query_counts(self, cuda_device, B):
        """The last block's rows past B are not live: the same bits as the
        first kernel at every cluster size, visits counted over live rows
        only (equal to the first kernel's at one CTA a block)."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(42)
        rep = _t(_centred(rng, 3001, 16)).to(cuda_device)
        q = _t(_centred(rng, B, 16)).to(cuda_device)
        _, g, _ = _padded_grid(rep)
        want = t_grid.grid_assign_v1(g, q)
        didx, ddist = t_assign.assign(q, rep, with_dist=True)
        assert torch.equal(want[0], didx) and torch.equal(want[1], ddist)
        for c in t_grid.CLUSTERS:
            got = t_grid.grid_assign(g, q, cluster=c)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), c
        assert _assign_visits(lambda: t_grid.grid_assign(g, q, cluster=1)) == \
            _assign_visits(lambda: t_grid.grid_assign_v1(g, q))

    @pytest.mark.parametrize("d", [2, 16, 200])
    def test_no_valid_row(self, cuda_device, d):
        """A table with no valid row: Lp and +inf for every query, and no
        visit (the first bound is +inf)."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(43)
        rep = _t(_centred(rng, 256, d)).to(cuda_device)
        g = t_grid.build_grid(rep, torch.zeros(256, dtype=torch.bool, device=cuda_device))
        q = _t(_centred(rng, 100, d)).to(cuda_device)
        for c in t_grid.CLUSTERS:
            visits = []

            def call(c=c):
                visits.append(t_grid.grid_assign(g, q, cluster=c))

            assert _assign_visits(call) == (0, 0)
            idx, dist = visits[0]
            assert bool((idx == 256).all()) and bool(torch.isinf(dist).all())
        oidx, odist = t_grid.grid_assign_v1(g, q)
        assert torch.equal(oidx, idx) and torch.equal(odist, dist)

    @pytest.mark.parametrize("L", [1, 5, 20, 33, 100])
    def test_small_tables(self, cuda_device, L):
        """One to four tiles of fewer than 32 rows (odd valid-byte spans):
        the ranks of a cluster start past the order's end."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(44)
        rep = _t(_centred(rng, L, 3)).to(cuda_device)
        q = _t(_centred(rng, 70, 3)).to(cuda_device)
        _, g, _ = _padded_grid(rep)
        want = t_grid.grid_assign_v1(g, q)
        didx, ddist = t_assign.assign(q, rep, with_dist=True)
        assert torch.equal(want[0], didx) and torch.equal(want[1], ddist)
        for c in t_grid.CLUSTERS:
            got = t_grid.grid_assign(g, q, cluster=c)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), c

    def test_visits_at_one_cta_equal_v1(self, cuda_device):
        """At a cluster of one the kernel walks as the first kernel does: the
        same row-tile visits and longest walk; a larger cluster visits at
        least as many tiles in all and walks no further."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(45)
        rep = _t(_grid_case("spread", rng, 4001, 16)).to(cuda_device)
        q = _t(_centred(rng, 8192, 16)).to(cuda_device)
        _, g, _ = _padded_grid(rep)
        v1 = _assign_visits(lambda: t_grid.grid_assign_v1(g, q))
        c1 = _assign_visits(lambda: t_grid.grid_assign(g, q, cluster=1))
        c8 = _assign_visits(lambda: t_grid.grid_assign(g, q, cluster=8))
        assert c1 == v1 and v1[0] > 0 and v1[1] > 0
        assert c8[0] >= c1[0] and 0 < c8[1] <= c1[1]

    def test_path_never_launches_v1(self, cuda_device):
        """``ops.assign(..., spatial_index=True)`` launches the new kernel
        once a call and the first kernel never, with the dense bits."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(46)
        rep = _t(_centred(rng, 1001, 16)).to(cuda_device)
        q = _t(_centred(rng, 500, 16)).to(cuda_device)
        t_grid.launches["grid_assign"] = t_grid.launches["grid_assign_v1"] = 0
        gi, gd = tops.assign(q, rep, with_dist=True, spatial_index=True)
        assert t_grid.launches["grid_assign"] == 1 and t_grid.launches["grid_assign_v1"] == 0
        di, dd = t_assign.assign(q, rep, with_dist=True)
        assert torch.equal(gi, di) and torch.equal(gd, dd)


def _cd_visits(fn):
    """(row-tile visits, longest walk of a CTA) of the Eq. 6 kernels during
    one call of ``fn``."""
    from repro_torch.kernels import grid as t_grid

    t_grid.track_visits(True, torch.device("cuda"))
    try:
        fn()
        got = t_grid.visit_counts()
    finally:
        t_grid.track_visits(False)
    return got["grid_core_distances"], got["grid_core_longest"]


@pytest.mark.cuda
class TestCudaGridCoreDistances:
    """The spatial index's redesigned Eq. 6 search (``csrc/grid_cd.cu``: the
    walk split across a cluster that stops on the cluster's k-th, a thread a
    row with its first k keys in registers up to k = 16, the first kernel's
    warp-select queues above) bit for bit its first kernel (``csrc/grid.cu``,
    ``grid_core_distances_v1``) and the dense ``bubble_cd``: at every cluster
    size, each compiled width (d = 2: 4-byte copies, 16 in registers, 40: 64
    from shared memory, 200: two slices of 128), min_pts on both sides of
    the register lists' edges (12 and 16 slots) and of the queue's 1024 (unit masses there, so
    the crossing is the min_pts-th row and a second round of selection
    carries the walk), block ranges, a table with fewer valid rows than
    min_pts, and its visits at one CTA a block against the first kernel's."""

    @pytest.mark.parametrize("min_pts", [1, 2, 10, 12, 13, 16, 17, 100, 1024, 1025, 2000])
    @pytest.mark.parametrize("case", ["spread", "dup", "collinear", "zeros"])
    @pytest.mark.parametrize("d", [2, 16, 40, 200])
    def test_equals_v1_and_dense(self, cuda_device, case, d, min_pts):
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(51)
        L = 3001 if min_pts >= 1024 else 1001
        rep = _t(_grid_case(case, rng, L, d)).to(cuda_device)
        masses = np.ones(L) if min_pts >= 1024 else rng.integers(1, 6, size=L)
        n_b = _t(masses.astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=L).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        want = t_grid.grid_core_distances_v1(g, nb_p, ext_p, min_pts, d)
        dense = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
        assert torch.equal(want[:L], dense), int((want[:L] != dense).sum())
        for c in t_grid.CLUSTERS:
            t_grid.launches["grid_core_distances"] = t_grid.launches["grid_core_distances_v1"] = 0
            got = t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, d, cluster=c)
            assert t_grid.launches["grid_core_distances"] == 1 and t_grid.launches["grid_core_distances_v1"] == 0
            assert torch.equal(got, want), (c, int((got != want).sum()))

    @pytest.mark.parametrize("min_pts", [10, 17, 100, 2000])
    def test_block_ranges(self, cuda_device, min_pts):
        """Each block range at every cluster size: bit for bit the same rows
        of the whole launch and the first kernel's range."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(52)
        rep = _t(_grid_case("spread", rng, 3001, 16)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=3001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=3001).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        views = t_grid._block_views(g)
        whole = t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, 16, views)[g.orig.long()]  # sorted order
        NB = views.order.shape[0]
        for b0, b1 in ((0, 1), (0, NB), (5, 17), (NB - 1, NB), (30, 47)):
            want = t_grid.grid_core_distances_v1(g, nb_p, ext_p, min_pts, 16, views, blocks=(b0, b1))
            assert torch.equal(want, whole[b0 * 64 : b1 * 64]), (b0, b1)
            for c in t_grid.CLUSTERS:
                got = t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, 16, views, blocks=(b0, b1), cluster=c)
                assert torch.equal(got, want), (b0, b1, c)

    @pytest.mark.parametrize("min_pts,unit", [(30, True), (50, False), (2000, True)])
    def test_fewer_valid_rows_than_min_pts(self, cuda_device, min_pts, unit):
        """20 valid rows in a 32-row table: with unit masses the walk ends
        short of min_pts and the last entry plays the crossing bubble (the
        first kernel's rule); with masses of 4 it crosses within the 20
        rows, also bit for bit the dense kernel."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(53)
        rep = _t(_centred(rng, 20, 3)).to(cuda_device)
        n_b = torch.full((20,), 1.0 if unit else 4.0, device=cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=20).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        want = t_grid.grid_core_distances_v1(g, nb_p, ext_p, min_pts, 3)
        assert bool(torch.isfinite(want).all()) and bool((want[:20] > 0).all())
        if not unit:
            assert torch.equal(want[:20], t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=3))
        for c in t_grid.CLUSTERS:
            assert torch.equal(t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, 3, cluster=c), want), c

    @pytest.mark.parametrize("min_pts", [10, 100])
    def test_visits_at_one_cta(self, cuda_device, min_pts):
        """At a cluster of one the register route's exact k-th stops no later
        than the first kernel's queued one (at most its visits and walk); the
        warp-select route walks as the first kernel does; a cluster of 8
        walks no further than one CTA."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(54)
        rep = _t(_grid_case("spread", rng, 6001, 16)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=6001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=6001).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        v1 = _cd_visits(lambda: t_grid.grid_core_distances_v1(g, nb_p, ext_p, min_pts, 16))
        c1 = _cd_visits(lambda: t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, 16, cluster=1))
        c8 = _cd_visits(lambda: t_grid.grid_core_distances(g, nb_p, ext_p, min_pts, 16, cluster=8))
        assert v1[0] > 0 and v1[1] > 0
        if min_pts <= 16:
            assert c1[0] <= v1[0] and c1[1] <= v1[1]
        else:
            assert c1 == v1
        assert 0 < c8[1] <= c1[1]

    def test_path_never_launches_v1(self, cuda_device):
        """``ops.bubble_core_distances(spatial_index=True)`` launches the new
        kernel once a call and the first kernel never, with the dense bits."""
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(55)
        rep = _t(_centred(rng, 1001, 16)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=1001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=1001).astype(np.float32)).to(cuda_device)
        t_grid.launches["grid_core_distances"] = t_grid.launches["grid_core_distances_v1"] = 0
        got = tops.bubble_core_distances(rep, n_b, extent, 10, spatial_index=True)
        assert t_grid.launches["grid_core_distances"] == 1 and t_grid.launches["grid_core_distances_v1"] == 0
        assert torch.equal(got, tops.bubble_core_distances(rep, n_b, extent, 10))


def _fma_probe_rows(rng, d=4):
    """Two f32 rows whose diff-form squared sum rounds differently when the
    last ``acc + diff * diff`` is contracted into one fused multiply-add:
    the kernel must give the unfused bits of the plain version."""
    for _ in range(100_000):
        a = rng.normal(size=(2, d)).astype(np.float32)
        diff = (a[0] - a[1]).astype(np.float32)
        acc = np.float32(0.0)
        for k in range(d - 1):
            acc = np.float32(acc + np.float32(diff[k] * diff[k]))
        unfused = np.float32(acc + np.float32(diff[-1] * diff[-1]))
        fused = np.float32(np.float64(acc) + np.float64(diff[-1]) * np.float64(diff[-1]))
        if unfused != fused:
            return a
    raise AssertionError("no FMA probe found")


@pytest.mark.cuda
class TestCudaDynamic:
    """The exact-dynamic engine's strip kernels bit for bit their plain
    versions: the distances and the top-k (``csrc/strip_tiles.cu``) also
    bit for bit their first kernels (``csrc/dynamic.cu``, the wrappers
    ``strip_dists_v1`` / ``strip_topk_v1``), each wrapper one launch a call
    with the first kernels' counters left at 0: ragged U and Np (multiples
    of no tile), d from 1 to 200, tie heavy integer grids, K not a multiple
    of 32 and past the 1024 queue, an FMA probe, a write into a row slice at
    an offset that is no multiple of 16 bytes, strips whose rows start at
    every alignment, invalid rows, fewer live columns than K, a row's own
    index at every place of a 16-byte load; the factor kernel of the round
    minima (``csrc/strip_minima.cu``) bit for bit its plain version and the
    first kernel fed the SW and smask built from the same factors (U = 1,
    ragged shapes, invalid rows, ties, one component, repeated strip ids, an
    E at int32's limit, an unaligned strip); then a small engine on the card
    against the same engine on the CPU, state for state."""

    @staticmethod
    def _dists_three_ways(t_dyn, r, x, out=None):
        """The new kernel (one launch, the first kernel's counter untouched)
        against the plain version on the card and the CPU and the first
        kernel."""
        for k in ("strip_dists", "strip_dists_v1"):
            t_dyn.launches[k] = 0
        got = t_dyn.strip_dists(r, x, out=out)
        assert t_dyn.launches["strip_dists"] == 1 and t_dyn.launches["strip_dists_v1"] == 0
        assert torch.equal(got, tref.strip_dists(r, x))
        assert torch.equal(got.cpu(), tref.strip_dists(r.cpu(), x.cpu()))
        assert torch.equal(got, t_dyn.strip_dists_v1(r, x))
        return got

    @staticmethod
    def _topk_three_ways(t_dyn, D, row_ids, valid, alive, K):
        """The new kernel (one launch, the first kernel's counter untouched)
        against the plain version and the first kernel."""
        for k in ("strip_topk", "strip_topk_v1"):
            t_dyn.launches[k] = 0
        gd, gi = t_dyn.strip_topk(D, row_ids, valid, alive, K)
        assert t_dyn.launches["strip_topk"] == 1 and t_dyn.launches["strip_topk_v1"] == 0
        wd, wi = tref.strip_topk(D, row_ids, valid, alive, K)
        assert torch.equal(gd, wd) and torch.equal(gi, wi)
        vd, vi = t_dyn.strip_topk_v1(D, row_ids, valid, alive, K)
        assert torch.equal(gd, vd) and torch.equal(gi, vi)
        return gd, gi

    @pytest.mark.parametrize("case", ["spread", "grid", "offset"])
    @pytest.mark.parametrize("shape", [(37, 1001, 3), (64, 128, 16), (5, 77, 40), (129, 1001, 1), (300, 4099, 16),
                                       (131, 257, 17), (77, 130, 200)])
    def test_strip_dists_bitwise(self, cuda_device, case, shape):
        from repro_torch.kernels import dynamic as t_dyn

        U, Np, d = shape
        rng = np.random.default_rng(41)
        if case == "grid":
            X = rng.integers(-4, 5, size=(Np, d)).astype(np.float32)
        else:
            X = (rng.normal(size=(Np, d)) * 3 + (1e3 if case == "offset" else 0)).astype(np.float32)
        rows = X[rng.integers(0, Np, size=U)]
        x, r = _t(X).to(cuda_device), _t(rows).to(cuda_device)
        self._dists_three_ways(t_dyn, r, x)

    @pytest.mark.parametrize("d", [4, 16, 17, 40])
    def test_strip_dists_fma_probe(self, cuda_device, d):
        from repro_torch.kernels import dynamic as t_dyn

        a = _t(_fma_probe_rows(np.random.default_rng(d), d)).to(cuda_device)
        self._dists_three_ways(t_dyn, a[:1], a)

    @pytest.mark.parametrize("Np,row0", [(1001, 1), (1001, 5), (1003, 3), (4096, 1), (130, 2)])
    def test_strip_dists_out_row_slice(self, cuda_device, Np, row0):
        """``out=`` a row slice of a larger strip starting at an offset that
        is no multiple of 16 bytes (odd Np: every row's alignment differs);
        the rows around it are untouched."""
        from repro_torch.kernels import dynamic as t_dyn

        rng = np.random.default_rng(Np + row0)
        U = 133
        X = (rng.normal(size=(Np, 16)) * 3 + 50).astype(np.float32)
        x = _t(X).to(cuda_device)
        r = x[torch.as_tensor(rng.integers(0, Np, size=U), device=cuda_device)]
        buf = torch.full((row0 + U + 2, Np), -7.0, device=cuda_device)
        self._dists_three_ways(t_dyn, r, x, out=buf[row0 : row0 + U])
        assert torch.equal(buf[row0 : row0 + U], tref.strip_dists(r, x))
        assert bool((buf[:row0] == -7.0).all()) and bool((buf[row0 + U :] == -7.0).all())

    @pytest.mark.parametrize("case", ["spread", "grid"])
    @pytest.mark.parametrize("K", [1, 10, 33, 100, 1024, 1025, 1500, 2000])
    def test_strip_topk_bitwise(self, cuda_device, case, K):
        from repro_torch.kernels import dynamic as t_dyn

        rng = np.random.default_rng(K)
        U, Np = 45, 2051
        X = (rng.integers(-3, 4, size=(Np, 3)) if case == "grid" else rng.normal(size=(Np, 3))).astype(np.float32)
        ids = rng.integers(0, Np, size=U)
        x = _t(X).to(cuda_device)
        D = tref.strip_dists(x[torch.as_tensor(ids, device=cuda_device)], x)
        row_ids = torch.as_tensor(ids, device=cuda_device)
        valid = torch.as_tensor(rng.random(U) < 0.9, device=cuda_device)
        alive = torch.as_tensor(rng.random(Np) < 0.8, device=cuda_device)
        self._topk_three_ways(t_dyn, D, row_ids, valid, alive, K)

    @pytest.mark.parametrize("K", [10, 100, 1025])
    @pytest.mark.parametrize("Np", [2049, 2050, 2051, 2052])
    @pytest.mark.parametrize("view", [0, 1, 2, 3])
    def test_strip_topk_rows_at_every_alignment(self, cuda_device, Np, view, K):
        """Np % 4 in {1, 2, 3, 0} and a strip that starts ``view`` floats into
        its storage (the insert's ``D_strip[Bp:]``): rows start at every
        alignment, so the head, the 16-byte body and the tail all vary;
        ``alive`` starts an odd byte into its storage; each row's own index
        sits at every place of a 16-byte load and in the head and tail, on
        a tie-heavy grid where its distance 0 is the row's minimum."""
        from repro_torch.kernels import dynamic as t_dyn

        rng = np.random.default_rng([Np, view, K])
        U = 61
        X = rng.integers(-3, 4, size=(Np, 2)).astype(np.float32)
        ids = np.concatenate([np.arange(8), Np - 1 - np.arange(8), rng.integers(0, Np, size=U - 16)])
        x = _t(X).to(cuda_device)
        row_ids = torch.as_tensor(ids, device=cuda_device)
        D = tref.strip_dists(x[row_ids], x)
        buf = torch.empty(D.numel() + view, device=cuda_device)
        Dv = buf[view:].view(U, Np).copy_(D)
        live = torch.zeros(Np + 1, dtype=torch.bool, device=cuda_device)
        alive = live[1:].copy_(torch.as_tensor(rng.random(Np) < 0.7, device=cuda_device))
        alive[row_ids[:16]] = True
        valid = torch.ones(U, dtype=torch.bool, device=cuda_device)
        gd, gi = self._topk_three_ways(t_dyn, Dv, row_ids, valid, alive, K)
        assert not bool((gi == row_ids[:, None].int()).any())

    @pytest.mark.parametrize("K", [1, 10, 1025, 2000])
    def test_strip_topk_invalid_rows_and_few_live(self, cuda_device, K):
        """Every row invalid: (+inf, −1) throughout; then 5 live columns,
        fewer than K, and a mix of valid rows."""
        from repro_torch.kernels import dynamic as t_dyn

        rng = np.random.default_rng(K)
        U, Np = 40, 3001
        x = _t(rng.normal(size=(Np, 4)).astype(np.float32)).to(cuda_device)
        row_ids = torch.as_tensor(rng.integers(0, Np, size=U), device=cuda_device)
        D = tref.strip_dists(x[row_ids], x)
        alive = torch.ones(Np, dtype=torch.bool, device=cuda_device)
        gd, gi = self._topk_three_ways(t_dyn, D, row_ids, torch.zeros(U, dtype=torch.bool, device=cuda_device),
                                       alive, K)
        assert bool(torch.isinf(gd).all()) and bool((gi == -1).all())
        few = torch.zeros(Np, dtype=torch.bool, device=cuda_device)
        few[torch.as_tensor(rng.choice(Np, size=5, replace=False), device=cuda_device)] = True
        valid = torch.as_tensor(rng.random(U) < 0.5, device=cuda_device)
        gd, gi = self._topk_three_ways(t_dyn, D, row_ids, valid, few, K)
        assert bool((gi[:, 5:] == -1).all())

    @pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
    @pytest.mark.parametrize("shape", [(10, 48), (333, 1001)])
    def test_strip_round_minima_bitwise(self, cuda_device, ties, shape):
        from repro_torch.kernels import dynamic as t_dyn

        U, n = shape
        rng = np.random.default_rng(U)
        SW = (rng.integers(1, 5, size=(U, n)) if ties else rng.random((U, n))).astype(np.float32)
        sids = rng.permutation(n)[:U]
        smask = (rng.random((U, n)) < 0.5) & (np.arange(n)[None, :] != sids[:, None])
        SW = np.where(smask, SW, np.inf).astype(np.float32)
        lab = rng.integers(0, max(2, n // 7), size=n)
        args = [_t(a).to(cuda_device) for a in (SW, smask, sids, lab)]
        t_dyn.launches["strip_round_minima"] = 0
        got = t_dyn.strip_round_minima(*args, E=n)
        assert t_dyn.launches["strip_round_minima"] == 1
        want = tref.strip_round_minima(args[0], args[1], args[2], args[3], n)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @staticmethod
    def _minima_factors(U, n, labels, ties=False, valid=1.0, repeat=False, seed=0):
        """A strip's factors: distances (small integers with ``ties``), core
        distances, strip ids (repeated when ``repeat``), row validity, live
        columns and the round's labels (node ids in [0, n))."""
        rng = np.random.default_rng([U, n, seed])
        D = (rng.integers(0, 4, size=(U, n)) if ties else rng.random((U, n)) * 3).astype(np.float32)
        cd = (rng.integers(0, 3, size=n) if ties else rng.random(n)).astype(np.float32)
        cd[rng.random(n) < 0.05] = np.inf  # rows with fewer than min_pts live neighbours
        sids = rng.integers(0, n, size=U) if repeat or U > n else rng.permutation(n)[:U]
        lab = {"round1": np.arange(n), "merged": np.arange(n) // max(1, n // 7) * max(1, n // 7),
               "random": rng.integers(0, max(2, n // 7), size=n), "one": np.zeros(n, np.int64)}[labels]
        return D, cd, sids, rng.random(U) < valid, rng.random(n) < 0.7, lab

    @staticmethod
    def _old_route(D, cd, sids, row_valid, alive, lab, E):
        """The first kernel on the SW and smask the update used to build."""
        from repro_torch.kernels import dynamic as t_dyn

        iota = torch.arange(D.shape[1], device=D.device)
        smask = row_valid[:, None] & alive[None, :] & (iota[None, :] != sids[:, None].long())
        SW = torch.maximum(torch.maximum(D, cd[sids.long()][:, None]), cd[None, :])
        SW.masked_fill_(~smask, float("inf"))
        return t_dyn.strip_round_minima(SW, smask, sids, lab, E)

    @pytest.mark.parametrize("case", [
        dict(U=1, n=48, labels="round1"),
        dict(U=333, n=1001, labels="random"),  # U and n multiples of no tile, n of 4 neither
        dict(U=517, n=2052, labels="merged", ties=True),
        dict(U=700, n=1536, labels="round1", valid=0.3),
        dict(U=64, n=640, labels="random", valid=0.0),  # every row invalid
        dict(U=260, n=1024, labels="one", ties=True),  # one component: nothing active
        dict(U=300, n=96, labels="random", ties=True, repeat=True),  # repeated strip ids: payloads break ties
        dict(U=1100, n=4100, labels="merged", valid=0.8),  # more rows than one chunk stages
    ], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
    def test_strip_round_minima_from_dists_bitwise(self, cuda_device, case):
        """The factor kernel bit for bit its plain version (on the card and
        on the CPU) and the first kernel on the SW and smask built from the
        same factors; one launch a call."""
        from repro_torch.kernels import dynamic as t_dyn

        U, n = case["U"], case["n"]
        f = [_t(a).to(cuda_device) for a in self._minima_factors(**case)]
        E = n + 3
        t_dyn.launches["strip_round_minima_from_dists"] = 0
        got = t_dyn.strip_round_minima_from_dists(*f, E=E)
        assert t_dyn.launches["strip_round_minima_from_dists"] == 1
        plain = tref.strip_round_minima_from_dists(*f, E=E)
        host = tref.strip_round_minima_from_dists(*(a.cpu() for a in f), E=E)
        old = self._old_route(*f, E)
        for g, p, h, o in zip(got, plain, host, old):
            assert g.dtype == p.dtype and torch.equal(g, p) and torch.equal(g.cpu(), h) and torch.equal(g, o)
        assert got[0].shape == (U,) and got[3].shape == (n,)

    def test_strip_round_minima_from_dists_payload_limit(self, cuda_device):
        """An E that puts the last payload at int32's limit."""
        from repro_torch.kernels import dynamic as t_dyn

        U, n = 40, 777
        f = [_t(a).to(cuda_device) for a in self._minima_factors(U, n, "random", valid=0.9)]
        E = 2**31 - 1 - U * n
        got = t_dyn.strip_round_minima_from_dists(*f, E=E)
        want = self._old_route(*f, E)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="int32"):
            t_dyn.strip_round_minima_from_dists(*f, E=E + 1)

    def test_strip_round_minima_from_dists_offset_view(self, cuda_device):
        """A strip that starts 4 bytes into its storage (no 16-byte loads)."""
        from repro_torch.kernels import dynamic as t_dyn

        D, cd, sids, rv, alive, lab = (_t(a).to(cuda_device) for a in self._minima_factors(90, 512, "random"))
        buf = torch.empty(D.numel() + 1, device=cuda_device)
        Dv = buf[1:].view(D.shape).copy_(D)
        got = t_dyn.strip_round_minima_from_dists(Dv, cd, sids, rv, alive, lab, E=7)
        for g, w in zip(got, tref.strip_round_minima_from_dists(D, cd, sids, rv, alive, lab, E=7)):
            assert torch.equal(g, w)

    def test_engine_on_the_card_equals_the_cpu(self, cuda_device):
        """A DynamicTorchHDBSCAN on the card and one on the CPU through the
        same inserts, deletes and a rebuild: every state field equal."""
        from repro_torch.core.dynamic_torch import DynamicTorchHDBSCAN
        from repro_torch.kernels import dynamic as t_dyn

        rng = np.random.default_rng(5)
        X0, X = rng.normal(size=(300, 16)), rng.normal(size=(12, 16))
        card = DynamicTorchHDBSCAN(10, 16, capacity=512, device=cuda_device)
        host = DynamicTorchHDBSCAN(10, 16, capacity=512, device="cpu")
        for k in t_dyn.launches:
            t_dyn.launches[k] = 0
        for h in (card, host):
            h.load(X0)
        for h in (card, host):
            h.insert_block(X)
            h.delete_block(list(range(0, 24, 2)))
            for i in range(3):  # more insert blocks: RkNN rows of partial validity
                h.insert_block(X[i::3] + 0.05 * (i + 1))
        # the update's Borůvka takes the factor route and the strips the redesigned kernels; the first kernels
        # are their oracles only
        oracles = ("strip_round_minima", "strip_dists_v1", "strip_topk_v1")
        assert all(t_dyn.launches[k] == 0 for k in oracles), t_dyn.launches
        assert all(v > 0 for k, v in t_dyn.launches.items() if k not in oracles), t_dyn.launches
        for f in card.state._fields:
            assert torch.equal(getattr(card.state, f).cpu(), getattr(host.state, f)), f

    def test_incremental_update_takes_card_tensors(self, cuda_device):
        """ops.incremental_update with the block already on the card: the
        same state as the CPU's from host arrays."""
        from repro_torch.core.dynamic_torch import DynamicTorchHDBSCAN

        rng = np.random.default_rng(6)
        X0, P = rng.normal(size=(200, 16)), rng.normal(size=(8, 16)).astype(np.float32)
        card = DynamicTorchHDBSCAN(10, 16, capacity=256, device=cuda_device)
        host = DynamicTorchHDBSCAN(10, 16, capacity=256, device="cpu")
        for h in (card, host):
            h.load(X0)
        slots, valid = np.arange(200, 208), np.ones(8, bool)
        got = tops.incremental_update(card.state, insert=_t(P).to(cuda_device),
                                      slots=torch.as_tensor(slots, device=cuda_device),
                                      valid=torch.as_tensor(valid, device=cuda_device), min_pts=10)
        want = tops.incremental_update(host.state, insert=P, slots=slots, valid=valid, min_pts=10)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
class TestCudaMesh:
    """The sharded offline pass's strip launches (``mesh=``) bit for bit
    the same rows of the whole launch: bubble_cd on both routes over row
    ranges, the distance panel with a global ``row0`` (aligned and
    unaligned strips, so both store plans), the grid's Eq. 6 and Borůvka
    round over block ranges (a tie-heavy table too); then the sharded pass
    on ``("cuda:0",) * k`` bit for bit the unsharded one, dense and
    spatial, and ``boruvka_shard``'s buffers ``boruvka``'s."""

    @staticmethod
    def _ranges(n):
        from repro_torch.launch.mesh import shard_ranges

        return [r for k in (2, 3, 8) for r in shard_ranges(n, k)] + [(5, 6), (1, n - 3)]

    @pytest.mark.parametrize("d,min_pts", [(16, 10), (16, 2000), (200, 10)])
    def test_bubble_cd_rows(self, cuda_device, d, min_pts):
        rng = np.random.default_rng(41)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 3001, d))
        full = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
        strip_full = t_bcd.bubble_cd_strip(rep, n_b, extent, min_pts=min_pts, dim=d)
        for a, b in self._ranges(3001):
            got = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d, rows=(a, b))
            assert torch.equal(got, full[a:b]), (a, b)
            got = t_bcd.bubble_cd_strip(rep, n_b, extent, min_pts=min_pts, dim=d, rows=(a, b))
            assert torch.equal(got, strip_full[a:b]), (a, b)

    @pytest.mark.parametrize("m", [3001, 3004])
    def test_mutual_reach_row0(self, cuda_device, m):
        rng = np.random.default_rng(42)
        X = _t(_centred(rng, m, 16)).to(cuda_device)
        cd = _t(rng.uniform(0.1, 1.0, size=m).astype(np.float32)).to(cuda_device)
        full = t_mr.mutual_reachability(X, X, cd, cd, zero_diag=True, n_valid=m - 300)
        for a, b in self._ranges(m):
            got = t_mr.mutual_reachability(X[a:b], X, cd[a:b], cd, zero_diag=True, n_valid=m - 300, row0=a)
            assert torch.equal(got, full[a:b]), (a, b)

    @pytest.mark.parametrize("case", ["spread", "dup"])
    def test_grid_block_ranges(self, cuda_device, case):
        from repro_torch.kernels import grid as t_grid

        rng = np.random.default_rng(43)
        rep = _t(_grid_case(case, rng, 3001, 16)).to(cuda_device)
        n_b = _t(rng.integers(1, 6, size=3001).astype(np.float32)).to(cuda_device)
        extent = _t(rng.uniform(0.05, 0.5, size=3001).astype(np.float32)).to(cuda_device)
        _, g, (nb_p, ext_p) = _padded_grid(rep, n_b, extent)
        views = t_grid._block_views(g)
        cd = t_grid.grid_core_distances(g, nb_p, ext_p, 10, 16, views)
        labels = torch.as_tensor(rng.integers(0, 500, size=4096), device=cuda_device)
        hopeless = torch.zeros(4096, dtype=torch.bool, device=cuda_device)
        w, e = t_grid.grid_round_minima(g, views, cd, labels, hopeless)
        rows = g.orig.long()
        cd_s, w_s, e_s = cd[rows], w[rows], e[rows]  # sorted order
        NB = views.order.shape[0]
        for b0, b1 in self._ranges(NB):
            got = t_grid.grid_core_distances(g, nb_p, ext_p, 10, 16, views, blocks=(b0, b1))
            assert torch.equal(got, cd_s[b0 * 64 : b1 * 64]), (b0, b1)
            gw, ge = t_grid.grid_round_minima(g, views, cd, labels, hopeless, blocks=(b0, b1))
            assert torch.equal(gw, w_s[b0 * 64 : b1 * 64]) and torch.equal(ge, e_s[b0 * 64 : b1 * 64]), (b0, b1)
            ow, oe = t_grid.grid_round_minima_v1(g, views, cd, labels, hopeless, blocks=(b0, b1))
            assert torch.equal(gw, ow) and torch.equal(ge, oe), (b0, b1)

    @pytest.mark.parametrize("spatial", [False, True], ids=["dense", "spatial"])
    def test_sharded_pass(self, cuda_device, spatial):
        rng = np.random.default_rng(44)
        rep = rng.normal(size=(3001, 16)) * 3.0 + 40.0
        n_b = rng.integers(1, 9, size=3001).astype(np.float64)
        extent = rng.uniform(0.1, 1.0, size=3001)
        want = tops.offline_recluster_from_table(rep, n_b, extent, 10, device=cuda_device, spatial_index=spatial)
        for k in (1, 2, 3, 4, 8):
            got = tops.offline_recluster_from_table(rep, n_b, extent, 10, device=cuda_device, spatial_index=spatial,
                                                    mesh=(cuda_device,) * k)
            for f in ("labels", "stabilities", "point_parent", "point_lambda", "cluster_parent", "cluster_birth",
                      "cluster_weight", "selected", "all_stabilities"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"k={k} {f}")
            for a, b in zip(got.mst, want.mst, strict=True):
                np.testing.assert_array_equal(a, b)

    def test_boruvka_shard_buffers(self, cuda_device):
        from repro_torch.core import mst as t_mst
        from repro_torch.launch.mesh import resolve_mesh, shard_ranges

        rng = np.random.default_rng(45)
        rep, n_b, extent = (_t(a).to(cuda_device) for a in _bubble_table(rng, 2048, 16))
        cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=10, dim=16)
        W = t_mr.mutual_reachability(rep, rep, cd, cd, zero_diag=True, n_valid=2000)
        want = t_mst.boruvka(W)
        for k in (1, 2, 3, 4, 8):
            ranges = shard_ranges(2048, k)
            got = t_mst.boruvka_shard([W[a:b] for a, b in ranges], [a for a, _ in ranges], 2048,
                                      resolve_mesh((cuda_device,) * k))
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w), k


@pytest.mark.cuda
class TestCudaSummarizer:
    """The online–offline summarizer on the card against the same summarizer
    on the CPU (plain versions): the same bubbles, the same bubble and point
    partitions, assignment indices identical on the tie-free rows, MST
    weight within 1e-6 relative; bubble_cd and mutual_reach launched once
    per ``cluster()``, assign once."""

    @pytest.mark.parametrize("d,offset", [(2, 0.0), (16, 50.0)])
    def test_summarizer_against_cpu(self, cuda_device, d, offset):
        from repro_torch.core import BubbleTreeSummarizer, assign_points
        from repro_torch.kernels import ops as t_ops

        rng = np.random.default_rng(7 + d)
        centres = rng.normal(scale=4.0, size=(6, d))
        X = centres[rng.integers(0, 6, size=6000)] + rng.normal(size=(6000, d)) + offset
        outs = []
        for dev in (cuda_device, "cpu"):
            s = BubbleTreeSummarizer(dim=d, min_pts=10, compression=0.03, device=dev)
            ids = s.insert_block(X)
            s.delete_block(ids[::4])
            if dev != "cpu":
                t_assign.launches = t_bcd.launches = t_mr.launches = 0
            outs.append((s, s.cluster()))
            if dev != "cpu":
                assert (t_bcd.launches, t_mr.launches, t_assign.launches) == (1, 1, 1)
        (gs, g), (cs, c) = outs
        for f in ("rep", "n", "extent"):
            assert np.array_equal(getattr(g.bubbles, f), getattr(c.bubbles, f))
        assert np.array_equal(g.point_ids, c.point_ids)
        assert_same_partition(g.bubble_labels, c.bubble_labels)
        rel = abs(g.hdbscan.total_mst_weight - c.hdbscan.total_mst_weight) / c.hdbscan.total_mst_weight
        assert rel <= 1e-6, rel
        _, Xa = gs.tree.alive_points()
        mu = g.bubbles.rep.mean(axis=0)
        R64 = g.bubbles.rep - mu
        sq = ((Xa - mu) ** 2).sum(1)[:, None] + (R64**2).sum(1)[None, :] - 2.0 * (Xa - mu) @ R64.T
        two = np.sort(sq, axis=1)[:, :2]
        keep = (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 1]
        a_gpu = assign_points(Xa, g.bubbles, backend=gs.backend)
        a_cpu = assign_points(Xa, g.bubbles, backend=t_ops.get_backend("cpu"))
        assert keep.mean() > 0.9
        assert np.array_equal(a_gpu[keep], a_cpu[keep])
        assert_same_partition(g.point_labels[keep], c.point_labels[keep])
