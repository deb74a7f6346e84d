"""The hand-written CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip on a machine without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
Tolerances: indices identical on tie-free centred data; values within
1e-5 relative plus the f32 cancellation allowance of the expanded
distance form, which the kernel and the plain version round in different
orders: δ(r²) = 8ε(max‖x‖² + max‖y‖²) on a squared distance, hence
δ(r) = min(√δ(r²), δ(r²)/2r) on a distance r — large only for the
near-zero distances of queries that sit on a representative.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import assign as t_assign
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import mutual_reach as t_mr
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

    def test_tf32_off(self, cuda_device):
        from repro_torch.device import resolve_device

        resolve_device(cuda_device)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
