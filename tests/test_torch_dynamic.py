"""The port's exact-dynamic engine (core/dynamic_torch.py, kernels/dynamic.py,
core/mst.py::boruvka_edges / boruvka_strip) against the JAX package's, on
the CPU.

Inputs are made from seeds with numpy and fed to both packages.
Tolerances:

* strip distances: within 1e-6 relative of ``dynamic_jax._strip_dists`` /
  ``_dense_dists`` — both are the diff form, but XLA may sum over d in
  another order than the port's ascending one; on integer-grid data every
  partial sum is exact, so there they are equal;
* top-K, round minima, Borůvka buffers and labels: identical (given the
  same distances, ties at the lowest index on both sides);
* carried updates: ``alive``, ``knn_idx``, ``ok``, ``n_alive`` identical,
  ``knn_dst`` and ``cd`` within 1e-6 relative, MST total weight within
  1e-6 relative; on integer-grid data the whole state is identical;
* the handle against the host f64 oracle ``repro.core.dynamic`` and static
  ``hdbscan``: MST weight within 1e-6 relative (as tests/test_dynamic_jax.py),
  partitions equal; a rebuild of an incremental state is bit for bit;
* ``incremental_recluster``: partition equal, stabilities within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro.core import dynamic_jax as dj
from repro.core import mst as jmst
from repro.core.dynamic import DynamicHDBSCAN
from repro.core.hdbscan import core_distances, hdbscan
from repro.kernels import ops as jops
from repro_torch import dyn_state_from_reference
from repro_torch.core import dynamic_torch as dt
from repro_torch.core import mst as tmst
from repro_torch.core.device_table import DynamicStateCapture
from repro_torch.core.dynamic_torch import DynamicTorchHDBSCAN
from repro_torch.kernels import dynamic as tdyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MP = 5
REL = 1e-6


def _data(case: str, rng, n: int, d: int) -> np.ndarray:
    """spread: tie-free Gaussian rows off the origin; grid: integer points
    of a small lattice (duplicates and tied distances everywhere)."""
    if case == "grid":
        return rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    return (rng.normal(size=(n, d)) * 2.0 + 5.0).astype(np.float32)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np_state(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in dj.DynState._fields}


def _weight(state) -> float:
    return float(np.sum(np.asarray(dt.state_mst_weights(state), dtype=np.float64)))


def _ref_weight(state) -> float:
    return float(np.sum(np.asarray(dj.state_mst_weights(state), dtype=np.float64)))


class TestPlainStrips:
    @pytest.mark.parametrize("d", [2, 3, 16])
    @pytest.mark.parametrize("case", ["spread", "grid"])
    def test_strip_dists_match_reference(self, case, d):
        rng = np.random.default_rng(d)
        X = _data(case, rng, 70, d)
        rows = X[rng.integers(0, 70, size=9)]
        got = tdyn.strip_dists(_t(rows), _t(X)).numpy()
        want = np.asarray(dj._strip_dists(jnp.asarray(rows), jnp.asarray(X)))
        if case == "grid":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=REL)
        dense = dt._dense_dists(_t(X)).numpy()
        np.testing.assert_allclose(dense, np.asarray(dj._dense_dists(jnp.asarray(X))), rtol=REL)
        np.testing.assert_array_equal(np.diag(dense), 0.0)

    def test_strip_dists_row_blocks_and_out(self, monkeypatch):
        """Row blocks change nothing; ``out`` receives the strip."""
        rng = np.random.default_rng(2)
        X, rows = _t(_data("spread", rng, 50, 4)), _t(_data("spread", rng, 13, 4))
        whole = tref.strip_dists(rows, X)
        monkeypatch.setattr(tref, "_STRIP_ELEMS", 120)
        assert torch.equal(tref.strip_dists(rows, X), whole)
        buf = torch.empty(20, 50)
        got = tdyn.strip_dists(rows, X, out=buf[3:16])
        assert torch.equal(got, whole) and torch.equal(buf[3:16], whole)

    @pytest.mark.parametrize("name", ["strip_dists", "strip_dists_v1"])
    def test_strip_dists_out_row_slice_on_the_cpu(self, name):
        """Both wrappers write ``out`` (a row slice at an odd offset) with the
        plain version's bits and leave the rows around it alone."""
        rng = np.random.default_rng(3)
        X, rows = _t(_data("spread", rng, 51, 16)), _t(_data("spread", rng, 13, 16))
        buf = torch.full((17, 51), -7.0)
        got = getattr(tdyn, name)(rows, X, out=buf[1:14])
        assert torch.equal(got, tref.strip_dists(rows, X)) and got.data_ptr() == buf[1:14].data_ptr()
        assert bool((buf[:1] == -7.0).all()) and bool((buf[14:] == -7.0).all())

    @pytest.mark.parametrize("name", ["strip_topk", "strip_topk_v1"])
    def test_strip_topk_row_view_on_the_cpu(self, name):
        """Both wrappers on a strip that starts one float into its storage,
        against the reference's masked ``lax.top_k``."""
        rng = np.random.default_rng(4)
        X = _data("grid", rng, 41, 3)
        ids = rng.integers(0, 41, size=9)
        D = tref.strip_dists(_t(X[ids]), _t(X))
        buf = torch.empty(D.numel() + 1)
        Dv = buf[1:].view(D.shape).copy_(D)
        alive = rng.random(41) < 0.7
        got_d, got_i = getattr(tdyn, name)(Dv, _t(ids), torch.ones(9, dtype=torch.bool), _t(alive), 7)
        m = alive[None, :] & (np.arange(41)[None, :] != ids[:, None])
        neg, idx = jax.lax.top_k(-jnp.where(jnp.asarray(m), jnp.asarray(D.numpy()), jnp.inf), 7)
        nd = -np.asarray(neg)
        np.testing.assert_array_equal(got_d.numpy(), nd)
        np.testing.assert_array_equal(got_i.numpy(), np.where(np.isfinite(nd), np.asarray(idx), -1))

    @pytest.mark.parametrize("K", [1, 5, 12])
    @pytest.mark.parametrize("case", ["spread", "grid"])
    def test_strip_topk_matches_top_k(self, case, K):
        """The same strip through ``strip_topk`` and the reference's masked
        ``lax.top_k``: values and indices identical, ties included."""
        rng = np.random.default_rng(K)
        X = _data(case, rng, 40, 3)
        ids = rng.integers(0, 40, size=11)
        D = tref.strip_dists(_t(X[ids]), _t(X))
        valid = rng.random(11) < 0.8
        alive = rng.random(40) < 0.7
        got_d, got_i = tdyn.strip_topk(D, _t(ids), _t(valid), _t(alive), K)
        m = valid[:, None] & alive[None, :] & (np.arange(40)[None, :] != ids[:, None])
        neg, idx = jax.lax.top_k(-jnp.where(jnp.asarray(m), jnp.asarray(D.numpy()), jnp.inf), K)
        nd = -np.asarray(neg)
        ni = np.where(np.isfinite(nd), np.asarray(idx), -1)
        np.testing.assert_array_equal(got_d.numpy(), nd)
        np.testing.assert_array_equal(got_i.numpy(), ni)
        assert got_i.dtype == torch.int32

    def test_strip_topk_fewer_live_than_k(self):
        D = torch.arange(12, dtype=torch.float32).reshape(2, 6)
        alive = torch.tensor([True, False, True, False, False, True])
        d, i = tdyn.strip_topk(D, torch.tensor([0, 5]), torch.tensor([True, True]), alive, 4)
        assert i.tolist() == [[2, 5, -1, -1], [0, 2, -1, -1]]
        assert torch.isinf(d[:, 2:]).all()

    def test_wrappers_refuse_bad_input(self):
        X = torch.zeros(8, 3)
        for dists in (tdyn.strip_dists, tdyn.strip_dists_v1):  # the redesign and its oracle, the first kernel
            with pytest.raises(ValueError, match=dists.__name__):
                dists(torch.zeros(4, 2), X)
            with pytest.raises(ValueError, match=dists.__name__):
                dists(torch.zeros(4, 3), X, out=torch.empty(4, 9))
            with pytest.raises(ValueError, match="cuda or cpu"):
                dists(X.to("meta"), X.to("meta"))
        for topk in (tdyn.strip_topk, tdyn.strip_topk_v1):
            with pytest.raises(ValueError, match=topk.__name__):
                topk(torch.zeros(4, 8), torch.zeros(3), torch.ones(4, dtype=torch.bool),
                     torch.ones(8, dtype=torch.bool), 2)
            with pytest.raises(ValueError, match=topk.__name__):
                topk(torch.zeros(4, 8), torch.zeros(4), torch.ones(4, dtype=torch.bool),
                     torch.ones(8, dtype=torch.bool), 0)
        # on the CPU the first kernels' wrappers take the plain versions too, and count no launch
        before = dict(tdyn.launches)
        rows = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        assert torch.equal(tdyn.strip_dists_v1(rows, X), tref.strip_dists(rows, X))
        D, ids, ok = tref.strip_dists(rows, X), torch.arange(4), torch.ones(4, dtype=torch.bool)
        for got, want in zip(tdyn.strip_topk_v1(D, ids, ok, torch.ones(8, dtype=torch.bool), 3),
                             tref.strip_topk(D, ids, ok, torch.ones(8, dtype=torch.bool), 3)):
            assert torch.equal(got, want)
        assert tdyn.launches == before
        with pytest.raises(ValueError, match="int32"):
            tdyn.strip_round_minima(torch.zeros(2, 8), torch.ones(2, 8, dtype=torch.bool), torch.zeros(2),
                                    torch.zeros(8), E=2**31 - 10)
        with pytest.raises(ValueError, match="cuda or cpu"):
            tdyn.strip_dists(X.to("meta"), X.to("meta"))
        f = (torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
             torch.ones(8, dtype=torch.bool), torch.zeros(8, dtype=torch.int64))
        with pytest.raises(ValueError, match="int32"):
            tdyn.strip_round_minima_from_dists(*f, E=2**31 - 10)
        with pytest.raises(ValueError, match="strip_round_minima_from_dists"):
            tdyn.strip_round_minima_from_dists(*f[:1], torch.zeros(7), *f[2:])


def _strip_case(seed: int, ties: bool, n=48, U=10, E=20):
    """A round's inputs: a random forest-ish edge list, strip rows at
    distinct nodes, weights (integers when ``ties``), a sparse mask."""
    rng = np.random.default_rng(seed)
    eu = rng.integers(0, n, size=E).astype(np.int32)
    ev = rng.integers(0, n, size=E).astype(np.int32)
    ew = (rng.integers(1, 5, size=E) if ties else rng.random(E)).astype(np.float32)
    evalid = (rng.random(E) < 0.7) & (eu != ev)
    sids = rng.permutation(n)[:U].astype(np.int32)
    SW = (rng.integers(1, 5, size=(U, n)) if ties else rng.random((U, n))).astype(np.float32)
    smask = (rng.random((U, n)) < 0.5) & (np.arange(n)[None, :] != sids[:, None])
    SW = np.where(smask, SW, np.inf).astype(np.float32)
    return eu, ev, ew, evalid, sids, SW, smask, n


class TestBoruvka:
    @pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_boruvka_strip_matches_reference(self, seed, ties):
        eu, ev, ew, evalid, sids, SW, smask, n = _strip_case(seed, ties)
        got = tmst.boruvka_strip(_t(eu), _t(ev), _t(ew), _t(evalid), _t(sids), _t(SW), _t(smask), n)
        want = jmst.boruvka_strip_jax(*(jnp.asarray(a) for a in (eu, ev, ew, evalid, sids, SW, smask)), n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
    def test_round_minima_is_the_three_passes(self, ties):
        """``ref.strip_round_minima`` per row and column against a direct
        lexicographic minimum of (w, pair id, payload)."""
        _, _, _, _, sids, SW, smask, n = _strip_case(5, ties)
        rng = np.random.default_rng(6)
        lab = rng.integers(0, 6, size=n)
        E = 17
        rw, re, rp, cw, ce, cp = tdyn.strip_round_minima(_t(SW), _t(smask), _t(sids), _t(lab), E)
        act = smask & (lab[sids][:, None] != lab[None, :])
        U = SW.shape[0]
        for axis, (w, e, p) in ((1, (rw, re, rp)), (0, (cw, ce, cp))):
            for i in range(SW.shape[1 - axis]):
                ent = [(float(SW[r, c]), min(sids[r], c) * n + max(sids[r], c), E + r * n + c)
                       for r in range(U) for c in range(n)
                       if act[r, c] and (r if axis == 1 else c) == i]
                best = min(ent) if ent else (np.inf, 2**31 - 1, 2**31 - 1)
                assert (float(w[i]), int(e[i]), int(p[i])) == best

    @pytest.mark.parametrize("case", ["random", "ties", "forced", "disconnected"])
    def test_boruvka_edges_matches_reference(self, case):
        rng = np.random.default_rng(11)
        n, E = 30, 60
        eu = rng.integers(0, n, size=E).astype(np.int32)
        ev = rng.integers(0, n, size=E).astype(np.int32)
        ew = (rng.integers(0, 3, size=E) if case == "ties" else rng.random(E)).astype(np.float32)
        valid = eu != ev
        if case == "forced":
            ew = np.where(rng.random(E) < 0.2, -1.0, ew).astype(np.float32)
        if case == "disconnected":
            valid &= (eu < 10) == (ev < 10)
        got = tmst.boruvka_edges(_t(eu), _t(ev), _t(ew), _t(valid), n)
        want = jmst.boruvka_edges_jax(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(ew), jnp.asarray(valid), n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _factors(seed: int, grid: bool, U: int, n: int, labels: str, valid=0.8, alive=0.7):
    """A strip's factors: distances (integer-grid points when ``grid``:
    small integer squares, ties everywhere), core distances (some +inf),
    strip ids, row validity, live columns, and the round's labels (node ids
    in [0, n))."""
    rng = np.random.default_rng(seed)
    X = _data("grid" if grid else "spread", rng, n, 2)
    sids = rng.permutation(n)[:U] if U <= n else rng.integers(0, n, size=U)
    D = tref.strip_dists(_t(X[sids]), _t(X))
    cd = np.sort(tref.strip_dists(_t(X), _t(X)).numpy(), axis=1)[:, 3].astype(np.float32)
    cd[rng.random(n) < 0.1] = np.inf
    step = max(1, n // 5)
    lab = {"round1": np.arange(n), "merged": np.arange(n) // step * step, "one": np.zeros(n, np.int64),
           "random": rng.integers(0, n, size=n)}[labels]
    return D, _t(cd), _t(sids), _t(rng.random(U) < valid), _t(rng.random(n) < alive), _t(lab)


def _built(D, cd, sids, row_valid, alive):
    """SW and smask as the update built them before the factor route."""
    iota = torch.arange(D.shape[1])
    smask = row_valid[:, None] & alive[None, :] & (iota[None, :] != sids[:, None].long())
    SW = torch.maximum(D, cd[sids.long()][:, None])
    SW = torch.maximum(SW, cd[None, :], out=SW)
    return SW.masked_fill_(~smask, np.inf), smask


class TestFactorRoute:
    """The round minima and Borůvka from the strip's factors
    (``ref.strip_round_minima_from_dists``, ``boruvka_strip_from_dists``):
    identical (bitwise) to the first form on the SW and smask built from the
    same factors, and to ``boruvka_strip_jax`` fed SW as
    ``dynamic_jax.insert_batch`` builds it."""

    @pytest.mark.parametrize("labels", ["round1", "merged", "one", "random"])
    @pytest.mark.parametrize("grid", [False, True], ids=["spread", "grid"])
    @pytest.mark.parametrize("shape", [(9, 40), (13, 37), (50, 24)], ids=["9x40", "ragged_13x37", "repeats_50x24"])
    def test_minima_equal_the_built_strip(self, shape, grid, labels, monkeypatch):
        """Ties, an integer grid, a ragged n, invalid rows, dead columns,
        +inf core distances, the self column (masked by smask and by the
        labels alike), repeated strip ids, row blocks of 3 rows."""
        U, n = shape
        f = _factors(U * n + grid, grid, U, n, labels)
        E = 11
        got = tdyn.strip_round_minima_from_dists(*f, E=E)
        SW, smask = _built(*f[:5])
        want = tref.strip_round_minima(SW, smask, f[2], f[5], E)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        monkeypatch.setattr(tref, "_STRIP_ELEMS", 3 * n)
        for g, w in zip(tref.strip_round_minima_from_dists(*f, E=E), want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("grid", [False, True], ids=["spread", "grid"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_boruvka_from_dists_matches_reference(self, seed, grid):
        """The factor route against ``boruvka_strip_jax`` on ``SW =
        max(D, max(cd[sids], cd))``, +inf off the mask
        (``dynamic_jax.py:223``), and against the first route."""
        n, U, E = 40, 12, 30
        D, cd, sids, rv, alive, _ = _factors(seed, grid, U, n, "round1")
        rng = np.random.default_rng(seed + 100)
        eu = rng.integers(0, n, size=E).astype(np.int32)
        ev = rng.integers(0, n, size=E).astype(np.int32)
        ew = (rng.integers(1, 5, size=E) if grid else rng.random(E) * 4).astype(np.float32)
        evalid = (rng.random(E) < 0.7) & (eu != ev)
        got = tmst.boruvka_strip_from_dists(_t(eu), _t(ev), _t(ew), _t(evalid), sids, D, cd, rv, alive, n)
        jd, jc, js = jnp.asarray(D.numpy()), jnp.asarray(cd.numpy()), jnp.asarray(sids.numpy())
        iota = jnp.arange(n)
        smask = jnp.asarray(rv.numpy())[:, None] & jnp.asarray(alive.numpy())[None, :] & (iota[None, :] != js[:, None])
        SW = jnp.where(smask, jnp.maximum(jd, jnp.maximum(jc[js][:, None], jc[None, :])), jnp.inf)
        want = jmst.boruvka_strip_jax(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(ew), jnp.asarray(evalid), js, SW,
                                      smask, n)
        first = tmst.boruvka_strip(_t(eu), _t(ev), _t(ew), _t(evalid), sids, *_built(D, cd, sids, rv, alive), n)
        for g, w, o in zip(got, want, first):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, o)

    def test_insert_takes_the_factor_route(self, carried, monkeypatch):
        """``insert_batch`` hands Borůvka the distance strip and its factors
        (no (U, Np) weight strip or mask), and never the first route."""
        seen = []
        real = dt.boruvka_strip_from_dists
        monkeypatch.setattr(dt, "boruvka_strip_from_dists", lambda *a: seen.append(a) or real(*a))
        monkeypatch.setattr(tdyn, "strip_round_minima", lambda *a, **k: pytest.fail("the first route ran"))
        port = dyn_state_from_reference(_np_state(carried["spread"][0].state), device="cpu")
        rng = np.random.default_rng(4)
        P = _data("spread", rng, 4, 3)
        dt.insert_batch(port, _t(P), _t(np.array([40, 41, 50, 51])), _t(np.ones(4, bool)), min_pts=MP, rk_cap=16)
        (eu, ev, ew, evalid, sids, D, cd, rv, alive, n), = seen
        assert D.shape == (4 + 16, 64) and D.dtype == torch.float32 and rv.dtype == torch.bool
        assert cd.shape == alive.shape == (64,) and n == 64 and bool(rv[:4].all())


@pytest.fixture(scope="module")
def carried():
    """Reference states mid-stream (capacity 64, blocks of 8), by data case."""
    out = {}
    for case in ("spread", "grid"):
        rng = np.random.default_rng(21)
        ref = dj.DynamicJaxHDBSCAN(MP, 3, capacity=64)
        for _ in range(4):
            ref.insert_block(_data(case, rng, 8, 3))
        out[case] = (ref, rng)
    return out


def _assert_same_state(port, ref, exact: bool):
    got, want = {f: getattr(port, f).numpy() for f in dj.DynState._fields}, _np_state(ref)
    for f in ("alive", "knn_idx", "ok", "n_alive", "mst_valid"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("knn_dst", "cd", "X"):
        if exact:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=REL, err_msg=f)
    assert _weight(port) == pytest.approx(_ref_weight(ref), rel=REL)
    if exact:
        for f in dj.DynState._fields:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


class TestCarriedUpdates:
    @pytest.mark.parametrize("op", ["insert", "delete", "rebuild", "insert_overflow", "delete_overflow"])
    @pytest.mark.parametrize("case", ["spread", "grid"])
    def test_update_matches_reference(self, carried, case, op):
        ref_h, _ = carried[case]
        rng = np.random.default_rng([["spread", "grid"].index(case), len(op), ord(op[0])])
        state = ref_h.state
        port = dyn_state_from_reference(_np_state(state), device="cpu")
        rk = 2 if op.endswith("overflow") else 64
        if op.startswith("insert"):
            P = _data(case, rng, 6, 3)
            P = np.concatenate([P, np.zeros((2, 3), np.float32)])
            slots = np.array([33, 40, 41, 50, 60, 63, 0, 0])
            valid = np.arange(8) < 6
            want = dj.insert_batch(state, jnp.asarray(P), jnp.asarray(slots), jnp.asarray(valid),
                                   min_pts=MP, rk_cap=rk)
            got = dt.insert_batch(port, _t(P), _t(slots), _t(valid), min_pts=MP, rk_cap=rk)
        elif op.startswith("delete"):
            alive = np.nonzero(np.asarray(state.alive))[0]
            slots = rng.choice(alive, size=8, replace=False)
            valid = np.arange(8) < 7
            want = dj.delete_batch(state, jnp.asarray(slots), jnp.asarray(valid), min_pts=MP, rk_cap=rk, s_cap=rk)
            got = dt.delete_batch(port, _t(slots), _t(valid), min_pts=MP, rk_cap=rk, s_cap=rk)
        else:
            want = dj.rebuild(state, min_pts=MP)
            got = dt.rebuild(port, min_pts=MP)
        assert bool(got.ok) == bool(want.ok) == (not op.endswith("overflow"))
        if op.endswith("overflow"):
            np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
            assert int(got.n_alive) == int(want.n_alive)
            return
        _assert_same_state(got, want, exact=case == "grid")

    def test_carry_keeps_dtypes(self, carried):
        port = dyn_state_from_reference(_np_state(carried["spread"][0].state), device="cpu")
        assert [getattr(port, f).dtype for f in dt.DynState._fields] == [
            torch.float32, torch.bool, torch.int32, torch.float32, torch.float32, torch.int32, torch.int32,
            torch.float32, torch.bool, torch.int32, torch.bool]

    @pytest.mark.parametrize("case", ["spread", "grid"])
    def test_incremental_recluster_matches_reference(self, carried, case):
        ref_h, _ = carried[case]
        port = dyn_state_from_reference(_np_state(ref_h.state), device="cpu")
        got, gslots, grep = tops.incremental_recluster(port, float(MP))
        want, wslots, wrep = jops.incremental_recluster(ref_h.state, float(MP))
        np.testing.assert_array_equal(gslots, wslots)
        np.testing.assert_array_equal(grep, wrep)
        assert_same_partition(got.labels, want.labels)
        np.testing.assert_allclose(np.sort(got.stabilities), np.sort(want.stabilities), rtol=1e-5)
        np.testing.assert_allclose(got.mst[2].sum(), want.mst[2].sum(), rtol=REL)


def _assert_weight(dev, oracle, msg=""):
    assert dev.total_weight() == pytest.approx(oracle.total_weight(), rel=REL, abs=1e-6), msg


def _mirror_insert(dev, oracle, X, slot2oid):
    slots = dev.insert_block(X)
    for s, p in zip(slots, X):
        slot2oid[s] = oracle.insert(p)
    return slots


class TestHandle:
    """``DynamicTorchHDBSCAN`` on tests/test_dynamic_jax.py's cases."""

    def test_incremental_matches_oracle(self, rng):
        dev = DynamicTorchHDBSCAN(MP, 3, capacity=64, device="cpu")
        oracle = DynamicHDBSCAN(min_pts=MP, dim=3)
        s2o = {}
        for i in range(6):
            _mirror_insert(dev, oracle, rng.normal(size=(8, 3)), s2o)
            _assert_weight(dev, oracle, f"after {8 * (i + 1)} inserts")
        assert dev.ok and dev.n == 48

    def test_core_distances_maintained(self, rng):
        X = rng.normal(size=(40, 2))
        dev = DynamicTorchHDBSCAN(4, 2, capacity=64, device="cpu")
        slots = dev.insert_block(X)
        np.testing.assert_allclose(dev.state.cd.numpy()[slots], core_distances(X, 4), rtol=1e-5, atol=1e-6)

    def test_block_equals_sequential(self, rng):
        X = rng.normal(size=(24, 2))
        a = DynamicTorchHDBSCAN(MP, 2, capacity=32, device="cpu")
        b = DynamicTorchHDBSCAN(MP, 2, capacity=32, device="cpu")
        a.insert_block(X)
        for row in X:
            b.insert_block(row[None, :])
        assert a.total_weight() == pytest.approx(b.total_weight(), rel=REL)
        np.testing.assert_allclose(np.sort(a.state.cd.numpy()), np.sort(b.state.cd.numpy()), rtol=1e-6, atol=1e-7)

    def test_delete_matches_oracle(self, rng):
        dev = DynamicTorchHDBSCAN(MP, 3, capacity=64, device="cpu")
        oracle = DynamicHDBSCAN(min_pts=MP, dim=3)
        s2o = {}
        _mirror_insert(dev, oracle, rng.normal(size=(48, 3)), s2o)
        drop = rng.choice(list(dev.alive_slots()), size=20, replace=False)
        for j in range(0, 20, 4):
            ds = [int(s) for s in drop[j : j + 4]]
            dev.delete_block(ds)
            oracle.delete_batch([s2o.pop(s) for s in ds])
            _assert_weight(dev, oracle, f"after {j + 4} deletes")

    def test_delete_hub(self):
        rng = np.random.default_rng(3)
        ring = rng.normal(size=(30, 2)) * 5.0
        X = np.concatenate([np.zeros((1, 2)), ring])
        dev = DynamicTorchHDBSCAN(3, 2, capacity=32, rk_cap=8, s_cap=8, device="cpu")
        slots = dev.insert_block(X)
        dev.delete_block([slots[0]])
        assert dev.total_weight() == pytest.approx(hdbscan(ring, min_pts=3).total_mst_weight, rel=REL)

    def test_delete_to_empty(self, rng):
        dev = DynamicTorchHDBSCAN(2, 2, capacity=16, device="cpu")
        for s in dev.insert_block(rng.normal(size=(6, 2))):
            dev.delete_block([s])
        assert dev.n == 0 and dev.total_weight() == 0.0

    def test_overflow_poisons_then_rebuilds(self, rng):
        dev = DynamicTorchHDBSCAN(4, 2, capacity=64, rk_cap=2, s_cap=2, device="cpu")
        oracle = DynamicHDBSCAN(min_pts=4, dim=2)
        s2o = {}
        _mirror_insert(dev, oracle, rng.normal(size=(40, 2)), s2o)
        drop = [int(s) for s in rng.choice(list(dev.alive_slots()), size=12, replace=False)]
        dev.delete_block(drop)
        oracle.delete_batch([s2o.pop(s) for s in drop])
        assert dev.stats["overflow_rebuilds"] >= 1 and dev.ok
        _assert_weight(dev, oracle, "post-overflow")

    def test_capacity_growth_stays_exact(self, rng):
        dev = DynamicTorchHDBSCAN(4, 2, capacity=16, device="cpu")
        oracle = DynamicHDBSCAN(min_pts=4, dim=2)
        s2o = {}
        for i in range(5):
            _mirror_insert(dev, oracle, rng.normal(size=(8, 2)) + i, s2o)
        assert dev.stats["grows"] >= 1 and dev.capacity >= 64
        _assert_weight(dev, oracle, "post-growth")

    def test_labels_match_static(self, blobs):
        X, _ = blobs
        dev = DynamicTorchHDBSCAN(MP, 2, capacity=256, device="cpu")
        slots = dev.insert_block(X)
        res, got_slots, _ = tops.incremental_recluster(dev.state, float(MP))
        np.testing.assert_array_equal(got_slots, np.sort(slots))
        ref = hdbscan(X[np.argsort(slots)], min_pts=MP, min_cluster_size=float(MP))
        assert_same_partition(res.labels, ref.labels)
        assert res.n_clusters == 3

    def test_labels_after_interleave(self, rng, blobs):
        X, _ = blobs
        dev = DynamicTorchHDBSCAN(MP, 2, capacity=256, device="cpu")
        slots = dev.insert_block(X[:120])
        drop = rng.choice(120, size=24, replace=False)
        dev.delete_block([slots[i] for i in drop])
        keep = np.ones(120, bool)
        keep[drop] = False
        surv_rows = [i for i in np.argsort(slots[:120]) if keep[i]]
        res, _, _ = tops.incremental_recluster(dev.state, float(MP))
        assert_same_partition(res.labels, hdbscan(X[surv_rows], min_pts=MP, min_cluster_size=float(MP)).labels)

    def test_rebuild_matches_incremental(self, rng):
        """In the port a rebuild of an incrementally built state is the
        same state bit for bit (the same strips, the same tie rules), up to
        the order of the MST's edge slots."""
        dev = DynamicTorchHDBSCAN(MP, 2, capacity=64, device="cpu")
        dev.insert_block(rng.normal(size=(40, 2)))
        before = dev.state
        dev.rebuild()
        after = dev.state
        for f in ("knn_idx", "knn_dst", "cd", "alive", "n_alive", "ok"):
            assert torch.equal(getattr(before, f), getattr(after, f)), f
        edges = [sorted(zip(s.mst_u[s.mst_valid].tolist(), s.mst_v[s.mst_valid].tolist(),
                            s.mst_raw[s.mst_valid].tolist())) for s in (before, after)]
        norm = [sorted((min(u, v), max(u, v), w) for u, v, w in e) for e in edges]
        assert norm[0] == norm[1]

    def test_ops_incremental_update_public_api(self, rng):
        X = rng.normal(size=(20, 2))
        P = rng.normal(size=(4, 2)) + 3.0
        dev = DynamicTorchHDBSCAN(4, 2, capacity=32, device="cpu")
        dev.insert_block(X)
        st = tops.incremental_update(dev.state, insert=P.astype(np.float32), slots=np.arange(24, 28),
                                     valid=np.ones(4, bool), min_pts=4)
        assert bool(st.ok)
        ref = hdbscan(np.concatenate([X, P]), min_pts=4).total_mst_weight
        assert _weight(st) == pytest.approx(ref, rel=REL)
        st = tops.incremental_update(st, delete=np.arange(0, 4), valid=np.ones(4, bool), min_pts=4)
        assert bool(st.ok)
        ref = hdbscan(np.concatenate([X[4:], P]), min_pts=4).total_mst_weight
        assert _weight(st) == pytest.approx(ref, rel=REL)
        with pytest.raises(ValueError, match="exactly one"):
            tops.incremental_update(st, min_pts=4, valid=np.ones(4, bool))

    def test_ops_incremental_update_takes_tensors(self, rng):
        """Tensors on the state's device go in as they are, and give the
        same state as the host arrays."""
        X = rng.normal(size=(20, 2))
        P = (rng.normal(size=(4, 2)) + 3.0).astype(np.float32)
        h = DynamicTorchHDBSCAN(4, 2, capacity=32, device="cpu")
        h.insert_block(X)
        kw = dict(min_pts=4)
        a = tops.incremental_update(h.state, insert=P, slots=np.arange(24, 28), valid=np.ones(4, bool), **kw)
        b = tops.incremental_update(h.state, insert=torch.from_numpy(P), slots=torch.arange(24, 28),
                                    valid=torch.ones(4, dtype=torch.bool), **kw)
        a = tops.incremental_update(a, delete=np.arange(0, 4), valid=np.ones(4, bool), **kw)
        b = tops.incremental_update(b, delete=torch.arange(0, 4), valid=torch.ones(4, dtype=torch.bool), **kw)
        assert bool(b.ok)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f

    def test_backend_hands_out_handles_and_captures(self, blobs):
        X, _ = blobs
        be = tops.get_backend("cpu")
        dev = be.make_dynamic(MP, 2, capacity=64, rk_cap=99)
        assert isinstance(dev, DynamicTorchHDBSCAN) and dev.state.X.device.type == "cpu" and dev.rk_cap == 99
        dev.insert_block(X)
        cap = DynamicStateCapture(state=dev.state, dim=2)
        res, rep, n_b, center = cap.recluster(be, min_pts=MP, min_cluster_size=float(MP))
        assert res.n_clusters == 3 and rep.shape == (len(X), 2) and (n_b == 1).all()
        np.testing.assert_allclose(center, rep.mean(0))
        with pytest.raises(ValueError, match="mesh"):
            cap.recluster(be, min_pts=MP, min_cluster_size=float(MP), mesh=object())

    def test_one_host_read_per_block(self, rng, monkeypatch):
        """The handle reads the device once per update (``ok`` with
        ``n_alive``); an update body reads nothing."""
        dev = DynamicTorchHDBSCAN(MP, 2, capacity=64, device="cpu")
        dev.insert_block(rng.normal(size=(30, 2)))
        reads = []
        real = torch.Tensor.tolist
        monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append(1) or real(t))
        dev.insert_block(rng.normal(size=(3, 2)))
        dev.delete_block([0, 1])
        assert len(reads) == 2 and dev.n == 31
