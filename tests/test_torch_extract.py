"""The extract stage's plain version and the extract kernel's algorithm, on the CPU.

* ``core/hierarchy.py::stabilities`` sums in one written-down order: each
  label's leaves in ascending leaf index, then its child labels in
  ascending label, one f32 add each from +0.0.  It must equal a numpy
  sequential f32 sum (``np.add.accumulate``) bit for bit and give the
  same bits on every call, at sizes where PyTorch's CPU
  ``index_put_(accumulate=True)`` adds with parallel atomics (32,768
  indices and more) and with several threads.
* The port's ``extract_fixed`` against the JAX package's
  ``repro.core.hierarchy_jax.extract_fixed`` on the same condensed
  arrays: ``selected``, ``labels`` and ``n_clusters`` equal, stabilities
  within 1e-5 relative (the reference's contract), both methods, with
  and without ``allow_single_cluster``, on the GRID, CORNERS and deep
  (chain, star, comb) cases of ``tests/test_torch_hierarchy_cuda.py``.
* ``extract_model``: the phases of ``csrc/hierarchy_extract.cu`` in numpy
  (the stable counting sort by (label, warp) cells over warp segments of
  32-item groups, the per-label folds, the EOM walk, blocking and
  resolution by pointer jumping that stops when no pointer moves), bit
  for bit the plain ``extract_fixed`` in every field.

The condensed arrays come from ``core/hierarchy.py``'s numpy models
(``single_linkage_chunked``, ``condense_jump``), which
``tests/test_torch_hierarchy_par.py`` holds bit for bit to the plain
loops.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy_jax as hj
from repro_torch.core import hierarchy as th
from test_torch_hierarchy_cuda import CORNERS, GRID, edge_buffers

CASES = {
    **{f"grid Lp{c[0]} nvalid{c[1]}": c for c in GRID},
    **{f"corner {name}": c for name, c in CORNERS.items()},
    "chain": (512, 512, {"shape": "chain"}, 5.0),
    "star": (512, 448, {"shape": "star", "masses": "frac"}, 3.0),
    "comb": (2048, 2000, {"shape": "comb", "masses": "frac"}, 8.0),
    "Lp 2": (2, 2, {}, 1.0),
    "Lp 3": (3, 3, {"shape": "chain"}, 1.0),
}
POLICIES = [("eom", False), ("eom", True), ("leaf", False), ("leaf", True)]

_extract_jit = jax.jit(hj.extract_fixed, static_argnames=("method", "allow_single_cluster"))


@functools.lru_cache(maxsize=None)
def _condensed(name):
    Lp, nv, opts, mcs = CASES[name]
    t = [torch.from_numpy(a) for a in edge_buffers(Lp, nv, 7, **opts)]
    slt = th.single_linkage_chunked(*t[:4], nv, t[4])
    return th.condense_jump(slt, t[4], mcs)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def sequential_stabilities(pp, lam, w, parent, birth, cw, n_labels):
    """The fixed order written out: per label, +0.0, then its leaves' terms
    in leaf order, then its child labels' terms in label order, by
    ``np.add.accumulate`` (one f32 add per element, in order)."""
    n_slots = parent.shape[0]
    leaf_terms = (lam - birth[pp]) * w
    kids = np.arange(1, n_labels)
    kid_terms = (birth[kids] - birth[parent[kids]]) * cw[kids]
    keys = np.concatenate([pp, parent[kids]])
    terms = np.concatenate([leaf_terms, kid_terms]).astype(np.float32)
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(n_slots + 1))
    out = np.zeros(n_slots, np.float32)
    for c in np.flatnonzero(np.diff(bounds)):
        seg = np.concatenate([np.zeros(1, np.float32), terms[order[bounds[c] : bounds[c + 1]]]])
        out[c] = np.add.accumulate(seg, dtype=np.float32)[-1]
    return out


def random_condensed(Lp, n_labels, seed):
    """Condensed arrays of a random label tree (labels in pairs under a
    lower parent, as condense makes them) with leaves spread over the
    labels; a tenth of the leaves weigh 0 below their label's birth, so
    some terms are −0.0."""
    rng = np.random.default_rng(seed)
    n_slots = 2 * Lp + 1
    parent = np.full(n_slots, 2 * Lp, np.int32)
    for a in range(1, n_labels, 2):
        parent[a : a + 2] = rng.integers(0, a)
    birth = np.zeros(n_slots, np.float32)
    for c in range(1, n_labels):
        birth[c] = birth[parent[c]] + np.float32(rng.uniform(0.01, 1.0))
    cw = np.zeros(n_slots, np.float32)
    cw[:n_labels] = rng.uniform(1.0, 50.0, n_labels)
    pp = rng.integers(0, n_labels, Lp).astype(np.int32)
    lam = (birth[pp] + rng.uniform(0.0, 2.0, Lp)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, Lp).astype(np.float32)
    zero = rng.random(Lp) < 0.1
    w[zero], lam[zero] = 0.0, birth[pp[zero]] - np.float32(0.5)
    return pp, lam, w, parent, birth, cw


@pytest.mark.parametrize("Lp", [16384, 32768])
def test_stabilities_fixed_order(Lp):
    """Bit for bit the sequential sum, and the same bits on every call, with
    eight threads: the second scatter alone has 2·Lp + 1 ≥ 32,769
    indices, Lp / 2 of them live (the earlier ``index_put_`` sum gave
    other bits on each call here)."""
    n_labels = Lp // 2 + 1
    arrays = random_condensed(Lp, n_labels, seed=Lp)
    ct = th.CondensedArrays(*(torch.from_numpy(a) for a in arrays),
                            n_labels=torch.tensor(n_labels, dtype=torch.int32))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        runs = [th.stabilities(ct).numpy() for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    want = sequential_stabilities(*arrays, n_labels)
    assert runs[0].dtype == np.float32 and runs[0].shape == (2 * Lp + 1,)
    for got in runs:
        assert np.array_equal(_bits(got), _bits(want))
    assert (_bits(runs[0][n_labels:]) == 0).all()  # +0.0 past the labels in use


@pytest.mark.parametrize("method,allow_single", POLICIES)
@pytest.mark.parametrize("name", list(CASES))
def test_extract_matches_jax(name, method, allow_single):
    ct = _condensed(name)
    got = th.extract_fixed(ct, method=method, allow_single_cluster=allow_single)
    want = _extract_jit(hj.CondensedArrays(*(jnp.asarray(a.numpy()) for a in ct)), method=method,
                        allow_single_cluster=allow_single)
    for field in ("selected", "labels", "n_clusters"):
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field))), field
    assert np.allclose(got.stability.numpy(), np.asarray(want.stability), rtol=1e-5, atol=0)


def extract_model(ct, method="eom", allow_single_cluster=False, warps=32):
    """``csrc/hierarchy_extract.cu``'s phases in numpy (``warps`` warps of 32
    lanes); returns ``ExtractionArrays`` like ``extract_fixed``."""
    pp, lam, w, parent, birth, cw = (a.numpy() for a in ct[:6])
    n_slots = parent.shape[0]
    n = min(max(int(ct.n_labels), 0), n_slots - 1)

    def sort_terms(keys, terms):
        """Stable counting sort: (label, warp) cells, one scan, placement."""
        count = keys.shape[0]
        keys = np.where((keys >= 0) & (keys < n), keys, -1)
        seg = -(-count // (warps * 32)) * 32
        table = np.zeros((n, warps), np.int64)
        for wp in range(warps):
            for base in range(min(count, wp * seg), min(count, wp * seg + seg), 32):
                grp = keys[base : min(base + 32, wp * seg + seg, count)]
                for k in np.unique(grp[grp >= 0]):
                    table[k, wp] += int((grp == k).sum())
        off = np.concatenate([[0], np.cumsum(table.sum(1))])
        cell = off[:-1, None] + np.cumsum(table, 1) - table
        out = np.zeros(off[-1], np.float32)
        for wp in range(warps):
            for base in range(min(count, wp * seg), min(count, wp * seg + seg), 32):
                for j in range(base, min(base + 32, wp * seg + seg, count)):
                    if keys[j] >= 0:
                        out[cell[keys[j], wp]] = terms[j]
                        cell[keys[j], wp] += 1
        return off, out

    loff, lterm = sort_terms(pp, (lam - birth[np.clip(pp, 0, n_slots - 1)]) * w)
    kids = np.arange(1, max(n, 1))
    koff, kterm = sort_terms(parent[kids], (birth[kids] - birth[np.clip(parent[kids], 0, n_slots - 1)]) * cw[kids])
    stab = np.zeros(n_slots, np.float32)
    for c in range(n):
        s = np.float32(0.0)
        for t in np.concatenate([lterm[loff[c] : loff[c + 1]], kterm[koff[c] : koff[c + 1]]]):
            s = np.float32(s + t)
        stab[c] = s
    acc, sel = np.zeros(max(n, 1), np.float32), np.zeros(max(n, 1), bool)
    for c in range(n - 1, -1, -1):
        sel[c] = koff[c + 1] == koff[c] or stab[c] >= acc[c]
        p = parent[c] if c >= 1 else -1
        if 0 <= p < n:
            acc[p] = np.float32(acc[p] + (stab[c] if sel[c] else acc[c]))
    ids = np.arange(n)
    par = np.where((ids >= 1) & (parent[:n] >= 0) & (parent[:n] < n), parent[:n], -1)
    allowed = sel[:n] & (allow_single_cluster | (ids != 0))
    if method == "leaf":
        eff = (koff[1:] == koff[:-1]) & (allow_single_cluster | (ids != 0))
    else:
        ptr, val = par.copy(), np.where(par >= 0, allowed[np.maximum(par, 0)], False)
        while (ptr >= 0).any():
            val = val | np.where(ptr >= 0, val[np.maximum(ptr, 0)], False)
            ptr = np.where(ptr >= 0, ptr[np.maximum(ptr, 0)], -1)
        eff = allowed & ~val
    if allow_single_cluster and n > 0 and not eff.any():
        eff[0] = True
    rank = np.cumsum(eff) - eff
    f = np.where(eff, ids, par)
    while True:
        g = np.where((f < 0) | eff[np.maximum(f, 0)], f, f[np.maximum(f, 0)])
        if np.array_equal(g, f):
            break
        f = g
    resolved = np.where((f >= 0) & eff[np.maximum(f, 0)], rank[np.maximum(f, 0)], -1)
    valid = (pp >= 0) & (pp < n)
    selected = np.zeros(n_slots, bool)
    selected[:n] = eff
    return th.ExtractionArrays(
        stability=torch.from_numpy(stab), selected=torch.from_numpy(selected),
        labels=torch.from_numpy(np.where(valid, resolved[np.where(valid, pp, 0)] if n else -1, -1).astype(np.int32)),
        n_clusters=torch.tensor(int(eff.sum()), dtype=torch.int32))


@pytest.mark.parametrize("method,allow_single", POLICIES)
@pytest.mark.parametrize("name,warps", [("grid Lp64 nvalid64", 32), ("corner ties", 32), ("comb", 32),
                                        ("corner fractional masses", 2), ("chain", 1), ("Lp 2", 32)])
def test_kernel_model(name, warps, method, allow_single):
    """The kernel's algorithm bit for bit the plain version in every field
    (at 1 and 2 warps, segments span many 32-item groups)."""
    ct = _condensed(name)
    got = extract_model(ct, method, allow_single, warps=warps)
    want = th.extract_fixed(ct, method=method, allow_single_cluster=allow_single)
    for field in want._fields:
        g, x = getattr(got, field).numpy(), getattr(want, field).numpy()
        assert g.dtype == x.dtype and g.shape == x.shape, field
        assert np.array_equal(_bits(g), _bits(x)), field
