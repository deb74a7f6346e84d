"""The hierarchy sweeps' CUDA kernels against the plain loops, on a card.

Marked ``cuda``: they skip on a machine without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hierarchy_cuda.py

This file imports no JAX.  The inputs are Borůvka-shaped edge buffers of
a seeded random spanning tree (``edge_buffers``; no W is needed), which
``kernels/hierarchy.py`` takes through its kernels (single-linkage,
condense, extract) and ``core/hierarchy.py``'s plain loops take on the
same card.  Every field must be bitwise equal, trash slots included, the
stabilities too: the extract kernel and the plain ``stabilities`` add in
one fixed order.  The largest bucket, Lp = 65,536, is held against the
plain loops on the CPU.  Two runs of the kernels give the same bits, and
an offline pass on the card reads nothing back from the device before
its unwrap (``torch.cuda.set_sync_debug_mode``).  ``-k HierarchyPar``:
the redesigned single-linkage and condense kernels
(``csrc/hierarchy_par.cu``) bit for bit against their first versions
(``csrc/hierarchy.cu``) and the plain loops on the CPU, on deep
dendrograms (chain, star, comb) as well, at every bucket.  ``-k
Extract``: the extract kernel (``csrc/hierarchy_extract.cu``) bit for
bit the plain ``extract_fixed`` on the CPU on the same cases, both
methods with and without ``allow_single_cluster``, and against
``extract_v1``, the composition it replaced (integer fields equal,
stabilities within 1e-5, or within the worst case of two orders of a
label's k terms, 2·(k − 1)·2⁻²⁴, where that is larger: ``index_put_``
sums in CUDA's own order), a label count past shared memory, two runs.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hierarchy as th
from repro_torch.kernels import hierarchy as t_h
from repro_torch.kernels import ops as tops

INT_FIELDS = {"left", "right", "point_parent", "cluster_parent", "n_labels", "selected", "labels", "n_clusters"}


def edge_buffers(Lp, n_valid, seed, *, masses="int", ties=False, zeros=0.0, drop=0, shape="random"):
    """(eu, ev, ew, valid, weights) numpy buffers as Borůvka leaves them
    for a bucket of Lp leaves, the first ``n_valid`` real: the n_valid − 1
    edges of a seeded spanning tree in random slots (``drop`` of them left
    out: a disconnected buffer), the other slots invalid with zero ends.
    ``shape``: "random" (a random recursive tree, a dendrogram ~ln n
    deep), "chain" (a path whose weights rise along it: every merge takes
    in one leaf, a dendrogram n_valid − 1 deep), "star" (every leaf
    joined to one hub, as deep) or "comb" (groups of 6 leaves on light
    edges, their heads on a path whose weights rise above them: every
    path merge splits two heavy subtrees, a dendrogram ~n_valid / 6 deep
    in splits).  ``masses``: "int" (1–5) or "frac"
    (uniform 0.5–3) weights, 0 past n_valid; ``ties``: every edge weight
    1; ``zeros``: that share of the edges at weight 0."""
    rng = np.random.default_rng(seed)
    n_e = n_valid - 1
    child = np.arange(1, n_valid)
    head = child % 6 == 0
    par = {"random": (rng.random(n_e) * child).astype(np.int64), "chain": child - 1,
           "star": np.zeros(n_e, np.int64), "comb": np.where(head, child - 6, child - 1)}[shape]
    perm = rng.permutation(n_valid)
    u, v = perm[child], perm[par]
    swap = rng.random(n_e) < 0.5
    u, v = np.where(swap, v, u), np.where(swap, u, v)
    w = np.ones(n_e) if ties else rng.uniform(0.1, 10.0, n_e)
    if shape in ("chain", "comb"):  # rising weights, distinct in f32: multiples of 2^-10 in [1, 1025)
        rise = 1.0 + np.sort(rng.choice(1 << 20, n_e, replace=False)) / 1024.0
        w = rise if shape == "chain" else np.where(head, 10.0 + rise, w / 10.0)
    w[rng.random(n_e) < zeros] = 0.0
    keep = np.sort(rng.permutation(n_e)[: n_e - drop])
    slots = rng.permutation(Lp)[: keep.size]
    eu, ev = np.zeros(Lp, np.int32), np.zeros(Lp, np.int32)
    ew, valid = np.zeros(Lp, np.float32), np.zeros(Lp, bool)
    eu[slots], ev[slots], ew[slots], valid[slots] = u[keep], v[keep], w[keep], True
    weights = np.zeros(Lp, np.float32)
    weights[:n_valid] = rng.integers(1, 6, n_valid) if masses == "int" else rng.uniform(0.5, 3.0, n_valid)
    return eu, ev, ew, valid, weights


# (Lp, n_valid, generator options, min_cluster_size)
GRID = [(Lp, nv, {}, 5.0) for Lp in (8, 64, 1024, 4096) for nv in (1, Lp // 2 + 1, Lp)]
CORNERS = {
    "ties": (1024, 1024, {"ties": True}, 5.0),
    "zero distances": (1024, 700, {"zeros": 0.3}, 5.0),
    "disconnected": (1024, 800, {"drop": 40}, 5.0),
    "mcs below every weight": (1024, 1024, {"masses": "frac"}, 0.25),
    "mcs above the total": (1024, 1024, {}, 1e6),
    "fractional masses": (4096, 3000, {"masses": "frac"}, 12.0),
}
CUDA_LPS = (8, 64, 1024, 4096, 8192, 16384, 32768, 65536)
DEEP = ("chain", "star", "comb")
# the new kernels' cases: GRID, CORNERS, the deep shapes at every bucket, merge counts at the
# 1024-merge chunk's borders (Lp − 1 = 1023, 1024, 1025, 2048) and the smallest buckets
PAR_CASES = ([(f"grid-Lp{c[0]}-nvalid{c[1]}", c) for c in GRID] + list(CORNERS.items())
             + [(f"{shape}-Lp{Lp}", (Lp, Lp - Lp // 8, {"shape": shape}, 5.0)) for shape in DEEP for Lp in CUDA_LPS]
             + [(f"chain-Lp{Lp}", (Lp, Lp, {"shape": "chain"}, 5.0)) for Lp in (1024, 1025, 1026, 2049)]
             + [(f"tiny-Lp{Lp}-nvalid{nv}", (Lp, nv, {}, 1.0)) for Lp, nv in ((2, 2), (2, 1), (3, 3), (3, 2))])


def _to(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _run(route, dev, case, seed, method="eom", allow_single=False):
    """(slt, ct, ex) of one case on ``dev``: ``route`` t_h through
    ``hierarchy_fixed`` (the kernels on a card), th through the plain
    loops."""
    Lp, nv, opts, mcs = case
    eu, ev, ew, valid, w = _to(dev, edge_buffers(Lp, nv, seed, **opts))
    if route is t_h:
        return th.hierarchy_fixed(eu, ev, ew, valid, nv, w, mcs, method=method, allow_single_cluster=allow_single)
    slt = th.single_linkage_fixed(eu, ev, ew, valid, nv, w)
    ct = th.condense_fixed(slt, w, mcs)
    return slt, ct, th.extract_fixed(ct, method=method, allow_single_cluster=allow_single)


def order_rtol(ct):
    """Per label slot, how far two f32 sums of its stability terms in
    different orders may lie apart, relative: 1e-5 (the reference's
    contract), or the worst case 2·(k − 1)·2⁻²⁴ of k non-negative terms
    where that is larger (a label that holds most of 65,536 leaves)."""
    n_slots = ct.cluster_parent.shape[0]
    n = int(ct.n_labels)
    k = torch.bincount(ct.point_parent.long().cpu(), minlength=n_slots)[:n_slots]
    k = k + torch.bincount(ct.cluster_parent[1:n].long().cpu(), minlength=n_slots)[:n_slots]
    return torch.clamp(2.0 * (k - 1).clamp(min=0).double() * 2.0 ** -24, min=1e-5)


def assert_same_hierarchy(got, want, stab_rtol=None):
    """Every field bitwise, stabilities included (the kernel and the plain
    version add in one fixed order); with ``stab_rtol`` (a number or one
    per slot), stabilities within that relative tolerance instead."""
    for g_arr, w_arr in zip(got, want):
        for field in w_arr._fields:
            g, w = getattr(g_arr, field).cpu(), getattr(w_arr, field).cpu()
            assert g.shape == w.shape, field
            if field in INT_FIELDS:
                assert torch.equal(g.long(), w.long()), field
            elif field == "stability" and stab_rtol is not None:
                assert bool(((g.double() - w.double()).abs() <= stab_rtol * w.double().abs()).all()), field
            else:
                assert g.dtype == w.dtype and torch.equal(g, w), field


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestHierarchyKernels:
    @pytest.mark.parametrize("case", GRID, ids=lambda c: f"Lp{c[0]}-nvalid{c[1]}")
    def test_grid(self, cuda_device, case):
        counts = (t_h.launches_single_linkage, t_h.launches_condense, t_h.launches_extract, t_h.launches_eom)
        got = _run(t_h, cuda_device, case, seed=case[0] + case[1])
        assert (t_h.launches_single_linkage, t_h.launches_condense, t_h.launches_extract,
                t_h.launches_eom) == (counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
        assert_same_hierarchy(got, _run(th, cuda_device, case, seed=case[0] + case[1]))

    @pytest.mark.parametrize("name", list(CORNERS))
    @pytest.mark.parametrize("method,allow_single", [("eom", False), ("eom", True), ("leaf", False), ("leaf", True)])
    def test_corners(self, cuda_device, name, method, allow_single):
        case = CORNERS[name]
        got = _run(t_h, cuda_device, case, 7, method, allow_single)
        want = _run(th, cuda_device, case, 7, method, allow_single)
        assert_same_hierarchy(got, want)
        if name == "disconnected":  # rejected merges: skipped rows and a loaded trash node
            slt = got[0]
            assert int((slt.left == 2 * case[0] - 1).sum()) > 1 and float(slt.node_weight[-1]) > 0
        if name == "zero distances":  # accepted merges at distance 0: λ = MAX_LAMBDA
            slt = got[0]
            assert bool(((slt.dist == 0) & (slt.left != 2 * case[0] - 1)).any())

    def test_replay(self, cuda_device):
        """Two runs of the kernels give the same bits, stabilities included."""
        case = (4096, 3000, {"masses": "frac"}, 12.0)
        a, b = (_run(t_h, cuda_device, case, 11) for _ in range(2))
        for x, y in zip(a, b):
            for field in x._fields:
                assert torch.equal(getattr(x, field), getattr(y, field)), field

    @pytest.mark.parametrize("Lp", CUDA_LPS)
    def test_buckets_route_state(self, cuda_device, Lp):
        """Every bucket of the offline pass, shared-memory and scratch
        state alike, against the plain loops on the CPU (the card's plain
        loops would take minutes at the largest)."""
        case = (Lp, Lp - Lp // 8, {"masses": "frac"}, 20.0)
        got = _run(t_h, cuda_device, case, 3)
        assert_same_hierarchy(got, _run(th, torch.device("cpu"), case, 3))

    def test_offline_pass_reads_no_host(self, cuda_device):
        """Eq. 6 → Eq. 7 → Borůvka → the hierarchy on the card with no host
        synchronisation: any sync raises under the debug mode."""
        rng = np.random.default_rng(5)
        L = 1000
        rep = rng.normal(size=(L, 4))
        (rep_t, nb_t, ext_t), min_pts, _ = tops._prepare_table(
            rep, rng.integers(1, 4, L).astype(float), rng.uniform(0.01, 0.1, L), 10, cuda_device)
        torch.cuda.synchronize()
        counts = (t_h.launches_extract, t_h.launches_eom)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = tops._offline_pipeline(rep_t, nb_t, ext_t, L, 10.0, min_pts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (t_h.launches_extract, t_h.launches_eom) == (counts[0] + 1, counts[1])
        # the plain loops on the CPU, fed the card's own Borůvka buffers
        _, ct, ex = th.hierarchy_fixed(*(out[k].cpu() for k in ("eu", "ev", "ew", "valid")), L, nb_t.cpu(), 10.0)
        for key, want in (("labels", ex.labels), ("stability", ex.stability), ("selected", ex.selected),
                          ("point_parent", ct.point_parent),
                          ("point_lambda", ct.point_lambda), ("cluster_parent", ct.cluster_parent),
                          ("n_labels", ct.n_labels)):
            assert torch.equal(out[key].cpu(), want), key


@pytest.mark.cuda
class TestHierarchyPar:
    @pytest.mark.parametrize("name,case", PAR_CASES, ids=[n for n, _ in PAR_CASES])
    def test_equal_first_versions_and_plain(self, cuda_device, name, case):
        """single_linkage_sorted and condense (one launch each) bit for bit
        against single_linkage_sorted_v1 / condense_v1 on the same inputs
        and against the plain loops on the CPU."""
        Lp, nv, opts, mcs = case
        bufs = edge_buffers(Lp, nv, 5, **opts)
        eu, ev, ew, valid, w = _to(cuda_device, bufs)
        edges = th.sorted_edges(eu, ev, ew, valid, nv)
        counts = (t_h.launches_single_linkage, t_h.launches_condense)
        slt = t_h.single_linkage_sorted(*edges, w)
        ct = t_h.condense(slt, w, mcs)
        assert (t_h.launches_single_linkage, t_h.launches_condense) == (counts[0] + 1, counts[1] + 1)
        assert_same_hierarchy((slt, ct), (t_h.single_linkage_sorted_v1(*edges, w), t_h.condense_v1(slt, w, mcs)))
        c = _to(torch.device("cpu"), bufs)
        p_slt = th.single_linkage_fixed(*c[:4], nv, c[4])
        assert_same_hierarchy((slt, ct), (p_slt, th.condense_fixed(p_slt, c[4], mcs)))

    @pytest.mark.parametrize("Lp", [8192, 32768])
    def test_replay(self, cuda_device, Lp):
        """Two runs of the new kernels give the same bits (shared-memory
        state at 8192, scratch at 32,768)."""
        eu, ev, ew, valid, w = _to(cuda_device, edge_buffers(Lp, Lp - 100, 13, shape="comb", masses="frac"))
        edges = th.sorted_edges(eu, ev, ew, valid, Lp - 100)
        runs = []
        for _ in range(2):
            slt = t_h.single_linkage_sorted(*edges, w)
            runs.append((slt, t_h.condense(slt, w, 8.0)))
        for x, y in zip(*runs):
            for field in x._fields:
                assert torch.equal(getattr(x, field), getattr(y, field)), field


POLICIES = [("eom", False), ("eom", True), ("leaf", False), ("leaf", True)]


def _condensed_on_card(dev, case, seed=5):
    Lp, nv, opts, mcs = case
    eu, ev, ew, valid, w = _to(dev, edge_buffers(Lp, nv, seed, **opts))
    return t_h.condense(t_h.single_linkage(eu, ev, ew, valid, nv, w), w, mcs)


@pytest.mark.cuda
class TestExtract:
    @pytest.mark.parametrize("name,case", PAR_CASES, ids=[n for n, _ in PAR_CASES])
    def test_equal_plain_and_v1(self, cuda_device, name, case):
        """One launch per call, every field bit for bit the plain
        extract_fixed on the CPU, and the integer fields of extract_v1
        (its index_put_ stabilities within ``order_rtol``), for each
        policy."""
        ct = _condensed_on_card(cuda_device, case)
        c_ct = type(ct)(*(t.cpu() for t in ct))
        for method, single in POLICIES:
            n = t_h.launches_extract
            got = t_h.extract(ct, method, single)
            assert t_h.launches_extract == n + 1
            assert_same_hierarchy([got], [th.extract_fixed(c_ct, method=method, allow_single_cluster=single)])
            assert_same_hierarchy([got], [t_h.extract_v1(ct, method, single)], stab_rtol=order_rtol(c_ct))

    def test_label_count_past_the_shared_memory_cap(self, cuda_device):
        """A comb at Lp = 65,536 with ~34,000 labels: the per-label arrays
        alone (sums, stabilities, offsets, parents, child terms, flags: 26
        bytes a label) outgrow shared memory several times; most go to the
        scratch buffer."""
        ct = _condensed_on_card(cuda_device, (65536, 65536 - 8192, {"shape": "comb"}, 5.0))
        n = int(ct.n_labels)
        assert 26 * n + t_h._BUFFERS["extract"] > t_h.SMEM_BYTES, n
        got = t_h.extract(ct)
        assert_same_hierarchy([got], [th.extract_fixed(type(ct)(*(t.cpu() for t in ct)))])
        assert int(got.n_clusters) > 1000

    @pytest.mark.parametrize("Lp", [8192, 65536])
    def test_replay(self, cuda_device, Lp):
        """Two runs give the same bits (every array in shared memory at
        8192's label count, most in scratch at 65,536)."""
        ct = _condensed_on_card(cuda_device, (Lp, Lp - 100, {"shape": "comb", "masses": "frac"}, 8.0), seed=13)
        for method, single in POLICIES:
            a, b = (t_h.extract(ct, method, single) for _ in range(2))
            for field in a._fields:
                assert torch.equal(getattr(a, field), getattr(b, field)), field

    @pytest.mark.parametrize("Lp", CUDA_LPS)
    def test_scratch_plan_is_the_kernels(self, cuda_device, Lp):
        """kernels/hierarchy.py::plan sizes the scratch buffer as the
        kernel's own layout does."""
        from repro_torch.kernels import _build

        assert t_h.plan("extract", Lp)[1] == _build.load().repro_extract_scratch_bytes(Lp, 2 * Lp + 1)


@pytest.mark.parametrize("Lp", [8, 1024, 8192, 16384, 65536])
def test_cuda_cases_are_well_formed(Lp):
    """The generator's buffers are what Borůvka leaves (runs anywhere), in
    every shape: a chain is one path whose weights rise along it, a star
    one hub, a comb groups of 6 below a path."""
    nv = Lp // 2 + 1
    for shape in ("random",) + DEEP:
        eu, ev, ew, valid, w = edge_buffers(Lp, nv, 1, drop=0, shape=shape)
        assert int(valid.sum()) == Lp // 2 and (eu[~valid] == 0).all() and (ew[~valid] == 0).all()
        assert (w[nv:] == 0).all() and (w[:nv] >= 1).all()
        assert eu.dtype == ev.dtype == np.int32 and ew.dtype == w.dtype == np.float32
        u, v = eu[valid], ev[valid]
        deg = np.bincount(np.concatenate([u, v]), minlength=Lp)
        assert deg[:nv].min() >= 1 and deg[nv:].max(initial=0) == 0
        if shape == "chain":  # consecutive edges by weight share an end: each merge takes in one leaf
            o = np.argsort(ew[valid], kind="stable")
            ends = np.stack([u[o], v[o]], 1)
            assert deg.max() <= 2 and all(set(a) & set(b) for a, b in zip(ends[:-1], ends[1:]))
        if shape == "star":
            assert deg.max() == nv - 1
