"""The port's online–offline summarizer, curator and per-call query path
against the JAX package's, on the CPU.

* ``BubbleTreeSummarizer(device="cpu")`` (W from the plain Eq. 6–7
  versions, the host HDBSCAN over it, the plain assign) against the
  reference's ``use_jax=True`` on the same tie-free blobs: the same
  bubble and point partitions (``conftest.assert_same_partition``), the
  same assignment indices, MST weight within 1e-6 relative;
* the numpy routes (no backend) of both packages: identical arrays;
* the reference's own ``TestOfflinePipeline`` / ``TestBaselines`` cases
  (``tests/test_summarizer.py``) rerun on the port;
* ``StreamCurator`` reports against the reference curator's on one
  stream: counts and bubble masses equal, the top-split λ within 1e-6
  relative and its drift within 1e-6 absolute (f32 W on the port, f64 in
  the reference), the sampling weights within 1e-12;
* ``query_percall`` against ``QueryEngine.query_detailed``;
* ``carry.summarizer_from_reference_state`` against a reference
  summarizer over the same tree;
* the exported names, ``examples/torch_quickstart.py --device cpu``, and
  the default device raising without a GPU.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import assert_same_partition, make_blobs
import repro.core as R_core
import repro.core.summarizer as R_summ
import repro.data as R_data
import repro.data.curation as R_cur
import repro_torch.core as T_core
import repro_torch.data as T_data
from repro_torch import StreamingClusterEngine, get_backend, summarizer_from_reference_state
from repro_torch.core import (
    BubbleTreeSummarizer,
    ClusTreeLite,
    IncrementalBubbles,
    ari,
    assign_points,
    cluster_bubbles,
    hdbscan,
    nmi,
)
from repro_torch.data import StreamCurator
from repro_torch.serving.query import query_percall

ROOT = Path(__file__).resolve().parents[1]
CPU = get_backend("cpu")


def _result_partition(r, t, msg=""):
    assert_same_partition(r.bubble_labels, t.bubble_labels, f"{msg} bubbles")
    np.testing.assert_array_equal(r.point_ids, t.point_ids)
    assert_same_partition(r.point_labels, t.point_labels, f"{msg} points")
    w_r, w_t = r.hdbscan.total_mst_weight, t.hdbscan.total_mst_weight
    assert abs(w_r - w_t) <= 1e-6 * abs(w_r), f"{msg} MST weight {w_t} vs {w_r}"


# the tie-free inputs of the cross-package cases: (X, dim, min_pts, compression)
CASES = {
    "blobs_d2": lambda: (make_blobs(np.random.default_rng(0), n_per=150, scale=0.35)[0], 2, 10, 0.1),
    "mixture_d4": lambda: (importlib.import_module("repro_torch.data.synthetic").gaussian_mixtures(
        900, d=4, k=5, overlap=0.05, seed=7)[0] + 40.0, 4, 12, 0.06),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """The same stream (a block, then a deleted sixth) through the reference
    summarizer with use_jax=True and the port's on the CPU."""
    X, dim, min_pts, compression = CASES[request.param]()
    ref = R_summ.BubbleTreeSummarizer(dim=dim, min_pts=min_pts, compression=compression, use_jax=True)
    port = BubbleTreeSummarizer(dim=dim, min_pts=min_pts, compression=compression, device="cpu")
    for s in (ref, port):
        ids = s.insert_block(X)
        s.delete_block(ids[: len(ids) // 6])
    return request.param, X, ref, port, ref.cluster(), port.cluster()


class TestAgainstReference:
    def test_same_partition(self, pair):
        name, _, _, _, r, t = pair
        for f in ("rep", "n", "extent"):
            np.testing.assert_array_equal(getattr(r.bubbles, f), getattr(t.bubbles, f))
        _result_partition(r, t, name)

    def test_same_assignment(self, pair):
        _, X, ref, port, r, _ = pair
        pids, Xa = port.tree.alive_points()
        a_ref = np.asarray(R_summ.assign_points(Xa, r.bubbles, use_jax=True))
        a_port = assign_points(Xa, r.bubbles, backend=port.backend)
        assert a_port.dtype == np.int32
        np.testing.assert_array_equal(a_port, a_ref)

    def test_numpy_routes_identical(self, pair):
        _, X, _, port, r, _ = pair
        b = port.tree.to_bubbles()
        for kw in (dict(), dict(extent_adjusted=True), dict(min_cluster_size=25.0, allow_single_cluster=True)):
            rr = R_summ.cluster_bubbles(b, port.min_pts, **kw)
            tt = cluster_bubbles(b, port.min_pts, **kw)
            np.testing.assert_array_equal(tt.labels, rr.labels)
            for x, y in zip(tt.mst, rr.mst):
                np.testing.assert_array_equal(x, y)
            assert tt.selected == rr.selected
        _, Xa = port.tree.alive_points()
        np.testing.assert_array_equal(assign_points(Xa, b), R_summ.assign_points(Xa, b))

    def test_stages_run_through_the_hook(self, pair):
        *_, port, _, t = pair
        seen = []

        def stage(name, fn, *a, **kw):
            seen.append(name)
            return fn(*a, **kw)

        out = port.cluster(stage=stage)
        assert seen == ["to_bubbles", "bubble_mutual_reachability", "w_to_host", "hdbscan", "assign_points"]
        np.testing.assert_array_equal(out.point_labels, t.point_labels)


# --- the reference's tests/test_summarizer.py cases, on the port ---------

class TestMetrics:
    def test_nmi_perfect(self):
        a = np.array([0, 0, 1, 1, 2, 2])
        assert nmi(a, a) == pytest.approx(1.0)
        assert nmi(a, np.array([0, 1, 1, 2, 2, 0])) < 1.0

    def test_ari_bounds(self):
        a = np.array([0, 0, 1, 1])
        assert ari(a, a) == pytest.approx(1.0)
        assert ari(a, np.array([0, 1, 0, 1])) <= 0.0 + 1e-9


class TestOfflinePipeline:
    def test_summarized_clustering_matches_static(self, rng):
        X, y = make_blobs(rng, n_per=150, scale=0.35)
        s = BubbleTreeSummarizer(dim=2, min_pts=10, compression=0.1, device="cpu")
        s.insert_block(X)
        out = s.cluster()
        static = hdbscan(X, min_pts=10)
        mask = (out.point_labels >= 0) & (static.labels[out.point_ids] >= 0)
        assert mask.mean() > 0.6
        score = nmi(out.point_labels[mask], static.labels[out.point_ids][mask])
        assert score > 0.85, f"NMI {score}"

    def test_fully_dynamic_summarize_then_cluster(self, rng):
        X, y = make_blobs(rng, n_per=120)
        s = BubbleTreeSummarizer(dim=2, min_pts=10, compression=0.12, device="cpu")
        ids = s.insert_block(X)
        blob0 = [i for i, lab in zip(ids, y) if lab == 0]
        s.delete_block(blob0)
        out = s.cluster()
        found = len(set(out.bubble_labels) - {-1})
        assert found == 2, f"expected 2 clusters after deleting one blob, got {found}"

    def test_device_path_matches_numpy(self, rng):
        """The reference's use_jax-vs-numpy case: the device route (here the
        plain versions) against the numpy route on the same tree."""
        X, y = make_blobs(rng, n_per=80)
        s = BubbleTreeSummarizer(dim=2, min_pts=8, compression=0.15, device="cpu")
        s.insert_block(X)
        out_dev = s.cluster()
        b = s.tree.to_bubbles()
        res = cluster_bubbles(b, 8)
        _, Xa = s.tree.alive_points()
        out_np = res.labels[assign_points(Xa, b)]
        assert nmi(out_np, out_dev.point_labels) > 0.95

    def test_weighted_flat_extraction(self, rng):
        X, y = make_blobs(rng, n_per=100)
        s = BubbleTreeSummarizer(dim=2, min_pts=10, compression=0.1, device="cpu")
        s.insert_block(X)
        out = s.cluster()
        total = 0.0
        for lab in set(out.bubble_labels) - {-1}:
            total += out.bubbles.n[out.bubble_labels == lab].sum()
        assert total <= 300.0 + 1e-9
        assert total > 0.7 * 300


class TestBaselines:
    def test_clustree_insert_and_bubbles(self, rng):
        X, y = make_blobs(rng, n_per=60)
        ct = ClusTreeLite(dim=2, max_height=5)
        for p in X:
            ct.insert(p)
        b = ct.to_bubbles()
        assert b.size >= 2
        assert b.n.sum() == pytest.approx(180.0)

    def test_clustree_decay_forgets(self, rng):
        ct = ClusTreeLite(dim=2, max_height=4, decay_lambda=0.05)
        for p in rng.normal(size=(200, 2)):
            ct.insert(p)
        assert ct.to_bubbles().n.sum() < 200.0

    def test_incremental_bubbles_maintains_L(self, rng):
        X, y = make_blobs(rng, n_per=100)
        inc = IncrementalBubbles(dim=2, compression=0.1)
        for p in X:
            inc.insert(p)
        assert abs(inc.num_leaves - 30) <= 10
        assert inc.to_bubbles().n.sum() == pytest.approx(300.0)

    def test_incremental_delete(self, rng):
        X, y = make_blobs(rng, n_per=80)
        inc = IncrementalBubbles(dim=2, compression=0.1)
        for p in X:
            inc.insert(p)
        for p in X[:100]:
            inc.delete_nearest(p)
        assert inc.to_bubbles().n.sum() == pytest.approx(140.0)

    def test_all_summarizers_cluster_blobs(self, rng):
        X, y = make_blobs(rng, n_per=150, scale=0.3)
        scores = {}
        bt = BubbleTreeSummarizer(dim=2, min_pts=10, compression=0.1, device="cpu")
        bt.insert_block(X)
        out = bt.cluster()
        a = assign_points(X, out.bubbles, backend=bt.backend)
        scores["bubble_tree"] = nmi(out.bubble_labels[a], y)
        for name, summ in (
            ("clustree", ClusTreeLite(dim=2, max_height=5)),
            ("incremental", IncrementalBubbles(dim=2, compression=0.1)),
        ):
            for p in X:
                summ.insert(p)
            b = summ.to_bubbles()
            res = cluster_bubbles(b, min_pts=10, backend=CPU)
            scores[name] = nmi(res.labels[assign_points(X, b, backend=CPU)], y)
        assert scores["bubble_tree"] > 0.8, scores
        assert scores["bubble_tree"] >= max(scores.values()) - 0.1, scores


# --- the curator ------------------------------------------------------------

def test_stream_curator_reports_against_reference():
    rng = np.random.default_rng(5)
    X, _ = make_blobs(rng, centers=((0.0, 0.0, 0.0), (5.0, 0.0, 0.0), (0.0, 5.0, 0.0)), n_per=200, d=3)
    ref = R_cur.StreamCurator(3, min_pts=8, compression=0.05)
    port = StreamCurator(3, min_pts=8, compression=0.05, device="cpu")
    for step, (lo, hi) in enumerate(((0, 300), (300, 450), (450, 600))):
        for c in (ref, port):
            c.observe_block(range(lo, hi), X[lo:hi])
            c.observe(("one", step), X[lo] + 0.01)
            for i in range(lo, lo + 60, 3):
                c.retire(i)
        r, t = ref.curate(step), port.curate(step)
        assert (t.step, t.n_examples, t.n_bubbles, t.n_clusters) == (r.step, r.n_examples, r.n_bubbles, r.n_clusters)
        assert sorted(t.cluster_mass.values()) == sorted(r.cluster_mass.values())
        assert t.overfilled_frac == r.overfilled_frac and t.drifted == r.drifted
        np.testing.assert_allclose(t.top_split_lambda, r.top_split_lambda, rtol=1e-6)
        # drift = |Δλ|/λ: each λ carries f32's ~1e-7 relative error, so the drift an absolute ~2e-7
        np.testing.assert_allclose(t.drift, r.drift, rtol=0, atol=1e-6)
    Z = X[::7] + 0.05
    np.testing.assert_allclose(port.sampling_weights(Z), ref.sampling_weights(Z), rtol=1e-12)
    assert len(port.reports) == 3


# --- the per-call query path --------------------------------------------------

@pytest.mark.parametrize("offset", [0.0, 1e4])
def test_query_percall_matches_cached(rng, offset):
    X, _ = make_blobs(rng, n_per=60)
    eng = StreamingClusterEngine(dim=2, min_pts=8, compression=0.1, min_offline_points=8, device="cpu")
    eng.ingest(X + offset)
    snap = eng.flush()
    Q = np.concatenate([X, rng.normal(size=(40, 2)) * 3.0]) + offset
    res = eng.query_detailed(Q)
    np.testing.assert_array_equal(res.labels, query_percall(eng.backend, snap, Q))
    assert (query_percall(eng.backend, None, Q) == -1).all()


# --- the carry ------------------------------------------------------------------

def test_summarizer_from_reference_state():
    """A port summarizer over a reference engine's checkpointed tree clusters
    as a reference summarizer over that tree does."""
    from repro.serving.stream import StreamingClusterEngine as RefEngine

    X, _ = make_blobs(np.random.default_rng(9), n_per=200, scale=0.35)
    eng = RefEngine(dim=2, min_pts=10, compression=0.08, backend="jnp", min_offline_points=10**9)
    pids = eng.ingest(X + 3.0)
    eng.retire(pids[:100])
    state = eng.checkpoint_state()
    port = summarizer_from_reference_state(state, device="cpu")
    assert port.tree.n_points == eng.tree.n_points and port.min_pts == 10
    ref = R_summ.BubbleTreeSummarizer(dim=2, min_pts=10, compression=0.08, use_jax=True)
    ref.tree = eng.tree
    _result_partition(ref.cluster(), port.cluster(), "carried")
    with pytest.raises(ValueError):
        summarizer_from_reference_state(dict(state, **{"cfg/format": np.int64(99)}), device="cpu")


# --- exports, the example, the default device ---------------------------------

def test_exported_names():
    mapped = {"boruvka_jax": "boruvka"}  # the port's name for each reference name that differs
    missing = {"DeviceTableProtocol"}  # no counterpart (see repro_torch.core's docstring)
    want = {mapped.get(n, n) for n in R_core.__all__} - missing
    assert want <= set(T_core.__all__), want - set(T_core.__all__)
    for name in T_core.__all__:
        assert getattr(T_core, name) is not None
    assert set(R_data.__all__) <= set(T_data.__all__)
    for name in T_data.__all__:
        assert name == "DATASET_SPECS" or getattr(T_data, name).__module__.startswith("repro_torch")


def test_quickstart_example_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "OK"


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="GPU"):
        BubbleTreeSummarizer(dim=2)
    with pytest.raises(RuntimeError, match="GPU"):
        StreamCurator(2)
