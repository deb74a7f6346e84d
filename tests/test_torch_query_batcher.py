"""The port's QueryBatcher and scoped device cache, on the CPU.

The three ``TestQueryBatcher`` cases of tests/test_query.py, on the port
(``device="cpu"``): concurrent callers fan out to their own rows, bad
input raises in the caller only, and a leader that dies takes the
exception to every ticket of its block.  Then the port's batcher against
the reference's ``QueryBatcher`` on engines fed the same stream: labels
and ``bubble_index`` identical, distance and strength within 1e-5 (as
tests/test_torch_stream.py holds the query path).  Then the cache keys:
two scopes at one version are two entries.
"""

import threading

import numpy as np
import pytest

from conftest import make_blobs
from repro.serving import QueryBatcher as RefBatcher
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro_torch import QueryBatcher, StreamingClusterEngine
from repro_torch.serving.query import QueryEngine, SnapshotDeviceCache

ENGINE_KW = dict(min_pts=8, compression=0.1, min_offline_points=8)


def _engine(rng, n_per=60):
    X, _ = make_blobs(rng, n_per=n_per)
    eng = StreamingClusterEngine(dim=2, device="cpu", **ENGINE_KW)
    eng.ingest(X)
    eng.flush()
    return eng, X


def _run_threads(fns):
    """Start one thread per callable, join each with a timeout, and return
    (results, errors); a thread still alive fails the test."""
    results, errors = [None] * len(fns), []

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — surfaced in the test
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results, errors


class TestQueryBatcher:
    def test_concurrent_callers_fan_out_correctly(self, rng):
        eng, X = _engine(rng)
        qb = QueryBatcher(eng, max_batch=256)
        chunks = [rng.normal(size=(int(rng.integers(1, 20)), 2)) * 3.0 for _ in range(16)]
        want = [eng.query(c) for c in chunks]
        got, errors = _run_threads([lambda c=c: qb.query(c) for c in chunks])
        assert not errors, errors[0]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert qb.fanned_out == len(chunks)
        assert 1 <= qb.batches <= len(chunks)

    def test_bad_input_raises_in_caller_only(self, rng):
        eng, X = _engine(rng)
        qb = QueryBatcher(eng)
        with pytest.raises(ValueError):
            qb.query(np.zeros((2, 9)))
        np.testing.assert_array_equal(qb.query(X[:3]), eng.query(X[:3]))
        assert qb.query([]).shape == (0,)

    def test_leader_death_fans_exception_to_whole_block(self, rng):
        eng, X = _engine(rng)
        qb = QueryBatcher(eng, max_batch=256)
        real_qd = eng.query_detailed

        def poison_qd(Xq, **kw):
            raise RuntimeError("poisoned batch")

        eng.query_detailed = poison_qd
        try:
            outcomes = [None] * 8

            def worker(i):
                try:
                    qb.query(rng.normal(size=(3, 2)))
                    outcomes[i] = "ok"
                except RuntimeError as e:
                    outcomes[i] = str(e)

            _run_threads([lambda i=i: worker(i) for i in range(8)])
            assert outcomes == ["poisoned batch"] * 8
        finally:
            eng.query_detailed = real_qd
        np.testing.assert_array_equal(qb.query(X[:5]), eng.query(X[:5]))

    def test_needs_an_engine_or_resolver(self):
        with pytest.raises(ValueError, match="engine or a resolve"):
            QueryBatcher()


class TestAgainstReference:
    def test_concurrent_callers_match_reference_batcher(self, rng):
        X, _ = make_blobs(rng, centers=((0.0, 0.0), (5.0, 0.0), (0.0, 5.0)), n_per=120)
        X = X + np.array([2.0, -1.0])
        port = StreamingClusterEngine(2, device="cpu", **ENGINE_KW)
        ref = RefEngine(2, backend="jnp", **ENGINE_KW)
        for eng in (port, ref):
            for i in range(0, len(X), 90):
                eng.ingest(X[i : i + 90])
            eng.flush()
        assert port.snapshot.version == ref.snapshot.version
        chunks = [rng.normal(size=(int(rng.integers(1, 40)), 2)) * 3.0 + 2.0 for _ in range(12)]
        pb, rb = QueryBatcher(port, max_batch=128), RefBatcher(ref, max_batch=128)
        got, errors = _run_threads([lambda c=c: pb.query_detailed(c) for c in chunks])
        want, ref_errors = _run_threads([lambda c=c: rb.query_detailed(c) for c in chunks])
        assert not errors and not ref_errors
        for g, w in zip(got, want):
            assert g.version == w.version
            np.testing.assert_array_equal(g.labels, w.labels)
            np.testing.assert_array_equal(g.bubble_index, w.bubble_index)
            np.testing.assert_allclose(g.distance, w.distance, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g.strength, w.strength, rtol=1e-5, atol=1e-5)
        assert pb.fanned_out == rb.fanned_out == len(chunks)


class TestScopedCache:
    def test_two_scopes_at_one_version_are_two_entries(self, rng):
        eng, X = _engine(rng)
        snap = eng.snapshot
        cache = SnapshotDeviceCache("cpu", keep=4)
        a = QueryEngine(eng.backend, 2, cache=cache, scope="a")
        b = QueryEngine(eng.backend, 2, cache=cache, scope="b")
        ra, rb = a.query_detailed(snap, X[:7]), b.query_detailed(snap, X[:7])
        np.testing.assert_array_equal(ra.labels, rb.labels)
        assert sorted(cache._entries) == [("a", snap.version), ("b", snap.version)]
        assert cache.builds == 2 and cache.hits == 0
        a.query_detailed(snap, X[:3])
        assert cache.hits == 1

    def test_unscoped_engine_keys_by_version(self, rng):
        eng, X = _engine(rng)
        eng.query(X[:4])
        assert list(eng._query_engine.cache._entries) == [eng.snapshot.version]
