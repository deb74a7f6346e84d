"""The port's streaming engine against the JAX package's, on the CPU.

The main-path milestone: one seeded insert/delete/query stream through
the reference engine (``backend="jnp"``) and the port (``device="cpu"``)
must publish the same snapshots — same version after every poll, same
partition (``conftest.assert_same_partition``), MST weight within 1e-5
relative — and ``query_detailed`` must return identical labels and
``bubble_index``, with distance and strength within 1e-5 (relative, plus
an absolute 1e-5 for the f32 cancellation of the expanded distance on
these unit-scale centred queries).  Sync mode compares after every poll;
async mode after ``flush()``, since the publish points of background
passes depend on timing.

The carry test starts the port from the reference's
``checkpoint_state()`` mid-stream and feeds both the same further blocks.
"""

import numpy as np
import pytest

from conftest import assert_same_partition, make_blobs
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro_torch import StreamingClusterEngine, engine_from_reference_state

DIM = 3
CENTERS = ((0.0, 0.0, 0.0), (3.0, 0.0, 0.0), (0.0, 3.0, 0.0))
ENGINE_KW = dict(min_pts=5, compression=0.05, epsilon=0.2, max_block=256, min_offline_points=32)


def _stream(seed: int):
    """A seeded op list: inserts of blob points (off the origin), deletes
    of earlier, still-alive inserts (by insert position — point ids are
    recycled), and query batches."""
    rng = np.random.default_rng(seed)
    X, _ = make_blobs(rng, centers=CENTERS, n_per=240, d=DIM, scale=0.3)
    X = X + np.array([0.5, -0.25, 1.0])
    alive = np.zeros(len(X), dtype=bool)
    ops, off = [], 0

    def insert(size):
        nonlocal off
        ops.append(("insert", X[off : off + size]))
        alive[off : off + size] = True
        off += size

    def delete(size):
        pos = rng.choice(np.nonzero(alive)[0], size=size, replace=False)
        alive[pos] = False
        ops.append(("delete", pos))

    def query():
        ops.append(("query", rng.normal(size=(40, DIM)) * 1.5 + X.mean(axis=0)))

    for size in (150, 150, 120, 100):
        insert(size)
        query()
    delete(90)
    insert(100)
    query()
    delete(60)
    query()
    return ops


def _assert_same_snapshot(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert port.n_bubbles == ref.n_bubbles
    np.testing.assert_array_equal(port.bubble_rep, ref.bubble_rep)
    assert_same_partition(port.bubble_labels, ref.bubble_labels)
    np.testing.assert_allclose(port.total_mst_weight, ref.total_mst_weight, rtol=1e-5)


def _assert_same_queries(port_eng, ref_eng, Q):
    a, b = port_eng.query_detailed(Q), ref_eng.query_detailed(Q)
    assert a.version == b.version
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
    np.testing.assert_allclose(a.distance, b.distance, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.strength, b.strength, rtol=1e-5, atol=1e-5)


def _drive(engines, ops, check_each_poll: bool):
    """Apply ``ops`` to every engine (pids kept per engine), comparing the
    first against the second after each poll when asked."""
    pids = [[] for _ in engines]
    for kind, payload in ops:
        for eng, mine in zip(engines, pids):
            if kind == "insert":
                mine.extend(eng.ingest(payload))
            elif kind == "delete":
                eng.retire([mine[i] for i in payload])
        if check_each_poll:
            port, ref = engines
            assert port.snapshot is not None or ref.snapshot is None
            if ref.snapshot is not None:
                assert port.snapshot.version == ref.snapshot.version
            _assert_same_snapshot(port.snapshot, ref.snapshot)
            if kind == "query":
                _assert_same_queries(port, ref, payload)
    assert pids[0] == pids[1]


class TestMainPathMilestone:
    def test_sync_stream_matches_reference(self):
        port = StreamingClusterEngine(DIM, device="cpu", **ENGINE_KW)
        ref = RefEngine(DIM, backend="jnp", **ENGINE_KW)
        ops = _stream(7)
        _drive([port, ref], ops, check_each_poll=True)
        assert port.stats["recluster_count"] == ref.stats["recluster_count"] >= 3
        port.flush(), ref.flush()
        _assert_same_snapshot(port.snapshot, ref.snapshot)
        _assert_same_queries(port, ref, ops[-1][1])
        pa, la = port.labels()
        pb, lb = ref.labels()
        np.testing.assert_array_equal(pa, pb)
        assert_same_partition(la, lb)

    def test_async_stream_matches_reference_after_flush(self):
        port = StreamingClusterEngine(DIM, device="cpu", async_offline=True, **ENGINE_KW)
        ref = RefEngine(DIM, backend="jnp", async_offline=True, **ENGINE_KW)
        ops = _stream(11)
        _drive([port, ref], ops, check_each_poll=False)
        port.flush(), ref.flush()
        _assert_same_snapshot(port.snapshot, ref.snapshot)
        a, b = port.query_detailed(ops[-1][1]), ref.query_detailed(ops[-1][1])
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
        np.testing.assert_allclose(a.distance, b.distance, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.strength, b.strength, rtol=1e-5, atol=1e-5)


class TestCarry:
    def test_resume_from_reference_checkpoint(self):
        ops = _stream(5)
        head, tail = ops[:6], ops[6:]
        ref = RefEngine(DIM, backend="jnp", **ENGINE_KW)
        pids = []
        for kind, payload in head:
            if kind == "insert":
                pids.extend(ref.ingest(payload))
        port = engine_from_reference_state(
            ref.checkpoint_state(), device="cpu",
            max_block=ENGINE_KW["max_block"], min_offline_points=ENGINE_KW["min_offline_points"])
        assert port.snapshot.version == ref.snapshot.version
        _assert_same_snapshot(port.snapshot, ref.snapshot)
        assert port.tree.dirty_mass == ref.tree.dirty_mass
        for kind, payload in tail:
            if kind == "insert":
                a, b = port.ingest(payload), ref.ingest(payload)
                assert a == b  # free-list order carried: same point ids
                pids.extend(a)
            elif kind == "delete":
                port.retire([pids[i] for i in payload])
                ref.retire([pids[i] for i in payload])
            else:
                _assert_same_queries(port, ref, payload)
            assert port.snapshot.version == ref.snapshot.version
            _assert_same_snapshot(port.snapshot, ref.snapshot)
        port.tree.check_invariants()

    def test_rejects_modes_not_ported(self):
        ref = RefEngine(DIM, backend="jnp", **ENGINE_KW)
        state = ref.checkpoint_state()
        state["cfg/exact"] = np.bool_(True)
        with pytest.raises(NotImplementedError):
            engine_from_reference_state(state, device="cpu")


class TestEngineOptions:
    @pytest.mark.parametrize("opt", [{"exact": True}, {"mesh": True}])
    def test_options_not_ported_raise(self, opt):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            StreamingClusterEngine(DIM, device="cpu", **opt)

    @pytest.mark.parametrize("device_online", [False, True], ids=["host_table", "device_online"])
    def test_spatial_index_runs_the_stream(self, device_online):
        """``spatial_index=True`` (the grid, kernels/grid.py) builds,
        ingests, retires, reclusters and serves in step with the reference
        engine of the same mode: the same partition at every snapshot and
        the same ``query_detailed`` labels and bubble rows."""
        kw = dict(ENGINE_KW, spatial_index=True, device_online=device_online)
        port = StreamingClusterEngine(DIM, device="cpu", **kw)
        ref = RefEngine(DIM, backend="jnp", **kw)
        assert repr(port.backend).endswith("spatial_index=True)")
        _drive([port, ref], _stream(7), check_each_poll=True)
        assert port.stats["recluster_count"] == ref.stats["recluster_count"] >= 3
        assert port.stats["device_online_blocks"] == ref.stats["device_online_blocks"]
        assert (port.stats["device_online_blocks"] > 0) == device_online

    def test_device_online_runs_the_stream(self):
        """``device_online=True`` builds, ingests, retires, reclusters and
        serves, in step with the reference engine of the same mode (the
        flat table's own parity cases are tests/test_torch_flat.py)."""
        port = StreamingClusterEngine(DIM, device="cpu", device_online=True, **ENGINE_KW)
        ref = RefEngine(DIM, backend="jnp", device_online=True, **ENGINE_KW)
        _drive([port, ref], _stream(7), check_each_poll=True)
        assert port.stats["recluster_count"] == ref.stats["recluster_count"] >= 3
        assert port.stats["device_online_blocks"] == ref.stats["device_online_blocks"] > 0
        assert not port._flat.stale and port._table is port._flat


class TestSnapshotCache:
    def test_single_flight_under_contention(self):
        """Many readers racing a fresh version build its device entry once
        and all get that one entry (the cache's single-flight contract)."""
        import sys
        import threading

        from repro_torch.serving.query import SnapshotDeviceCache

        eng = StreamingClusterEngine(DIM, device="cpu", **ENGINE_KW)
        eng.ingest(_stream(3)[0][1])
        snap = eng.flush()
        cache = SnapshotDeviceCache("cpu", keep=2)
        got, start = [], threading.Barrier(16)

        def read():
            start.wait(timeout=30)
            got.append(cache.entry(snap))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=read) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 16 and all(e is got[0] for e in got)
        assert cache.builds == 1 and cache.hits == 15
