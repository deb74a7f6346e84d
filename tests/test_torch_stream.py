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

The exact-dynamic cases (``-k exact``) drive an interleaved insert /
delete / query stream, as tests/test_hybrid_fuzz.py does, through both
``exact=True`` engines: every poll the same version, the same partition,
MST weight within 1e-6 relative, the same served rows, and the same
``incremental_blocks`` / ``exact_full_blocks`` / ``exact_rebuilds``.
"""

import numpy as np
import pytest

from conftest import assert_same_partition, make_blobs
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro.serving.stream import UpdatePolicy as RefPolicy
from repro_torch import StreamingClusterEngine, UpdatePolicy, engine_from_reference_state

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
        """Both modes once refused carry across: an exact-mode reference
        checkpoint as an exact-mode engine, and a default-mode one into a
        mesh engine (``mesh=("cpu",) * 2``, once refused too), each resuming
        in step with the reference; an exact checkpoint with a mesh is
        refused as the reference refuses it."""
        ops = _stream(5)
        head, tail = ops[:6], ops[6:10]
        ref = RefEngine(DIM, backend="jnp", exact=True, **ENGINE_KW)
        pids = [p for kind, payload in head if kind == "insert" for p in ref.ingest(payload)]
        port = engine_from_reference_state(
            ref.checkpoint_state(), device="cpu",
            max_block=ENGINE_KW["max_block"], min_offline_points=ENGINE_KW["min_offline_points"])
        assert port.exact and port.snapshot.version == ref.snapshot.version
        for kind, payload in tail:
            if kind == "insert":
                pids.extend(port.ingest(payload))
                assert ref.ingest(payload) == pids[-len(payload):]
            elif kind == "delete":
                port.retire([pids[i] for i in payload])
                ref.retire([pids[i] for i in payload])
            else:
                _assert_same_queries(port, ref, payload)
            assert port.snapshot.version == ref.snapshot.version
            _assert_same_snapshot(port.snapshot, ref.snapshot)
        with pytest.raises(ValueError, match="exact=True"):
            engine_from_reference_state(ref.checkpoint_state(), device="cpu", mesh=("cpu",) * 2)
        ref = RefEngine(DIM, backend="jnp", **ENGINE_KW)
        pids = [p for kind, payload in head if kind == "insert" for p in ref.ingest(payload)]
        port = engine_from_reference_state(
            ref.checkpoint_state(), device="cpu", mesh=("cpu",) * 2,
            max_block=ENGINE_KW["max_block"], min_offline_points=ENGINE_KW["min_offline_points"])
        assert len(port.mesh.devices) == 2 and port.snapshot.version == ref.snapshot.version
        for kind, payload in tail:
            if kind == "insert":
                pids.extend(port.ingest(payload))
                assert ref.ingest(payload) == pids[-len(payload):]
            elif kind == "delete":
                port.retire([pids[i] for i in payload])
                ref.retire([pids[i] for i in payload])
            else:
                _assert_same_queries(port, ref, payload)
            assert port.snapshot.version == ref.snapshot.version
            _assert_same_snapshot(port.snapshot, ref.snapshot)
        assert port.stats["recluster_count"] >= 1


class TestEngineOptions:
    @pytest.mark.parametrize("opt", [{"exact": True}, {"mesh": ("cpu",) * 2}])
    def test_options_not_ported_raise(self, opt):
        """The options once refused as not ported, ``exact`` and ``mesh``,
        construct and poll: exact mode publishes every point as a bubble,
        the mesh engine the unsharded engine's snapshot bit for bit."""
        X = _stream(3)[0][1]
        eng = StreamingClusterEngine(DIM, device="cpu", **opt, **ENGINE_KW)
        eng.submit_insert(X)
        assert eng.poll() == 150
        assert eng.snapshot.n_points == 150
        if "exact" in opt:
            assert eng.snapshot.n_bubbles == 150
            return
        plain = StreamingClusterEngine(DIM, device="cpu", **ENGINE_KW)
        plain.submit_insert(X)
        plain.poll()
        np.testing.assert_array_equal(eng.snapshot.bubble_labels, plain.snapshot.bubble_labels)
        for a, b in zip(eng.snapshot.mst, plain.snapshot.mst, strict=True):
            np.testing.assert_array_equal(a, b)

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


EXACT_KW = dict(exact=True, min_pts=5, min_cluster_size=5.0, exact_capacity=64, min_offline_points=10)
EXACT_COUNTERS = ("incremental_blocks", "exact_full_blocks", "exact_rebuilds")


def _exact_stream(seed: int, steps: int):
    """Interleaved ops in the manner of tests/test_hybrid_fuzz.py: inserts
    of 1–11 points around three centres, deletes of 1–5 live points (by
    insert position), query batches."""
    rng = np.random.default_rng(seed)
    centres = np.array([[0.0, 0.0, 0.0], [6.0, 6.0, 0.0], [-6.0, 5.0, 1.0]])
    ops, live, n_ins = [], [], 0
    for step in range(steps):
        r = rng.random()
        if step < 4 or len(live) < 30 or r < 0.5:
            k = int(rng.integers(1, 12))
            ops.append(("insert", centres[rng.integers(3, size=k)] + rng.normal(size=(k, 3))))
            live += range(n_ins, n_ins + k)
            n_ins += k
        elif r < 0.85:
            pos = set(rng.choice(len(live), size=int(rng.integers(1, 6)), replace=False).tolist())
            ops.append(("delete", [a for i, a in enumerate(live) if i in pos]))
            live = [a for i, a in enumerate(live) if i not in pos]
        else:
            ops.append(("query", rng.normal(size=(30, 3)) * 4.0))
    return ops


def _drive_exact(port, ref, ops):
    pids = []
    for kind, payload in ops:
        if kind == "insert":
            a, b = port.ingest(payload), ref.ingest(payload)
            assert a == b
            pids.extend(a)
        elif kind == "delete":
            port.retire([pids[i] for i in payload])
            ref.retire([pids[i] for i in payload])
        else:
            _assert_same_queries(port, ref, payload)
        assert (port.snapshot is None) == (ref.snapshot is None)
        if ref.snapshot is not None:
            assert port.snapshot.version == ref.snapshot.version
            _assert_same_snapshot(port.snapshot, ref.snapshot)
            np.testing.assert_allclose(port.snapshot.total_mst_weight, ref.snapshot.total_mst_weight, rtol=1e-6)
        assert [port.stats[k] for k in EXACT_COUNTERS] == [ref.stats[k] for k in EXACT_COUNTERS]
    pa, la = port.labels()
    pb, lb = ref.labels()
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(la, lb)


class TestExactMode:
    @pytest.mark.parametrize("spatial", [False, True], ids=["dense", "spatial"])
    def test_exact_stream_matches_reference(self, spatial):
        kw = dict(EXACT_KW, spatial_index=spatial)
        port = StreamingClusterEngine(DIM, device="cpu", update_policy=UpdatePolicy(0.25, 24), **kw)
        ref = RefEngine(DIM, backend="jnp", update_policy=RefPolicy(0.25, 24), **kw)
        _drive_exact(port, ref, _exact_stream(3, 30))
        assert port.stats["incremental_blocks"] > 0 and port.stats["exact_rebuilds"] > 1
        assert port._dyn.state.X.device.type == "cpu"

    def test_exact_fallback_only_policy(self):
        """``max_update_frac=0``: every block routes full, every refresh
        rebuilds — still the reference's snapshots."""
        port = StreamingClusterEngine(DIM, device="cpu", update_policy=UpdatePolicy(0.0, 24), **EXACT_KW)
        ref = RefEngine(DIM, backend="jnp", update_policy=RefPolicy(0.0, 24), **EXACT_KW)
        _drive_exact(port, ref, _exact_stream(4, 14))
        assert port.stats["incremental_blocks"] == 0 < port.stats["exact_full_blocks"]

    @pytest.mark.parametrize("opt", ["async_offline", "device_online"])
    def test_exact_refuses_incompatible_modes(self, opt):
        with pytest.raises(ValueError, match=opt.split("_")[0]):
            StreamingClusterEngine(DIM, device="cpu", exact=True, **{opt: True})

    def test_exact_runs_on_the_card_by_default(self):
        """Without ``device`` the engine resolves ``cuda``: on a machine
        with no GPU that raises and says how to ask for the CPU."""
        import torch

        if torch.cuda.is_available():
            eng = StreamingClusterEngine(16, exact=True)
            assert eng._dyn.state.X.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                StreamingClusterEngine(16, exact=True)
