"""The port's TenantRouter, on the CPU.

The six cases of tests/test_tenants.py on the port (``device="cpu"``):
one shared ``SnapshotDeviceCache`` keyed ``(tenant, version)``, one
``QueryBatcher`` whose blocks never mix tenants, lifecycle errors,
per-tenant overrides (a ``device_online`` tenant among them, which
ingests and serves beside the others), and ``save_all`` / ``recover``
replaying the fleet bit for bit.  Then per-tenant labels against a reference
``TenantRouter`` fed the same traffic (same versions, same partition per
tenant, served labels identical), with and without ``spatial_index``,
and with ``exact=True`` reaching every tenant's engine.
"""

import threading

import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro.serving import TenantRouter as RefRouter
from repro_torch import TenantRouter

ROUTER_KW = dict(min_pts=8, compression=0.15, min_offline_points=8)


def _router(tmp_path=None, **kw):
    return TenantRouter(2, device="cpu", checkpoint_root=None if tmp_path is None else str(tmp_path),
                        **{**ROUTER_KW, **kw})


def _tenant_data(rng, n_tenants, n=120):
    """Well-separated per-tenant datasets: labels leaking across tenants
    would show at once."""
    return {f"t{i}": rng.normal(size=(n, 2)) + 10.0 * i for i in range(n_tenants)}


class TestRouting:
    def test_isolation_and_shared_cache_keys(self, rng):
        r = _router()
        data = _tenant_data(rng, 3)
        for name, X in data.items():
            r.create(name)
            r.ingest(name, X)
        r.flush()
        for name, X in data.items():
            np.testing.assert_array_equal(r.query(name, X[:40]), r.engine(name).query(X[:40]))
        assert sorted(r.cache._entries) == [(n, 1) for n in sorted(data)]
        st = r.stats()
        assert st["tenants"] == 3 and st["cache_builds"] == 3

    def test_concurrent_mixed_tenants_through_one_batcher(self, rng):
        r = _router()
        data = _tenant_data(rng, 4)
        for name, X in data.items():
            r.create(name)
            r.submit_insert(name, X)
        assert r.poll() == 4 * 120
        r.flush()
        want = {n: r.engine(n).query(X[:25]) for n, X in data.items()}
        got, errors = {}, []

        def worker(name, X):
            try:
                got[name] = r.query(name, X[:25])
            except BaseException as e:  # noqa: BLE001 — surfaced in main
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(n, X)) for n, X in data.items() for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        for name in data:
            np.testing.assert_array_equal(got[name], want[name])
        assert r.batcher.fanned_out == len(threads)
        assert r.batcher.batches >= len(data)

    def test_lifecycle_errors(self, rng):
        r = _router()
        r.create("acme")
        with pytest.raises(ValueError, match="already exists"):
            r.create("acme")
        with pytest.raises(ValueError, match="must match"):
            r.create("../escape")
        with pytest.raises(KeyError, match="unknown tenant"):
            r.query("ghost", np.zeros((1, 2)))
        assert "acme" in r and len(r) == 1
        with pytest.raises(RuntimeError, match="checkpoint_root"):
            r.save("acme")
        r.drop("acme")
        assert "acme" not in r

    def test_per_tenant_overrides(self, rng):
        r = _router(epsilon=0.5)
        a = r.create("small")
        b = r.create("wide", dim=3, epsilon=0.1)
        assert a.policy.epsilon == 0.5 and b.policy.epsilon == 0.1 and b.tree.dim == 3
        assert a._query_engine.cache is r.cache is b._query_engine.cache
        assert a._query_engine.scope == "small"
        online = r.create("online", device_online=True)
        assert "online" in r and online._flat is not None
        X = np.concatenate([rng.normal(size=(40, 2)) * 0.3 + c for c in ([0, 0], [5, 0], [0, 5])])
        for i in range(0, len(X), 40):  # the first block bootstraps on the host, the rest on the device
            r.ingest("online", X[i : i + 40])
        r.flush()
        assert online.stats["device_online_blocks"] >= 1 and not online._flat.stale
        assert online.snapshot is not None and online.snapshot.n_clusters >= 2
        want = online.query(X[:30])
        np.testing.assert_array_equal(r.query("online", X[:30]), want)
        assert set(want.tolist()) - {-1}


class TestFleetRecovery:
    def test_save_all_recover_bitwise(self, rng, tmp_path):
        data = _tenant_data(rng, 3)
        r = _router(tmp_path)
        for name, X in data.items():
            r.create(name)
            r.ingest(name, X[:80])
        r.flush()
        want = {n: r.query(n, X[:30]) for n, X in data.items()}
        steps = r.save_all()
        assert sorted(steps) == sorted(data)
        r.close()

        r2 = _router(tmp_path)
        assert r2.recover() == sorted(data)
        for name, X in data.items():
            np.testing.assert_array_equal(r2.query(name, X[:30]), want[name])
        for name, X in data.items():
            r2.ingest(name, X[80:])
        r2.flush()
        oracle = _router()
        for name, X in data.items():
            oracle.create(name)
            oracle.ingest(name, X[:80])
        oracle.flush()
        for name, X in data.items():
            oracle.ingest(name, X[80:])
        oracle.flush()
        for name in data:
            e1, e2 = oracle.engine(name), r2.engine(name)
            assert e1.snapshot.version == e2.snapshot.version
            np.testing.assert_array_equal(e1.snapshot.bubble_labels, e2.snapshot.bubble_labels)
            np.testing.assert_array_equal(e1.snapshot.mst[2], e2.snapshot.mst[2])
        r2.close()

    def test_recover_skips_unpublished_tenants(self, rng, tmp_path):
        r = _router(tmp_path)
        r.create("ready")
        r.ingest("ready", rng.normal(size=(60, 2)))
        r.flush()
        r.save("ready")
        (tmp_path / "empty-tenant").mkdir()
        r.close()
        r2 = _router(tmp_path)
        assert r2.recover() == ["ready"]
        assert "empty-tenant" not in r2
        r2.close()


class TestAgainstReference:
    def test_per_tenant_labels_match_reference_router(self, rng):
        data = _tenant_data(rng, 3, n=150)
        port = _router()
        ref = RefRouter(2, backend="jnp", **ROUTER_KW)
        for r in (port, ref):
            for name in data:
                r.create(name)
            for i in range(0, 150, 50):  # interleaved blocks
                for name, X in data.items():
                    r.submit_insert(name, X[i : i + 50])
                r.poll()
            r.flush()
        for name, X in data.items():
            ps, rs = port.engine(name).snapshot, ref.engine(name).snapshot
            assert ps.version == rs.version
            assert_same_partition(ps.bubble_labels, rs.bubble_labels)
            Q = X[::3] + 0.05
            a, b = port.query_detailed(name, Q), ref.query_detailed(name, Q)
            np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert len(set(a.labels.tolist()) - {-1}) >= 1


class TestOptions:
    def test_spatial_index_is_not_ported(self, rng):
        """``spatial_index=True`` reaches every tenant's engine and the
        shared cache (whose entries then carry their grid), and the router
        serves the reference router's partitions and labels."""
        data = _tenant_data(rng, 2, n=150)
        port = _router(spatial_index=True)
        ref = RefRouter(2, backend="jnp", spatial_index=True, **ROUTER_KW)
        for r in (port, ref):
            for name, X in data.items():
                r.create(name)
                r.ingest(name, X)
            r.flush()
        assert port.cache.spatial
        for name, X in data.items():
            eng = port.engine(name)
            assert eng.backend.spatial_index
            ps, rs = eng.snapshot, ref.engine(name).snapshot
            assert ps.version == rs.version
            assert_same_partition(ps.bubble_labels, rs.bubble_labels)
            Q = X[::3] + 0.05
            a, b = port.query_detailed(name, Q), ref.query_detailed(name, Q)
            np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert port.cache._entries[(name, ps.version)].grid is not None

    def test_exact_mode_reaches_every_engine(self, rng):
        """``exact=True`` (and its update policy) pass through the router to
        every tenant's engine, which serves the reference router's
        versions, partitions and labels, with the same exact-mode counters."""
        from repro.serving.stream import UpdatePolicy as RefPolicy
        from repro_torch import UpdatePolicy

        data = _tenant_data(rng, 2, n=150)
        port = _router(exact=True, update_policy=UpdatePolicy(0.5, 24))
        ref = RefRouter(2, backend="jnp", exact=True, update_policy=RefPolicy(0.5, 24), **ROUTER_KW)
        for r in (port, ref):
            for name in data:
                r.create(name)
            for i in range(0, 150, 30):  # interleaved blocks, incremental past the first
                for name, X in data.items():
                    r.submit_insert(name, X[i : i + 30])
                r.poll()
            r.flush()
        for name, X in data.items():
            pe, re_ = port.engine(name), ref.engine(name)
            assert pe.exact and pe._dyn is not None
            counters = ("incremental_blocks", "exact_full_blocks", "exact_rebuilds")
            assert [pe.stats[k] for k in counters] == [re_.stats[k] for k in counters]
            assert pe.stats["incremental_blocks"] > 0
            ps, rs = pe.snapshot, re_.snapshot
            assert ps.version == rs.version and ps.n_bubbles == 150
            assert_same_partition(ps.bubble_labels, rs.bubble_labels)
            Q = X[::3] + 0.05
            a, b = port.query_detailed(name, Q), ref.query_detailed(name, Q)
            np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
            np.testing.assert_array_equal(a.labels, b.labels)

    def test_default_device_raises_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a GPU: the default device resolves")
        with pytest.raises(RuntimeError, match="GPU"):
            TenantRouter(2)
