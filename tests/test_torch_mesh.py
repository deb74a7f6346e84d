"""The sharded offline pass (``mesh=``, DESIGN.md §12) of the port, on the CPU.

A k-way mesh here is one CPU named k times (``("cpu",) * k``), the
port's counterpart of the reference tests' forced host devices; k runs
over 1, 2, 3, 4 and 8, so strips and block ranges come uneven and, on
the small tables, empty.  Every shard then runs the plain versions of
the strip kernels (on the CPU, slices of one plain distance matrix: a
CPU BLAS may round a strip's product otherwise than the same rows of the
whole one).

Held:

* the port's sharded pass BIT FOR BIT its unsharded pass — labels, MST
  u/v/w, stabilities and every condensed field — dense and
  ``spatial_index=True``, from the host table and from the device-online
  flat table, on spread, tie-heavy (integer grid) and duplicate-heavy
  tables with an ``n_valid`` below the bucket; the sharded d_m matrix bit
  for bit ``bubble_mutual_reachability``;
* ``boruvka_shard`` / ``boruvka_grid_shard`` buffer for buffer against
  ``boruvka`` / ``boruvka_grid``, and the grid's sharded Eq. 6;
* the JAX package's sharded pass (``repro.launch.mesh.make_host_mesh()``:
  one device here, so k = 1) against the port's sharded pass under the
  parity tiers: the same partition, MST weight within 1e-6 relative,
  stabilities within 1e-5, W within 1e-5 relative plus 1e-5 (the f32
  cancellation of the expanded distance at unit scale);
* the engine with a mesh against the unsharded engine (every published
  snapshot and every served row bit for bit, host-table and
  device-online) and against the reference engine with ``mesh=True``
  under the tiers; checkpoints across mesh and no mesh; a router's
  engines with a mesh;
* the reference's refusals: ``exact=True`` or ``return_w`` with a mesh, a
  mesh mixing device types; ``leaf_row_owner`` against the reference's.

The strip kernels bit for bit their whole launches on the card are in
tests/test_torch_cuda.py (``-k Mesh``).
"""

import numpy as np
import pytest
import torch

from conftest import assert_same_partition, make_blobs
from repro.kernels import ops as jops
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.sharding import leaf_row_owner as ref_leaf_row_owner
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro_torch import CheckpointStore, StreamingClusterEngine, TenantRouter
from repro_torch.core import mst as tmst
from repro_torch.core.bubble_tree import BubbleTree
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import grid as t_grid
from repro_torch.kernels import mutual_reach as t_mr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import Mesh, leaf_row_owner, make_host_mesh, resolve_mesh, shard_ranges

MIN_PTS = 5
MCS = 2.0
KS = (1, 2, 3, 4, 8)
FIELDS = ("labels", "stabilities", "weights", "point_parent", "point_lambda", "cluster_parent", "cluster_birth",
          "cluster_weight", "selected", "all_stabilities")


def _cpu_mesh(k):
    return ("cpu",) * k


def _table(kind: str, L: int, d: int, seed: int = 0):
    """A bubble table off the origin: ``spread`` Gaussian reps, ``ties``
    reps on an integer grid (many equal distances), ``dups`` a third of
    the rows copies of a few."""
    rng = np.random.default_rng(seed)
    rep = rng.normal(size=(L, d)) * 3.0
    if kind == "ties":
        rep = np.round(rep)
    elif kind == "dups":
        rep[: L // 3] = rep[rng.integers(L // 3, L, size=4)][rng.integers(0, 4, size=L // 3)]
    n_b = rng.integers(1, 9, size=L).astype(np.float64)
    extent = rng.uniform(0.1, 1.0, size=L)
    return rep + 20.0, n_b, extent


def _assert_same_result(got, want, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{msg} {f}")
    for a, b in zip(got.mst, want.mst, strict=True):
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} mst")


def _f32(*arrays):
    return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in arrays)


class TestShardedPass:
    @pytest.mark.parametrize("spatial", [False, True], ids=["dense", "spatial"])
    @pytest.mark.parametrize("kind,L,d", [("spread", 300, 16), ("ties", 600, 2), ("dups", 300, 2)])
    def test_from_table_bitwise_unsharded(self, kind, L, d, spatial):
        rep, n_b, extent = _table(kind, L, d)
        want = tops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, MCS, device="cpu", spatial_index=spatial)
        for k in KS:
            got = tops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, MCS, device="cpu",
                                                    spatial_index=spatial, mesh=_cpu_mesh(k))
            _assert_same_result(got, want, f"k={k}")

    @staticmethod
    def _flat_state(L=45, d=3, Lp=64, seed=11):
        """A device-online flat table: L populated slots spread over Lp
        with dead ones between (origin-centred compensated sums)."""
        rng = np.random.default_rng(seed)
        slots = np.sort(rng.choice(Lp, size=L, replace=False))
        X = np.round(rng.normal(size=(L, d)) * 2.0)
        n = rng.integers(1, 6, size=L).astype(np.float64)
        LS, SS, N = np.zeros((Lp, d), np.float32), np.zeros(Lp, np.float32), np.zeros(Lp, np.float32)
        alive = np.zeros(Lp, bool)
        LS[slots] = X * n[:, None]
        SS[slots] = np.sum(X * X, -1) * n + rng.uniform(0, 1, L)
        N[slots] = n
        alive[slots] = True
        LSe, SSe = np.full_like(LS, 1e-7), np.full_like(SS, -1e-7)
        view = _f32(LS, LSe, SS, SSe, N) + (torch.as_tensor(alive),)
        return view, np.full(d, 3.0), slots

    @pytest.mark.parametrize("spatial", [False, True], ids=["dense", "spatial"])
    def test_from_device_table_bitwise_unsharded(self, spatial):
        view, origin, slots = self._flat_state()
        want = tops.offline_recluster_from_device_table(*view, origin, MIN_PTS, MCS, slots=slots,
                                                        spatial_index=spatial)
        for k in KS:
            got = tops.offline_recluster_from_device_table(*view, origin, MIN_PTS, MCS, slots=slots,
                                                           spatial_index=spatial, mesh=_cpu_mesh(k))
            _assert_same_result(got[0], want[0], f"k={k}")
            for a, b in zip(got[1:], want[1:], strict=True):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("kind,d", [("spread", 16), ("ties", 2)])
    def test_mutual_reachability_sharded_bitwise(self, kind, d):
        rep, n_b, extent = _f32(*_table(kind, 200, d))
        want = tops.bubble_mutual_reachability(rep, n_b, extent, MIN_PTS)
        for k in KS:
            got = tops.bubble_mutual_reachability_sharded(rep, n_b, extent, MIN_PTS, _cpu_mesh(k))
            assert torch.equal(got, want), k


class TestShardedBoruvka:
    @staticmethod
    def _padded(kind, L, Lp, d):
        rep, n_b, extent = _table(kind, L, d)
        rep = np.concatenate([rep - rep.mean(0), np.full((Lp - L, d), 1e6)])
        n_b, extent = (np.concatenate([a, np.zeros(Lp - L)]) for a in (n_b, extent))
        return _f32(rep, n_b, extent)

    @pytest.mark.parametrize("kind", ["spread", "ties"])
    def test_dense_buffers(self, kind):
        rep, n_b, extent = self._padded(kind, 100, 128, 2)
        cd = tref.bubble_core_distances(rep, n_b, extent, MIN_PTS, 2)
        W = tref.mutual_reachability(rep, rep, cd, cd, n_valid=100)
        want = tmst.boruvka(W)
        for k in KS + (5, 128):
            ranges = shard_ranges(128, k)
            got = tmst.boruvka_shard([W[a:b] for a, b in ranges], [a for a, _ in ranges], 128,
                                     resolve_mesh(_cpu_mesh(k)))
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w), k

    def test_grid_buffers_and_core_distances(self):
        rep, n_b, extent = self._padded("ties", 200, 256, 2)
        valid = torch.arange(256) < 200
        grid = t_grid.build_grid(rep, valid)
        views = t_grid._block_views(grid)
        cd = t_grid.grid_core_distances(grid, n_b, extent, MIN_PTS, 2, views)
        want = tmst.boruvka_grid(grid, cd, views)
        for k in KS:
            mesh = resolve_mesh(_cpu_mesh(k))
            assert torch.equal(t_grid.grid_core_distances_shard(grid, n_b, extent, MIN_PTS, 2, mesh, views), cd)
            for g, w in zip(tmst.boruvka_grid_shard(grid, cd, views, mesh), want, strict=True):
                assert torch.equal(g, w), k

    def test_strip_wrappers_take_global_rows(self):
        """On the CPU the row-range wrappers run the plain version on the
        strip: the diagonal and the pad mask sit at global rows, the values
        within the f32 rounding of a differently blocked product."""
        rep, n_b, extent = self._padded("spread", 100, 128, 16)
        cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=MIN_PTS, dim=16)
        W = tref.mutual_reachability(rep, rep, cd, cd, n_valid=100)
        for a, b in ((0, 50), (50, 100), (37, 128), (128, 128)):
            got_cd = t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=MIN_PTS, dim=16, rows=(a, b))
            np.testing.assert_allclose(got_cd.numpy(), cd[a:b].numpy(), rtol=1e-6, atol=1e-6)
            strip = t_mr.mutual_reachability(rep[a:b], rep, cd[a:b], cd, n_valid=100, row0=a)
            assert torch.equal(torch.isinf(strip), torch.isinf(W[a:b]))
            assert bool((strip.diagonal(a)[: max(0, 100 - a)] == 0).all())  # the valid rows' own entries
            fin = torch.isfinite(strip)
            np.testing.assert_allclose(strip[fin].numpy(), W[a:b][fin].numpy(), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="outside"):
            t_bcd.bubble_core_distances(rep, n_b, extent, min_pts=MIN_PTS, dim=16, rows=(10, 200))


class TestAgainstReference:
    """The JAX package's sharded pass on its one CPU device (k = 1) against
    the port's sharded pass (k = 2 and 3) under the parity tiers, on
    Bubble-tree summaries (masses > 1, extents > 0) on and off the origin,
    as tests/test_torch_offline.py holds the unsharded passes."""

    @pytest.mark.parametrize("spatial", [False, True], ids=["dense", "spatial"])
    @pytest.mark.parametrize("offset", [0.0, 1e4])
    def test_offline_pass(self, offset, spatial):
        X, _ = make_blobs(np.random.default_rng(3), n_per=150, d=3)
        tree = BubbleTree(dim=3, compression=0.1)
        tree.insert_block(X + offset)
        ids, LS, SS, N = tree.leaf_cf_buffers()
        rep, extent, n_b, _ = tops.bubble_table(LS, SS, N, ids)
        want = jops.offline_recluster_from_table(rep, n_b, extent, 10, use_ref=True, spatial_index=spatial,
                                                 mesh=ref_host_mesh())
        for k in (2, 3):
            got = tops.offline_recluster_from_table(rep, n_b, extent, 10, device="cpu", spatial_index=spatial,
                                                    mesh=_cpu_mesh(k))
            assert_same_partition(got.labels, want.labels, f"k={k}")
            np.testing.assert_allclose(got.mst[2].sum(), want.mst[2].sum(), rtol=1e-6)
            np.testing.assert_allclose(np.sort(got.stabilities), np.sort(want.stabilities), rtol=1e-5, atol=1e-5)

    def test_mutual_reachability_sharded(self):
        rep, n_b, extent = _table("spread", 200, 16, seed=4)
        rep = rep - rep.mean(0)
        want = np.asarray(jops.bubble_mutual_reachability_sharded(rep, n_b, extent, MIN_PTS, ref_host_mesh()))
        got = tops.bubble_mutual_reachability_sharded(*_f32(rep, n_b, extent), MIN_PTS, _cpu_mesh(3)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (np.diag(got) == 0.0).all()


ENGINE_KW = dict(min_pts=5, compression=0.05, epsilon=0.2, max_block=256, min_offline_points=32)


def _ops(seed: int):
    """A seeded insert / delete / query op list over three blobs off the
    origin (deletes by insert position)."""
    rng = np.random.default_rng(seed)
    X, _ = make_blobs(rng, centers=((0.0, 0.0, 0.0), (3.0, 0.0, 0.0), (0.0, 3.0, 0.0)), n_per=200, d=3,
                      scale=0.3)
    X = X + 5.0
    ops, off, alive = [], 0, np.zeros(len(X), bool)
    for size in (150, 150, 120, 100, 60, 20):
        ops.append(("insert", X[off : off + size]))
        alive[off : off + size] = True
        off += size
        ops.append(("query", rng.normal(size=(40, 3)) * 1.5 + 6.0))
        if size == 120:
            pos = rng.choice(np.flatnonzero(alive), size=80, replace=False)
            alive[pos] = False
            ops.append(("delete", pos))
    return ops


def _drive(eng, ops, pids=None):
    """Apply ``ops`` to ``eng``; yields after each op with its query result."""
    pids = [] if pids is None else pids
    for kind, payload in ops:
        res = None
        if kind == "insert":
            pids.extend(eng.ingest(payload))
        elif kind == "delete":
            eng.retire([pids[i] for i in payload])
        else:
            res = eng.query_detailed(payload)
        yield res


def _same_snapshot(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.version == b.version and a.n_bubbles == b.n_bubbles
    np.testing.assert_array_equal(a.bubble_rep, b.bubble_rep)
    _assert_same_result(a.result, b.result, f"version {a.version}")


def _same_query(a, b):
    if a is None:
        return
    for f in ("version", "labels", "bubble_index", "distance", "strength"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


class TestEngine:
    @pytest.mark.parametrize("device_online", [False, True], ids=["host_table", "device_online"])
    def test_stream_bitwise_unsharded(self, device_online):
        kw = dict(ENGINE_KW, device="cpu", device_online=device_online)
        sharded = StreamingClusterEngine(3, mesh=_cpu_mesh(3), **kw)
        plain = StreamingClusterEngine(3, **kw)
        ops = _ops(5)
        for a, b in zip(_drive(sharded, ops), _drive(plain, ops), strict=True):
            _same_snapshot(sharded.snapshot, plain.snapshot)
            _same_query(a, b)
        assert sharded.stats["recluster_count"] == plain.stats["recluster_count"] >= 3
        _same_snapshot(sharded.flush(), plain.flush())

    def test_stream_against_reference_mesh_engine(self):
        port = StreamingClusterEngine(3, mesh=_cpu_mesh(2), device="cpu", **ENGINE_KW)
        ref = RefEngine(3, backend="jnp", mesh=True, **ENGINE_KW)
        ops = _ops(6)
        for a, b in zip(_drive(port, ops), _drive(ref, ops), strict=True):
            assert (port.snapshot is None) == (ref.snapshot is None)
            if ref.snapshot is None:
                continue
            assert port.snapshot.version == ref.snapshot.version
            np.testing.assert_array_equal(port.snapshot.bubble_rep, ref.snapshot.bubble_rep)
            assert_same_partition(port.snapshot.bubble_labels, ref.snapshot.bubble_labels)
            np.testing.assert_allclose(port.snapshot.total_mst_weight, ref.snapshot.total_mst_weight, rtol=1e-6)
            if a is not None:
                np.testing.assert_array_equal(a.bubble_index, b.bubble_index)
                np.testing.assert_array_equal(a.labels, b.labels)

    @pytest.mark.parametrize("direction", ["mesh_to_plain", "plain_to_mesh"])
    def test_checkpoint_across_mesh(self, tmp_path, direction):
        """A checkpoint of a mesh engine restores into one without a mesh,
        and the reverse: the same snapshot, then the same further passes."""
        meshes = (_cpu_mesh(3), None) if direction == "mesh_to_plain" else (None, _cpu_mesh(3))
        ops = _ops(7)
        head, tail = ops[:5], ops[5:]
        src = StreamingClusterEngine(3, mesh=meshes[0], device="cpu", **ENGINE_KW)
        pids = []
        for _ in _drive(src, head, pids):
            pass
        store = CheckpointStore(str(tmp_path))
        src.save(store)
        dst = StreamingClusterEngine(3, mesh=meshes[1], device="cpu", **ENGINE_KW)
        dst.restore(store)
        _same_snapshot(dst.snapshot, src.snapshot)
        dst_pids = list(pids)
        for a, b in zip(_drive(dst, tail, dst_pids), _drive(src, tail, pids), strict=True):
            _same_snapshot(dst.snapshot, src.snapshot)
            _same_query(a, b)

    def test_tenant_router_forwards_mesh(self):
        rng = np.random.default_rng(8)
        data = {f"t{i}": rng.normal(size=(120, 2)) + 10.0 * i for i in range(2)}
        kw = dict(min_pts=8, compression=0.15, min_offline_points=8)
        routers = (TenantRouter(2, device="cpu", mesh=_cpu_mesh(2), **kw), TenantRouter(2, device="cpu", **kw))
        for r in routers:
            for name, X in data.items():
                r.create(name)
                r.ingest(name, X)
            r.flush()
        for name, X in data.items():
            assert len(routers[0].engine(name).mesh.devices) == 2 and routers[1].engine(name).mesh is None
            _same_snapshot(routers[0].engine(name).snapshot, routers[1].engine(name).snapshot)
            np.testing.assert_array_equal(routers[0].query(name, X[:30]), routers[1].query(name, X[:30]))


class TestRefusals:
    def test_exact_with_mesh(self):
        with pytest.raises(ValueError, match="exact"):
            StreamingClusterEngine(2, device="cpu", mesh=_cpu_mesh(2), exact=True)

    def test_return_w_with_mesh(self):
        rep, n_b, extent = _table("spread", 30, 2)
        with pytest.raises(ValueError, match="return_w"):
            tops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device="cpu", return_w=True,
                                              mesh=_cpu_mesh(2))

    def test_mixed_device_types(self):
        with pytest.raises(ValueError, match="one type"):
            resolve_mesh(("cpu", "cuda:0"), "cpu")
        with pytest.raises(ValueError, match="one type"):
            StreamingClusterEngine(2, device="cpu", mesh=("cpu", "meta"))

    def test_mesh_forms(self):
        assert resolve_mesh(None) is None and resolve_mesh(False) is None
        one = resolve_mesh(True, "cpu")
        assert one == make_host_mesh("cpu") and one.shape == {"data": 1}  # one device stays a mesh
        m = resolve_mesh(Mesh(("cpu",) * 3, "rows"), "cpu")
        assert m.shape == {"rows": 3} and m.lead == torch.device("cpu")
        with pytest.raises(ValueError, match="axis"):
            resolve_mesh(m, "cpu", "data")

    @pytest.mark.parametrize("Lp", [13, 64, 1024])
    @pytest.mark.parametrize("k", KS)
    def test_leaf_row_owner_matches_reference(self, Lp, k):
        mesh = resolve_mesh(_cpu_mesh(k))
        slots = np.random.default_rng(Lp + k).integers(0, Lp, size=50)
        np.testing.assert_array_equal(leaf_row_owner(slots, Lp, mesh), ref_leaf_row_owner(slots, Lp, mesh))
