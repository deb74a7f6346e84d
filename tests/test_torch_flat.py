"""Device-online ingest on the port (``device_online=True``), on the CPU.

The port's counterparts of tests/test_bubble_flat.py and of the
device-online cases of tests/test_checkpoint_recovery.py.  On the CPU the
``flat_scatter`` wrapper runs its plain version (kernels/ref.py).  Each
case is held against the host tree (the f64 oracle) and against the JAX
package's ``BubbleFlat`` or engine (``backend="jnp"``) fed the same data:

* CF parity after every applied block: the flat table's uncentred f64
  CFs (compensated sums) equal the tree's per alive leaf within 1e-6
  relative (plus 1e-6 × the largest magnitude, absolute), N exactly;
* the port's flat state against the JAX package's: the same slots, free
  list and watermark, N exactly, LS/LSe/SS/SSe within 1e-6 relative of
  the largest magnitude of LS or SS (a compensation word is the rounding
  residue of its sum, so it is held at that sum's scale);
* label parity: every ε-pass read from the device table gives the same
  partition per leaf as the host-table pass on the same tree, and the JAX
  engine publishes the same versions and partitions with the MST weight
  within 1e-6 relative.  Against the host-table pass the weight is held
  within 1e-5 (the main-path milestone's tier): the device derives each
  extent (Eq. 4) in f32 from ``2n·SS − 2‖LS‖²``, which cancels where a
  leaf sits far from the table's origin relative to its own spread, while
  the host derives it in f64 (tests/test_bubble_flat.py allows 1e-4 for
  the same comparison; these streams differ by up to 1.4e-6).  The
  clusters at offset 1e4 cancel so in both packages' f32 derivations,
  and are held to each other at 1e-5 too;
* checkpoints with ``flat/has``: port → port bit for bit, and across the
  packages both ways;
* the populated slots and their count taken on the host equal the ones
  the device's N gives.
"""

import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro.checkpoint import CheckpointStore as RefStore
from repro.core.bubble_flat import BubbleFlat as RefFlat
from repro.core.bubble_flat import _flat_delete as ref_flat_delete
from repro.core.bubble_flat import _kahan_add as ref_kahan_add
from repro.core.bubble_tree import BubbleTree as RefTree
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro_torch import CheckpointStore, StreamingClusterEngine, engine_from_reference_state
from repro_torch.core.bubble_flat import BubbleFlat
from repro_torch.core.bubble_tree import BubbleTree
from repro_torch.kernels import flat_scatter as t_fs
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import kahan_add

MIN_PTS = 6
MCS = 6.0
KW = dict(min_pts=MIN_PTS, min_cluster_size=MCS, compression=0.12, epsilon=0.15,
          min_offline_points=10, max_block=64, device_online=True)
CENTERS = np.asarray([[0.0, 0.0], [5.0, 5.0], [-5.0, 4.0]])


def _port(dim=2, **kw):
    return StreamingClusterEngine(dim=dim, device="cpu", **{**KW, **kw})


def _ref(dim=2, **kw):
    return RefEngine(dim=dim, backend="jnp", **{**KW, **kw})


def _host(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_cf_parity(eng, rtol=1e-6):
    """Flat device table vs the host tree, per alive non-empty leaf."""
    leaf_ids, LS, SS, N = eng._flat.host_cfs()
    ids = eng.tree.alive_leaf_ids()
    tids = np.sort(ids[eng.tree.N[ids] > 0])
    srt = np.sort(leaf_ids)
    np.testing.assert_array_equal(srt, tids)
    order = np.argsort(leaf_ids)
    for got, want in ((LS[order], eng.tree.LS[srt]), (SS[order], eng.tree.SS[srt])):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))
    np.testing.assert_array_equal(N[order], eng.tree.N[srt])


def _assert_same_flat(port, ref, rtol=1e-6):
    """The port's BubbleFlat against the JAX package's on the same stream."""
    assert port.Lp == ref.Lp and port.stale == ref.stale
    np.testing.assert_array_equal(port.leaf_of_slot, ref.leaf_of_slot)
    assert list(port._free) == list(ref._free) and port._hi == ref._hi
    np.testing.assert_array_equal(port._alive_host, ref._alive_host)
    np.testing.assert_array_equal(port.origin, ref.origin)
    for name in ("LS", "LSe", "SS", "SSe"):
        # a compensation word is held at the scale of its sum: it is the
        # rounding residue of that sum, which the summation order sets
        a, b = _host(getattr(port, name)), np.asarray(getattr(ref, name))
        scale = np.abs(np.asarray(getattr(ref, name.rstrip("e")))).max()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1.0, float(scale)), err_msg=name)
    np.testing.assert_array_equal(_host(port.N), np.asarray(ref.N))
    np.testing.assert_array_equal(_host(port.alive), np.asarray(ref.alive))


def _assert_label_parity(eng):
    """The device-table snapshot vs the host-table pass on the same tree,
    aligned per leaf (snapshot rows are ascending-slot, the host pass's
    ascending-leaf)."""
    snap = eng.snapshot
    ids, LS, SS, N = eng.tree.leaf_cf_buffers()
    res = eng.backend.offline_recluster(LS, SS, N, ids, MIN_PTS, min_cluster_size=MCS)
    flat_leaves = eng._flat.leaf_of_slot[eng._flat.alive_slots()]
    assert snap.bubble_labels.shape[0] == len(flat_leaves)
    pos = {int(leaf): i for i, leaf in enumerate(ids)}
    host_rows = np.asarray([pos[int(leaf)] for leaf in flat_leaves])
    assert_same_partition(snap.bubble_labels, res.labels[host_rows])
    np.testing.assert_allclose(snap.total_mst_weight, float(np.sum(res.mst[2])), rtol=1e-5)


def _assert_same_snapshot(port, ref, rtol=1e-6):
    assert (port is None) == (ref is None)
    if ref is not None:
        assert port.version == ref.version and port.n_bubbles == ref.n_bubbles
        assert_same_partition(port.bubble_labels, ref.bubble_labels)
        np.testing.assert_allclose(port.total_mst_weight, ref.total_mst_weight, rtol=rtol)


def _assert_same_device_order(flat):
    """The populated slots the host knows are the ones the device's N has."""
    dev = torch.nonzero(flat.alive & (flat.N > 0)).squeeze(1).numpy()
    np.testing.assert_array_equal(flat.alive_slots(), dev)


class TestDifferential:
    def test_interleaved_stream_against_tree_and_reference(self):
        """60 interleaved insert/delete/query steps through the port and the
        JAX engine: after every block the CF parity against the tree and
        the flat state against the reference's, at every ε-pass the label
        parity against the host-table pass and the reference's snapshot."""
        rng = np.random.default_rng(3)
        port, ref = _port(), _ref()
        live, passes = [], 0
        for _ in range(60):
            op = rng.random()
            before = port.stats["recluster_count"]
            if op < 0.55 or len(live) < 12:
                X = rng.normal(size=(int(rng.integers(1, 16)), 2)) * 0.4 + CENTERS[rng.integers(0, 3)]
                pa, pb = port.ingest(X), ref.ingest(X)
                assert pa == pb
                live.extend(pa)
            elif op < 0.85:
                idx = rng.choice(len(live), size=min(len(live), int(rng.integers(1, 10))), replace=False)
                gone = set(idx.tolist())
                pids = [live[i] for i in idx]
                live = [p for i, p in enumerate(live) if i not in gone]
                port.retire(pids)
                ref.retire(pids)
            else:
                q = rng.normal(size=(5, 2)) * 3.0
                np.testing.assert_array_equal(port.query(q), ref.query(q))
            port.tree.check_invariants()
            _assert_same_flat(port._flat, ref._flat)
            _assert_same_snapshot(port.snapshot, ref.snapshot)
            if not port._flat.stale:
                _assert_cf_parity(port)
                _assert_same_device_order(port._flat)
            if port.stats["recluster_count"] > before and not port._flat.stale:
                _assert_label_parity(port)
                passes += 1
        assert port.stats["device_online_blocks"] > 30
        for k in ("device_online_blocks", "flat_loads", "recluster_count", "blocks_applied"):
            assert port.stats[k] == ref.stats[k], k
        assert passes >= 2
        port.flush()
        ref.flush()
        _assert_same_snapshot(port.snapshot, ref.snapshot)
        _assert_label_parity(port)

    def test_far_from_origin(self, rng):
        """Clusters at offset 1e4 with unit separations: the centred
        compensated table still tracks the f64 tree at 1e-6 relative, and
        the device pass separates the three blobs as the reference's."""
        off = np.array([1.0e4, -7.5e3])
        kw = dict(compression=0.1, epsilon=0.1, max_block=128)
        port, ref = _port(**kw), _ref(**kw)
        centers = np.asarray([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]]) + off
        pids = []
        for _ in range(4):
            for c in centers:
                X = rng.normal(size=(20, 2)) * 0.3 + c
                pids.extend(port.ingest(X))
                ref.ingest(X)
            _assert_cf_parity(port)
            _assert_same_flat(port._flat, ref._flat)
        port.flush()
        ref.flush()
        _assert_label_parity(port)
        # both derive the extents in f32 on the device, where this offset
        # cancels (see the module docstring): the milestone's 1e-5 here
        _assert_same_snapshot(port.snapshot, ref.snapshot, rtol=1e-5)
        assert port.snapshot.n_clusters == 3
        assert len(set(port.query(centers).tolist())) == 3
        port.retire(pids[: len(pids) // 3])
        ref.retire(pids[: len(pids) // 3])
        _assert_cf_parity(port)
        _assert_same_flat(port._flat, ref._flat)


class TestScatter:
    """The block scatter's plain version (the CPU side of the kernel)."""

    @pytest.mark.parametrize("case", ["spread", "ties", "empty"])
    def test_against_reference_delete_program(self, case):
        """``flat_scatter`` with sign -1 against the JAX package's
        ``_flat_delete`` (segment sums + ``_kahan_add``) on the same state
        and slots: sums within 1e-6 relative of the largest magnitude, N
        and the work list exact; also with nonzero compensation words on
        slots that get no row."""
        rng = np.random.default_rng({"spread": 1, "ties": 2, "empty": 3}[case])
        Lp, d, Bp = 64, 5, 128
        state = [rng.normal(size=(Lp, d)), rng.normal(size=(Lp, d)) * 1e-7,
                 rng.random(Lp) * 10, rng.normal(size=Lp) * 1e-7]
        state = [a.astype(np.float32) for a in state]
        N = rng.integers(5, 40, size=Lp).astype(np.float32)
        alive = rng.random(Lp) < 0.8
        slots = {"spread": rng.integers(0, Lp, Bp), "ties": rng.integers(0, 3, Bp),
                 "empty": np.zeros(Bp, dtype=np.int64)}[case].astype(np.int32)
        valid = np.ones(Bp, dtype=bool) if case != "empty" else np.zeros(Bp, dtype=bool)
        valid[-7:] = False
        X = rng.normal(size=(Bp, d)).astype(np.float32)
        want = ref_flat_delete(*state, N, alive, slots, X, valid, np.float32(12))
        t = [torch.from_numpy(a.copy()) for a in (*state, N)]
        flags = t_fs.flat_scatter(*t, torch.from_numpy(alive), torch.from_numpy(X), torch.from_numpy(slots),
                                  torch.from_numpy(valid), 12.0, sign=-1)
        for got, w in zip(t, want[:5]):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(w).max())))
        np.testing.assert_array_equal(t[4].numpy(), np.asarray(want[4]))
        np.testing.assert_array_equal(flags.numpy(), np.asarray(want[5]))
        if case == "empty":  # zero deltas still move (hi, err) where err != 0
            assert not np.array_equal(t[0].numpy(), state[0])

    def test_insert_then_delete_is_the_identity_on_counts(self):
        rng = np.random.default_rng(4)
        Lp, d, Bp = 32, 3, 64
        LS = torch.zeros(Lp, d)
        LSe, SS, SSe, N = torch.zeros(Lp, d), torch.zeros(Lp), torch.zeros(Lp), torch.zeros(Lp)
        alive = torch.ones(Lp, dtype=torch.bool)
        X = torch.from_numpy(rng.normal(size=(Bp, d)).astype(np.float32))
        slot = torch.from_numpy(rng.integers(0, Lp, Bp).astype(np.int32))
        valid = torch.ones(Bp, dtype=torch.bool)
        over = t_fs.flat_scatter(LS, LSe, SS, SSe, N, alive, X, slot, valid, 3.0, sign=1)
        counts = torch.bincount(slot.long(), minlength=Lp).float()
        assert torch.equal(N, counts) and torch.equal(over, counts > 3)
        under = t_fs.flat_scatter(LS, LSe, SS, SSe, N, alive, X, slot, valid, 1.0, sign=-1)
        assert torch.equal(N, torch.zeros(Lp)) and bool(under.all())
        assert float((LS - LSe).abs().max()) <= 1e-6 and float((SS - SSe).abs().max()) <= 1e-5

    def test_kahan_add_is_the_reference(self):
        rng = np.random.default_rng(5)
        hi, err, delta = (rng.normal(size=100).astype(np.float32) * s for s in (1e3, 1e-4, 1.0))
        want = ref_kahan_add(hi, err, delta)
        got = kahan_add(torch.from_numpy(hi), torch.from_numpy(err), torch.from_numpy(delta))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_wrapper_validates(self):
        z = torch.zeros(8, 2)
        v = torch.zeros(8)
        with pytest.raises(ValueError, match="slot"):
            t_fs.flat_scatter(z, z.clone(), v, v.clone(), v.clone(), torch.ones(8, dtype=torch.bool),
                              torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool),
                              1.0, sign=1)
        with pytest.raises(ValueError, match="sign"):
            t_fs.flat_scatter(z, z.clone(), v, v.clone(), v.clone(), torch.ones(8, dtype=torch.bool),
                              torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                              1.0, sign=0)


class TestFlatState:
    def test_standalone_against_reference_flat(self, rng):
        """One tree, two flats (the port's and the JAX package's) fed the
        same blocks: the same slots on tie-free centred data, the same
        state within 1e-6; then 300 tiny blocks keep the compensated sums
        at f64-oracle precision (Kahan drift)."""
        ptree, rtree = BubbleTree(dim=2, compression=0.1), RefTree(dim=2, compression=0.1)
        X0 = rng.normal(size=(200, 2)) + 3.0
        ptree.insert_block(X0)
        rtree.insert_block(X0)
        pflat, rflat = BubbleFlat(2, device="cpu"), RefFlat(2, use_ref=True)
        pflat.load(ptree)
        rflat.load(rtree)
        _assert_same_flat(pflat, rflat)
        for i in range(300):
            X = rng.normal(size=(4, 2)) * 0.3 + 3.0
            cap = ptree._leaf_cap_at(ptree.n_points + X.shape[0])
            pl, pw = pflat.insert_block(X, cap)
            if i < 40:
                rl, rw = rflat.insert_block(X, cap)
                np.testing.assert_array_equal(pl, rl)
                np.testing.assert_array_equal(pw, rw)
                rtree.apply_assigned_block(X, rl, overfull_hint=rw)
                rflat.sync_struct(rtree)
            ptree.apply_assigned_block(X, pl, overfull_hint=pw)
            pflat.sync_struct(ptree)
            if i < 40:
                _assert_same_flat(pflat, rflat)
        leaf_ids, LS, SS, N = pflat.host_cfs()
        srt, order = np.sort(leaf_ids), np.argsort(leaf_ids)
        np.testing.assert_allclose(LS[order], ptree.LS[srt], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(SS[order], ptree.SS[srt], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(N[order], ptree.N[srt])
        _assert_same_device_order(pflat)

    def test_work_list_drives_host_fixpoint(self, rng):
        """A concentrated block through the device path comes back flagged
        overfull, and the host fixpoint it feeds shatters the leaf."""
        kw = dict(compression=0.05, epsilon=10.0, min_offline_points=10**9, max_block=4096)
        port, ref = _port(**kw), _ref(**kw)
        X0, X1 = rng.normal(size=(400, 2)) * 5.0, rng.normal(size=(1024, 2)) * 0.01 + 2.0
        for eng in (port, ref):
            eng.ingest(X0)
            assert not eng._flat.stale
            eng.ingest(X1)
        port.tree.check_invariants()
        _assert_cf_parity(port)
        _assert_same_flat(port._flat, ref._flat)
        cap = port.tree.leaf_cap
        for leaf in port.tree.alive_leaf_ids():
            assert len(port.tree.leaf_points[int(leaf)]) <= cap

    def test_delete_scatter_and_dissolve(self, rng):
        kw = dict(compression=0.08, epsilon=10.0, min_offline_points=10**9)
        port, ref = _port(dim=3, **kw), _ref(dim=3, **kw)
        X = rng.normal(size=(300, 3))
        pids = port.ingest(X)
        assert ref.ingest(X) == pids
        order = rng.permutation(len(pids))
        for i in range(0, 260, 13):
            block = [pids[j] for j in order[i : i + 13]]
            port.retire(block)
            ref.retire(block)
            port.tree.check_invariants()
            _assert_same_flat(port._flat, ref._flat)
            if not port._flat.stale:
                _assert_cf_parity(port)
        assert port.tree.n_points == 40

    def test_bootstrap_and_bucket_growth(self, rng):
        kw = dict(compression=0.2, epsilon=10.0, min_offline_points=10**9)
        port, ref = _port(**kw), _ref(**kw)
        blocks = [rng.normal(size=(3, 2)), rng.normal(size=(40, 2)), rng.normal(size=(2000, 2)) * 3.0]
        port.ingest(blocks[0])
        ref.ingest(blocks[0])
        assert port._flat.stale
        port.ingest(blocks[1])
        ref.ingest(blocks[1])
        assert not port._flat.stale
        lp0, loads0 = port._flat.Lp, port.stats["flat_loads"]
        port.ingest(blocks[2])
        ref.ingest(blocks[2])
        port.tree.check_invariants()
        _assert_cf_parity(port)
        _assert_same_flat(port._flat, ref._flat)
        assert port._flat.Lp > lp0 and port.stats["flat_loads"] > loads0 >= 1
        assert port.stats["flat_loads"] == ref.stats["flat_loads"]

    def test_drift_outside_frame_falls_back_and_reloads(self, rng):
        """A block beyond the dead-slot parking coordinate never reaches the
        tree as a -1 leaf: the table refuses, the engine takes the host
        path, and the next block reloads at a fresh origin."""
        port = _port(compression=0.1, epsilon=10.0, min_offline_points=10**9)
        port.ingest(rng.normal(size=(200, 2)))
        assert not port._flat.stale
        pids = port.ingest(rng.normal(size=(32, 2)) + 3.0e6)
        assert len(pids) == 32
        alive = set(port.tree.alive_leaf_ids().tolist())
        assert sum(len(port.tree.leaf_points[leaf]) for leaf in alive) == port.tree.n_points
        assert all(int(port.tree.point_leaf[p]) in alive for p in pids)
        assert port._flat.stale and port._table.ready is False
        port.ingest(rng.normal(size=(32, 2)) + 3.0e6)
        assert not port._flat.stale
        _assert_cf_parity(port)

    @pytest.mark.parametrize("kind", ["insert", "delete"])
    def test_scatter_failure_reaches_the_caller(self, rng, monkeypatch, kind):
        """A flat_scatter that fails (as a build or launch failure does,
        with a RuntimeError) is never swallowed into the host path: it
        leaves ingest/retire, the table goes stale, and once the kernel
        works again the next block reloads it from the tree."""
        port = _port(compression=0.1, epsilon=10.0, min_offline_points=10**9)
        pids = port.ingest(rng.normal(size=(200, 2)))
        assert not port._flat.stale
        n0, blocks0 = port.tree.n_points, port.stats["device_online_blocks"]

        def broken(*args, **kw):
            raise RuntimeError("flat_scatter kernel launch failed")

        with monkeypatch.context() as m:
            m.setattr(t_fs, "flat_scatter", broken)
            with pytest.raises(RuntimeError, match="launch failed"):
                if kind == "insert":
                    port.ingest(rng.normal(size=(32, 2)))
                else:
                    port.retire(pids[:16])
        assert port._flat.stale
        assert port.stats["device_online_blocks"] == blocks0
        assert port.tree.n_points == (n0 if kind == "insert" else n0 - 16)
        port.tree.check_invariants()
        loads = port.stats["flat_loads"]
        port.ingest(rng.normal(size=(32, 2)))
        assert not port._flat.stale and port.stats["flat_loads"] == loads + 1
        _assert_cf_parity(port)

    def test_bad_delete_leaves_flat_consistent(self, rng):
        port = _port(compression=0.1, epsilon=10.0, min_offline_points=10**9)
        pids = port.ingest(rng.normal(size=(120, 2)))
        with pytest.raises(KeyError):
            port.retire([pids[0], 10**6])
        port.tree.check_invariants()
        _assert_cf_parity(port)
        port.retire([pids[0]])
        _assert_cf_parity(port)


class TestEngineModes:
    def test_rejects_exact_mode(self):
        """exact=True with device_online is refused (the reference's
        ValueError); exact=True alone now runs, with no flat table."""
        with pytest.raises(ValueError, match="exact"):
            StreamingClusterEngine(dim=2, device="cpu", exact=True, device_online=True)
        eng = StreamingClusterEngine(dim=2, device="cpu", exact=True, min_offline_points=8)
        eng.ingest(np.random.default_rng(0).normal(size=(40, 2)))
        assert eng._flat is None and eng.snapshot.n_points == 40 and eng.stats["exact_rebuilds"] == 1

    def test_backend_hands_out_flat_tables(self):
        flat = tops.get_backend("cpu").make_flat(3, capacity=20)
        assert isinstance(flat, BubbleFlat) and flat.Lp == 32 and flat.dim == 3 and not flat.ready

    def test_async_offline_and_a_held_capture(self, rng):
        """device_online with async_offline gives the sync engine's
        partition; a capture taken before a block lands keeps its bits
        (the scatter updates the live tensors in place)."""
        kw = dict(compression=0.1, epsilon=0.1, max_block=512)
        a, b = _port(async_offline=False, **kw), _port(async_offline=True, **kw)
        X = np.concatenate([rng.normal(size=(60, 2)) * 0.4 + c for c in ([0, 0], [6, 0], [0, 6])])
        for eng in (a, b):
            for i in range(0, X.shape[0], 40):
                eng.submit_insert(X[i : i + 40])
                eng.poll()
            eng.flush()
            eng.tree.check_invariants()
        assert b.stats["recluster_count"] >= 1
        q = np.asarray([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])
        assert_same_partition(a.query(q), b.query(q))
        cap = a._flat.capture(a.tree.n_points)
        before = [t.clone() for t in cap.view]
        a.ingest(rng.normal(size=(30, 2)) * 0.4)
        assert not torch.equal(a._flat.N, before[4])
        for t, t0 in zip(cap.view, before):
            assert torch.equal(t, t0)
        res, rep, n_b, _ = cap.recluster(a.backend, min_pts=MIN_PTS, min_cluster_size=MCS)
        assert res.n_bubbles == len(cap.slots) == int((before[5] & (before[4] > 0)).sum())
        assert n_b.sum() == a.tree.n_points - 30


class TestCheckpoints:
    @staticmethod
    def _drive(eng, blocks, retire_every=3):
        for i, blk in enumerate(blocks):
            pids = eng.ingest(blk)
            if i % retire_every == retire_every - 1:
                eng.retire(pids[::4])
        eng.flush()

    @staticmethod
    def _blocks(seed, n, n_per=40):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=(n_per, 2)) * 0.7 + rng.normal(size=(1, 2)) * 6.0 for _ in range(n)]

    def test_state_keys_match_the_reference(self):
        blocks = self._blocks(1, 3)
        port, ref = _port(), _ref()
        for eng in (port, ref):
            self._drive(eng, blocks)
        a, b = port.checkpoint_state(), ref.checkpoint_state()
        assert sorted(a) == sorted(b) and a["flat/has"] and a["cfg/device_online"]
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.shape(a[k]) == np.shape(b[k]), k
        for k in ("flat/leaf_of_slot", "flat/free", "flat/hi", "flat/alive", "flat/N", "flat/origin"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_port_drill_replays_bit_for_bit(self, tmp_path):
        """Kill and recover inside the port: every version published after
        the restore, bit for bit the uninterrupted engine's."""
        blocks = self._blocks(11, 8)
        oracle, victim = _port(), _port()
        for eng in (oracle, victim):
            self._drive(eng, blocks[:4])
        store = CheckpointStore(str(tmp_path), keep=2)
        victim.save(store)
        del victim
        recovered = _port()
        recovered.restore(store)
        store.close()
        f, g = oracle._flat, recovered._flat
        for name in ("LS", "LSe", "SS", "SSe", "N", "alive"):
            assert torch.equal(getattr(f, name), getattr(g, name)), name
        assert f._free == g._free and f._hi == g._hi and f.slot_of_leaf == g.slot_of_leaf
        published = 0
        for blk in blocks[4:]:
            for eng in (oracle, recovered):
                eng.ingest(blk)
            a, b = oracle.snapshot, recovered.snapshot
            assert a.version == b.version
            for u, v in zip(a.mst, b.mst):
                np.testing.assert_array_equal(u, v)
            for name in ("bubble_rep", "bubble_n", "center"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            np.testing.assert_array_equal(a.bubble_labels, b.bubble_labels)
            np.testing.assert_array_equal(a.result.all_stabilities, b.result.all_stabilities)
            published += 1
        assert oracle.snapshot.version >= 2 and published == 4
        for name in ("LS", "LSe", "SS", "SSe", "N"):
            assert torch.equal(getattr(f, name), getattr(g, name)), name

    @pytest.mark.parametrize("route", ["carry", "store"])
    def test_reference_state_continues_in_the_port(self, tmp_path, route):
        blocks = self._blocks(21, 6)
        ref, twin = _ref(), _ref()
        for eng in (ref, twin):
            self._drive(eng, blocks[:3])
        if route == "carry":
            port = engine_from_reference_state(ref.checkpoint_state(), device="cpu", min_offline_points=10,
                                               max_block=64)
        else:
            store = RefStore(str(tmp_path), keep=2)
            ref.save(store)
            store.close()
            port = _port()
            pstore = CheckpointStore(str(tmp_path))
            port.restore(pstore)
            pstore.close()
        assert port._flat is not None and not port._flat.stale
        _assert_same_flat(port._flat, twin._flat, rtol=0.0)
        _assert_same_snapshot(port.snapshot, twin.snapshot)
        for blk in blocks[3:]:
            for eng in (port, twin):
                eng.ingest(blk)
            _assert_cf_parity(port)
            _assert_same_flat(port._flat, twin._flat)
            _assert_same_snapshot(port.snapshot, twin.snapshot)

    def test_port_state_continues_in_the_reference(self, tmp_path):
        blocks = self._blocks(22, 6)
        port, twin = _port(), _port()
        for eng in (port, twin):
            self._drive(eng, blocks[:3])
        store = CheckpointStore(str(tmp_path), keep=2)
        port.save(store)
        store.close()
        ref = _ref()
        rstore = RefStore(str(tmp_path))
        ref.restore(rstore)
        rstore.close()
        _assert_same_flat(twin._flat, ref._flat, rtol=0.0)
        for blk in blocks[3:]:
            for eng in (twin, ref):
                eng.ingest(blk)
            _assert_same_flat(twin._flat, ref._flat)
            _assert_same_snapshot(twin.snapshot, ref.snapshot)

    def test_mode_mismatch_raises_value_error(self):
        default = StreamingClusterEngine(dim=2, device="cpu", min_pts=MIN_PTS)
        online = _port()
        self._drive(online, self._blocks(5, 3))
        state = online.checkpoint_state()
        with pytest.raises(ValueError, match="device_online"):
            default.restore(_OneState(state))
        plain = default.checkpoint_state()
        with pytest.raises(ValueError, match="device_online"):
            _port().restore(_OneState(plain))
        stale = _port()
        stale.ingest(np.zeros((1, 2)))
        assert not stale.checkpoint_state()["flat/has"]


class _OneState:
    def __init__(self, state):
        self.state = state

    def restore(self, step=None):
        return 0, self.state
