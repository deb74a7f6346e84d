"""The port's checkpoint store and engine checkpoints, on the CPU.

The store (``repro_torch.checkpoint``): dtypes round-trip, a corrupted or
truncated leaf raises ``IOError``, the publish never loses a step, ``keep``
retention, junk of killed writers is collected, an async failure is
latched, and a directory written by the JAX package's store reads back
identically through the port's, and the other way round.

The engine: the kill-and-recover drill replays bit for bit inside the
port (the pattern of tests/test_checkpoint_recovery.py); the reference
engine's checkpoint restores into the port engine and the port's into the
reference engine, and the two then stay together on further blocks as
the main-path milestone holds them (same versions, same partition, MST
weight within 1e-5 relative); mismatched configurations and modes the
port does not carry are refused; and versions keep rising after a
restore (tests/test_snapshot_race.py).
"""

import os

import numpy as np
import pytest
import torch

from conftest import assert_same_partition
from repro.checkpoint import CheckpointStore as RefStore
from repro.serving.stream import StreamingClusterEngine as RefEngine
from repro_torch import CheckpointStore, StreamingClusterEngine
from repro_torch.checkpoint import latest_step

ENGINE_KW = dict(min_pts=8, compression=0.15, min_offline_points=8, epsilon=0.2)


def _tree():
    return {
        "f64": np.linspace(0.0, 1.0, 6).reshape(2, 3),
        "f32": np.arange(5, dtype=np.float32) / 3,
        "i32": np.arange(-3, 3, dtype=np.int32),
        "u8": np.arange(4, dtype=np.uint8),
        "flags": np.array([True, False, True]),
        "empty": np.zeros((0,), dtype=np.int64),
        "nested": {"scalar": np.int64(7), "half": np.float16(0.5), "x": np.float64(-2.25)},
        "seq": [np.ones(2), np.zeros((1, 1), dtype=np.float32)],
    }


def _flat_expected():
    t = _tree()
    return {
        "f64": t["f64"], "f32": t["f32"], "i32": t["i32"], "u8": t["u8"],
        "flags": t["flags"], "empty": t["empty"],
        "nested/scalar": np.asarray(t["nested"]["scalar"]),
        "nested/half": np.asarray(t["nested"]["half"]),
        "nested/x": np.asarray(t["nested"]["x"]),
        "seq/0": t["seq"][0], "seq/1": t["seq"][1],
    }


def _assert_same_flat(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _one_leaf(tmp_path, step=1):
    d = tmp_path / f"step_{step}"
    return d / next(f for f in sorted(os.listdir(d)) if f.endswith(".npy"))


class TestStore:
    def test_dtype_round_trip(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)
        store.save(10, _tree())
        step, out = store.restore()
        store.close()
        assert step == 10
        _assert_same_flat(out, _flat_expected())

    def test_torch_tensors_are_saved_from_the_host(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "i": torch.tensor([3, 1], dtype=torch.int64)})
        _, out = store.restore()
        store.close()
        np.testing.assert_array_equal(out["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
        assert out["i"].dtype == np.int64

    def test_bfloat16_leaf_is_refused_naming_the_key(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        with pytest.raises(TypeError, match="'model/w'"):
            store.save(1, {"model": {"w": torch.ones(2, dtype=torch.bfloat16)}})
        store.close()

    @pytest.mark.parametrize("damage", ["corrupt", "truncate"])
    def test_damaged_leaf_raises_ioerror(self, tmp_path, damage):
        store = CheckpointStore(str(tmp_path), keep=2)
        store.save(1, {"w": np.arange(16.0)})
        leaf = _one_leaf(tmp_path)
        arr = np.load(leaf)
        np.save(leaf, arr + 99 if damage == "corrupt" else arr[:-3])
        with pytest.raises(IOError, match="checksum mismatch"):
            store.restore()
        store.close()

    def test_publish_never_loses_a_step(self, tmp_path, monkeypatch):
        """A crash between renaming the old copy aside and publishing the
        new one leaves the old copy, which the next store renames back."""
        store = CheckpointStore(str(tmp_path), keep=2)
        store.save(7, {"w": np.arange(4.0)})
        real_rename = os.rename

        def crash_on_publish(src, dst):
            if ".tmp-" in os.path.basename(src):
                raise OSError("simulated crash between rename-aside and publish")
            return real_rename(src, dst)

        monkeypatch.setattr(os, "rename", crash_on_publish)
        with pytest.raises(OSError, match="simulated crash"):
            store.save(7, {"w": np.arange(4.0) + 100})
        monkeypatch.undo()
        store2 = CheckpointStore(str(tmp_path), keep=2)
        assert latest_step(str(tmp_path)) == 7
        step, out = store2.restore()
        assert step == 7
        np.testing.assert_array_equal(out["w"], np.arange(4.0))
        store2.save(8, {"w": np.arange(4.0)})
        assert [d for d in os.listdir(tmp_path) if ".tmp-" in d or ".old-" in d] == []
        store2.close()
        store.close()

    def test_async_saves_and_keep_retention(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            store.save(s, {"w": np.zeros((8, 8)) + s}, blocking=False)
        store.wait()
        assert latest_step(str(tmp_path)) == 4
        assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == ["step_3", "step_4"]
        _, out = store.restore()
        assert float(out["w"][0, 0]) == 4.0
        _, out = store.restore(step=3)
        assert float(out["w"][0, 0]) == 3.0
        store.close()

    def test_junk_of_killed_writers_is_ignored_and_collected(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=3)
        store.save(3, {"w": np.ones(2)})
        store.save(4, {"w": np.ones(2)})
        for stale in ("step_9.tmp-12345", "step_3.old-12345"):
            (tmp_path / stale).mkdir()
            (tmp_path / stale / "leaf_00000.npy").write_bytes(b"junk")
        assert latest_step(str(tmp_path)) == 4
        store.save(5, {"w": np.ones(2)})
        assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]
        store.close()

    def test_async_error_is_latched_first_wins(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)

        def failing_write(step, host):
            raise ValueError(f"disk full at step {step}")

        store._write = failing_write
        store.save(1, {"w": np.ones(2)}, blocking=False)
        store._q.join()
        store._q.put((2, {"w": np.ones(2)}))  # a second failure
        store._q.join()
        with pytest.raises(RuntimeError, match="checkpoint writer failed") as ei:
            store.save(3, {"w": np.ones(2)}, blocking=False)
        assert "step 1" in str(ei.value.__cause__)
        with pytest.raises(RuntimeError):
            store.wait()
        with pytest.raises(RuntimeError):
            store.close()

    def test_restore_of_an_empty_directory_raises(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            store.restore()
        store.close()


class TestCrossPackage:
    def test_reference_directory_reads_back_through_the_port(self, tmp_path):
        ref = RefStore(str(tmp_path), keep=2)
        ref.save(5, _tree())
        ref.close()
        store = CheckpointStore(str(tmp_path))
        step, out = store.restore()
        store.close()
        assert step == 5
        _assert_same_flat(out, _flat_expected())

    def test_port_directory_reads_back_through_the_reference(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)
        store.save(6, _tree())
        store.close()
        ref = RefStore(str(tmp_path))
        step, out = ref.restore()
        ref.close()
        assert step == 6
        _assert_same_flat(out, _flat_expected())
        idx = (tmp_path / "step_6" / "index.json").read_text()
        assert '"crc"' in idx and '"leaf_00000.npy"' in idx

    def test_reference_bfloat16_leaf_is_refused(self, tmp_path):
        import jax.numpy as jnp

        ref = RefStore(str(tmp_path))
        ref.save(1, {"w": jnp.ones(4, jnp.bfloat16)})
        ref.close()
        store = CheckpointStore(str(tmp_path))
        with pytest.raises(TypeError, match="'w'"):
            store.restore()
        store.close()


# -- the engine ---------------------------------------------------------------


def _port(**kw):
    return StreamingClusterEngine(dim=2, device="cpu", **{**ENGINE_KW, **kw})


def _ref(**kw):
    return RefEngine(dim=2, backend="jnp", **{**ENGINE_KW, **kw})


def _blocks(seed, n_blocks, n_per=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        c = rng.normal(size=(1, 2)) * 6.0
        out.append(rng.normal(size=(n_per, 2)) * 0.7 + c)
    return out


def _drive(eng, blocks, retire_every=3):
    """Mixed insert/retire schedule with ε-policy passes; retires use the
    pids ``ingest`` returned, so pid allocation must replay."""
    for i, b in enumerate(blocks):
        pids = eng.ingest(b)
        if retire_every and i % retire_every == retire_every - 1:
            eng.retire(pids[::4])
        eng.maybe_recluster()
    eng.flush()


def _assert_lockstep(a, b, versions=True):
    pa, la = a.labels()
    pb, lb = b.labels()
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(la, lb)
    for u, v in zip(a.snapshot.mst, b.snapshot.mst):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(a.snapshot.bubble_labels, b.snapshot.bubble_labels)
    np.testing.assert_array_equal(a.snapshot.stabilities, b.snapshot.stabilities)
    ca, cb = a.snapshot.condensed, b.snapshot.condensed
    for f in ("parent", "child", "lambda_val", "child_weight"):
        np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f), err_msg=f)
    if versions:
        assert a.snapshot.version == b.snapshot.version
        assert a.tree.dirty_mass == b.tree.dirty_mass
        assert a.tree.mutations == b.tree.mutations


def _assert_milestone(port, ref):
    """The main-path milestone's tiers between the two packages."""
    assert port.snapshot.version == ref.snapshot.version
    ps, rs = port.snapshot, ref.snapshot
    np.testing.assert_array_equal(ps.bubble_rep, rs.bubble_rep)
    assert_same_partition(ps.bubble_labels, rs.bubble_labels)
    np.testing.assert_allclose(ps.total_mst_weight, rs.total_mst_weight, rtol=1e-5)
    pa, la = port.labels()
    pb, lb = ref.labels()
    np.testing.assert_array_equal(pa, pb)
    assert_same_partition(la, lb)


class _DictStore:
    """A store that hands back one state dict (restore only)."""

    def __init__(self, state):
        self.state = state

    def restore(self, step=None):
        return 0, self.state


class TestEngineRoundTrip:
    def test_state_has_the_reference_keys_dtypes_and_shapes(self):
        blocks = _blocks(1, 3)
        port, ref = _port(), _ref()
        for eng in (port, ref):
            _drive(eng, blocks)
        a, b = port.checkpoint_state(), ref.checkpoint_state()
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.shape(a[k]) == np.shape(b[k]), k
        for k in ("cfg/exact", "cfg/device_online", "flat/has"):
            assert a[k] == np.bool_(False)
        for k in b:
            if k.startswith(("tree/", "eng/", "cfg/")) or k in ("snap/version", "snap/bubble_rep"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_host_tree_round_trip_is_bitwise(self, tmp_path):
        blocks = _blocks(2, 5)
        eng = _port()
        _drive(eng, blocks)
        store = CheckpointStore(str(tmp_path), keep=2)
        step = eng.save(store)
        assert step == int(eng.tree.mutations)
        fresh = _port()
        assert fresh.restore(store) == step
        _assert_lockstep(eng, fresh)
        res_a = eng.query_detailed(blocks[0][:16])
        res_b = fresh.query_detailed(blocks[0][:16])
        assert res_a.version == res_b.version
        for f in ("labels", "bubble_index", "distance", "strength"):
            np.testing.assert_array_equal(getattr(res_a, f), getattr(res_b, f))
        assert fresh.tree._struct_dirty == eng.tree._struct_dirty
        assert fresh.tree._point_free == eng.tree._point_free
        assert fresh.tree._node_free == eng.tree._node_free
        store.close()

    def test_restore_rejects_mismatched_configuration(self, tmp_path):
        eng = _port()
        _drive(eng, _blocks(4, 2))
        store = CheckpointStore(str(tmp_path), keep=2)
        eng.save(store)
        with pytest.raises(ValueError, match="dim"):
            StreamingClusterEngine(dim=3, device="cpu", **ENGINE_KW).restore(store)
        state = eng.checkpoint_state()
        state["cfg/device_online"] = np.bool_(True)
        with pytest.raises(ValueError, match="device_online"):
            _port().restore(_DictStore(state))
        state = eng.checkpoint_state()
        state["cfg/format"] = np.int64(2)
        with pytest.raises(ValueError, match="format"):
            _port().restore(_DictStore(state))
        busy = _port()
        busy.submit_insert(np.zeros((3, 2)))
        with pytest.raises(RuntimeError, match="queued"):
            busy.restore(store)
        store.close()

    @pytest.mark.parametrize("field,item", [("cfg/exact", "item 6")])
    def test_unported_state_is_refused(self, field, item):
        """An exact-mode state (ROADMAP queue 1, item 6, once refused as not
        ported): restore into a default engine checks the mode first and
        raises the reference's ValueError; the carry, which takes its modes
        from the state, now builds an exact-mode engine that rebuilds its
        dynamic state from the restored tree and stays in lockstep."""
        from repro_torch import engine_from_reference_state

        eng = _port(exact=True)
        _drive(eng, _blocks(5, 2))
        state = eng.checkpoint_state()
        assert bool(state[field]) and item == "item 6"
        fresh = _port()
        with pytest.raises(ValueError, match=field):
            fresh.restore(_DictStore(state))
        assert fresh.snapshot is None and fresh.tree.n_points == 0
        carried = engine_from_reference_state(state, device="cpu")
        assert carried.exact and carried.snapshot.version == eng.snapshot.version
        extra = _blocks(6, 1)[0]
        for e in (eng, carried):
            e.ingest(extra)
        _assert_lockstep(carried, eng)
        assert carried.stats["exact_rebuilds"] == 1

    def test_device_online_state_restores(self):
        """A live flat table (``flat/has``) restores into a device-online
        engine, which then stays in lockstep with the engine it came from."""
        blocks = _blocks(5, 4)
        eng = _port(device_online=True)
        _drive(eng, blocks[:2])
        state = eng.checkpoint_state()
        assert state["flat/has"] and state["cfg/device_online"]
        fresh = _port(device_online=True)
        fresh.restore(_DictStore(state))
        assert not fresh._flat.stale and fresh._flat._free == eng._flat._free
        for e in (eng, fresh):
            _drive(e, blocks[2:])
        _assert_lockstep(eng, fresh)

    def test_versions_keep_rising_after_a_restore(self, rng):
        eng = _port(min_pts=4)
        eng.ingest(rng.normal(size=(64, 2)))
        eng.maybe_recluster(force=True)
        state = eng.checkpoint_state()
        eng2 = _port(min_pts=4)
        eng2.restore(_DictStore(state))
        restored = eng2.snapshot
        assert eng2._version == int(state["eng/version"])
        eng2.maybe_recluster(force=True)
        assert eng2.snapshot.version > restored.version


class TestKillAndRecover:
    def test_drill_bitwise_replay(self, tmp_path):
        blocks = _blocks(11, 6)
        cut = len(blocks) // 2
        oracle, victim = _port(), _port()
        for eng in (oracle, victim):
            _drive(eng, blocks[:cut])
        store = CheckpointStore(str(tmp_path), keep=2)
        victim.save(store)
        del victim  # the kill: only the checkpoint survives
        recovered = _port()
        recovered.restore(store)
        for eng in (oracle, recovered):
            _drive(eng, blocks[cut:])
        _assert_lockstep(oracle, recovered)
        store.close()

    def test_kill_mid_async_pass(self, tmp_path):
        """A checkpoint taken while an async pass may be in flight holds the
        last PUBLISHED version; after the same further blocks and a flush,
        labels and MST converge bit for bit (versions may not)."""
        blocks = _blocks(13, 6)
        cut = 4
        oracle, victim = _port(async_offline=True), _port(async_offline=True)
        store = CheckpointStore(str(tmp_path), keep=2)
        for eng in (oracle, victim):
            for b in blocks[:cut]:
                eng.ingest(b)
                eng.maybe_recluster()
        victim.save(store)
        del victim
        recovered = _port(async_offline=True)
        recovered.restore(store)
        for eng in (oracle, recovered):
            for b in blocks[cut:]:
                eng.ingest(b)
            eng.flush()
        _assert_lockstep(oracle, recovered, versions=False)
        store.close()

    def test_recover_from_latest_of_many(self, tmp_path):
        blocks = _blocks(14, 6)
        oracle, victim = _port(), _port()
        store = CheckpointStore(str(tmp_path), keep=2)
        steps = []
        for i, b in enumerate(blocks[:4]):
            for eng in (oracle, victim):
                eng.ingest(b)
                eng.maybe_recluster()
            steps.append(victim.save(store, step=i, blocking=i % 2 == 0))
        store.wait()
        recovered = _port()
        assert recovered.restore(store) == steps[-1]
        for eng in (oracle, recovered):
            _drive(eng, blocks[4:])
        _assert_lockstep(oracle, recovered)
        store.close()


class TestAcrossPackages:
    def test_reference_checkpoint_restores_into_the_port(self, tmp_path):
        blocks = _blocks(21, 6)
        cut = 3
        ref, ref_twin = _ref(), _ref()
        for eng in (ref, ref_twin):
            _drive(eng, blocks[:cut])
        store = RefStore(str(tmp_path), keep=2)
        ref.save(store)
        store.close()
        port = _port()
        pstore = CheckpointStore(str(tmp_path))
        port.restore(pstore)
        pstore.close()
        _assert_milestone(port, ref_twin)
        assert port.tree.dirty_mass == ref_twin.tree.dirty_mass
        for eng in (port, ref_twin):
            _drive(eng, blocks[cut:])
        _assert_milestone(port, ref_twin)

    def test_port_checkpoint_restores_into_the_reference(self, tmp_path):
        blocks = _blocks(22, 6)
        cut = 3
        port, ref_twin = _port(), _ref()
        for eng in (port, ref_twin):
            _drive(eng, blocks[:cut])
        store = CheckpointStore(str(tmp_path), keep=2)
        port.save(store)
        store.close()
        ref = _ref()
        rstore = RefStore(str(tmp_path))
        ref.restore(rstore)
        rstore.close()
        _assert_milestone(port, ref)
        for eng in (port, ref, ref_twin):
            _drive(eng, blocks[cut:])
        _assert_milestone(port, ref)
        _assert_milestone(port, ref_twin)


class TestExactModeCheckpoints:
    @pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
    def test_exact_mode_roundtrip(self, tmp_path, direction):
        """An ``exact=True`` engine saved by one package restores into the
        other's (``cfg/exact`` carried; the dynamic state rebuilt from the
        tree at the next refresh), and the next refreshes give the
        reference's versions and partitions."""
        blocks = _blocks(23, 6)
        cut = 3
        to_port = direction == "reference_to_port"
        src = _ref(exact=True) if to_port else _port(exact=True)
        twin = _ref(exact=True)
        for eng in (src, twin):
            _drive(eng, blocks[:cut])
        store = (RefStore if to_port else CheckpointStore)(str(tmp_path), keep=2)
        src.save(store)
        store.close()
        dst = _port(exact=True) if to_port else _ref(exact=True)
        rstore = (CheckpointStore if to_port else RefStore)(str(tmp_path))
        dst.restore(rstore)
        rstore.close()
        port, ref = (dst, twin) if to_port else (src, dst)
        _assert_milestone(port, ref)
        for eng in (port, ref):
            _drive(eng, blocks[cut:])
        _assert_milestone(port, ref)
        assert dst.exact and dst.stats["exact_rebuilds"] >= 1


class TestTrainingStateCheckpoints:
    """A ``(params, opt_state)`` training state crosses between the
    packages' stores: the JAX store's save (outside a mesh) restores into
    the port with ``restore(like=)`` bit for bit, the next port step's
    loss, grad_norm and lr are the next JAX step's (f32 compute: within
    2e-6 relative, the sums' order), its params within 2·lr (Adam's step
    on a gradient element at f32 noise can take either sign); the port's
    save restores in the JAX store bit for bit."""

    ARCH = "qwen2-1.5b"

    def _setup(self):
        import jax
        import jax.numpy as jnp

        import repro.configs as RC
        import repro_torch.configs as PC
        from repro.models import model as RM
        from repro.train import optim as RO

        rc = RC.get_smoke(self.ARCH).replace(compute_dtype=jnp.float32)
        pc = PC.get_smoke(self.ARCH).replace(compute_dtype=torch.float32)
        opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
        values, _ = RM.init_params(rc, jax.random.PRNGKey(0))
        rng = np.random.default_rng(11)
        batches = []
        for _ in range(2):
            toks = rng.integers(0, rc.vocab_size, size=(2, 25)).astype(np.int32)
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        step = jax.jit(RM.make_train_step(rc, RO.AdamWConfig(**opt)))
        values, state, _ = step(values, RO.adamw_init(values), {k: jnp.asarray(v) for k, v in batches[0].items()})
        return rc, pc, opt, values, state, step, batches

    def test_jax_training_state_into_the_port_and_back(self, tmp_path):
        import jax
        import jax.numpy as jnp

        from repro_torch.models import model as M
        from repro_torch.train import AdamWConfig, adamw_init
        from repro_torch.tree import tree_leaves

        rc, pc, opt, values, state, step, batches = self._setup()
        ref = RefStore(str(tmp_path / "jax"), keep=2)
        ref.save(1, (values, state), blocking=True)
        ref.close()
        like = M.init_params(pc, torch.Generator().manual_seed(3), device="cpu")
        store = CheckpointStore(str(tmp_path / "jax"))
        at, (params, pstate) = store.restore(like=(like, adamw_init(like)))
        store.close()
        assert at == 1 and pstate["step"].dtype == torch.int32 and int(pstate["step"]) == 1
        want = jax.tree.map(np.asarray, (values, state))
        got_leaves, want_leaves = tree_leaves((params, pstate)), jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert g.dtype == torch.from_numpy(np.array(w)).dtype and np.array_equal(g.numpy(), w)
        # the next step on both sides
        values, state, rm = step(values, state, {k: jnp.asarray(v) for k, v in batches[1].items()})
        params, pstate, pm = M.make_train_step(pc, AdamWConfig(**opt))(
            params, pstate, {k: torch.as_tensor(v) for k, v in batches[1].items()})
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(pm[key]) - float(rm[key])) <= 2e-6 * abs(float(rm[key])), key
        for g, w in zip(tree_leaves(params), jax.tree.leaves(jax.tree.map(np.asarray, values))):
            assert float(np.abs(g.numpy() - w).max()) <= 2 * opt["lr"]
        # the port's save, restored by the JAX store
        out = CheckpointStore(str(tmp_path / "port"), keep=2)
        out.save(2, (params, pstate), blocking=False)
        out.close()
        back = RefStore(str(tmp_path / "port"))
        at, restored = back.restore(like=(values, state))
        back.close()
        assert at == 2
        for g, w in zip(tree_leaves((params, pstate)), jax.tree.leaves(restored)):
            assert np.array_equal(g.numpy(), np.asarray(w))

    def test_restore_like_refuses_a_missing_leaf(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(3, {"a": torch.ones(2), "b": {"c": torch.zeros(3, dtype=torch.int32)}})
        at, tree = store.restore(like={"a": torch.empty(2, dtype=torch.float64), "b": {"c": np.zeros(3, np.int64)}})
        assert at == 3 and tree["a"].dtype == torch.float64 and tree["b"]["c"].dtype == np.int64
        with pytest.raises(KeyError):
            store.restore(like={"a": torch.empty(2), "z": torch.empty(1)})
        store.close()

    def test_restore_like_refuses_another_shape(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, ({"w": torch.ones(2, 3)}, (torch.zeros(4), None)))
        at, (w, (v, none)) = store.restore(like=({"w": torch.empty(2, 3)}, (torch.empty(4), None)))
        assert at == 1 and torch.equal(w["w"], torch.ones(2, 3)) and torch.equal(v, torch.zeros(4)) and none is None
        with pytest.raises(ValueError, match="another shape"):
            store.restore(like=({"w": torch.empty(3, 2)}, (torch.empty(4), None)))
        store.close()

    def test_async_save_takes_its_copy_before_an_in_place_update(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        t = torch.arange(4, dtype=torch.float32)
        store.save(1, {"t": t}, blocking=False)
        t.add_(100.0)  # the optimizer's in-place update, before the writer runs
        store.wait()
        _, flat = store.restore(1)
        store.close()
        assert np.array_equal(flat["t"], np.arange(4, dtype=np.float32))
