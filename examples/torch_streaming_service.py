"""Streaming clustering as a service on the PyTorch port: batched
ingestion + incremental offline re-clustering + label serving, end to end
on the card (or on the CPU's plain versions with --device cpu).

Simulates a fleet of producers inserting/retiring points while a consumer
queries cluster labels between offline passes:

  1. warm-up: bulk-load half the stream, first offline pass runs;
  2. steady state: mixed insert/delete blocks arrive; the engine batches
     them, re-clustering only when ≥ ε of the mass changed;
  3. serving: every round, labels are read from the *cached* hierarchy —
     queries never wait for ingestion or the offline pass;
  4. kill-and-recover: the engine checkpoints its summary (checkpoint/
     store.py — atomic publish, async writes), the process "dies", and a
     fresh engine restores and keeps streaming bit-for-bit (DESIGN.md
     §11) — replay cost is O(summary), never O(raw stream).

  PYTHONPATH=src python examples/torch_streaming_service.py               # on the GPU
  PYTHONPATH=src python examples/torch_streaming_service.py --device cpu  # plain versions
"""

import argparse
import tempfile

import numpy as np

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.metrics import nmi
from repro_torch.data.synthetic import gaussian_mixtures
from repro_torch.serving.stream import StreamingClusterEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(11)
    X, y = gaussian_mixtures(4000, d=4, k=5, overlap=0.05, seed=11)

    eng = StreamingClusterEngine(
        dim=4,
        min_pts=15,
        compression=0.05,
        epsilon=0.15,          # re-cluster when ≥15% of mass changed
        max_block=512,
        device=args.device,    # the card by default; "cpu" runs the plain versions
        async_offline=True,    # offline pass off the ingest path
    )
    print(f"engine on {eng.backend}")

    # -- 1. warm-up ---------------------------------------------------------
    warm = eng.submit_insert(X[:2000])
    eng.poll()
    eng.join()  # wait for the first hierarchy so serving starts labelled
    snap = eng.snapshot
    assert snap is not None
    print(f"[warmup] v{snap.version}: {snap.n_bubbles} bubbles, "
          f"{snap.n_clusters} clusters, offline {snap.wall_seconds * 1e3:.0f} ms")

    # -- 2./3. steady state: mixed stream + serving in between --------------
    # the tree recycles pids of deleted points, so a service keeps its own
    # pid -> record mapping (here: row of X, for final scoring)
    row_of = {pid: row for row, pid in enumerate(warm.pids)}
    live = list(warm.pids)
    i = 2000
    round_no = 0
    while i < 4000:
        blk = X[i : i + 400]
        t = eng.submit_insert(blk)                     # arrivals
        drop = [live.pop(rng.integers(len(live))) for _ in range(150)]
        eng.submit_delete(drop)                        # retirements
        eng.poll()
        live.extend(t.pids)
        for pid in drop:
            row_of.pop(pid)
        row_of.update({pid: row for row, pid in zip(range(i, i + 400), t.pids)})
        i += 400
        round_no += 1
        # serve from whatever hierarchy is cached RIGHT NOW — the
        # device-cached path (DESIGN.md §9): one upload per snapshot
        # version, one fused assign launch per query batch, and query_detailed
        # adds distance + condensed-tree membership strength
        q = rng.choice(len(X), size=200, replace=False)
        res = eng.query_detailed(X[q])
        labels = res.labels
        snap = eng.snapshot
        served = (labels >= 0).mean()
        strong = res.strength[labels >= 0].mean() if (labels >= 0).any() else 0.0
        print(f"[round {round_no}] n={eng.tree.n_points} "
              f"dirty={eng.tree.dirty_fraction():.2f} serving v{res.version} "
              f"({snap.n_clusters} clusters, {100 * served:.0f}% non-noise, "
              f"mean strength {strong:.2f})")

    # -- 4. kill-and-recover round ------------------------------------------
    # checkpoint the summary, "kill" the worker, restore into a fresh
    # engine — it serves the last published snapshot immediately and the
    # next blocks replay bitwise (pid allocation, ε accounting and the
    # snapshot version all round-trip; tests/test_torch_checkpoint.py
    # pins this on the port)
    ckpt_dir = tempfile.TemporaryDirectory(prefix="svc_ckpt_")  # removed at exit
    store = CheckpointStore(ckpt_dir.name, keep=2)
    eng.join()  # example-ism: quiesce so old/new stay in version lockstep
    step = eng.save(store)
    pre_kill = eng.query(X[:200])
    old_eng, eng = eng, StreamingClusterEngine(
        dim=4, min_pts=15, compression=0.05, epsilon=0.15,
        max_block=512, device=args.device, async_offline=True,
    )
    eng.restore(store)
    assert np.array_equal(eng.query(X[:200]), pre_kill)
    print(f"[recover] restored step {step}: serving v{eng.snapshot.version} "
          f"with {eng.tree.n_points} points, pre-kill labels reproduced")
    blk_rows = rng.choice(2000, size=200, replace=False)  # stream continues
    for e in (old_eng, eng):
        pids = e.ingest(X[blk_rows])
        e.flush()
    row_of.update({pid: int(row) for pid, row in zip(pids, blk_rows)})
    p_old, l_old = old_eng.labels()
    p_new, l_new = eng.labels()
    assert np.array_equal(p_old, p_new) and np.array_equal(l_old, l_new)
    print(f"[recover] post-restore block replays bitwise "
          f"(v{eng.snapshot.version}, {eng.tree.n_points} points)")

    # -- final: drain + force a last pass, score against ground truth -------
    snap = eng.flush()
    pids, labels = eng.labels()
    truth = y[[row_of[int(p)] for p in pids]]
    score = nmi(labels, truth)
    s = eng.stats
    print(f"[final] v{snap.version}: {snap.n_clusters} clusters over "
          f"{eng.tree.n_points} points, {snap.n_bubbles} bubbles")
    print(f"[final] {s['inserts']} inserts + {s['deletes']} deletes in "
          f"{s['blocks_applied']} blocks, {s['recluster_count']} offline passes "
          f"({s['offline_seconds_total']:.2f}s total)")
    print(f"[final] NMI vs ground truth on survivors: {score:.3f}")
    assert score > 0.7, "streaming labels diverged from ground truth"
    print("OK")


if __name__ == "__main__":
    main()
