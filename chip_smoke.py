#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each printing its own lines:

  1. card     nvidia-smi's name and power limit, torch/CUDA versions, the
              TF32 switches;
  2. build    the hand-written CUDA kernels, built from src/repro_torch/
              kernels/csrc at first use (nvcc, sm_90a);
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes, on a tie-free mean-centred table
              and on a duplicate-heavy one, with kernel / plain / library
              times;
  4. stream   the default StreamingClusterEngine on the card: 262,144
              points at d = 16 from a seeded Gaussian mixture, ingested in
              blocks of 8192 (compression 0.02 → ~5,200 leaves, Lp = 8192),
              a quarter retired in blocks, 65,536 queries in chunks; then
              the snapshots and the served rows held against the port's
              own plain pipeline on the CPU, and one offline pass at
              Lp = 8192 timed stage by stage;
  5. the kernels JSON line (launches on the stream, errors, times, bounds);
  6. the last line: {"ok": true, "device": {...}}.

Exits non-zero, with no result line, without a GPU, outside a checkout
of the repository, or when any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20241209
DIM = 16
N_POINTS = 262_144
BLOCK = 8192
COMPRESSION = 0.02
MIN_PTS = 10
EPSILON = 0.2
N_QUERIES = 65_536
QUERY_CHUNK = 4096
LP = 8192  # the offline bucket the stream reaches, and the kernels' check size
RTOL = 1e-5

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_BYTES = 3.35e12
EPS32 = float(np.finfo(np.float32).eps)


def say(*parts):
    print(*parts, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def mixture(rng, n, k=20, spread=3.0):
    """A seeded d=16 Gaussian mixture: k unit-variance blobs whose centres
    are N(0, spread²) per coordinate."""
    centres = rng.normal(scale=spread, size=(k, DIM))
    return centres[rng.integers(0, k, size=n)] + rng.normal(size=(n, DIM))


def time_ms(fn, reps=10, warm=2):
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dist_tol(x, y, r):
    """Elementwise allowance for an f32 distance r between rows of x and y
    computed in the expanded form by two different summation orders:
    1e-5 relative plus the cancellation bound δ(r²) = 8ε(max‖x‖²+max‖y‖²),
    i.e. δ(r) = min(√δ(r²), δ(r²)/2r)."""
    import torch

    dsq = 8 * EPS32 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    floor = torch.minimum(torch.full_like(r, dsq**0.5), dsq / (2 * r.clamp_min(1e-30)))
    return RTOL * r.abs() + floor


def compare(name, got, want, tol):
    """Hold ``got`` to ``want`` within ``tol`` (+inf must match +inf)."""
    import torch

    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    check(bool(torch.equal(inf_g, inf_w)), f"{name}: +inf positions differ")
    fin = ~inf_w
    err = (got[fin] - want[fin]).abs()
    bad = int((err > tol[fin]).sum())
    rel = float((err / want[fin].abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    check(bad == 0, f"{name}: {bad} elements outside tolerance")
    return float(err.max()) if err.numel() else 0.0, rel


def tie_free_rows(q, reps, sites=None):
    """Rows of q whose best and second-best squared distance to the table
    (or to its distinct ``sites``) differ by more than 64× the f32
    rounding of the expanded form — no near-tie rounding can flip."""
    import torch

    from repro_torch.kernels import ref

    table = reps if sites is None else sites
    sq = ref.pairwise_sqdist(q, table)
    two = torch.topk(sq, 2, dim=1, largest=False).values
    noise = 64 * EPS32 * ((q * q).sum(1) + float((table * table).sum(1).max()))
    keep = (two[:, 1] - two[:, 0]) > noise
    return q[keep], int((~keep).sum())


def direct_core_distances(rep, nb, ext, rows=256):
    """Eq. 6 by the plain sort + cumulative mass over distances in the
    direct-difference form √Σ(x−y)², ``rows`` table rows at a time.  Exact
    copies of a row are exactly 0 apart here, as in the kernel, so the
    (d, j) order among copies is the index order on both sides.  The
    yardstick of the duplicate-order check only."""
    import torch

    from repro_torch.kernels import ref

    out = []
    for i in range(0, rep.shape[0], rows):
        blk = rep[i : i + rows]
        d = (blk[:, None, :] - rep[None, :, :]).square().sum(-1).sqrt()
        ids = torch.arange(i, i + blk.shape[0], device=rep.device)
        out.append(ref.bubble_core_distances_from_dm(d, ids, nb, ext, MIN_PTS, DIM))
    return torch.cat(out)


def phase_card():
    import torch

    from repro_torch.device import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    say(f"[card] {card}")
    dev = resolve_device("cuda")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    say(f"[card] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 must be off")
    return dev, card


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    say(f"[build] {info['path']} built in {info['seconds']:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            say(f"[build] {line.strip()}")


def phase_kernels(dev):
    """Each kernel vs its plain version at the path's shapes; returns the
    per-kernel numbers for the JSON line."""
    import torch

    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ref

    rng = np.random.default_rng(SEED)
    out = {}

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    # tie-free centred table and a duplicate-heavy one (300 sites over LP rows)
    pts = mixture(rng, LP + 3 * LP)
    pts -= pts.mean(axis=0)
    R = t(pts[:LP])
    Q, dropped = tie_free_rows(t(pts[LP:]), R)
    Q = Q[:LP].contiguous()
    check(Q.shape[0] == LP, f"only {Q.shape[0]} tie-free queries")
    sites = mixture(rng, 300)
    sites -= sites.mean(axis=0)
    site_of_row = rng.integers(0, 300, size=LP)
    Rdup = t(sites[site_of_row])
    near = sites[rng.integers(0, 300, size=2 * LP)] + rng.normal(scale=0.3, size=(2 * LP, DIM))
    Qdup, dropped_dup = tie_free_rows(t(near), Rdup, t(sites))
    Qdup = torch.cat([Rdup[:1000], Qdup[: LP - 1000]]).contiguous()  # on-table rows tie by index

    # --- assign: 8192 × 8192 × 16, with and without the distance; ragged L
    errs = []
    ragged = LP - 192  # a multiple of no kernel chunk or tile
    Rr = R[:ragged].contiguous()
    Qr, _ = tie_free_rows(Q, Rr)
    for label, q, r in (("tie-free", Q, R), ("duplicates", Qdup, Rdup), (f"ragged L={ragged}", Qr, Rr)):
        idx, dist = k_assign.assign(q, r, with_dist=True)
        idx_only = k_assign.assign(q, r)
        pidx, pdist = ref.assign_with_dist(q, r)
        check(bool(torch.equal(idx, pidx)) and bool(torch.equal(idx_only, pidx)),
              f"assign {label}: {int((idx != pidx).sum())} indices differ")
        e, rel = compare(f"assign {label}", dist, pdist, dist_tol(q, r, pdist))
        errs.append(e)
        say(f"[kernels] assign {label}: indices identical ({q.shape[0]} rows, {r.shape[0]} reps), "
            f"dist max_abs_err {e:.3e} max_rel {rel:.3e}")
    say(f"[kernels] assign: near-tie rows left out of the tie-free sets: {dropped} / {dropped_dup}")
    n, L = Q.shape[0], R.shape[0]
    ms = time_ms(lambda: k_assign.assign(Q, R))
    ms_d = time_ms(lambda: k_assign.assign(Q, R, with_dist=True))
    plain = time_ms(lambda: ref.assign(Q, R))
    lib = time_ms(lambda: torch.cdist(Q, R).min(dim=1))
    b, by = bound_ms(2.0 * n * L * DIM, 4.0 * (n * DIM + L * DIM + n))
    say(f"[kernels] assign {n}x{L}x{DIM}: kernel {ms:.4f} ms (with dist {ms_d:.4f}), plain {plain:.4f} ms, "
        f"cdist+min {lib:.4f} ms, bound {b:.4f} ms ({by})")
    out["assign"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)

    # --- bubble_cd: LP rows, min_pts 10, masses > 1; path layout (pads at
    # 1e6 with mass 0 past the real rows) and a ragged pad-free table
    def table(rows, real, site=None):
        """Masses 1..30 and extents per row, or per site for a table of
        duplicated bubbles: the copies of a row sit at distance 0 in the
        kernel and at f32 rounding noise in the plain version, so which
        copy crosses min_pts differs, and only a per-site mass and extent
        makes Eq. 6 independent of that order (the order itself is held
        against the direct-difference yardstick below)."""
        rep = rows.clone()
        rep[real:] = 1e6
        key = np.arange(rep.shape[0]) if site is None else site
        nb = t(rng.integers(1, 31, size=key.max() + 1)[key])
        nb[real:] = 0
        ext = t(rng.uniform(0.2, 2.0, size=key.max() + 1)[key])
        ext[real:] = 0
        return rep.contiguous(), nb, ext

    real = min(LP, round(COMPRESSION * N_POINTS))  # the leaf count the stream reaches
    cases = {"tie-free": (table(R, real), real), "duplicates, mass per site": (table(Rdup, real, site_of_row), real),
             f"ragged L={ragged}": (table(Rr, ragged), ragged)}
    errs = []
    cds = {}
    for label, ((rep, nb, ext), nreal) in cases.items():
        cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM)
        pcd = ref.bubble_core_distances(rep, nb, ext, MIN_PTS, DIM)
        # pad rows (mass 0, all at one far point) never cross min_pts and
        # take each side's documented fallback; their W rows are +inf
        # the allowance is that of the row's nearest other bubble, the
        # shortest distance the crossing can sit at (self crossings are 0)
        sq = ref.pairwise_sqdist(rep[:nreal], rep[:nreal]).fill_diagonal_(float("inf"))
        r1 = sq.amin(1).sqrt()
        del sq
        tol = dist_tol(rep[:nreal], rep[:nreal], r1) - RTOL * r1 + RTOL * pcd[:nreal].abs()
        e, rel = compare(f"bubble_cd {label}", cd[:nreal], pcd[:nreal], tol)
        errs.append(e)
        cds[label] = (rep, nb, ext, pcd, nreal)
        say(f"[kernels] bubble_cd {label}: {nreal} real rows of {rep.shape[0]}, "
            f"max_abs_err {e:.3e} max_rel {rel:.3e}")
    # the (d, j) order among copies: duplicates with a mass and extent per
    # ROW, so Eq. 6 depends on which copy crosses min_pts.  A row whose
    # site holds >= min_pts of mass crosses among its own copies, all at
    # exactly 0 in the kernel and the yardstick: there the two agree to
    # 1e-5 relative or the order differs.  Other rows cross at another
    # site, no nearer than the nearest other site, and get that distance's
    # cancellation allowance as above.
    rep, nb, ext = table(Rdup, real)
    cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM)
    want = direct_core_distances(rep, nb, ext)
    site_mass = np.bincount(site_of_row[:real], weights=nb[:real].cpu().numpy(), minlength=300)
    own = torch.as_tensor(site_mass[site_of_row[:real]] >= MIN_PTS, device=dev)
    ts = t(sites)
    sq = ref.pairwise_sqdist(ts, ts).fill_diagonal_(float("inf"))
    r1 = sq.amin(1).sqrt()[torch.as_tensor(site_of_row[:real], device=dev)]
    tol = RTOL * want[:real].abs() + torch.where(
        own, 0.0, dist_tol(rep[:real], rep[:real], r1) - RTOL * r1)
    e, rel = compare("bubble_cd duplicates, mass per row", cd[:real], want[:real], tol)
    errs.append(e)
    say(f"[kernels] bubble_cd duplicates, mass per row, vs the direct-difference yardstick: {real} real rows, "
        f"{int(own.sum())} crossing among their own copies (tie order, 1e-5 relative), "
        f"max_abs_err {e:.3e} max_rel {rel:.3e}")
    rep, nb, ext, _, _ = cds["tie-free"]
    ms = time_ms(lambda: k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM))
    plain = time_ms(lambda: ref.bubble_core_distances(rep, nb, ext, MIN_PTS, DIM), reps=3)
    # every unordered pair's distance once: L(L-1)/2 · d FMAs
    b, by = bound_ms(1.0 * LP * (LP - 1) * DIM, 4.0 * (LP * DIM + 3 * LP))
    say(f"[kernels] bubble_cd L={LP} d={DIM} min_pts={MIN_PTS}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.4f} ms ({by}); no single PyTorch call computes Eq. 6")
    out["bubble_cd"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)

    # --- mutual_reach: LP², pad rows/cols +inf, diagonal 0
    errs = []
    for label, (rep, _, _, pcd, nreal) in cds.items():
        W = k_mr.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal)
        pW = ref.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal)
        check(bool((W.diagonal()[:nreal] == 0).all()), f"mutual_reach {label}: diagonal not 0")
        base = ref.mutual_reachability(rep, rep, torch.zeros_like(pcd), torch.zeros_like(pcd), n_valid=nreal)
        e, rel = compare(f"mutual_reach {label}", W, pW, dist_tol(rep[:nreal], rep[:nreal], base) + RTOL * pW.abs())
        errs.append(e)
        say(f"[kernels] mutual_reach {label}: {rep.shape[0]}², n_valid {nreal}, max_abs_err {e:.3e} max_rel {rel:.3e}")
        del W, pW, base
    rep, _, _, pcd, nreal = cds["tie-free"]
    ms = time_ms(lambda: k_mr.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal))
    plain = time_ms(lambda: ref.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal), reps=5)
    lib = time_ms(lambda: torch.maximum(torch.cdist(rep, rep), torch.maximum(pcd[:, None], pcd[None, :])), reps=5)
    b, by = bound_ms(2.0 * LP * LP * DIM, 4.0 * (LP * LP + 2 * LP * DIM + 2 * LP))
    say(f"[kernels] mutual_reach {LP}²x{DIM}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"cdist+maximum {lib:.4f} ms, bound {b:.4f} ms ({by})")
    out["mutual_reach"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a == -1, b == -1):
        return False
    m = a != -1
    pairs = set(zip(a[m].tolist(), b[m].tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs})


def phase_stream(dev):
    """The engine on the card; returns the launch counts of the stream and
    the tables for the CPU checks."""
    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import mutual_reach as k_mr

    rng = np.random.default_rng(SEED + 1)
    data = mixture(rng, N_POINTS + N_QUERIES) + 50.0  # off the origin: the engine centres
    X, Qs = data[:N_POINTS], data[N_POINTS:]
    eng = StreamingClusterEngine(
        DIM, min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device=dev)
    passes = []

    def note_pass(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            passes.append((snap.n_bubbles, max(8, 1 << (snap.n_bubbles - 1).bit_length()),
                           snap.wall_seconds * 1e3))

    for mod in (k_assign, k_bcd, k_mr):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_stream = time.perf_counter()
    ingest_s, pids = 0.0, []
    for i in range(0, N_POINTS, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        pids.extend(eng.ingest(X[i : i + BLOCK]))
        ingest_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        note_pass(v0)
    v0 = eng.snapshot.version
    snap_full = eng.flush()
    note_pass(v0)
    table_full = eng._table.capture(eng.tree.n_points).table()
    retire_s = 0.0
    drop = rng.choice(len(pids), size=N_POINTS // 4, replace=False)
    for i in range(0, len(drop), BLOCK):
        v0 = eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        eng.retire([pids[j] for j in drop[i : i + BLOCK]])
        retire_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        note_pass(v0)
    v0 = eng.snapshot.version
    snap_last = eng.flush()
    note_pass(v0)
    table_last = eng._table.capture(eng.tree.n_points).table()
    lat, served = [], []
    for i in range(0, N_QUERIES, QUERY_CHUNK):
        t0 = time.perf_counter()
        served.append(eng.query_detailed(Qs[i : i + QUERY_CHUNK]))
        lat.append((time.perf_counter() - t0) * 1e3)
    stream_s = time.perf_counter() - t_stream
    launches = {"assign": k_assign.launches, "bubble_cd": k_bcd.launches, "mutual_reach": k_mr.launches}

    say(f"[stream] {N_POINTS} points d={DIM} in blocks of {BLOCK}, {len(drop)} retired, "
        f"{N_QUERIES} queries in chunks of {QUERY_CHUNK}: {stream_s:.2f} s wall, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[stream] launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the stream")
    say(f"[stream] ingest {ingest_s / N_POINTS * 1e6:.3f} ms per 1k points (host tree + assign kernel, "
        f"offline passes excluded); retire {retire_s / len(drop) * 1e6:.3f} ms per 1k points")
    say(f"[stream] offline passes (L, Lp, ms): {[(a, b, round(c, 1)) for a, b, c in passes]}")
    check(any(lp == LP for _, lp, _ in passes), f"no offline pass at Lp = {LP}")
    check(snap_full.n_bubbles > LP // 2, "the full-stream snapshot is not in the Lp = 8192 bucket")
    say(f"[stream] query latency per {QUERY_CHUNK}-row chunk: p50 {np.median(lat):.3f} ms, "
        f"min {min(lat):.3f} ms, max {max(lat):.3f} ms")
    for res in served:
        check(res.version == snap_last.version and np.isfinite(res.distance).all()
              and ((res.strength >= 0) & (res.strength <= 1)).all(), "malformed query result")
    return dict(snap_full=snap_full, table_full=table_full, snap_last=snap_last,
                table_last=table_last, Qs=Qs, served=served, launches=launches)


def phase_cpu_check(run):
    """The stream's snapshots and served rows against the port's own plain
    pipeline on the CPU."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.serving.query import _build_entry, _fused_query

    for name in ("full", "last"):
        snap, (rep, extent, n_b, center) = run[f"snap_{name}"], run[f"table_{name}"]
        check(np.array_equal(rep, snap.bubble_rep) and np.array_equal(center, snap.center),
              f"{name}: the captured table is not the snapshot's")
        t0 = time.perf_counter()
        cpu = ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device="cpu")
        w_gpu, w_cpu = float(np.sum(snap.mst[2])), float(np.sum(cpu.mst[2]))
        rel = abs(w_gpu - w_cpu) / abs(w_cpu)
        say(f"[check] {name} snapshot (L={snap.n_bubbles}): CPU plain pass {time.perf_counter() - t0:.2f} s, "
            f"{cpu.n_clusters} vs {snap.result.n_clusters} clusters, MST weight rel diff {rel:.3e}")
        check(_same_partition(snap.bubble_labels, cpu.labels), f"{name}: partition differs from the CPU pass")
        check(rel <= RTOL, f"{name}: MST weight differs by {rel:.3e}")

    snap = run["snap_last"]
    entry = _build_entry(snap, torch.device("cpu"))
    X = run["Qs"]
    idx, lbl, near_tie = [], [], []
    for i in range(0, X.shape[0], 16384):
        xc = torch.from_numpy((X[i : i + 16384] - entry.center[None, :]).astype(np.float32))
        out = _fused_query(xc, entry.reps, entry.labels, entry.lam, entry.lam_max)
        idx.append(out[0].numpy())
        lbl.append(out[1].numpy())
        sq = ref.pairwise_sqdist(xc, entry.reps[: snap.n_bubbles])
        two = torch.topk(sq, 2, dim=1, largest=False).values.sqrt()
        near_tie.append(((two[:, 1] - two[:, 0]) <= RTOL * two[:, 1]).numpy())
    idx, lbl, near_tie = (np.concatenate(a) for a in (idx, lbl, near_tie))
    got = np.concatenate([r.bubble_index for r in run["served"]])
    got_lbl = np.concatenate([r.labels for r in run["served"]])
    differ = (got != idx) & ~near_tie
    say(f"[check] served bubble_index vs CPU plain _fused_query: {int(differ.sum())} differ on "
        f"{int((~near_tie).sum())} rows; {int(near_tie.sum())} near-ties (second-best within 1e-5) left out")
    check(not differ.any(), "served rows differ from the CPU plain query")
    check(np.array_equal(got_lbl[~near_tie], lbl[~near_tie]), "served labels differ")


def phase_stages(dev, table):
    """One offline pass at Lp = 8192 through the engine's own entry point,
    ops.offline_recluster_from_table, each stage timed through its
    ``stage`` hook."""
    import torch

    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    L = rep.shape[0]
    times = {}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return r

    for _ in range(2):  # the second round is the one reported (warm caches)
        res = ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=timed)
    check(res.n_bubbles == L and res.n_clusters > 0, "the timed pass gave no clustering")
    total = sum(times.values())
    say(f"[stages] one offline pass at L={L}, Lp={ops._pow2_rows(L)} (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + f"; total {total:.2f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    t0 = time.perf_counter()
    dev, card = phase_card()
    phase_build()
    numbers = phase_kernels(dev)
    run = phase_stream(dev)
    phase_cpu_check(run)
    phase_stages(dev, run["table_full"])
    sources = {"assign": "src/repro/kernels/assign.py:21",
               "bubble_cd": "src/repro/kernels/bubble_cd.py:41",
               "mutual_reach": "src/repro/kernels/mutual_reach.py:23"}
    kernels = [
        dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
             replaces=sources[name], launches=run["launches"][name], **numbers[name])
        for name in ("assign", "bubble_cd", "mutual_reach")
    ]
    say(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
