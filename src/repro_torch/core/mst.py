"""Borůvka MST over the dense (n, n) mutual-reachability matrix, or over
the grid (``spatial_index=True``).

The PyTorch counterpart of the JAX package's ``core/mst.py::boruvka_jax``,
``boruvka_grid_jax`` and ``_boruvka_round_tail``: the offline pass's L×L
bubble W (or the Morton grid and the core distances) in, fixed ``(n,)``
edge buffers out.  Union-find is label propagation by pointer
jumping; each round every component picks its lightest outgoing edge by
the composite key (w, canonical edge id), with ``eid = min·n + max`` in
int32 so the hook graph has only mirrored 2-cycles even with tied weights.
Component minima are ``scatter_reduce`` "amin" (order-independent, so the
buffers do not depend on the device's reduction order).  A fixed round
count runs with no host sync inside; rounds that finish early append
nothing.

``boruvka_grid`` finds each round's row minima by the grid's tile search
(``kernels/grid.py::grid_round_minima``, a CUDA kernel on the card) and
never builds W; the rest of the round is the dense tail verbatim, so the
buffers are bitwise those of ``boruvka`` on the W of the same core
distances (pad rows at +inf).

``boruvka_shard`` and ``boruvka_grid_shard`` are the counterparts of
``boruvka_shard_jax`` and ``boruvka_grid_shard_jax`` for the sharded
offline pass (``mesh=``, DESIGN.md §12): each round every shard reduces
its own row strip (or query-block range) on its own device, the minima
are gathered on the lead device in row order, and the same round tail
runs there, so the buffers are bit for bit the unsharded ones on any
mesh.  ``boruvka`` and ``boruvka_grid`` are their one-shard case.

The exact-dynamic engine (core/dynamic_torch.py) adds two forests over
explicit candidates, the counterparts of ``boruvka_edges_jax`` and
``boruvka_strip_jax``: ``boruvka_edges`` over a padded edge list, and
``boruvka_strip`` over an edge list plus dense (U, n) row strips, whose
per-round strip minima come from ``kernels/dynamic.py::strip_round_minima``
(a CUDA kernel on the card).  ``boruvka_strip_from_dists`` is the same
forest from the strip's factors (distances, core distances, row and column
masks): its minima come from ``strip_round_minima_from_dists``, which forms
the weights and the mask in the kernel, so no (U, n) weight strip or mask
is built; the update takes this route, and the first stays as the JAX
parity form and the kernel's oracle.  Both run the reference's fixed round
count with its (w, pair id, index or payload) tie rules and no host read.

The host engines are the port's own copies of the JAX package's numpy
ones, bit for bit: ``UnionFind``, ``kruskal_edges`` (Kruskal over an
explicit edge list, the reduction rule Eq. 11) and ``boruvka_dense``
(vectorized Borůvka over a dense f64 matrix, from a partial forest for the
contraction rule Eq. 12).  The host HDBSCAN (core/hdbscan.py) and the
host exact-dynamic oracle (core/dynamic.py) run on them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import dynamic as _dyn_k
from ..kernels import grid as _grid_k
from ..launch.mesh import Mesh, gather, shard_ranges

__all__ = ["UnionFind", "kruskal_edges", "boruvka_dense", "boruvka", "boruvka_shard", "boruvka_grid",
           "boruvka_grid_shard", "boruvka_edges", "boruvka_strip", "boruvka_strip_from_dists", "mst_total_weight"]

_BIGID = np.iinfo(np.int32).max


class UnionFind:
    """Array-based union-find with path halving + union by size."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)
        self.n_components = n

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]  # path halving
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        self.n_components -= 1
        return True

    def labels(self) -> np.ndarray:
        """Root label for every element (fully compressed)."""
        p = self.parent
        # iterate to convergence (log-depth after halving)
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parent = p
        return p.copy()


def kruskal_edges(u, v, w, n, uf: UnionFind | None = None):
    """MST (or forest completion) over an explicit edge list.

    Args:
      u, v: (E,) int endpoints.
      w: (E,) float weights.
      n: number of nodes.
      uf: optionally a pre-seeded union-find (nodes already merged by a
        partial forest — the contraction rule).  Mutated in place.

    Returns:
      (mu, mv, mw): MST edge arrays, in ascending weight order.
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    order = np.argsort(w, kind="stable")
    if uf is None:
        uf = UnionFind(n)
    mu, mv, mw = [], [], []
    for i in order:
        a, b = int(u[i]), int(v[i])
        if a == b:
            continue
        if uf.union(a, b):
            mu.append(a)
            mv.append(b)
            mw.append(float(w[i]))
            if uf.n_components == 1:
                break
    return (
        np.asarray(mu, dtype=np.int64),
        np.asarray(mv, dtype=np.int64),
        np.asarray(mw, dtype=np.float64),
    )


def _component_min_outgoing(W: np.ndarray, labels: np.ndarray):
    """For every component, the lightest edge leaving it (dense W).

    Returns (src, dst, wt) arrays with one candidate per component.
    Vectorized: mask same-component entries to +inf, row-argmin, then a
    segmented min over rows by component label.
    """
    n = W.shape[0]
    masked = np.where(labels[:, None] == labels[None, :], np.inf, W)
    np.fill_diagonal(masked, np.inf)
    row_min_j = np.argmin(masked, axis=1)
    row_min_w = masked[np.arange(n), row_min_j]
    # segmented min over component labels
    uniq, inv = np.unique(labels, return_inverse=True)
    best = np.full(uniq.shape[0], np.inf)
    np.minimum.at(best, inv, row_min_w)
    # pick one row achieving the per-component min
    src = np.full(uniq.shape[0], -1, dtype=np.int64)
    hit = row_min_w == best[inv]
    # last writer wins; any row achieving the min is a valid Borůvka choice
    src[inv[hit]] = np.nonzero(hit)[0]
    ok = (src >= 0) & np.isfinite(best)
    src = src[ok]
    return src, row_min_j[src], row_min_w[src]


def boruvka_dense(W: np.ndarray, forest=None, uf: UnionFind | None = None):
    """Vectorized Borůvka MST over a dense symmetric weight matrix.

    Args:
      W: (n, n) float weights (np.inf on unusable entries is allowed).
      forest: optional (u, v, w) arrays of an existing partial forest whose
        edges are kept (contraction rule, Eq. 12).
      uf: optional union-find pre-seeded consistently with `forest`.

    Returns: (u, v, w) of the completed spanning forest edges *added or
      kept*, i.e. the full MST edge set including the seed forest.
    """
    n = W.shape[0]
    if uf is None:
        uf = UnionFind(n)
    eu, ev, ew = [], [], []
    if forest is not None:
        fu, fv, fw = forest
        for a, b, c in zip(fu, fv, fw):
            uf.union(int(a), int(b))
            eu.append(int(a))
            ev.append(int(b))
            ew.append(float(c))
    while uf.n_components > 1:
        labels = uf.labels()
        src, dst, wt = _component_min_outgoing(W, labels)
        if src.size == 0:
            break  # disconnected graph (inf-masked): return spanning forest
        merged_any = False
        order = np.argsort(wt, kind="stable")
        for i in order:
            a, b = int(src[i]), int(dst[i])
            if uf.union(a, b):
                eu.append(a)
                ev.append(b)
                ew.append(float(wt[i]))
                merged_any = True
        if not merged_any:
            break
    return (
        np.asarray(eu, dtype=np.int64),
        np.asarray(ev, dtype=np.int64),
        np.asarray(ew, dtype=np.float64),
    )


def mst_total_weight(w) -> float:
    return float(np.sum(np.asarray(w, dtype=np.float64)))


def _segment_min(labels: torch.Tensor, values: torch.Tensor, init) -> torch.Tensor:
    out = torch.full_like(values, init)
    return out.scatter_reduce_(0, labels, values, reduce="amin", include_self=True)


def _hook_and_append(labels, comp_key, has, tgt, n_edges, n: int, jumps: int, valid, *writes):
    """The back half of every round: hook each component that has an edge
    on its target ``tgt`` (a mirrored 2-cycle, both components choosing the
    same ``comp_key``, roots at the lower label), jump pointers, and append
    the kept edges at cumsum slots (rejects land in the trash slot ``n``):
    ``valid`` gets the keep mask and each ``(buffer, values)`` of
    ``writes`` its values.  Returns the new labels and edge count."""
    iota = torch.arange(n, device=labels.device)
    mirror = has & (comp_key[tgt] == comp_key)
    keep = has & ~(mirror & (iota > tgt))
    parent = torch.where(has, tgt, iota)
    parent = torch.where(mirror & (iota < tgt), iota, parent)
    for _ in range(jumps):
        parent = parent[parent]
    slot = n_edges + torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep, torch.clamp_max(slot, n - 1), n)
    for buf, val in writes:
        buf[slot] = val
    valid[slot] = keep
    return parent[labels], n_edges + keep.sum()


def _boruvka_round_tail(labels, row_w, row_eid, row_j, row_has,
                        eu, ev, ew, valid, n_edges, n: int, jumps: int):
    """Per-component (w, eid) minimum of the rows' choices, then
    ``_hook_and_append``.  ``labels`` and ``row_j`` are int64, ``row_eid``
    int64; returns the updated (labels, eu, ev, ew, valid, n_edges)."""
    dev = row_w.device
    iota = torch.arange(n, device=dev)
    comp_w = _segment_min(labels, row_w, float("inf"))
    w_hit = row_has & (row_w == comp_w[labels])
    comp_eid = _segment_min(labels, torch.where(w_hit, row_eid, _BIGID), _BIGID)
    full_hit = w_hit & (row_eid == comp_eid[labels])
    comp_row = _segment_min(labels, torch.where(full_hit, iota, n), n)
    has_edge = comp_row < n
    safe_row = torch.clamp_max(comp_row, n - 1)
    comp_v = row_j[safe_row]
    labels, n_edges = _hook_and_append(labels, comp_eid, has_edge, labels[comp_v], n_edges, n, jumps, valid,
                                       (eu, safe_row.int()), (ev, comp_v.int()), (ew, row_w[safe_row]))
    return labels, eu, ev, ew, valid, n_edges


def _rounds(n: int) -> tuple[int, int]:
    """(Borůvka rounds, pointer jumps per round) for n rows."""
    if n * n >= _BIGID:
        raise ValueError("boruvka supports n <= 46340 (int32 edge ids)")
    steps = math.ceil(math.log2(max(n, 2))) + 1
    return max(1, steps - 1) + 1, steps


def _buffers(n: int, dev, dtype):
    return (torch.zeros(n + 1, dtype=torch.int32, device=dev), torch.zeros(n + 1, dtype=torch.int32, device=dev),
            torch.zeros(n + 1, dtype=dtype, device=dev), torch.zeros(n + 1, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _strip_eid(row0: int, m: int, n: int, dev) -> torch.Tensor:
    """(m, n) int32 canonical edge ids ``min·n + max`` of rows row0 .. row0 + m."""
    rows = torch.arange(row0, row0 + m, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    return torch.minimum(rows, cols) * n + torch.maximum(rows, cols)


def _strip_minima(W: torch.Tensor, eid: torch.Tensor, labels: torch.Tensor, row0: int):
    """The (w, eid) minima of a strip holding rows ``row0 ..`` of the
    weight matrix, over columns of another component (each row's own entry,
    at column ``row0 + r``, excluded): a row's minimum reads only that row,
    so a strip's are bit for bit the same rows' of the whole matrix."""
    inf = float("inf")
    same = labels[row0 : row0 + W.shape[0], None] == labels[None, :]
    same.diagonal(row0).fill_(True)
    masked = torch.where(same, inf, W)
    del same
    row_w = masked.amin(dim=1)
    at_min = masked == row_w[:, None]
    del masked
    return row_w, torch.where(at_min, eid, _BIGID).amin(dim=1)


def boruvka(W: torch.Tensor):
    """Borůvka MST of a dense symmetric (n, n) weight matrix (+inf entries
    allowed) on W's device.  Returns ``(eu, ev, ew, valid)``: (n,) int32,
    int32, W-dtype and bool buffers, ``valid`` marking the written edges.
    With duplicate weights the (w, eid) key makes every choice
    deterministic (lowest canonical edge id)."""
    return boruvka_shard([W], [0], W.shape[0])


def boruvka_shard(strips, row0s, n: int, mesh=None):
    """``boruvka`` over a row-sharded weight matrix: ``strips[i]`` holds rows
    ``row0s[i] ..`` (all n columns) on shard i's device, the strips in row
    order covering [0, n).  Each round copies the labels to each shard, each
    shard reduces its strip's (w, eid) row minima with global rows, the
    minima are gathered on the lead device (``mesh.lead``, else the first
    strip's) in row order, and the round tail runs there, unchanged.  The
    buffers are bit for bit ``boruvka`` of the whole matrix on any mesh, on
    the lead device."""
    max_rounds, jumps = _rounds(n)  # before the eid strips: it enforces n <= 46,340
    dev = mesh.lead if mesh is not None else strips[0].device
    eids = [_strip_eid(r0, W.shape[0], n, W.device) for W, r0 in zip(strips, row0s)]
    iota = torch.arange(n, device=dev)
    labels = iota.clone()
    eu, ev, ew, valid, n_edges = _buffers(n, dev, strips[0].dtype)
    for _ in range(max_rounds):
        parts = [_strip_minima(W, eid, labels.to(W.device, non_blocking=True), r0)
                 for W, eid, r0 in zip(strips, eids, row0s)]
        row_w = gather([w for w, _ in parts], dev)
        row_eid = gather([e for _, e in parts], dev).long()
        del parts
        # the column holding the row's chosen canonical edge
        lo, hi = row_eid // n, row_eid % n
        row_j = torch.where(lo == iota, hi, lo)
        labels, eu, ev, ew, valid, n_edges = _boruvka_round_tail(
            labels, row_w, row_eid, row_j, torch.isfinite(row_w), eu, ev, ew, valid, n_edges, n, jumps)
    return eu[:-1], ev[:-1], ew[:-1], valid[:-1]


def boruvka_grid(grid, cd: torch.Tensor, views=None):
    """Borůvka MST of the grid's valid rows under Eq. 7 weights
    ``max(d, cd_r, cd_c)`` (``cd`` (n,) in ORIGINAL row order), with no
    (n, n) matrix: each round's row minima come from
    ``grid_round_minima`` over the block visit lists ``views`` (computed
    once, ``grid._block_views`` by default).  A row whose component already
    holds every valid row is hopeless and skips its search.  Fixed round
    count, no host read.  Returns the ``boruvka`` buffers."""
    return boruvka_grid_shard(grid, cd, views, Mesh((grid.pts.device,)))


def boruvka_grid_shard(grid, cd: torch.Tensor, views, mesh):
    """``boruvka_grid`` with each round's search split over ``mesh``: shard
    i searches its contiguous range of ⌈NB/k⌉ query blocks (the last ranges
    shorter or empty) on its own device with the round's labels and
    hopeless mask copied there, the ranges' sorted-order minima are
    gathered on the lead device (the grid's) in block order, scattered back
    to original order, and the round tail runs there: bit for bit
    ``boruvka_grid`` on any mesh."""
    n = grid.pts.shape[0]
    max_rounds, jumps = _rounds(n)
    dev = grid.pts.device
    views = _grid_k._block_views(grid) if views is None else views
    shards = list(zip(_grid_k._replicas(grid, views, mesh), mesh.devices,
                      shard_ranges(views.order.shape[0], len(mesh.devices))))
    cds = {d: cd.to(d, non_blocking=True) for d in mesh.devices}
    iota = torch.arange(n, device=dev)
    valid_orig = torch.zeros(n, dtype=torch.int64, device=dev)
    valid_orig[grid.orig.long()] = grid.valid.long()
    total_valid = grid.n_valid.long()
    labels = iota.clone()
    eu, ev, ew, valid, n_edges = _buffers(n, dev, torch.float32)
    for _ in range(max_rounds):
        cnt = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(0, labels, valid_orig)
        hopeless = cnt[labels] >= total_valid
        parts = [_grid_k.grid_round_minima(g, v, cds[d], labels.to(d, non_blocking=True),
                                           hopeless.to(d, non_blocking=True), blocks=blocks)
                 for (g, v), d, blocks in shards]
        row_w, row_eid = _grid_k._scatter(grid, gather([w for w, _ in parts], dev),
                                          gather([e for _, e in parts], dev))
        row_eid = row_eid.long()
        lo = row_eid // n
        # the column of the chosen canonical edge; rows with no edge are
        # gated by row_has in the tail, the clamp keeps their gathers in range
        row_j = torch.clamp(torch.where(lo == iota, row_eid - lo * n, lo), 0, n - 1)
        labels, eu, ev, ew, valid, n_edges = _boruvka_round_tail(
            labels, row_w, row_eid, row_j, torch.isfinite(row_w), eu, ev, ew, valid, n_edges, n, jumps)
    return eu[:-1], ev[:-1], ew[:-1], valid[:-1]


def _segment_min_of(n: int, init, dtype, device, pairs) -> torch.Tensor:
    """(n,) ``init`` lowered by ``scatter_reduce("amin")`` of each
    ``(index, values)`` pair in turn (order-independent)."""
    out = torch.full((n,), init, dtype=dtype, device=device)
    for idx, val in pairs:
        out = out.scatter_reduce(0, idx, val, "amin")
    return out


def boruvka_edges(eu, ev, ew, valid, n: int):
    """Borůvka minimum spanning forest over an explicit padded edge list:
    ``boruvka_edges_jax``.  (E,) ends, weights and validity; every node of
    ``[0, n)`` starts as a singleton.  Ties break on the edge index.
    Returns ``(sel_idx, sel_valid, labels)``: (n,) int64 indices of the
    chosen edges, (n,) bool, and the (n,) int64 final labels."""
    dev = ew.device
    E = eu.shape[0]
    rounds, jumps = _rounds(n)
    inf = float("inf")
    iota = torch.arange(n, device=dev)
    idx_e = torch.arange(E, device=dev)
    eu, ev = eu.long(), ev.long()
    valid = valid.bool()
    lab = iota.clone()
    out_idx = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    out_ok = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    n_edges = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(rounds):
        lu, lv = lab[eu], lab[ev]
        active = valid & (lu != lv)
        w_act = torch.where(active, ew, inf)
        comp_w = _segment_min_of(n, inf, ew.dtype, dev, ((lu, w_act), (lv, w_act)))
        hit_u = active & (ew == comp_w[lu])
        hit_v = active & (ew == comp_w[lv])
        comp_e = _segment_min_of(n, _BIGID, torch.int64, dev, (
            (lu, torch.where(hit_u, idx_e, _BIGID)), (lv, torch.where(hit_v, idx_e, _BIGID))))
        has = comp_e < _BIGID
        e = torch.clamp_max(comp_e, max(E - 1, 0))
        a, b = lab[eu[e]], lab[ev[e]]
        tgt = torch.where(a == iota, b, a)
        lab, n_edges = _hook_and_append(lab, comp_e, has, tgt, n_edges, n, jumps, out_ok, (out_idx, e))
    return out_idx[:-1], out_ok[:-1], lab


def boruvka_strip(eu, ev, ew, evalid, sids, SW, smask, n: int):
    """Borůvka MSF over an explicit edge list PLUS dense row strips:
    ``boruvka_strip_jax``.  (E,) edges (masked slots inert); ``sids`` (U,)
    the node of each strip row, ``SW`` (U, n) its weights to every node,
    ``smask`` (U, n) the usable entries.  Each round, the strip's per-row
    and per-column lexicographic (w, pair id, payload) minima come from
    ``strip_round_minima`` (a CUDA kernel on the card); the component
    minima over the edge list and those minima, the hook, the pointer
    jumping and the append are torch operations.  A row's (column's) pair
    id counts only where its weight is its component's minimum, its
    payload only where its pair id is too, which is the reference's three
    passes.  Returns ``(pay, pay_valid, labels)``: (n,) int64 payloads
    (``< E`` an edge index, else ``E + row·n + col``), (n,) bool, (n,)
    int64 labels."""
    E = eu.shape[0]
    return _boruvka_strip(eu, ev, ew, evalid, sids, SW.shape[0], n, SW.device, SW.dtype,
                          lambda lab: _dyn_k.strip_round_minima(SW, smask, sids, lab, E))


def boruvka_strip_from_dists(eu, ev, ew, evalid, sids, D, cd, row_valid, alive, n: int):
    """``boruvka_strip`` on ``SW = max(max(D, cd[sids][:, None]), cd[None,
    :])`` and ``smask = row_valid[:, None] & alive[None, :] & (col !=
    sids[:, None])`` without building either: each round's strip minima
    come from ``strip_round_minima_from_dists`` (a CUDA kernel on the card)
    over the factors.  ``D`` (U, n) f32 distances, ``cd`` (n,), ``row_valid``
    (U,), ``alive`` (n,).  The same buffers as ``boruvka_strip`` on that SW
    and smask, bit for bit."""
    E = eu.shape[0]
    sids32 = sids.to(torch.int32)
    return _boruvka_strip(eu, ev, ew, evalid, sids, D.shape[0], n, D.device, torch.float32,
                          lambda lab: _dyn_k.strip_round_minima_from_dists(D, cd, sids32, row_valid, alive, lab, E))


def _boruvka_strip(eu, ev, ew, evalid, sids, U: int, n: int, dev, wdtype, minima):
    """The rounds of ``boruvka_strip``; ``minima(lab)`` gives a round's strip
    minima (row_w, row_eid, row_pay, col_w, col_eid, col_pay)."""
    E = eu.shape[0]
    rounds, jumps = _rounds(n)
    inf = float("inf")
    iota = torch.arange(n, device=dev)
    eu, ev = eu.long(), ev.long()
    sids = sids.long()
    evalid = evalid.bool()
    eid_tree = torch.minimum(eu, ev) * n + torch.maximum(eu, ev)
    pay_tree = torch.arange(E, device=dev)
    lab = iota.clone()
    out_pay = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    out_ok = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    n_edges = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(rounds):
        lu, lv = lab[eu], lab[ev]
        eact = evalid & (lu != lv)
        ewa = torch.where(eact, ew, inf)
        slab = lab[sids]
        rw, re, rp, cw, ce, cp = minima(lab)
        comp_w = _segment_min_of(n, inf, wdtype, dev, ((lu, ewa), (lv, ewa), (slab, rw), (lab, cw)))
        e_hit_u = eact & (ew == comp_w[lu])
        e_hit_v = eact & (ew == comp_w[lv])
        r_hit = rw == comp_w[slab]
        c_hit = cw == comp_w[lab]
        comp_eid = _segment_min_of(n, _BIGID, torch.int64, dev, (
            (lu, torch.where(e_hit_u, eid_tree, _BIGID)), (lv, torch.where(e_hit_v, eid_tree, _BIGID)),
            (slab, torch.where(r_hit, re, _BIGID)), (lab, torch.where(c_hit, ce, _BIGID))))
        comp_pay = _segment_min_of(n, _BIGID, torch.int64, dev, (
            (lu, torch.where(e_hit_u & (eid_tree == comp_eid[lu]), pay_tree, _BIGID)),
            (lv, torch.where(e_hit_v & (eid_tree == comp_eid[lv]), pay_tree, _BIGID)),
            (slab, torch.where(r_hit & (re == comp_eid[slab]), rp, _BIGID)),
            (lab, torch.where(c_hit & (ce == comp_eid[lab]), cp, _BIGID))))
        has = comp_eid < _BIGID
        pay = torch.clamp_max(comp_pay, E + U * n - 1)
        is_strip = pay >= E
        t_idx = torch.clamp_max(pay, max(E - 1, 0))
        s_flat = torch.clamp_min(pay - E, 0)
        pu = torch.where(is_strip, sids[torch.div(s_flat, n, rounding_mode="floor")], eu[t_idx])
        pv = torch.where(is_strip, s_flat % n, ev[t_idx])
        a, b = lab[pu], lab[pv]
        tgt = torch.where(a == iota, b, a)
        lab, n_edges = _hook_and_append(lab, comp_eid, has, tgt, n_edges, n, jumps, out_ok, (out_pay, pay))
    return out_pay[:-1], out_ok[:-1], lab
