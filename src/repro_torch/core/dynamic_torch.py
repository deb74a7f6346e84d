"""Exact dynamic HDBSCAN on the device — the paper's update rules (§3,
Algorithms 5 and 6, Eqs. 11–12) batched over padded capacity buckets.

The PyTorch counterpart of the JAX package's ``core/dynamic_jax.py``,
under the same names and with the same state, rules and tie orders:

  insert block (Eq. 11):  T' = MSF(T ∪ (P ∪ M)×V) — the old tree plus every
      edge of the new points P and of the rows M whose kNN horizon a new
      point entered, as a (|P| + |M|, Np) distance strip through
      ``core/mst.py::boruvka_strip_from_dists`` (the strip's weights and
      mask are formed in the kernel, never stored);
  delete block (Eq. 12):  the survivor forest kept outright, completed by a
      dense Borůvka over the ≤ s_cap + 1 contracted components;
  kNN / core distances:   the touched rows' tables recomputed exactly from
      gathered strips.

The strip work runs in the CUDA kernels of ``kernels/dynamic.py`` on the
card (plain versions on the CPU): ``strip_dists`` for every distance strip
and the rebuild's (Np, Np) matrix, ``strip_topk`` for the four kNN
rebuilds, ``strip_round_minima_from_dists`` inside
``boruvka_strip_from_dists``.  Distances are
the DIFF form, never the expansion: the state holds uncentred coordinates
and every stored raw length is reproducible bit for bit from them.

An update body reads nothing of the device: ``jnp.nonzero(size=…)``
becomes a cumsum-rank scatter into a buffer with a trash slot, and the
fixed-shape buckets make every overflow a flipped ``ok`` bit.  The handle
``DynamicTorchHDBSCAN`` reads ``ok`` (with ``n_alive``) once per block,
as the reference's does, and rebuilds when an update overflowed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import dynamic as _dyn_k
from .mst import boruvka, boruvka_edges, boruvka_strip_from_dists

__all__ = [
    "DynState",
    "DynamicTorchHDBSCAN",
    "init_state",
    "insert_batch",
    "delete_batch",
    "rebuild",
    "state_mst_weights",
    "state_mutual_reach_dense",
]

_BIG = np.iinfo(np.int32).max
_INF = float("inf")


class DynState(NamedTuple):
    """Padded dynamic-maintenance state over Np capacity slots (the
    reference's eleven fields and dtypes).  ``alive`` masks the live slots;
    the MST is held as raw Euclidean lengths and the mutual-reachability
    weights are derived on demand as max(raw, cd[u], cd[v])."""

    X: torch.Tensor  # (Np, d) f32 coordinates (dead slots: stale/zero)
    alive: torch.Tensor  # (Np,) bool
    knn_idx: torch.Tensor  # (Np, K) int32 — K = minPts nearest OTHER points
    knn_dst: torch.Tensor  # (Np, K) f32 ascending (+inf empty)
    cd: torch.Tensor  # (Np,) f32 core distances (Def. 1, self-inclusive)
    mst_u: torch.Tensor  # (Np,) int32 slot ids
    mst_v: torch.Tensor  # (Np,) int32
    mst_raw: torch.Tensor  # (Np,) f32 raw Euclidean edge lengths
    mst_valid: torch.Tensor  # (Np,) bool — exactly n_alive - 1 True slots
    n_alive: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool — False: an update overflowed rk_cap/s_cap


def init_state(capacity: int, dim: int, min_pts: int, device=None) -> DynState:
    dev = resolve_device(device)
    Np, K = int(capacity), int(min_pts)
    return DynState(
        X=torch.zeros((Np, dim), dtype=torch.float32, device=dev),
        alive=torch.zeros(Np, dtype=torch.bool, device=dev),
        knn_idx=torch.full((Np, K), -1, dtype=torch.int32, device=dev),
        knn_dst=torch.full((Np, K), _INF, dtype=torch.float32, device=dev),
        cd=torch.zeros(Np, dtype=torch.float32, device=dev),
        mst_u=torch.zeros(Np, dtype=torch.int32, device=dev),
        mst_v=torch.zeros(Np, dtype=torch.int32, device=dev),
        mst_raw=torch.zeros(Np, dtype=torch.float32, device=dev),
        mst_valid=torch.zeros(Np, dtype=torch.bool, device=dev),
        n_alive=torch.zeros((), dtype=torch.int32, device=dev),
        ok=torch.ones((), dtype=torch.bool, device=dev),
    )


def _cd_from_rows(knn_dst: torch.Tensor, min_pts: int) -> torch.Tensor:
    """Self-inclusive cd per row: the (minPts−1)-th other distance, or the
    largest finite entry when fewer others exist."""
    k = min_pts - 1
    if k <= 0:
        return torch.zeros(knn_dst.shape[0], dtype=torch.float32, device=knn_dst.device)
    kth = knn_dst[:, k - 1]
    fallback = torch.where(torch.isfinite(knn_dst), knn_dst, 0.0).amax(1)
    return torch.where(torch.isfinite(kth), kth, fallback)


def _dense_dists(X: torch.Tensor) -> torch.Tensor:
    """(Np, Np) diff-form distances: the strip of every slot against every
    slot, in the arithmetic of every other strip, so a rebuild's weights
    are bitwise what an incremental step derives for the same pair."""
    Np = X.shape[0]
    return _dyn_k.strip_dists(X, X, out=torch.empty((Np, Np), dtype=torch.float32, device=X.device))


def _strip_dists(rows: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(U, Np) diff-form distances from gathered rows to every slot."""
    return _dyn_k.strip_dists(rows, X, out=out)


def _scatter_rows(A: torch.Tensor, tgt: torch.Tensor, rows_new: torch.Tensor) -> torch.Tensor:
    """Write rows_new at row indices tgt; index len(A) is the trash row
    (only trash indices repeat, so any one writer is right)."""
    pad = torch.zeros((1,) + tuple(A.shape[1:]), dtype=A.dtype, device=A.device)
    out = torch.cat([A, pad])
    out[tgt.long()] = rows_new.to(A.dtype)
    return out[: A.shape[0]]


def _first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=0)`` with no host read: the
    first ``size`` True positions by cumsum rank, scattered into a
    ``(size + 1,)`` buffer whose slot ``size`` is the trash; 0 past them."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.long(), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out[tgt] = torch.arange(n, device=mask.device)
    return out[:size]


def _put(n: int, dtype, device, *writes) -> torch.Tensor:
    """(n,) zeros with each ``(idx, value)`` of ``writes`` written in turn
    (index n is the trash, the only index that repeats)."""
    out = torch.zeros(n + 1, dtype=dtype, device=device)
    for idx, value in writes:
        if torch.is_tensor(value):
            out[idx.long()] = value.to(dtype)
        else:  # a Python scalar: index_fill_ needs no host-to-device copy of it
            out.index_fill_(0, idx.long(), value)
    return out[:n]


def insert_batch(state: DynState, P, slots, valid, *, min_pts: int, rk_cap: int) -> DynState:
    """Apply a padded block of insertions as ONE update (Eq. 11, batched).

    P: (Bp, d) f32; slots: (Bp,) pre-assigned free slots (host free list);
    valid: (Bp,) bool — padding rows are exact no-ops.  Pure insertions
    only shrink core distances, so MST(final) ⊆ T ∪ (P ∪ M)×V with M every
    old row a new point entered the kNN horizon of (strict <)."""
    dev = state.X.device
    P = P.to(dev, torch.float32)
    slots = slots.to(dev).long()
    valid = valid.to(dev).bool()
    Np, K = state.knn_idx.shape
    Bp = P.shape[0]
    tgt = torch.where(valid, slots, Np)  # trash-slot scatter for pad rows

    alive_old = state.alive
    X2 = _scatter_rows(state.X, tgt, P)
    alive2 = _scatter_rows(alive_old, tgt, torch.ones(Bp, dtype=torch.bool, device=dev))

    # the new rows' distances vs the FINAL population, and the RkNN rows'
    # below them in one strip (new points see each other)
    D_strip = torch.empty((Bp + rk_cap, Np), dtype=torch.float32, device=dev)
    D_new = _strip_dists(P, X2, out=D_strip[:Bp])
    nd, ni = _dyn_k.strip_topk(D_new, slots, valid, alive2, K)
    knn_dst = _scatter_rows(state.knn_dst, tgt, nd)
    knn_idx = _scatter_rows(state.knn_idx, tgt, ni)
    cd = _scatter_rows(state.cd[:, None], tgt, _cd_from_rows(nd, min_pts)[:, None])[:, 0]

    # M: old rows with a new point strictly inside their kNN horizon
    horizon = state.knn_dst[:, K - 1]
    dmin = torch.where(valid[:, None], D_new, _INF).amin(0)
    M = alive_old & (dmin < horizon)
    rk_n = M.sum()
    ok = state.ok & (rk_n <= rk_cap)
    rids = _first_true(M, rk_cap)
    rvalid = torch.arange(rk_cap, device=dev) < rk_n
    D_M = _strip_dists(X2[rids], X2, out=D_strip[Bp:])
    md, mi = _dyn_k.strip_topk(D_M, rids, rvalid, alive2, K)
    rtgt = torch.where(rvalid, rids, Np)
    knn_dst = _scatter_rows(knn_dst, rtgt, md)
    knn_idx = _scatter_rows(knn_idx, rtgt, mi)
    cd = _scatter_rows(cd[:, None], rtgt, _cd_from_rows(md, min_pts)[:, None])[:, 0]

    # --- Eq. 11 (batched): MSF over T ∪ (P ∪ M)×V ---
    ew_tree = torch.where(state.mst_valid, state_mst_weights(state._replace(cd=cd)), _INF)
    sids = torch.cat([torch.clamp_max(slots, Np - 1), rids])
    pay, pay_ok, _ = boruvka_strip_from_dists(state.mst_u, state.mst_v, ew_tree, state.mst_valid, sids, D_strip, cd,
                                              torch.cat([valid, rvalid]), alive2, Np)
    E = Np
    is_strip = pay >= E
    t_idx = torch.clamp_max(pay, E - 1)
    s_flat = torch.clamp_min(pay - E, 0)
    mu = torch.where(is_strip, sids[torch.div(s_flat, Np, rounding_mode="floor")], state.mst_u[t_idx].long())
    mv = torch.where(is_strip, s_flat % Np, state.mst_v[t_idx].long())
    s_flat = torch.clamp_max(s_flat, (Bp + rk_cap) * Np - 1)
    mraw = torch.where(is_strip, D_strip.reshape(-1)[s_flat], state.mst_raw[t_idx])
    return state._replace(
        X=X2,
        alive=alive2,
        knn_idx=knn_idx,
        knn_dst=knn_dst,
        cd=cd,
        mst_u=torch.where(pay_ok, mu, 0).to(torch.int32),
        mst_v=torch.where(pay_ok, mv, 0).to(torch.int32),
        mst_raw=torch.where(pay_ok, mraw, 0.0),
        mst_valid=pay_ok,
        n_alive=(state.n_alive + valid.sum()).to(torch.int32),
        ok=ok,
    )


def delete_batch(state: DynState, slots, valid, *, min_pts: int, rk_cap: int, s_cap: int) -> DynState:
    """Apply a padded block of deletions as ONE update (Eq. 12, batched):
    the survivor forest kept outright (deletions only raise core
    distances), completed over the contracted component graph."""
    dev = state.X.device
    slots = slots.to(dev).long()
    valid = valid.to(dev).bool()
    Np, K = state.knn_idx.shape
    iota = torch.arange(Np, device=dev)
    tgt = torch.where(valid, slots, Np)
    del_flag = _put(Np, torch.bool, dev, (tgt, True))
    alive = state.alive & ~del_flag
    n_del = (valid & state.alive[torch.clamp_max(slots, Np - 1)]).sum()

    # RkNN: alive rows listing any retired slot — recomputed from a strip
    knn_idx_l = state.knn_idx.long()
    lists = alive & (del_flag[torch.clamp(knn_idx_l, 0, Np - 1)] & (knn_idx_l >= 0)).any(1)
    rk_n = lists.sum()
    ok = state.ok & (rk_n <= rk_cap)
    rids = _first_true(lists, rk_cap)
    rvalid = torch.arange(rk_cap, device=dev) < rk_n
    D = _strip_dists(state.X[rids], state.X)
    nd, ni = _dyn_k.strip_topk(D, rids, rvalid, alive, K)
    del D
    rtgt = torch.where(rvalid, rids, Np)
    knn_dst = _scatter_rows(state.knn_dst, rtgt, nd).masked_fill_(del_flag[:, None], _INF)
    knn_idx = _scatter_rows(state.knn_idx, rtgt, ni).masked_fill_(del_flag[:, None], -1)
    cd = torch.where(lists, _cd_from_rows(knn_dst, min_pts), state.cd).masked_fill_(del_flag, 0.0)

    # --- Eq. 12 (batched): survivor forest + contracted completion ---
    touched = lists | del_flag
    mu_l, mv_l = state.mst_u.long(), state.mst_v.long()
    keep = state.mst_valid & ~(touched[mu_l] | touched[mv_l])
    _, _, labels_f = boruvka_edges(mu_l, mv_l, torch.where(keep, 0.0, _INF), keep, Np)
    # compact component ids over ALIVE nodes (dead singletons excluded)
    present = _put(Np, torch.int64, dev, (torch.where(alive, labels_f, Np), 1))
    crank = torch.cumsum(present, 0) - 1
    Kc = s_cap + 1  # ≤ s_cap non-largest comps + the largest (else ok=False)
    cid = torch.where(alive, crank[labels_f], Kc)  # dead → dropped on scatter
    cnt = torch.zeros(Kc + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp_max(cid, Kc), alive.long())[:Kc]
    biggest = torch.argmax(cnt)
    s_mask = alive & (cid != biggest)
    s_n = s_mask.sum()
    ok = ok & (s_n <= s_cap) & (present.sum() <= Kc)
    sids = _first_true(s_mask, s_cap)
    svalid = torch.arange(s_cap, device=dev) < s_n
    DS = _strip_dists(state.X[sids], state.X)
    WS = torch.maximum(DS, cd[sids][:, None])
    WS = torch.maximum(WS, cd[None, :], out=WS)
    rowc = cid[sids]
    # (a) S'-component → largest: a dense masked min per strip row
    to_big = svalid[:, None] & alive[None, :] & (cid[None, :] == biggest)
    w_big = torch.where(to_big, WS, _INF)
    del to_big
    row_min = w_big.amin(1)
    row_arg = torch.argmin(w_big, 1)
    del w_big
    rowc_t = torch.clamp_max(rowc, Kc)
    comp_big_w = torch.full((Kc + 1,), _INF, device=dev).scatter_reduce(
        0, rowc_t, torch.where(svalid, row_min, _INF), "amin")[:Kc]
    hit_r = svalid & (row_min == comp_big_w[torch.clamp_max(rowc, Kc - 1)])
    comp_big_row = torch.full((Kc + 1,), _BIG, dtype=torch.int64, device=dev).scatter_reduce(
        0, rowc_t, torch.where(hit_r, torch.arange(s_cap, device=dev), _BIG), "amin")[:Kc]
    safe_row = torch.clamp_max(comp_big_row, s_cap - 1)
    comp_big_flat = safe_row * Np + row_arg[safe_row]
    # (b) the S'×S' block (columns gathered at the S' ids)
    WSS = WS[:, sids]
    del WS
    rc = torch.clamp_max(rowc, Kc - 1)  # equal to rowc wherever ok holds
    cross = svalid[:, None] & svalid[None, :] & (rowc[:, None] != rowc[None, :])
    pair_f = torch.where(cross, rc[:, None] * Kc + rc[None, :], Kc * Kc).reshape(-1)
    flat_w = torch.where(cross, WSS, _INF).reshape(-1)
    del WSS
    Wc = torch.full((Kc * Kc + 1,), _INF, device=dev).scatter_reduce(0, pair_f, flat_w, "amin")[:-1]
    hit = cross.reshape(-1) & (flat_w == Wc[torch.clamp_max(pair_f, Kc * Kc - 1)])
    del cross, flat_w
    # witness indices flattened into the FULL strip: row r, column sids[c]
    full_flat = (torch.arange(s_cap, device=dev)[:, None] * Np + sids[None, :]).reshape(-1)
    Ec = torch.full((Kc * Kc + 1,), _BIG, dtype=torch.int64, device=dev).scatter_reduce(
        0, pair_f, torch.where(hit, full_flat, _BIG), "amin")[:-1]
    del hit, full_flat, pair_f
    Wc = Wc.reshape(Kc, Kc)
    Ec = Ec.reshape(Kc, Kc)
    # merge in the to-largest column
    safe_big = torch.clamp_max(biggest, Kc - 1)
    col_w = Wc.index_select(1, safe_big.reshape(1))[:, 0]
    col_e = Ec.index_select(1, safe_big.reshape(1))[:, 0]
    better = comp_big_w < col_w
    Wc.index_copy_(1, safe_big.reshape(1), torch.where(better, comp_big_w, col_w)[:, None])
    Ec.index_copy_(1, safe_big.reshape(1), torch.where(better, comp_big_flat, col_e)[:, None])
    # symmetrize (S'×S' pairs appear in both orientations, S'×largest in one)
    pick_t = Wc.T < Wc
    tie = Wc.T == Wc
    Wsym = torch.where(pick_t, Wc.T, Wc)
    Esym = torch.where(pick_t, Ec.T, torch.where(tie, torch.minimum(Ec, Ec.T), Ec))
    del Wc, Ec, pick_t, tie
    ea, eb, _, evalid_c = boruvka(Wsym)
    del Wsym
    # witness point pair of each selected component edge
    flat = torch.clamp_max(Esym[ea.long(), eb.long()], s_cap * Np - 1)
    cu = sids[torch.div(flat, Np, rounding_mode="floor")]
    cv = flat % Np
    craw = DS.reshape(-1)[flat]

    # assemble the new tree: kept survivor edges, then completion edges
    krank = torch.cumsum(keep.long(), 0) - 1
    n_keep = keep.sum()
    tgt_k = torch.where(keep, krank, Np)
    crank2 = torch.cumsum(evalid_c.long(), 0) - 1
    tgt_c = torch.where(evalid_c, torch.clamp_max(n_keep + crank2, Np), Np)
    nu = _put(Np, torch.int32, dev, (tgt_k, state.mst_u), (tgt_c, cu))
    nv = _put(Np, torch.int32, dev, (tgt_k, state.mst_v), (tgt_c, cv))
    nr = _put(Np, torch.float32, dev, (tgt_k, state.mst_raw), (tgt_c, craw))
    nval = _put(Np, torch.bool, dev, (tgt_k, keep), (tgt_c, evalid_c))
    return state._replace(
        alive=alive,
        knn_idx=knn_idx,
        knn_dst=knn_dst,
        cd=cd,
        mst_u=nu,
        mst_v=nv,
        mst_raw=nr,
        mst_valid=nval,
        n_alive=(state.n_alive - n_del).to(torch.int32),
        ok=ok,
    )


def rebuild(state: DynState, *, min_pts: int) -> DynState:
    """From-scratch build from X/alive only: the dense distances → kNN
    tables → core distances → dense Borůvka MST.  The hybrid path's full
    pass, and the recovery from an overflowed incremental state."""
    Np, K = state.knn_idx.shape
    dev = state.X.device
    iota = torch.arange(Np, device=dev)
    alive = state.alive
    D = _dense_dists(state.X)
    knn_dst, knn_idx = _dyn_k.strip_topk(D, iota, alive, alive, K)
    cd = torch.where(alive, _cd_from_rows(knn_dst, min_pts), 0.0)
    # W = max(D, cd_r, cd_c) over live pairs off the diagonal, +inf elsewhere
    W = torch.maximum(D, cd[:, None])
    W = torch.maximum(W, cd[None, :], out=W)
    W.masked_fill_(~alive[:, None], _INF)
    W.masked_fill_(~alive[None, :], _INF)
    W.fill_diagonal_(_INF)
    eu, ev, _, valid = boruvka(W)
    del W
    safe_u = torch.clamp_max(eu.long(), Np - 1)
    safe_v = torch.clamp_max(ev.long(), Np - 1)
    return state._replace(
        knn_idx=knn_idx,
        knn_dst=knn_dst,
        cd=cd,
        mst_u=torch.where(valid, safe_u, 0).to(torch.int32),
        mst_v=torch.where(valid, safe_v, 0).to(torch.int32),
        mst_raw=torch.where(valid, D[safe_u, safe_v], 0.0),
        mst_valid=valid,
        n_alive=alive.sum().to(torch.int32),
        ok=torch.ones((), dtype=torch.bool, device=dev),
    )


def state_mst_weights(state: DynState) -> torch.Tensor:
    """(Np,) mutual-reachability weights of the maintained tree (invalid
    slots 0), derived from raw lengths and the current core distances."""
    w = torch.maximum(state.mst_raw, torch.maximum(state.cd[state.mst_u.long()], state.cd[state.mst_v.long()]))
    return torch.where(state.mst_valid, w, 0.0)


def state_mutual_reach_dense(state: DynState) -> np.ndarray:
    """(n, n) f64 mutual-reachability matrix over the alive slots
    (ascending slot order), from the device's own f32 arithmetic: diff-form
    distances and the maintained core distances."""
    ids = torch.nonzero(state.alive).reshape(-1)
    D = _dense_dists(state.X[ids]).cpu().numpy().astype(np.float64)
    cd = state.cd[ids].cpu().numpy().astype(np.float64)
    W = np.maximum(D, np.maximum(cd[:, None], cd[None, :]))
    np.fill_diagonal(W, 0.0)
    return W


class DynamicTorchHDBSCAN:
    """Host handle over the device state: slot free list, power-of-two
    capacity growth, and rebuild-on-overflow, as the reference's
    ``DynamicJaxHDBSCAN``.  Blocks are padded to power-of-two buckets of at
    least ``MIN_BLOCK`` rows.  ``ok`` and ``n`` come from ONE read of the
    device per block (cached until the state changes)."""

    MIN_BLOCK = 4

    def __init__(self, min_pts: int, dim: int, capacity: int = 256, rk_cap: int | None = None,
                 s_cap: int | None = None, device=None):
        self.min_pts = int(min_pts)
        self.dim = int(dim)
        self.device = resolve_device(device)
        # capacity must cover the (Np, K) kNN tables' top-K (K ≤ Np)
        cap = max(16, 2 * self.min_pts, int(capacity))
        cap = 1 << (max(cap - 1, 1)).bit_length()
        # user-pinned caps are used as-is; None scales with the block
        self._rk_cap = int(rk_cap) if rk_cap is not None else None
        self._s_cap = int(s_cap) if s_cap is not None else None
        self.state = init_state(cap, self.dim, self.min_pts, self.device)
        self._free: list[int] = list(range(cap - 1, -1, -1))
        self.stats = {"inserts": 0, "deletes": 0, "overflow_rebuilds": 0, "grows": 0}

    # -- host bookkeeping --------------------------------------------------

    @property
    def state(self) -> DynState:
        return self._state

    @state.setter
    def state(self, s: DynState):
        self._state = s
        self._host = None  # (ok, n) of this state, read on first use

    def _read(self) -> tuple[bool, int]:
        if self._host is None:
            ok, n = torch.stack([self._state.ok.long(), self._state.n_alive.long()]).tolist()
            self._host = (bool(ok), int(n))
        return self._host

    @property
    def capacity(self) -> int:
        return int(self.state.X.shape[0])

    @property
    def n(self) -> int:
        return self._read()[1]

    @property
    def ok(self) -> bool:
        return self._read()[0]

    @property
    def rk_cap(self) -> int:
        return self._rk_cap if self._rk_cap is not None else self._eff_cap(1)

    @property
    def s_cap(self) -> int:
        return self._s_cap if self._s_cap is not None else self._eff_s_cap(1)

    def _eff_cap(self, bp: int) -> int:
        # RkNN sets average ≈ minPts per op with heavy tails on clustered
        # data: floor at minPts², scale with the block, clamp at capacity/4
        want = max(32, self.min_pts * self.min_pts, 2 * self.min_pts * max(bp, 1))
        return min(max(self.capacity // 4, 32), want)

    def _eff_s_cap(self, bp: int) -> int:
        # S' does not shrink with the block (one cut bridge strands a whole
        # cluster): a flat capacity/4 bucket
        return max(64, self.capacity // 4)

    def _grow_to(self, cap: int):
        old = self.capacity
        cap = 1 << (max(cap - 1, 1)).bit_length()
        if cap <= old:
            return
        s = self.state
        pad = cap - old

        def grow(t, value=0):
            return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), value)])

        self.state = DynState(
            X=grow(s.X), alive=grow(s.alive, False), knn_idx=grow(s.knn_idx, -1),
            knn_dst=grow(s.knn_dst, _INF), cd=grow(s.cd), mst_u=grow(s.mst_u), mst_v=grow(s.mst_v),
            mst_raw=grow(s.mst_raw), mst_valid=grow(s.mst_valid, False), n_alive=s.n_alive, ok=s.ok,
        )
        self._free.extend(range(cap - 1, old - 1, -1))
        self.stats["grows"] += 1

    def _pad_block(self, arrs, n: int):
        bp = max(self.MIN_BLOCK, 1 << (max(n - 1, 1)).bit_length())
        out = [np.pad(a, [(0, bp - n)] + [(0, 0)] * (a.ndim - 1)) for a in arrs]
        return out, np.arange(bp) < n

    def _to_dev(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def would_grow(self, n_new: int) -> bool:
        return len(self._free) < int(n_new)

    # -- updates -----------------------------------------------------------

    def insert_block(self, X) -> list[int]:
        X = np.asarray(X, dtype=np.float32).reshape(-1, self.dim)
        B = X.shape[0]
        if B == 0:
            return []
        if self.would_grow(B):
            self._grow_to(self.capacity + B)
        slots = [self._free.pop() for _ in range(B)]
        (Xp, sp), valid = self._pad_block([X, np.asarray(slots, np.int64)], B)
        rk = self._rk_cap if self._rk_cap is not None else self._eff_cap(len(valid))
        self.state = insert_batch(
            self.state, self._to_dev(Xp, torch.float32), self._to_dev(sp, torch.int64),
            self._to_dev(valid, torch.bool), min_pts=self.min_pts, rk_cap=rk)
        self.stats["inserts"] += B
        if not self.ok:
            self.stats["overflow_rebuilds"] += 1
            self.rebuild()
        return slots

    def delete_block(self, slots):
        slots = [int(s) for s in slots]
        B = len(slots)
        if B == 0:
            return
        (sp,), valid = self._pad_block([np.asarray(slots, np.int64)], B)
        rk = self._rk_cap if self._rk_cap is not None else self._eff_cap(len(valid))
        sc = self._s_cap if self._s_cap is not None else self._eff_s_cap(len(valid))
        self.state = delete_batch(
            self.state, self._to_dev(sp, torch.int64), self._to_dev(valid, torch.bool),
            min_pts=self.min_pts, rk_cap=rk, s_cap=sc)
        self._free.extend(reversed(slots))
        self.stats["deletes"] += B
        if not self.ok:
            # an RkNN/S' strip overflowed its bucket: rebuild
            self.stats["overflow_rebuilds"] += 1
            self.rebuild()

    def rebuild(self):
        """From-scratch pass over the current X/alive (the hybrid path's
        full-pass fallback); ``ok`` is True after it and ``n`` unchanged."""
        n = self._host[1] if self._host is not None else None
        self.state = rebuild(self.state, min_pts=self.min_pts)
        if n is not None:
            self._host = (True, n)

    def load(self, X, slots=None, shrink: bool = False):
        """Replace the population: X rows land in ``slots`` (default
        0..n-1) and everything is rebuilt from scratch.  ``shrink``
        re-buckets capacity to ~1.5× the population first."""
        X = np.asarray(X, dtype=np.float32).reshape(-1, self.dim)
        n = X.shape[0]
        slots = list(range(n)) if slots is None else [int(s) for s in slots]
        if len(slots) != n:
            raise ValueError(f"{n} rows but {len(slots)} slots")
        need = (max(slots) + 1) if slots else 1
        if shrink:
            tgt = max(16, 2 * self.min_pts, need, int(1.5 * n))
            tgt = 1 << (max(tgt - 1, 1)).bit_length()
            if tgt != self.capacity:
                self.state = init_state(tgt, self.dim, self.min_pts, self.device)
        if need > self.capacity:
            self._grow_to(need)
        cap = self.capacity
        Xb = np.zeros((cap, self.dim), np.float32)
        alive = np.zeros((cap,), bool)
        Xb[slots] = X
        alive[slots] = True
        self.state = self.state._replace(X=self._to_dev(Xb, torch.float32), alive=self._to_dev(alive, torch.bool))
        taken = set(slots)
        self._free = [i for i in range(cap - 1, -1, -1) if i not in taken]
        self._host = (True, n)
        self.rebuild()
        return slots

    # -- inspection (host reads) -------------------------------------------

    def alive_slots(self) -> np.ndarray:
        return np.nonzero(self.state.alive.cpu().numpy())[0]

    def mst_edges(self):
        """(u, v, w_mutual) host arrays of the maintained tree."""
        valid = self.state.mst_valid.cpu().numpy()
        w = state_mst_weights(self.state).cpu().numpy().astype(np.float64)
        return (self.state.mst_u.cpu().numpy().astype(np.int64)[valid],
                self.state.mst_v.cpu().numpy().astype(np.int64)[valid], w[valid])

    def total_weight(self) -> float:
        return float(np.sum(state_mst_weights(self.state).cpu().numpy().astype(np.float64)))
