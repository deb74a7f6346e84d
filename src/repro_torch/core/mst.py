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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import grid as _grid_k

__all__ = ["boruvka", "boruvka_grid", "mst_total_weight"]

_BIGID = np.iinfo(np.int32).max


def mst_total_weight(w) -> float:
    return float(np.sum(np.asarray(w, dtype=np.float64)))


def _segment_min(labels: torch.Tensor, values: torch.Tensor, init) -> torch.Tensor:
    out = torch.full_like(values, init)
    return out.scatter_reduce_(0, labels, values, reduce="amin", include_self=True)


def _boruvka_round_tail(labels, row_w, row_eid, row_j, row_has,
                        eu, ev, ew, valid, n_edges, n: int, jumps: int):
    """Back half of one round: per-component (w, eid) minimum, hooking,
    pointer jumping and edge append (slot via cumsum; rejects land in the
    trash slot ``n``).  ``labels`` and ``row_j`` are int64, ``row_eid``
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
    comp_wt = row_w[safe_row]
    comp_tgt = labels[comp_v]
    # mirrored 2-cycle iff both components chose the same canonical edge
    is_mirror = has_edge & (comp_eid[comp_tgt] == comp_eid)
    keep = has_edge & ~(is_mirror & (iota > comp_tgt))
    # hook: parent = target label; mirror pairs root at the lower label
    parent = torch.where(has_edge, comp_tgt, iota)
    parent = torch.where(is_mirror & (iota < comp_tgt), iota, parent)
    for _ in range(jumps):
        parent = parent[parent]
    new_labels = parent[labels]
    slot = n_edges + torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep, torch.clamp_max(slot, n - 1), n)
    eu[slot] = safe_row.int()
    ev[slot] = comp_v.int()
    ew[slot] = comp_wt
    valid[slot] = keep
    return new_labels, eu, ev, ew, valid, n_edges + keep.sum()


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


def boruvka(W: torch.Tensor):
    """Borůvka MST of a dense symmetric (n, n) weight matrix (+inf entries
    allowed) on W's device.  Returns ``(eu, ev, ew, valid)``: (n,) int32,
    int32, W-dtype and bool buffers, ``valid`` marking the written edges.
    With duplicate weights the (w, eid) key makes every choice
    deterministic (lowest canonical edge id)."""
    n = W.shape[0]
    max_rounds, jumps = _rounds(n)
    dev = W.device
    inf = float("inf")
    iota32 = torch.arange(n, dtype=torch.int32, device=dev)
    iota = iota32.long()
    eid = torch.minimum(iota32[:, None], iota32[None, :]) * n + torch.maximum(iota32[:, None], iota32[None, :])

    labels = iota.clone()
    eu, ev, ew, valid, n_edges = _buffers(n, dev, W.dtype)
    for _ in range(max_rounds):
        same = labels[:, None] == labels[None, :]
        same.fill_diagonal_(True)
        masked = torch.where(same, inf, W)
        del same
        row_w = masked.amin(dim=1)
        at_min = masked == row_w[:, None]
        del masked
        row_eid = torch.where(at_min, eid, _BIGID).amin(dim=1).long()
        del at_min
        # the column holding the row's chosen canonical edge
        lo, hi = row_eid // n, row_eid % n
        row_j = torch.where(lo == iota, hi, lo)
        row_has = torch.isfinite(row_w)
        labels, eu, ev, ew, valid, n_edges = _boruvka_round_tail(
            labels, row_w, row_eid, row_j, row_has, eu, ev, ew, valid, n_edges, n, jumps)
    return eu[:-1], ev[:-1], ew[:-1], valid[:-1]


def boruvka_grid(grid, cd: torch.Tensor, views=None):
    """Borůvka MST of the grid's valid rows under Eq. 7 weights
    ``max(d, cd_r, cd_c)`` (``cd`` (n,) in ORIGINAL row order), with no
    (n, n) matrix: each round's row minima come from
    ``grid_round_minima`` over the block visit lists ``views`` (computed
    once, ``grid._block_views`` by default).  A row whose component already
    holds every valid row is hopeless and skips its search.  Fixed round
    count, no host read.  Returns the ``boruvka`` buffers."""
    n = grid.pts.shape[0]
    max_rounds, jumps = _rounds(n)
    dev = grid.pts.device
    views = _grid_k._block_views(grid) if views is None else views
    iota = torch.arange(n, device=dev)
    rows = grid.orig.long()
    valid_orig = torch.zeros(n, dtype=torch.int64, device=dev)
    valid_orig[rows] = grid.valid.long()
    total_valid = grid.n_valid.long()
    labels = iota.clone()
    eu, ev, ew, valid, n_edges = _buffers(n, dev, torch.float32)
    for _ in range(max_rounds):
        cnt = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(0, labels, valid_orig)
        hopeless = cnt[labels] >= total_valid
        row_w, row_eid = _grid_k.grid_round_minima(grid, views, cd, labels, hopeless)
        row_eid = row_eid.long()
        lo = row_eid // n
        # the column of the chosen canonical edge; rows with no edge are
        # gated by row_has in the tail, the clamp keeps their gathers in range
        row_j = torch.clamp(torch.where(lo == iota, row_eid - lo * n, lo), 0, n - 1)
        labels, eu, ev, ew, valid, n_edges = _boruvka_round_tail(
            labels, row_w, row_eid, row_j, torch.isfinite(row_w), eu, ev, ew, valid, n_edges, n, jumps)
    return eu[:-1], ev[:-1], ew[:-1], valid[:-1]
