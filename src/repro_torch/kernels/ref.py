"""Plain PyTorch versions of the port's kernels.

These are the only arithmetic the CPU path and the tests run, and the
yardstick every CUDA kernel is held against on the card.  They run on any
device and compute the same quantities as the Pallas kernels of the JAX
package (``repro/kernels/{assign,bubble_cd,mutual_reach,knn,pairwise,
flash_attention}.py``):

* squared distances in the expanded form ``max(‖x‖² + ‖y‖² − 2·x·y, 0)``,
  f32, on mean-centred inputs (the expansion cancels off-origin);
* the nearest representative is the lowest index attaining the row
  minimum of that clamped quantity — the Pallas ``assign`` form.  The JAX
  package's ``ref._nearest`` instead elides ``‖x‖²`` and does not clamp,
  so on duplicate or near-zero rows it can pick another index than the
  Pallas kernel; the port follows the kernel;
* Eq. 6 by stable sort + cumulative mass, Eq. 7 as the max of the
  distance and both core distances with the diagonal at 0;
* the k nearest by a stable ascending sort (ties at the lowest index, as
  ``jax.lax.top_k`` orders them);
* attention with f32 scores scaled by 1/√D, masked with the finite
  ``-1e30`` (a fully masked row is the uniform mean of V, not NaN);
* the flat leaf-CF table's block scatter (the JAX package's segment sums
  and ``_kahan_add`` in ``repro/core/bubble_flat.py``, no Pallas kernel):
  each slot's rows summed in ascending row order, then the compensated add;
* the grid-pruned searches (the JAX package's ``repro/kernels/grid.py``
  and ``core/mst.py::_grid_round_minima``, jnp programs): the block loop
  (all blocks at once, each masked out once it stops), the tile loop in
  ascending lower bound, the strict skip rule and the lexicographic merges
  on original indices, with the tile distances in the plain
  ``(xx + yy) − 2·x@yᵀ`` form above;
* the exact-dynamic engine's strip work (the JAX package's
  ``core/dynamic_jax.py`` and ``core/mst.py::boruvka_strip_jax``, jnp
  programs): distances in the DIFF form ``sqrt(Σ_k (r_k − x_k)²)``, summed
  over k in ascending order one IEEE operation at a time (never the
  expansion: the dynamic state holds uncentred coordinates), the masked
  K smallest of each strip row by a stable sort, and one Borůvka round's
  lexicographic (w, pair id, payload) row and column minima of a strip.

Dense ``(L, L)`` work is allowed in this file only (repro-lint RPL402).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "pairwise_sqdist",
    "mutual_reachability",
    "nearest",
    "assign",
    "assign_with_dist",
    "dim_root",
    "bubble_core_distances_from_dm",
    "bubble_core_distances_rows",
    "bubble_core_distances",
    "bubble_mutual_reachability",
    "knn",
    "flash_attention",
    "gqa_flash_attention",
    "kahan_add",
    "flat_scatter",
    "grid_assign",
    "grid_core_distances",
    "grid_round_minima",
    "strip_dists",
    "strip_topk",
    "strip_round_minima",
    "strip_round_minima_from_dists",
]

_INT32_MAX = 2**31 - 1


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.float()
    y = y.float()
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def mutual_reachability(x, y, cd_x, cd_y, zero_diag: bool = True, n_valid: int | None = None, row0: int = 0):
    """Eq. 7 tiles ``max(d(x, y), cd_x, cd_y)``; the global diagonal is 0
    with ``zero_diag``, and rows/columns ≥ ``n_valid`` are +inf (the
    offline pass's pad rows, which Borůvka must never connect).  ``x`` is
    rows ``row0 ..`` of the table: the diagonal and the row mask read
    global row indices."""
    d = torch.sqrt(pairwise_sqdist(x, y))
    m = torch.maximum(d, torch.maximum(cd_x.float()[:, None], cd_y.float()[None, :]))
    n, mm = m.shape
    rows = row0 + torch.arange(n, device=m.device)[:, None]
    cols = torch.arange(mm, device=m.device)[None, :]
    if zero_diag:
        m = torch.where(rows == cols, 0.0, m)
    if n_valid is not None:
        m = torch.where((rows >= n_valid) | (cols >= n_valid), float("inf"), m)
    return m


def nearest(x: torch.Tensor, reps: torch.Tensor):
    """Lowest index attaining the row minimum of the clamped squared
    distance, and that minimum: ``(idx int32 (n,), sq f32 (n,))``."""
    sq = pairwise_sqdist(x, reps)
    m = sq.min(dim=1).values
    L = sq.shape[1]
    cols = torch.arange(L, dtype=torch.int32, device=sq.device)[None, :]
    idx = torch.where(sq == m[:, None], cols, L).amin(dim=1)
    return idx.to(torch.int32), m


def assign(x, reps):
    return nearest(x, reps)[0]


def assign_with_dist(x, reps):
    """Nearest index + euclidean distance, the square root of the same
    row minimum (the serve plane's fused query path)."""
    idx, m = nearest(x, reps)
    return idx, torch.sqrt(m)


def dim_root(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x**(1/dim): repeated correctly-rounded sqrt for power-of-two dims
    (context-stable bits), ``pow`` otherwise."""
    if dim >= 1 and (dim & (dim - 1)) == 0:
        for _ in range(int(dim).bit_length() - 1):
            x = torch.sqrt(x)
        return x
    return torch.pow(x, 1.0 / float(dim))


def bubble_core_distances_from_dm(d, row_ids, n_b, extent, min_pts: int, dim: int):
    """Eq. 6 for an (m, L) euclidean-distance strip holding rows
    ``row_ids`` of the full bubble distance matrix: self at distance 0,
    stable ascending sort, cumulative mass crossing ``min_pts``, then
    ``d* + dim_root(k_resid / n_C, dim) · extent_C``.  A row whose mass
    never crosses falls back to its farthest entry."""
    m, L = d.shape
    dev = d.device
    cols = torch.arange(L, device=dev)
    d = torch.where(row_ids.long()[:, None] == cols[None, :], 0.0, d)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    nb = n_b.float()
    csum = torch.cumsum(nb[order], dim=1)
    reach = csum >= float(min_pts)
    first = torch.argmax(reach.to(torch.int8), dim=1)
    idx = torch.where(reach.any(dim=1), first, L - 1)
    rows = torch.arange(m, device=dev)
    before = torch.where(idx > 0, csum[rows, torch.clamp_min(idx - 1, 0)], 0.0)
    k_resid = torch.clamp_min(float(min_pts) - before, 1.0)
    C = order[rows, idx]
    nC = torch.clamp_min(nb[C], 1.0)
    k_resid = torch.minimum(torch.clamp_min(k_resid, 0.0), nC)
    nnd = dim_root(k_resid / nC, dim) * extent.float()[C]
    return d_sorted[rows, idx] + nnd


def bubble_core_distances_rows(rep_rows, row_ids, rep, n_b, extent, min_pts: int, dim: int):
    d = torch.sqrt(pairwise_sqdist(rep_rows, rep))
    return bubble_core_distances_from_dm(d, row_ids, n_b, extent, min_pts, dim)


def bubble_core_distances(rep, n_b, extent, min_pts: int, dim: int):
    """Eq. 6 over every bubble of the table."""
    L = rep.shape[0]
    ids = torch.arange(L, device=rep.device)
    return bubble_core_distances_rows(rep, ids, rep, n_b, extent, min_pts, dim)


def bubble_mutual_reachability(rep, n_b, extent, min_pts: int, n_valid: int | None = None):
    cd = bubble_core_distances(rep, n_b, extent, min_pts, rep.shape[1])
    return mutual_reachability(rep, rep, cd, cd, zero_diag=True, n_valid=n_valid)


def knn(x, y, k: int):
    """The k smallest distances of each x row to the rows of y, ascending,
    and their int32 indices; equal distances keep the lower index first."""
    d = torch.sqrt(pairwise_sqdist(x, y))
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def flash_attention(q, k, v, qpos, kpos, causal: bool = True, window: int | None = None):
    """Masked softmax attention over (H, S, D) head-major tensors with
    positional masks: dead keys ``kpos < 0``, causal ``kpos > qpos``,
    window ``kpos <= qpos - window``.  Scores in f32, masked with -1e30,
    the result cast to q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) / math.sqrt(d)
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    mask = kp < 0
    if causal:
        mask = mask | (kp > qp)
    if window is not None:
        mask = mask | (kp <= qp - window)
    s = torch.where(mask, -1e30, s)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", w, v.float()).to(q.dtype)


def gqa_flash_attention(q, k, v, qpos, kpos, causal: bool = True, window: int | None = None):
    """``flash_attention`` over (B, H, Sq, D) queries and (B, KV, Sk, D)
    keys and values, query head h paired with kv head h // (H / KV), and
    (B, S) positions: the layout of the kernel wrapper."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    kx, vx = (t.repeat_interleave(G, dim=1).reshape(B * H, -1, D) for t in (k, v))
    out = flash_attention(q.reshape(B * H, Sq, D), kx, vx, qpos.repeat_interleave(H, dim=0),
                          kpos.repeat_interleave(H, dim=0), causal=causal, window=window)
    return out.reshape(B, H, Sq, D)


def _gqa_scores(q, k, qpos, kpos, causal: bool, window: int | None):
    """f32 scores (B, KV, G, Sq, Sk) of (B, H, Sq, D) queries against
    (B, KV, Sk, D) keys, scaled by 1/√D, and the mask (True where masked)
    that broadcasts against them."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    qg = q.float().reshape(B, KV, H // KV, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(D)
    kp, qp = kpos[:, None, None, None, :], qpos[:, None, None, :, None]
    mask = kp < 0
    if causal:
        mask = mask | (kp > qp)
    if window is not None:
        mask = mask | (kp <= qp - window)
    return s, mask


def gqa_flash_lse(q, k, qpos, kpos, causal: bool = True, window: int | None = None):
    """Each row's log-sum-exp of the scaled scores over its live keys, f32
    (B, H, Sq), +inf on a row with no live key: what the forward kernels
    write into ``lse``."""
    B, H, Sq, _ = q.shape
    s, mask = _gqa_scores(q, k, qpos, kpos, causal, window)
    lse = torch.logsumexp(s.masked_fill(mask, -math.inf), dim=-1)
    return torch.where(mask.all(-1), math.inf, lse).reshape(B, H, Sq)


def _gqa_backward(q, k, v, o, lse, do, qpos, kpos, causal, window, weights):
    """f32 (dq, dk, dv) of the plain backward, each of P (into dv) and dS
    (into dk and dq) passed through ``weights`` before its products."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    s, mask = _gqa_scores(q, k, qpos, kpos, causal, window)
    mask = mask.expand(s.shape)
    lse = lse.float().reshape(B, KV, G, Sq, 1)
    dead = torch.isinf(lse)
    p = torch.where(mask, 0.0, torch.exp(s - torch.where(dead, 0.0, lse)))
    p = torch.where(dead, 1.0 / Sk, p)
    dog = do.float().reshape(B, KV, G, Sq, D)
    delta = (dog * o.float().reshape(B, KV, G, Sq, D)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = weights(torch.where(mask, 0.0, p * (dp - delta)))
    dv = torch.einsum("bkgqs,bkgqd->bksd", weights(p), dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.float().reshape(B, KV, G, Sq, D)) / math.sqrt(D)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) / math.sqrt(D)
    return dq.reshape(B, H, Sq, D), dk, dv


def gqa_flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal: bool = True, window: int | None = None):
    """(dq, dk, dv) of ``gqa_flash_attention`` against ``do``, written
    plainly in f32 from the saved output and log-sum-exp, as the backward
    kernels compute them: P = exp(s − lse) on a live pair and 0 on a masked
    one, Δ = rowsum(do ∘ o), dS = P (do·vᵀ − Δ) on a live pair, dv = Pᵀ do,
    dk = dSᵀ q / √D and dq = dS k / √D, each summed over the G query heads
    of a kv head.  A row with no live key (lse = +inf) is the uniform mean
    of V: its weights are 1/Sk in dv and it adds nothing to dq or dk, as
    autograd through ``gqa_flash_attention`` gives (masked scores pass no
    gradient).  Returned in the inputs' dtypes."""
    dq, dk, dv = _gqa_backward(q, k, v, o, lse, do, qpos, kpos, causal, window, lambda x: x)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_terms(x, split: bool = True):
    """f32 ``x`` as the tensor-core backward feeds it to a product: the
    sum of two bf16 terms hi = bf16(x) and lo = bf16(x − hi), which
    carries x to 2^-17 (``split``), or bf16(x) rounded once (off by up to
    2^-8); in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if split else hi


def gqa_flash_attention_backward_mma(q, k, v, o, lse, do, qpos, kpos, causal: bool = True,
                                     window: int | None = None, split: bool = True):
    """A plain model of ``csrc/flash_attention_bwd_mma.cu``'s arithmetic,
    for the tests only: q, k, v, o and do as bf16
    operands; S, dP and Δ summed in f32 from them; P (into dv) and dS
    (into dk and dq) entering the products as ``bf16_terms`` — hi + lo, or
    with ``split=False`` rounded once; f32 sums; the gradients rounded once
    to bf16.  The order of the f32 sums is the CPU's, and they round to
    nearest: the tensor cores' own f32 sums do not, which is why the
    kernel adds each tile's sum to its running sums in round-to-nearest
    f32."""
    bf = [t.to(torch.bfloat16).float() for t in (q, k, v, o, do)]
    grads = _gqa_backward(*bf[:4], lse, bf[4], qpos, kpos, causal, window, lambda x: bf16_terms(x, split))
    return tuple(t.to(torch.bfloat16) for t in grads)


def gqa_flash_attention_wgmma(q, k, v, qpos, kpos, causal: bool = True, window: int | None = None,
                              tile: int = 128, split: bool = True):
    """A plain model of ``csrc/flash_attention_wgmma.cu``'s arithmetic, for
    the tests only: q, k and v as bf16 operands; each ``tile`` of keys in
    order, its scores summed in f32 and scaled into the log2 domain
    (1/√D · log2 e), a masked one set to −1e30; the online softmax over
    the tiles (running row max m, p = 2^(s − m) in f32, the row sum l of
    the f32 p, O rescaled by 2^(m_old − m_new)); P entering P·V as
    ``bf16_terms`` — hi + lo, or with ``split=False`` rounded once, as the
    Pallas kernel's ``p.astype(v.dtype)``; f32 sums; O / l rounded once to
    q's dtype.  A row that met no live key gets the uniform mean of V over
    the Sk keys.  The order of the f32 sums is the CPU's."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.to(torch.bfloat16).float().reshape(B, KV, G, Sq, D)
    kf, vf = (t.to(torch.bfloat16).float() for t in (k, v))
    sl = 1.0 / math.sqrt(D) * math.log2(math.e)
    m = torch.full((B, KV, G, Sq), -1e30)
    l = torch.zeros((B, KV, G, Sq))
    o = torch.zeros((B, KV, G, Sq, D))
    qp = qpos[:, None, None, :, None]
    for t0 in range(0, Sk, tile):
        kp = kpos[:, None, None, None, t0 : t0 + tile]
        mask = kp < 0
        if causal:
            mask = mask | (kp > qp)
        if window is not None:
            mask = mask | (kp <= qp - window)
        s = torch.where(mask, -1e30, torch.einsum("bkgqd,bksd->bkgqs", qf, kf[:, :, t0 : t0 + tile]) * sl)
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", bf16_terms(p, split), vf[:, :, t0 : t0 + tile])
        m = mn
    mean_v = vf.mean(2)[:, :, None, None, :]
    out = torch.where((m > -1e30)[..., None], o / l.clamp_min(1e-30)[..., None], mean_v)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def kahan_add(hi, err, delta):
    """Compensated accumulate: (hi, err) += delta with the running f32
    rounding error carried in err (the true sum is ``hi - err``)."""
    y = delta - err
    t = hi + y
    return t, (t - hi) - y


def flat_scatter(LS, LSe, SS, SSe, N, alive, x, slot, valid, thresh: float, sign: int):
    """The flat table's block scatter, out of place: for every slot s, the
    rows with ``slot == s`` (valid, slot in [0, Lp)) summed in ascending row
    order from 0 — x, ``‖x‖²`` (one rounded product per feature, added in
    ascending feature order) and the count — then ``kahan_add`` of
    ``sign`` × those sums on every slot, a zero delta included, and the
    count added to N.  Returns (LS, LSe, SS, SSe, N, flags) with flags
    ``alive & (N > thresh)`` for sign +1 (insert), ``alive & (N < thresh)``
    for -1 (delete).  The fixed order makes it bit for bit the CUDA kernel:
    rows that share a slot are added one rank at a time, each rank a
    scatter with no repeated index."""
    Lp, d = LS.shape
    x = x.float()
    sq = x[:, 0] * x[:, 0]
    for j in range(1, d):
        sq = sq + x[:, j] * x[:, j]
    seg = slot.long()
    rows = torch.nonzero(valid & (seg >= 0) & (seg < Lp)).squeeze(1)
    s, order = torch.sort(seg[rows], stable=True)
    rows = rows[order]
    cnt = torch.bincount(s, minlength=Lp)
    rank = torch.arange(s.numel(), device=s.device) - (torch.cumsum(cnt, 0) - cnt)[s]
    dLS, dSS = torch.zeros_like(LS), torch.zeros_like(SS)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == k
        r, t = rows[at], s[at]
        dLS[t] = dLS[t] + x[r]
        dSS[t] = dSS[t] + sq[r]
    dN = cnt.to(N.dtype)
    if sign < 0:
        dLS, dSS, dN = -dLS, -dSS, -dN
    LS, LSe = kahan_add(LS, LSe, dLS)
    SS, SSe = kahan_add(SS, SSe, dSS)
    N = N + dN
    thresh = float(np.float32(thresh))
    flags = alive & ((N > thresh) if sign > 0 else (N < thresh))
    return LS, LSe, SS, SSe, N, flags


def _grid_tiles(grid, order_t):
    """The tiles ``order_t`` (NB,) of the sorted table, one per block:
    rows (NB, T, d), squared norms, valid mask and original rows."""
    Lp, d = grid.pts.shape
    T = grid.tile
    cols = order_t.long()[:, None] * T + torch.arange(T, device=order_t.device)[None, :]
    ys = grid.pts[cols]
    return ys, (ys * ys).sum(-1), grid.valid[cols], grid.orig.long()[cols]


def _tile_sq(xb, xx, ys, yy):
    """(NB, bn, T) clamped squared distances, ``(xx + yy) − 2·x@yᵀ``."""
    xy = torch.bmm(xb, ys.transpose(1, 2))
    return torch.clamp_min((xx[:, :, None] + yy[:, None, :]) - 2.0 * xy, 0.0)


def grid_assign(grid, xs, views):
    """Plain ``grid_assign`` over Morton-sorted queries ``xs`` (B, d) and
    their blocks' visit lists: the nearest VALID rep by (clamped squared
    distance, original index) per row, in the queries' sorted order.
    Returns (idx int32 (B,), the squared distance (B,)); idx = Lp where no
    valid rep exists.  A block stops before the first tile whose bound
    (``lb_sq − slack``) exceeds every one of its rows' best, or is +inf."""
    B, d = xs.shape
    Lp = grid.pts.shape[0]
    NB, NT = views.order.shape
    bn = views.block
    dev = xs.device
    live = (torch.arange(NB * bn, device=dev) < B).view(NB, bn)
    xb = torch.cat([xs, xs.new_zeros(NB * bn - B, d)]).view(NB, bn, d)
    xx = (xb * xb).sum(-1)
    best = torch.full((NB, bn), float("inf"), device=dev)
    bidx = torch.full((NB, bn), Lp, dtype=torch.int64, device=dev)
    active = torch.ones(NB, dtype=torch.bool, device=dev)
    for t in range(NT):
        lb = views.lbs[:, t]
        active = active & torch.isfinite(lb) & (live & (lb[:, None] <= best)).any(1)
        if not bool(active.any()):
            break
        ys, yy, yv, yo = _grid_tiles(grid, views.order[:, t])
        sq = torch.where(yv[:, None, :], _tile_sq(xb, xx, ys, yy), float("inf"))
        m = sq.amin(2)
        cols = torch.where(yv, yo, Lp)[:, None, :]
        j = torch.where(sq == m[..., None], cols, Lp).amin(2)
        better = active[:, None] & ((m < best) | ((m == best) & (j < bidx)))
        best = torch.where(better, m, best)
        bidx = torch.where(better, j, bidx)
    return bidx.reshape(-1)[:B].to(torch.int32), best.reshape(-1)[:B]


def _lex_topk(d, i, K: int):
    """The K smallest (d, i) pairs of each row, ascending lexicographically."""
    by_i = torch.argsort(i, dim=-1, stable=True)
    d, i = torch.gather(d, -1, by_i), torch.gather(i, -1, by_i)
    by_d = torch.argsort(d, dim=-1, stable=True)[..., :K]
    return torch.gather(d, -1, by_d), torch.gather(i, -1, by_d)


def _query_blocks(grid, views, blocks):
    """The sorted table's query blocks ``[b0, b1)`` (all by default): rows
    (NB, bn, d), valid mask, original rows, and their visit lists."""
    d = grid.pts.shape[1]
    bn = views.block
    b0, b1 = (0, views.order.shape[0]) if blocks is None else blocks
    rows = slice(b0 * bn, b1 * bn)
    return (grid.pts[rows].view(-1, bn, d), grid.valid[rows].view(-1, bn), grid.orig[rows].long().view(-1, bn),
            views.order[b0:b1], views.lbs[b0:b1])


def grid_core_distances(grid, views, n_b, extent, min_pts: int, dim: int, blocks=None):
    """Plain ``grid_core_distances``: per row of the sorted table, the
    first K = min(min_pts, Lp) VALID rows of the (distance, original index)
    order — self at exactly 0 — kept by a lexicographic top-K merge tile
    after tile, then Eq. 6 over that prefix.  A block stops before the
    first tile whose bound exceeds its valid rows' K-th distance, or is
    +inf.  ``n_b``/``extent`` and the result are in ORIGINAL row order
    (0 on invalid rows); with ``blocks = (b0, b1)`` only those query
    blocks run and the result is their rows' values in SORTED order."""
    Lp, d = grid.pts.shape
    NT = views.order.shape[1]
    bn = views.block
    dev = grid.pts.device
    K = min(int(min_pts), Lp)
    mp = float(min_pts)
    xb, xv, xo, v_order, v_lbs = _query_blocks(grid, views, blocks)
    NB = xb.shape[0]
    xx = (xb * xb).sum(-1)
    inf = float("inf")
    bd = torch.full((NB, bn, K), inf, device=dev)
    bi = torch.full((NB, bn, K), Lp, dtype=torch.int64, device=dev)
    active = torch.ones(NB, dtype=torch.bool, device=dev)
    for t in range(NT):
        lb = v_lbs[:, t]
        kth = torch.where(xv, bd[:, :, K - 1], -inf).amax(1)
        active = active & torch.isfinite(lb) & (lb <= kth)
        if not bool(active.any()):
            break
        ys, yy, yv, yo = _grid_tiles(grid, v_order[:, t])
        dm = torch.sqrt(_tile_sq(xb, xx, ys, yy))
        dm = torch.where(yo[:, None, :] == xo[:, :, None], 0.0, dm)  # self at exactly 0
        dm = torch.where(yv[:, None, :], dm, inf)
        ci = torch.where(yv, yo, Lp)[:, None, :].expand(NB, bn, -1)
        nd, ni = _lex_topk(torch.cat([bd, dm], -1), torch.cat([bi, ci], -1), K)
        bd = torch.where(active[:, None, None], nd, bd)
        bi = torch.where(active[:, None, None], ni, bi)
    nb = n_b.float()
    safe_i = torch.clamp_max(bi, Lp - 1)
    n_sorted = torch.where(bi < Lp, nb[safe_i], 0.0)
    csum = torch.cumsum(n_sorted, -1)
    reach = csum >= mp
    idx = torch.where(reach.any(-1), torch.argmax(reach.to(torch.int8), -1), K - 1)[..., None]
    before = torch.where(idx > 0, torch.gather(csum, -1, torch.clamp_min(idx - 1, 0)), 0.0)
    k_resid = torch.clamp_min(mp - before, 1.0)
    C = torch.gather(safe_i, -1, idx)
    nC = torch.clamp_min(nb[C], 1.0)
    k_resid = torch.minimum(torch.clamp_min(k_resid, 0.0), nC)
    cdb = torch.gather(bd, -1, idx) + dim_root(k_resid / nC, dim) * extent.float()[C]
    vals = torch.where(xv, cdb[..., 0], 0.0).reshape(-1)
    if blocks is not None:
        return vals
    out = torch.zeros(Lp, device=dev)
    out[xo.reshape(-1)] = vals
    return out


def grid_round_minima(grid, views, cd, labels, hopeless, blocks=None):
    """Plain ``grid_round_minima``: per row, the lightest edge to another
    component by (w, canonical edge id), ``w = max(d, cd_r, cd_c)`` and
    ``eid = min(o_r, o_c)·n + max(o_r, o_c)``, over valid columns with
    another label.  A block stops before the first tile where
    ``max(lb, cd_r) > best_w`` for all its live rows (valid, not
    ``hopeless``), or whose bound is +inf.  ``cd``/``labels``/``hopeless``
    and the result (row_w f32, row_eid int32; +inf and int32 max where no
    edge) are in ORIGINAL row order; with ``blocks = (b0, b1)`` only those
    query blocks run and the result is their rows' in SORTED order."""
    n, d = grid.pts.shape
    NT = views.order.shape[1]
    dev = grid.pts.device
    xb, xv, xo, v_order, v_lbs = _query_blocks(grid, views, blocks)
    NB, bn = xv.shape
    xx = (xb * xb).sum(-1)
    lab_r, cd_r = labels[xo], cd[xo]
    alive = xv & ~hopeless[xo]
    bw = torch.full((NB, bn), float("inf"), device=dev)
    be = torch.full((NB, bn), _INT32_MAX, dtype=torch.int64, device=dev)
    active = torch.ones(NB, dtype=torch.bool, device=dev)
    for t in range(NT):
        lb = v_lbs[:, t]
        thr = torch.maximum(lb[:, None], cd_r)
        active = active & torch.isfinite(lb) & (alive & (thr <= bw)).any(1)
        if not bool(active.any()):
            break
        ys, yy, yv, yo = _grid_tiles(grid, v_order[:, t])
        dm = torch.sqrt(_tile_sq(xb, xx, ys, yy))
        w = torch.maximum(dm, torch.maximum(cd_r[:, :, None], cd[yo][:, None, :]))
        ok = alive[:, :, None] & yv[:, None, :] & (labels[yo][:, None, :] != lab_r[:, :, None])
        w = torch.where(ok, w, float("inf"))
        eid = torch.minimum(xo[:, :, None], yo[:, None, :]) * n + torch.maximum(xo[:, :, None], yo[:, None, :])
        eid = torch.where(ok, eid, _INT32_MAX)
        rw = w.amin(2)
        re = torch.where(w == rw[..., None], eid, _INT32_MAX).amin(2)
        better = active[:, None] & ((rw < bw) | ((rw == bw) & (re < be)))
        bw = torch.where(better, rw, bw)
        be = torch.where(better, re, be)
    if blocks is not None:
        return bw.reshape(-1), be.reshape(-1).to(torch.int32)
    rows = xo.reshape(-1)
    row_w = torch.empty(n, device=dev)
    row_eid = torch.empty(n, dtype=torch.int32, device=dev)
    row_w[rows] = bw.reshape(-1)
    row_eid[rows] = be.reshape(-1).to(torch.int32)
    return row_w, row_eid


_STRIP_ELEMS = 1 << 22  # (rows, Np) elements per row block of the strip functions


def _row_blocks(U: int, Np: int):
    step = max(1, _STRIP_ELEMS // max(Np, 1))
    return ((r0, min(U, r0 + step)) for r0 in range(0, U, step))


def strip_dists(rows: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(U, Np) f32 diff-form distances ``sqrt(Σ_k (rows[u, k] − X[j, k])²)``,
    the sum over k in ascending order (``acc = acc + diff * diff``), in row
    blocks of at most ``_STRIP_ELEMS`` elements.  The root is taken in f64
    and rounded once to f32, which is the correctly rounded f32 root (as
    the kernel's ``__fsqrt_rn``) on any device: PyTorch's vectorised f32
    ``sqrt`` on the CPU is not correctly rounded."""
    rows, X = rows.float(), X.float()
    U, d = rows.shape
    out = torch.empty((U, X.shape[0]), dtype=torch.float32, device=X.device)
    for r0, r1 in _row_blocks(U, X.shape[0]):
        acc = torch.zeros((r1 - r0, X.shape[0]), dtype=torch.float32, device=X.device)
        for k in range(d):
            diff = rows[r0:r1, k : k + 1] - X[None, :, k]
            acc = acc + diff * diff
        out[r0:r1] = torch.sqrt(acc.double()).float()
    return out


def strip_topk(D, row_ids, row_valid, alive, K: int):
    """Per strip row u, the K smallest (distance, column) pairs of ``D[u]``
    over the columns j with ``row_valid[u] & alive[j] & (j != row_ids[u])``,
    ascending, ties at the lowest column (a stable sort), padded with
    (+inf, −1); a non-finite distance also gets index −1.  Returns
    ((U, K) f32, (U, K) int32)."""
    U, Np = D.shape
    dev = D.device
    iota = torch.arange(Np, device=dev)
    out_d = torch.empty((U, K), dtype=torch.float32, device=dev)
    out_i = torch.empty((U, K), dtype=torch.int32, device=dev)
    for r0, r1 in _row_blocks(U, Np):
        m = row_valid[r0:r1, None] & alive[None, :] & (iota[None, :] != row_ids[r0:r1, None].long())
        dm = torch.where(m, D[r0:r1].float(), float("inf"))
        vals, idx = torch.sort(dm, dim=1, stable=True)
        vals, idx = vals[:, :K], idx[:, :K]
        out_d[r0:r1] = vals
        out_i[r0:r1] = torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)
    return out_d, out_i


def _lex_better(w, e, p, bw, be, bp):
    """Where (w, e, p) is lexicographically below (bw, be, bp)."""
    return (w < bw) | ((w == bw) & ((e < be) | ((e == be) & (p < bp))))


def strip_round_minima(SW, smask, sids, lab, E: int = 0):
    """One ``boruvka_strip_jax`` round's strip reductions: per strip row and
    per column, the lexicographic minimum of (w, canonical pair id
    ``min(s, c)·n + max(s, c)``, payload ``E + row·n + col``) over the
    active entries ``smask & (lab[sids[row]] != lab[col])``.  Rows and
    columns with no active entry get (+inf, int32 max, int32 max).
    Returns (row_w f32 (U,), row_eid, row_pay int64 (U,), col_w f32 (n,),
    col_eid, col_pay int64 (n,))."""
    return _strip_minima(SW.shape, SW.device, lambda r0, r1: (SW[r0:r1].float(), smask[r0:r1]), sids, lab, E)


def strip_round_minima_from_dists(D, cd, sids, row_valid, alive, lab, E: int = 0):
    """``strip_round_minima`` on the exact insert's weights and mask
    (``repro/core/dynamic_jax.py:223``), built from the strip's factors a
    row block at a time: ``SW = max(max(D, cd[sids][:, None]), cd[None,
    :])``, +inf off ``smask = row_valid[:, None] & alive[None, :] & (col !=
    sids[:, None])``."""
    n = D.shape[1]
    iota = torch.arange(n, device=D.device)
    sids_l = sids.long()

    def block(r0, r1):
        s = sids_l[r0:r1]
        m = row_valid[r0:r1, None] & alive[None, :] & (iota[None, :] != s[:, None])
        w = torch.maximum(D[r0:r1].float(), cd[s][:, None])
        w = torch.maximum(w, cd[None, :], out=w)
        return w.masked_fill_(~m, float("inf")), m

    return _strip_minima(D.shape, D.device, block, sids, lab, E)


def _strip_minima(shape, dev, block, sids, lab, E: int):
    """The reductions of ``strip_round_minima`` over row blocks; ``block(r0,
    r1)`` gives the blocks' (f32 weights, mask)."""
    U, n = shape
    inf = float("inf")
    lab = lab.long()
    sids = sids.long()
    slab = lab[sids]
    iota = torch.arange(n, device=dev)
    rw = torch.full((U,), inf, device=dev)
    re = torch.full((U,), _INT32_MAX, dtype=torch.int64, device=dev)
    rp = torch.full((U,), _INT32_MAX, dtype=torch.int64, device=dev)
    cw = torch.full((n,), inf, device=dev)
    ce = torch.full((n,), _INT32_MAX, dtype=torch.int64, device=dev)
    cp = torch.full((n,), _INT32_MAX, dtype=torch.int64, device=dev)
    for r0, r1 in _row_blocks(U, n):
        SWb, mb = block(r0, r1)
        act = mb & (slab[r0:r1, None] != lab[None, :])
        w = torch.where(act, SWb, inf)
        s = sids[r0:r1, None]
        eid = torch.where(act, torch.minimum(s, iota[None, :]) * n + torch.maximum(s, iota[None, :]), _INT32_MAX)
        pay = torch.where(act, E + torch.arange(r0, r1, device=dev)[:, None] * n + iota[None, :], _INT32_MAX)
        # rows: weight, then pair id among the weight's hits, then payload
        bw = w.amin(1)
        hit = w == bw[:, None]
        be = torch.where(hit, eid, _INT32_MAX).amin(1)
        hit &= eid == be[:, None]
        rw[r0:r1], re[r0:r1], rp[r0:r1] = bw, be, torch.where(hit, pay, _INT32_MAX).amin(1)
        # columns: this block's minima, merged into the running ones
        bw = w.amin(0)
        hit = w == bw[None, :]
        be = torch.where(hit, eid, _INT32_MAX).amin(0)
        hit &= eid == be[None, :]
        bp = torch.where(hit, pay, _INT32_MAX).amin(0)
        better = _lex_better(bw, be, bp, cw, ce, cp)
        cw, ce, cp = torch.where(better, bw, cw), torch.where(better, be, ce), torch.where(better, bp, cp)
    return rw, re, rp, cw, ce, cp
