"""Grid-pruned exact neighbour engine (DESIGN.md §10): the Morton grid and
the launch wrappers of its three CUDA kernels.

The PyTorch counterpart of the JAX package's ``repro/kernels/grid.py``
and of the per-round search of ``core/mst.py::boruvka_grid_jax``.  A
bubble table is bucketed into fixed-shape, Morton-ordered tiles of
``DEFAULT_TILE`` rows with an axis-aligned box each; a query block of
``DEFAULT_BLOCK`` rows visits the tiles in ascending order of a lower
bound on their distance and stops at the first tile that cannot beat the
block's current answers.  Pruning is exact, not approximate:

  * a tile is skipped only when its bound, less ``_slack`` (a generous
    f32 forward-error budget), is STRICTLY above every answer the block
    still needs, so ties are always visited;
  * candidate distances carry the dense kernels' bits: every norm and
    dot product is one ascending ``__fmaf_rn`` chain inside the kernel
    (``csrc/common.cuh::dot_chain``), then ``expanded_sq``;
  * answers merge on (value, ORIGINAL row index), the lexicographic order
    of the dense kernels' tie-breaks.

Invalid rows (size-bucket padding, dead slots) are never candidates: the
dense path instead parks them at ``_PAD_COORD``, so the two agree for data
well inside that envelope.

The grid itself (``build_grid``, ``_block_views``, ``_query_views``) is
O(L·d) torch code on the table's device plus one (NB, NT) sort; nothing
reads the device.  The three searches are hand-written CUDA kernels, one
block (or cluster of blocks) per 64 query rows:

  ``grid_assign``          nearest valid rep per query row (ingest and
                           serve), replacing ``grid.py:355``
                           (``csrc/grid_assign.cu``: a prefetched tile ring
                           carrying the columns' attributes, the walk split
                           across a cluster of ``ASSIGN_CLUSTER`` CTAs);
  ``grid_core_distances``  Eq. 6 over each row's (distance, index) walk,
                           replacing ``grid.py:222`` / ``:255``
                           (``csrc/grid_cd.cu``: a thread a row with its
                           first k keys in registers up to k = 16, the
                           walk split across a cluster of ``CD_CLUSTER``
                           CTAs stopping on the cluster's k-th; above, the
                           first kernel's warp-select queues, its passes
                           spread over the CTAs);
  ``grid_round_minima``    one Borůvka round's lightest outgoing
                           (w, edge id) per row, replacing ``mst.py:392``
                           (``csrc/grid_round.cu``: a prefetched tile ring,
                           the walk split across a cluster of
                           ``ROUND_CLUSTER`` CTAs).

``grid_assign_v1``, ``grid_core_distances_v1`` and
``grid_round_minima_v1`` launch the first kernels (``csrc/grid.cu``), the
redesigns' bitwise oracles: no path calls them.

The Eq. 6 and Borůvka searches take a range of query blocks: the
sharded offline pass (``mesh=``) gives each shard a contiguous range
(``grid_core_distances_shard``, ``core/mst.py::boruvka_grid_shard``), each
block's answers do not depend on which blocks share a launch, and the
range's rows come back in sorted order for the lead device to scatter.

Bound on the H100: operations.  Each visited tile costs 64 × 32 × d FMAs
of dot product; the table and the visit lists are a few MB.  Every kernel
stages a visited tile in shared memory once for all 64 rows of its block
and reads the tile's rows by broadcast, with no (rows, L) buffer anywhere.
The layouts differ.  The redesigned kernels (``csrc/grid_assign.cu``,
``csrc/grid_cd.cu`` up to k = 16, ``csrc/grid_round.cu``) give a thread a
row, 64 threads a CTA: a visit is 32 columns × d FMAs a thread, the tiles
come through a ring of ``cp.async`` copies a few visits ahead, and a
block's walk is split over the CTAs of a cluster.  The first kernels
(``csrc/grid.cu``), and ``csrc/grid_cd.cu`` past k = 16 (its passes and
walk spread over the cluster), give lane j of each warp column j of the tile and a
warp R of the block's rows: a visit is R rows × d FMAs a thread, one tile
in flight.  A tensor on the CPU takes the plain version in
``kernels/ref.py``; a CUDA tensor launches the kernel or raises.
``track_visits`` counts the kernels' row-tile visits on the card and the
longest walk of one CTA.
"""

from __future__ import annotations

import dataclasses

import torch

from ..launch.mesh import gather, on_devices, shard_ranges
from . import _build
from . import ref as _ref

__all__ = [
    "GridIndex",
    "GridViews",
    "build_grid",
    "morton_codes",
    "tile_gap_sq",
    "grid_assign",
    "grid_core_distances",
    "grid_round_minima",
    "grid_round_minima_v1",
    "grid_assign_v1",
    "grid_core_distances_v1",
    "grid_core_distances_shard",
    "track_visits",
    "visit_counts",
    "DEFAULT_TILE",
    "DEFAULT_BLOCK",
    "ROUND_CLUSTER",
    "ASSIGN_CLUSTER",
    "CD_CLUSTER",
]

# quantisation bits per grid dimension; with <= 3 interleaved dims the
# Morton code stays inside int32 (3 * 10 = 30 bits)
_BITS = 10
_MAX_GDIMS = 3
_EPS32 = 2.0 ** -23

DEFAULT_TILE = 32  # candidate-tile rows (contiguous in Morton order); the kernels' warp width
DEFAULT_BLOCK = 64  # query rows per block: csrc/grid.cu kRows
_LB_CHUNK = 1 << 24  # floats of one (blocks, tiles, d) gap chunk in _lower_bounds
_INT32_MAX = 2**31 - 1

ROUND_CLUSTER = 8  # CTAs a query block in grid_round_minima's launch (python -m repro_torch.kernels.grid_variants)
ASSIGN_CLUSTER = 8  # CTAs a query block in grid_assign's launch (python -m repro_torch.kernels.grid_variants assign)
CD_CLUSTER = 8  # CTAs a query block in grid_core_distances' launch (python -m repro_torch.kernels.grid_variants cd)
CLUSTERS = (1, 2, 4, 8)  # the cluster sizes the kernels are built for

launches = {"grid_assign": 0, "grid_core_distances": 0, "grid_round_minima": 0, "grid_round_minima_v1": 0,
            "grid_assign_v1": 0, "grid_core_distances_v1": 0}
# (6,) int64 on the card while track_visits is on, by slot (_SLOTS): the row-tile visits of assign, Eq. 6 and the
# round (both kernels of each), each followed by its longest walk of a CTA
_SLOTS = ("grid_assign", "grid_assign_longest", "grid_core_distances", "grid_core_longest", "grid_round_minima",
          "grid_round_longest")
_visits: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """Morton-sorted copy of a rep table with per-tile bounding boxes.

    The tile size is ``pts.shape[0] // tile_lo.shape[0]``."""

    pts: torch.Tensor  # (Lp, d) f32 rows in Morton order (invalid rows last)
    orig: torch.Tensor  # (Lp,) int32 original row of each sorted position
    valid: torch.Tensor  # (Lp,) bool per sorted position
    tile_lo: torch.Tensor  # (NT, d) per-tile box over valid rows (+inf if none)
    tile_hi: torch.Tensor  # (NT, d) (-inf if none)
    lo: torch.Tensor  # (d,) quantisation lower corner
    inv_w: torch.Tensor  # (d,) inverse cell width per dim (0: dim unused)
    gdims: torch.Tensor  # (g,) int32 dims interleaved into the Morton code
    r2: torch.Tensor  # () f32 largest squared norm over valid rows
    n_valid: torch.Tensor  # () int32 number of valid rows

    @property
    def tile(self) -> int:
        return self.pts.shape[0] // self.tile_lo.shape[0]


@dataclasses.dataclass(frozen=True)
class GridViews:
    """A set of query blocks' tile visit lists: ``order[b]`` the tiles in
    ascending lower bound, ``lbs[b]`` those bounds (slack subtracted), each
    block ``block`` query rows."""

    order: torch.Tensor  # (NB, NT) int32
    lbs: torch.Tensor  # (NB, NT) f32
    block: int


def _slack(dim: int, r2a: torch.Tensor, r2b: torch.Tensor) -> torch.Tensor:
    """Conservative absolute error budget of computed SQUARED distances
    and box bounds at magnitude r2a + r2b: a forward analysis of
    ``(xx + yy) - 2·xy`` gives ~(2d+4)·eps·(r2a + r2b); 64·(d+8) leaves
    more than 10× headroom.  Over-estimating only costs tile visits."""
    return (64.0 * (dim + 8) * _EPS32) * (r2a.float() + r2b.float()) + 1e-30


def morton_codes(x: torch.Tensor, lo: torch.Tensor, inv_w: torch.Tensor, gdims: torch.Tensor) -> torch.Tensor:
    """Interleaved grid codes: the ``gdims`` columns of ``x`` quantised to
    ``2**_BITS`` cells each and bit-interleaved.  A visit-order heuristic
    only: no result depends on it."""
    cells = float(1 << _BITS)
    q = torch.clamp(torch.floor((x.float() - lo[None, :]) * inv_w[None, :]), 0.0, cells - 1.0).to(torch.int32)
    qg = q[:, gdims.long()]  # (n, g)
    g = qg.shape[1]
    b = torch.arange(_BITS, dtype=torch.int32, device=x.device)
    # bit b of dim k goes to position b·g + k; the positions are distinct, so the sum is the OR
    at = b[None, :] * g + torch.arange(g, dtype=torch.int32, device=x.device)[:, None]  # (g, BITS)
    return (((qg[:, :, None] >> b) & 1) << at).sum((1, 2), dtype=torch.int32)


def tile_gap_sq(blo, bhi, tlo, thi) -> torch.Tensor:
    """Squared-distance lower bound between query boxes (blo, bhi), (..., d),
    and every tile box, (NT, d): the per-dim gap ``max(tlo - bhi, blo - thi,
    0)``, squared and summed, (..., NT).  Empty boxes (lo = +inf, hi = -inf)
    give +inf."""
    gap = torch.clamp_min(torch.maximum(tlo - bhi[..., None, :], blo[..., None, :] - thi), 0.0)
    return (gap * gap).sum(-1)


def build_grid(pts: torch.Tensor, valid: torch.Tensor, tile: int = DEFAULT_TILE) -> GridIndex:
    """Bucket ``pts`` rows into Morton-ordered tiles of ``tile`` rows on
    their device.  ``valid`` masks the real rows: the others are excluded
    from every candidate set and from the quantisation frame.  The row
    count must be a multiple of the (clamped) tile: the callers' power-of-
    two buckets are."""
    if pts.dim() != 2 or valid.shape != (pts.shape[0],):
        raise ValueError(f"build_grid wants (L, d) and (L,), got {tuple(pts.shape)} and {tuple(valid.shape)}")
    pts = pts.float().contiguous()
    valid = valid.to(device=pts.device, dtype=torch.bool).contiguous()
    Lp, d = pts.shape
    T = min(int(tile), Lp)
    if T < 1 or Lp % T:
        raise ValueError(f"build_grid needs a row count that the tile divides, got {Lp} rows and tile {T}")
    inf = float("inf")
    vlo = torch.where(valid[:, None], pts, inf).amin(0)
    vhi = torch.where(valid[:, None], pts, -inf).amax(0)
    vlo = torch.where(torch.isfinite(vlo), vlo, 0.0)
    vhi = torch.where(torch.isfinite(vhi), vhi, 0.0)
    rng = vhi - vlo
    inv_w = torch.where(rng > 0, float(1 << _BITS) / rng, 0.0)
    # interleave the widest dims (stable: range ties break by dim index)
    gdims = torch.argsort(-rng, stable=True)[: min(d, _MAX_GDIMS)].to(torch.int32)
    code = morton_codes(pts, vlo, inv_w, gdims)
    code = torch.where(valid, code, _INT32_MAX)  # invalid rows last
    perm = torch.argsort(code, stable=True)
    pts_s = pts[perm].contiguous()
    valid_s = valid[perm].contiguous()
    NT = Lp // T
    p3 = pts_s.view(NT, T, d)
    v3 = valid_s.view(NT, T, 1)
    sq = (pts_s * pts_s).sum(-1)
    return GridIndex(
        pts=pts_s, orig=perm.to(torch.int32), valid=valid_s,
        tile_lo=torch.where(v3, p3, inf).amin(1), tile_hi=torch.where(v3, p3, -inf).amax(1),
        lo=vlo, inv_w=inv_w, gdims=gdims, r2=torch.where(valid_s, sq, 0.0).amax(),
        n_valid=valid.sum(dtype=torch.int32),
    )


def _lower_bounds(blo, bhi, grid: GridIndex) -> torch.Tensor:
    """(NB, NT) squared-distance lower bounds between each block box and
    each tile box, in chunks of blocks so no (NB, NT, d) tensor grows past
    ``_LB_CHUNK`` floats."""
    NB, d = blo.shape
    NT = grid.tile_lo.shape[0]
    step = max(1, _LB_CHUNK // max(NT * d, 1))
    return torch.cat([tile_gap_sq(blo[b0 : b0 + step], bhi[b0 : b0 + step], grid.tile_lo, grid.tile_hi)
                      for b0 in range(0, NB, step)])


def _sorted_views(lb: torch.Tensor, block: int) -> GridViews:
    order = torch.argsort(lb, dim=1, stable=True)
    return GridViews(order=order.to(torch.int32).contiguous(), lbs=torch.gather(lb, 1, order).contiguous(),
                     block=block)


def _block_views(grid: GridIndex, block: int = DEFAULT_BLOCK) -> GridViews:
    """The table's own rows as query blocks (Eq. 6 and Borůvka): blocks of
    ``min(block, Lp)`` sorted rows, each with its tiles in ascending lower
    bound in DISTANCE space, slack already subtracted."""
    Lp, d = grid.pts.shape
    bn = min(int(block), Lp)
    NB = Lp // bn
    xb = grid.pts.view(NB, bn, d)
    xv = grid.valid.view(NB, bn, 1)
    blo = torch.where(xv, xb, float("inf")).amin(1)
    bhi = torch.where(xv, xb, float("-inf")).amax(1)
    lb_sq = _lower_bounds(blo, bhi, grid)
    lb_d = torch.sqrt(torch.clamp_min(lb_sq - _slack(d, grid.r2, grid.r2), 0.0))
    return _sorted_views(torch.where(torch.isfinite(lb_sq), lb_d, float("inf")), bn)


def _query_views(grid: GridIndex, x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Morton-sort the queries in the grid's frame and cut them into
    blocks of ``block`` rows (the last one ragged): returns the sorted
    queries, the permutation, and each block's tiles in ascending lower
    bound in SQUARED space, ``lb_sq - slack``."""
    B, d = x.shape
    qperm = torch.argsort(morton_codes(x, grid.lo, grid.inv_w, grid.gdims), stable=True)
    xs = x[qperm].contiguous()
    NB = -(-B // block)
    # the ragged block's box is over its real rows: pad with copies of the last row
    xp = torch.cat([xs, xs[-1:].expand(NB * block - B, d)]).view(NB, block, d)
    lb = _lower_bounds(xp.amin(1), xp.amax(1), grid)
    slack = _slack(d, (xs * xs).sum(-1).amax(), grid.r2)
    return xs, qperm, _sorted_views(lb - slack, block)


def track_visits(on: bool, device=None) -> None:
    """Start (zeroed) or stop counting the kernels' row-tile visits on the
    card: each visit of a tile adds the live rows of the block that visit it
    (both kernels of a search count under its name: ``grid_assign``,
    ``grid_core_distances``, ``grid_round_minima``), and every kernel keeps
    the most tiles one CTA visited (``grid_assign_longest``,
    ``grid_core_longest``, ``grid_round_longest``).  ``visit_counts()``
    reads them (a host sync): for measurement only."""
    global _visits
    _visits = torch.zeros(len(_SLOTS), dtype=torch.int64, device=device) if on else None


def visit_counts() -> dict:
    """{slot: count} for the six slots of ``_SLOTS`` while counting is on
    (``grid_assign``, ``grid_assign_longest``, ``grid_core_distances``,
    ``grid_core_longest``, ``grid_round_minima``, ``grid_round_longest``),
    else {}."""
    if _visits is None:
        return {}
    return dict(zip(_SLOTS, (int(v) for v in _visits.cpu())))


def _visit_ptr(slot: str, device):
    """The counter of ``slot`` (the kernel writes its longest walk at the
    next slot), or None while counting is off or on another device."""
    if _visits is None or _visits.device != device:
        return None
    return _visits[_SLOTS.index(slot):].data_ptr()


def _checked_grid(grid: GridIndex, what: str, *tensors) -> bool:
    """Validate the grid and the per-row ``tensors`` that go with it; True
    for the card, False for the CPU."""
    Lp, d = grid.pts.shape
    if (grid.pts.dtype != torch.float32 or grid.orig.dtype != torch.int32 or grid.valid.dtype != torch.bool
            or grid.orig.shape != (Lp,) or grid.valid.shape != (Lp,)
            or not all(t.is_contiguous() for t in (grid.pts, grid.orig, grid.valid))):
        raise ValueError(f"{what}: malformed grid (pts {tuple(grid.pts.shape)} {grid.pts.dtype})")
    if any(t.device != grid.pts.device for t in (grid.orig, grid.valid, *tensors)):
        raise ValueError(f"{what}: inputs on another device than the grid's {grid.pts.device}")
    if Lp * Lp >= 2**31 - 1:
        raise ValueError(f"{what} takes Lp <= 46340 (int32 edge ids and indices), got {Lp}")
    if grid.tile > 32:
        raise ValueError(f"{what} kernels take tiles of at most 32 rows, got {grid.tile}")
    dev = grid.pts.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return True


def _views_ok(grid: GridIndex, views: GridViews, n_rows: int, what: str) -> None:
    NT = grid.tile_lo.shape[0]
    NB = -(-n_rows // views.block)
    if (views.order.dtype != torch.int32 or views.lbs.dtype != torch.float32
            or not (views.order.is_contiguous() and views.lbs.is_contiguous())
            or views.order.device != grid.pts.device or views.lbs.device != grid.pts.device):
        raise ValueError(f"{what}: visit lists must be contiguous int32 / float32 on {grid.pts.device}")
    if views.block != DEFAULT_BLOCK and NB != 1:
        raise ValueError(f"{what} kernels take blocks of {DEFAULT_BLOCK} rows, got {views.block}")
    if views.order.shape != (NB, NT) or views.lbs.shape != (NB, NT):
        raise ValueError(f"{what}: visit lists {tuple(views.order.shape)} for {NB} blocks x {NT} tiles")


def grid_assign(grid: GridIndex, x: torch.Tensor, cluster: int = ASSIGN_CLUSTER):
    """(B, d) f32 queries → (idx int32 (B,), dist f32 (B,)): the nearest
    VALID rep by (clamped squared distance, original index) and the square
    root of that distance, bitwise the dense assign kernel on the valid
    rows.  ``idx`` is the original row, ``Lp`` where the table has no valid
    row at all (``csrc/grid_assign.cu``).  ``cluster``: CTAs a query block on
    the card, 1, 2, 4 or 8; the bits do not depend on it."""
    if cluster not in CLUSTERS:
        raise ValueError(f"grid_assign: cluster must be 1, 2, 4 or 8, got {cluster}")
    return _assign("grid_assign", "repro_grid_assign_tiles_f32", (cluster,), grid, x)


def grid_assign_v1(grid: GridIndex, x: torch.Tensor):
    """``grid_assign`` through its first kernel (``csrc/grid.cu``), the
    redesign's bitwise oracle: no path calls it."""
    return _assign("grid_assign_v1", "repro_grid_assign_f32", (), grid, x)


def _assign(name: str, entry: str, extra: tuple, grid: GridIndex, x: torch.Tensor):
    """``grid_assign``'s checks, the queries' Morton sort and visit lists,
    the search (``_assign_sorted``) and the scatter back to the queries'
    order."""
    _checked_grid(grid, name, x)
    x = x.float().contiguous()
    if x.dim() != 2 or x.shape[1] != grid.pts.shape[1] or x.device != grid.pts.device:
        raise ValueError(f"{name} wants (B, {grid.pts.shape[1]}) queries on {grid.pts.device}, "
                         f"got {tuple(x.shape)} on {x.device}")
    B = x.shape[0]
    if B == 0:
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                torch.empty(0, dtype=torch.float32, device=x.device))
    xs, qperm, views = _query_views(grid, x)
    idx_s, dist_s = _assign_sorted(name, entry, extra, grid, xs, views)
    idx = torch.empty_like(idx_s)
    dist = torch.empty_like(dist_s)
    idx[qperm] = idx_s
    dist[qperm] = dist_s
    return idx, dist


def _assign_sorted(name: str, entry: str, extra: tuple, grid: GridIndex, xs: torch.Tensor, views: GridViews):
    """``grid_assign``'s search over queries already in Morton order, with
    their blocks' visit lists: (idx, dist) in that order; its plain version
    on the CPU, and on the card the launch of C entry ``entry``, which takes
    the arguments ``extra`` before its outputs."""
    B = xs.shape[0]
    if grid.pts.device.type == "cpu":
        idx_s, sq_s = _ref.grid_assign(grid, xs, views)
        return idx_s, torch.sqrt(sq_s)
    _views_ok(grid, views, B, name)
    idx_s = torch.empty(B, dtype=torch.int32, device=xs.device)
    dist_s = torch.empty(B, dtype=torch.float32, device=xs.device)
    _launch(name, entry, xs.device,
            xs.data_ptr(), B, *_grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(),
            views.order.shape[1], *extra, idx_s.data_ptr(), dist_s.data_ptr(), _visit_ptr("grid_assign", xs.device))
    return idx_s, dist_s


def _block_range(grid: GridIndex, views: GridViews, blocks) -> tuple[int, int, int]:
    """(b0, b1, rows) of a query-block range, all blocks by default; rows
    is the number of table rows the range covers."""
    NB, bn = views.order.shape[0], views.block
    b0, b1 = (0, NB) if blocks is None else (int(blocks[0]), int(blocks[1]))
    if not 0 <= b0 <= b1 <= NB:
        raise ValueError(f"query blocks [{b0}, {b1}) outside the grid's {NB}")
    return b0, b1, min(b1 * bn, grid.pts.shape[0]) - b0 * bn


def _scatter(grid: GridIndex, *sorted_vals):
    """Sorted-order values of every row → original row order."""
    rows = grid.orig.long()
    out = tuple(torch.empty_like(v) for v in sorted_vals)
    for o, v in zip(out, sorted_vals):
        o[rows] = v
    return out


def grid_core_distances(grid: GridIndex, n_b, extent, min_pts: int, dim: int,
                        views: GridViews | None = None, blocks=None, cluster: int = CD_CLUSTER) -> torch.Tensor:
    """Eq. 6 bubble core distances over the grid: ``n_b``/``extent`` (Lp,)
    in ORIGINAL row order, the result too (0 on invalid rows).  Bitwise the
    dense Eq. 6 kernels on the valid rows, for a pre-clamped ``min_pts``
    (at most the valid rows' mass).  With ``blocks = (b0, b1)`` only those
    query blocks run, and the result is their rows' values in SORTED
    order (``csrc/grid_cd.cu``).  ``cluster``: CTAs a query block on the
    card, 1, 2, 4 or 8 (past k = 16 at most that many: the warp-select route
    gives them its passes first and splits a walk over at most 2); the bits
    do not depend on it."""
    if cluster not in CLUSTERS:
        raise ValueError(f"grid_core_distances: cluster must be 1, 2, 4 or 8, got {cluster}")
    return _core_distances("grid_core_distances", "repro_grid_cd_tiles_f32", (cluster,), grid, n_b, extent, min_pts,
                           dim, views, blocks)


def grid_core_distances_v1(grid: GridIndex, n_b, extent, min_pts: int, dim: int,
                           views: GridViews | None = None, blocks=None) -> torch.Tensor:
    """``grid_core_distances`` through its first kernel (``csrc/grid.cu``),
    the redesign's bitwise oracle: no path calls it."""
    return _core_distances("grid_core_distances_v1", "repro_grid_core_distances_f32", (), grid, n_b, extent,
                           min_pts, dim, views, blocks)


def _core_distances(name: str, entry: str, extra: tuple, grid: GridIndex, n_b, extent, min_pts: int, dim: int,
                    views: GridViews | None, blocks) -> torch.Tensor:
    """The Eq. 6 search's checks, its plain version on the CPU, and the
    launch of C entry ``entry``, which takes the arguments ``extra`` before
    its output."""
    on_card = _checked_grid(grid, name, n_b, extent)
    Lp, d = grid.pts.shape
    n_b, extent = n_b.float().contiguous(), extent.float().contiguous()
    if n_b.shape != (Lp,) or extent.shape != (Lp,):
        raise ValueError(f"{name} wants ({Lp},) masses and extents, got {tuple(n_b.shape)} and "
                         f"{tuple(extent.shape)}")
    min_pts, dim = int(min_pts), int(dim)
    if min_pts < 1 or dim < 1:
        raise ValueError(f"min_pts and dim must be >= 1, got {min_pts}, {dim}")
    views = _block_views(grid) if views is None else views
    _views_ok(grid, views, Lp, name)
    b0, b1, rows = _block_range(grid, views, blocks)
    if not on_card:
        return _ref.grid_core_distances(grid, views, n_b, extent, min_pts, dim, blocks=blocks)
    out = torch.empty(rows, dtype=torch.float32, device=grid.pts.device)
    if rows:
        _launch(name, entry, out.device,
                *_grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), views.order.shape[1],
                n_b.data_ptr(), extent.data_ptr(), min(min_pts, Lp), min_pts, dim, b0, b1 - b0, *extra,
                out.data_ptr(), _visit_ptr("grid_core_distances", out.device))
    return out if blocks is not None else _scatter(grid, out)[0]


def _replicas(grid: GridIndex, views: GridViews, mesh) -> list:
    """(grid, views) on each shard's device, copied once per distinct
    device (non-blocking peer copies; none on the lead)."""
    names = [f.name for f in dataclasses.fields(GridIndex)]
    copies = on_devices(mesh, *(getattr(grid, n) for n in names), views.order, views.lbs)
    return [(GridIndex(**dict(zip(names, copies[dev]))),
             GridViews(order=copies[dev][-2], lbs=copies[dev][-1], block=views.block)) for dev in mesh.devices]


def grid_core_distances_shard(grid: GridIndex, n_b, extent, min_pts: int, dim: int, mesh,
                              views: GridViews | None = None) -> torch.Tensor:
    """``grid_core_distances`` with the query blocks split over ``mesh``:
    shard i runs its contiguous range of ⌈NB/k⌉ blocks (the last ranges
    shorter or empty) on its own device, the ranges' sorted-order values
    are gathered on the lead device (the grid's) in block order, and one
    scatter puts them back in original row order: bitwise
    ``grid_core_distances`` on any mesh."""
    views = _block_views(grid) if views is None else views
    cols = on_devices(mesh, n_b, extent)
    parts = [grid_core_distances(g, *cols[dev], min_pts, dim, v, blocks=blocks)
             for (g, v), dev, blocks in zip(_replicas(grid, views, mesh), mesh.devices,
                                            shard_ranges(views.order.shape[0], len(mesh.devices)))]
    return _scatter(grid, gather(parts, grid.pts.device))[0]


def grid_round_minima(grid: GridIndex, views: GridViews, cd, labels, hopeless, blocks=None,
                      cluster: int = ROUND_CLUSTER):
    """One Borůvka round's search: per row (ORIGINAL order), the lightest
    edge to another component by (w, canonical edge id), with
    ``w = max(d, cd_r, cd_c)`` and ``eid = min(o_r, o_c)·n + max(o_r, o_c)``.
    Invalid and ``hopeless`` rows find nothing: (+inf, int32 max).  Returns
    (row_w f32 (n,), row_eid int32 (n,)); with ``blocks = (b0, b1)`` only
    those query blocks run, and the two are their rows' in SORTED order
    (``csrc/grid_round.cu``).  ``cluster``: CTAs a query block on the card,
    1, 2, 4 or 8; the bits do not depend on it."""
    if cluster not in CLUSTERS:
        raise ValueError(f"grid_round_minima: cluster must be 1, 2, 4 or 8, got {cluster}")
    return _round_minima("grid_round_minima", "repro_grid_round_tiles_f32", (cluster,), grid, views, cd, labels,
                         hopeless, blocks)


def grid_round_minima_v1(grid: GridIndex, views: GridViews, cd, labels, hopeless, blocks=None):
    """``grid_round_minima`` through its first kernel (``csrc/grid.cu``),
    the redesign's bitwise oracle: no path calls it."""
    return _round_minima("grid_round_minima_v1", "repro_grid_round_minima_f32", (), grid, views, cd, labels,
                         hopeless, blocks)


def _round_minima(name: str, entry: str, extra: tuple, grid: GridIndex, views: GridViews, cd, labels, hopeless,
                  blocks):
    """The round's checks, its plain version on the CPU, and the launch of
    C entry ``entry``, which takes the arguments ``extra`` before its
    outputs."""
    on_card = _checked_grid(grid, name, cd, labels, hopeless)
    n = grid.pts.shape[0]
    cd = cd.float().contiguous()
    labels = labels.long().contiguous()
    hopeless = hopeless.bool().contiguous()
    if cd.shape != (n,) or labels.shape != (n,) or hopeless.shape != (n,):
        raise ValueError(f"{name} wants ({n},) cd, labels and hopeless")
    _views_ok(grid, views, n, name)
    b0, b1, rows = _block_range(grid, views, blocks)
    if not on_card:
        return _ref.grid_round_minima(grid, views, cd, labels, hopeless, blocks=blocks)
    w_s = torch.empty(rows, dtype=torch.float32, device=cd.device)
    e_s = torch.empty(rows, dtype=torch.int32, device=cd.device)
    if rows:
        _launch(name, entry, cd.device,
                *_grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), views.order.shape[1],
                cd.data_ptr(), labels.data_ptr(), hopeless.data_ptr(), b0, b1 - b0, *extra, w_s.data_ptr(),
                e_s.data_ptr(), _visit_ptr("grid_round_minima", cd.device))
    return (w_s, e_s) if blocks is not None else _scatter(grid, w_s, e_s)


def _grid_args(grid: GridIndex):
    Lp, d = grid.pts.shape
    return (grid.pts.data_ptr(), grid.orig.data_ptr(), grid.valid.data_ptr(), Lp, d, grid.tile)


def _launch(name: str, entry: str, device, *args) -> None:
    lib = _build.load()
    with torch.cuda.device(device):
        code = getattr(lib, entry)(*args, _build.current_stream(device))
    _build.check(code, name)
    launches[name] += 1
