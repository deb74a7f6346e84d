"""The kernel API and the offline pass.

The PyTorch counterpart of the JAX package's ``repro/kernels/ops.py``:

* the point-level functions ``pairwise_sqdist``, ``mutual_reachability``,
  ``knn`` and ``core_distances`` (Def. 1, self-inclusive), the
  model-layout GQA ``flash_attention``, and the bubble-level ``assign`` /
  ``bubble_core_distances`` / ``bubble_mutual_reachability``, each over a
  kernel wrapper: CUDA kernel for a CUDA tensor, plain version for a CPU
  tensor;
* ``bubble_table``: the host f64 derivation of Eqs. 3–4;
* ``offline_recluster_from_table``: ``_prepare_table`` (host centring,
  the ``min_pts`` clamp and the power-of-two pad), then
  ``_offline_pipeline`` on the device — Eq. 6 core distances → Eq. 7 W →
  Borůvka → single-linkage → condense → extract — and one unwrap into an
  ``OfflineClusterResult``.  Each stage runs through a ``stage`` hook, so
  a caller can time the very calls the engine makes (chip_smoke.py);
* ``offline_recluster_from_device_table``: the same pass straight from the
  device-online flat leaf-CF table (core/bubble_flat.py) — the populated
  slots compacted in ascending order and the bubble table derived on the
  device (``_device_table_prepare``), no upload of the summary;
* ``incremental_update`` / ``incremental_recluster``: the exact-dynamic
  path (core/dynamic_torch.py) — one update step over a ``DynState``, and
  labels straight from the maintained point-level MST through the
  hierarchy stages alone (no Eq. 6, no W, no Borůvka), one host read;
* ``ClusterBackend``: the device, resolved once by the engine, and the
  ``spatial_index`` switch.

With ``spatial_index=True`` (DESIGN.md §10) assignment, Eq. 6 and Borůvka
go through the Morton grid of ``kernels/grid.py`` instead: tile-pruned
exact searches, bitwise the dense kernels on the valid rows, and the
offline pass never builds the (Lp, Lp) W unless ``return_w`` asks for it.

With ``mesh=`` (DESIGN.md §12; a ``launch/mesh.py::Mesh``, ``True`` or a
list of devices, one process) both offline passes run their O(L²) heart
in row strips, one per shard on its own device (``_sharded_mst_stage``):
Eq. 6 over the shard's rows, one gather of the core distances on the lead
device, the Eq. 7 strip, and Borůvka's per-row minima per strip with one
gather a round; the round tail and the hierarchy run on the lead.  Each
strip kernel computes every element as the whole launch does, so the
sharded pass is bit for bit the unsharded one on any mesh, and no shard
holds more than an (Lp/k, Lp) strip of W.  ``bubble_mutual_reachability_
sharded`` is the same decomposition of the d_m matrix.

There is no feature padding to 128 lanes (a TPU tiling) and no L or m
cap on the Eq. 6 and knn kernels (TPU VMEM sizings): the CUDA kernels
stream over the table.  Nor is there a cap on d, on k or on ``min_pts``:
above the warp-select core's d <= 128 and k <= 1024, knn and the Eq. 6
kernel take their strip route (``kernels/knn.py``, ``kernels/bubble_cd.py``),
and the assign and tile kernels walk d in slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.cf import cf_extent, cf_rep
from ..core.hdbscan import CondensedTree
from ..core.hierarchy import hierarchy_fixed
from ..core.mst import boruvka, boruvka_grid, boruvka_grid_shard, boruvka_shard
from ..device import resolve_device, to_device, to_numpy
from ..launch.mesh import gather, on_devices, resolve_mesh, shard_ranges
from . import assign as _assign_k
from . import bubble_cd as _bcd_k
from . import flash_attention as _fa_k
from . import grid as _grid_k
from . import hierarchy as _h_k
from . import knn as _knn_k
from . import mutual_reach as _mr_k
from . import pairwise as _pw_k

__all__ = [
    "pairwise_sqdist",
    "mutual_reachability",
    "knn",
    "core_distances",
    "flash_attention",
    "FlashAttentionFn",
    "assign",
    "bubble_core_distances",
    "bubble_mutual_reachability",
    "bubble_mutual_reachability_sharded",
    "bubble_table",
    "OfflineClusterResult",
    "offline_recluster_from_table",
    "offline_recluster_from_device_table",
    "incremental_update",
    "incremental_recluster",
    "ClusterBackend",
    "get_backend",
]

# Padding coordinate for size-bucketed bubble tables: far from any data
# (so padded bubbles are never a nearest neighbour) but small enough that
# its squared distances stay finite in f32 (1e12·d ≪ 3.4e38).
_PAD_COORD = 1e6


def _pow2_rows(n: int) -> int:
    return max(8, 1 << (max(n - 1, 1)).bit_length())


def _contig_f32(*ts):
    return tuple(t.float().contiguous() for t in ts)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``."""
    return _pw_k.pairwise_sqdist(*_contig_f32(x, y))


def mutual_reachability(x, y, cd_x, cd_y, zero_diag: bool = True) -> torch.Tensor:
    """Point-level Eq. 7 (Def. 2): ``max(d(x, y), cd_x, cd_y)`` as an
    (n, m) matrix, the global diagonal at 0 with ``zero_diag``."""
    return _mr_k.mutual_reachability(*_contig_f32(x, y, cd_x, cd_y), zero_diag=zero_diag)


def knn(x: torch.Tensor, y: torch.Tensor, k: int):
    """k nearest distances (ascending) and int32 indices into y for each
    x row, with ``k = min(k, m)``.  Rows of x that also appear in y return
    themselves at distance 0 (the Def. 1 convention counts the point
    itself inside ``min_pts``)."""
    return _knn_k.knn(*_contig_f32(x, y), min(int(k), y.shape[0]))


def core_distances(x: torch.Tensor, min_pts: int) -> torch.Tensor:
    """cd(p) per Def. 1 (self-inclusive): the distance to the
    ``min(min_pts, n)``-th nearest row, the row itself first."""
    d, _ = knn(x, x, min_pts)
    return d[:, min(int(min_pts), x.shape[0]) - 1].contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward kernel, over model-layout
    tensors: the forward kernel also writes each row's log-sum-exp, and
    q, k, v, the output, the log-sum-exp and the positions are saved for
    ``kernels/flash_attention.py::flash_attention_backward``.  The
    gradients come back in the model layout (B, S, heads, Dh), contiguous.
    ``flash_attention`` takes it for CUDA tensors when grad is enabled and
    q, k or v requires it; on CPU tensors both wrappers take their plain
    versions (the tests call it there directly)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window):
        B, Sq, H, _ = q.shape
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        _fa_k.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qpos, kpos, causal=causal,
                              window=window, out=out.transpose(1, 2), lse=lse)
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        dout = dout if dout.stride(-1) == 1 else dout.contiguous()
        grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v)]
        _fa_k.flash_attention_backward(*(t.transpose(1, 2) for t in (q, k, v, out)), lse, dout.transpose(1, 2),
                                       qpos, kpos, causal=ctx.causal, window=ctx.window,
                                       dq=grads[0].transpose(1, 2), dk=grads[1].transpose(1, 2),
                                       dv=grads[2].transpose(1, 2))
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, qpos=None, kpos=None, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Batched GQA attention over model-layout tensors.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh), f32 or bf16.  Positions
    default to ``arange``; 1-D positions broadcast to (B, S).  Query head
    h attends with kv head h // (H / KV), batch × heads fold into the
    kernel's grid, and the kernel reads and writes the model layout
    through strides: nothing is copied per head.  Returns (B, Sq, H, Dh)
    in q's dtype.

    Differentiable: on CUDA tensors with grad enabled and q, k or v
    requiring it, the call goes through ``FlashAttentionFn`` (the forward
    kernel with the log-sum-exp, the backward kernel); an inference call
    launches the forward kernel alone, as before.  On CPU tensors autograd
    runs through the plain version."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    dev = q.device

    def positions(p, S):
        p = torch.arange(S, device=dev) if p is None else torch.as_tensor(p, device=dev)
        return torch.broadcast_to(p.to(torch.int32), (B, S)).contiguous()

    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if dev.type == "cuda" and torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, positions(qpos, Sq), positions(kpos, Sk), causal, window)
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=dev)
    _fa_k.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), positions(qpos, Sq),
        positions(kpos, Sk), causal=causal, window=window, out=out.transpose(1, 2))
    return out


def assign(x: torch.Tensor, reps: torch.Tensor, with_dist: bool = False,
           spatial_index: bool = False, valid=None):
    """Nearest-representative index per row (lowest index on ties); with
    ``with_dist=True`` also the euclidean distance to it.

    ``spatial_index=True`` routes through the grid (``kernels/grid.py``):
    the reps padded to a power of two with far invalid rows, one grid,
    ``grid_assign``.  ``valid`` (spatial only) masks rep rows out of the
    candidate set; where no row is valid the index is L − 1."""
    x, reps = _contig_f32(x, reps)
    if not spatial_index:
        return _assign_k.assign(x, reps, with_dist=with_dist)
    L, d = reps.shape
    valid = (torch.ones(L, dtype=torch.bool, device=reps.device) if valid is None
             else torch.as_tensor(valid, device=reps.device).bool())
    Lp = _pow2_rows(L)
    if Lp != L:
        reps = torch.cat([reps, reps.new_full((Lp - L, d), _PAD_COORD)])
        valid = torch.cat([valid, valid.new_zeros(Lp - L)])
    idx, dist = _grid_k.grid_assign(_grid_k.build_grid(reps, valid), x)
    idx = torch.clamp_max(idx, L - 1)
    return (idx, dist) if with_dist else idx


def _clamp_min_pts(min_pts: int, total_mass: float) -> int:
    # Eq. 6's scan can never reach min_pts beyond the represented mass
    # (the kernel's min_pts-entry prefix relies on it)
    return max(1, min(int(min_pts), int(total_mass)))


def _grid_table(rep, n_valid: int):
    """The grid over a padded table whose first ``n_valid`` rows are real,
    and its own rows' visit lists."""
    valid = torch.arange(rep.shape[0], device=rep.device) < n_valid
    grid = _grid_k.build_grid(rep, valid)
    return grid, _grid_k._block_views(grid)


def bubble_core_distances(rep, n_b, extent, min_pts: int, spatial_index: bool = False) -> torch.Tensor:
    """Eq. 6 bubble core distances, ``min_pts`` clamped to the mass; with
    ``spatial_index`` through the grid (the table padded to a power of two
    with far, massless, invalid rows)."""
    rep, n_b, extent = _contig_f32(rep, n_b, extent)
    min_pts = _clamp_min_pts(min_pts, float(n_b.sum()))
    L, d = rep.shape
    if not spatial_index:
        return _bcd_k.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=d)
    pad = _pow2_rows(L) - L
    rep = torch.cat([rep, rep.new_full((pad, d), _PAD_COORD)])
    n_b, extent = (torch.cat([t, t.new_zeros(pad)]) for t in (n_b, extent))
    grid, views = _grid_table(rep, L)
    return _grid_k.grid_core_distances(grid, n_b, extent, min_pts, d, views)[:L]


def bubble_mutual_reachability(rep, n_b, extent, min_pts: int, spatial_index: bool = False) -> torch.Tensor:
    """The (L, L) bubble d_m matrix (Eqs. 6–7), diagonal 0; with
    ``spatial_index`` the core distances come from the grid (the matrix
    itself is dense by definition)."""
    cd = bubble_core_distances(rep, n_b, extent, min_pts, spatial_index)
    (rep,) = _contig_f32(rep)
    return _mr_k.mutual_reachability(rep, rep, cd, cd, zero_diag=True)


def _run_stage(name: str, fn, *args, **kw):
    return fn(*args, **kw)


def _sharded_core_distances(tables, ranges, min_pts: int, lead) -> torch.Tensor:
    """Eq. 6 over each shard's rows on its device (``tables[i]`` the shard's
    (rep, n_b, extent)), gathered on the lead in row order."""
    return gather([_bcd_k.bubble_core_distances(rep, nb, ext, min_pts=min_pts, dim=rep.shape[1], rows=(a, b))
                    for (rep, nb, ext), (a, b) in zip(tables, ranges)], lead)


def _sharded_mutual_reach(tables, ranges, cds, n_valid) -> list:
    """Each shard's (b − a, Lp) Eq. 7 strip on its device, its rows global
    (``row0 = a``): diagonal 0, rows and columns ≥ ``n_valid`` at +inf.
    ``cds`` maps each device to its copy of the gathered core distances."""
    strips = []
    for (rep, _, _), (a, b) in zip(tables, ranges):
        cd = cds[rep.device][0]
        strips.append(_mr_k.mutual_reachability(rep[a:b], rep, cd[a:b], cd, zero_diag=True, n_valid=n_valid,
                                                row0=a))
    return strips


def _dense_shards(rep, n_b, extent, n_valid, min_pts: int, mesh, stage=_run_stage):
    """Eq. 6 per shard → the core distances gathered on the lead and copied
    to every shard → each shard's Eq. 7 strip.  Returns the strips and the
    row ranges: shard i holds rows [i·⌈Lp/k⌉, ...), the last strips shorter
    or empty.

    On the CPU (the plain versions) Eq. 6 and W are each computed once,
    whole, on the lead and the strips are slices of W: a CPU BLAS blocks a
    strip's product ``x @ y.T``, and the vectorised ``pow``/``sqrt`` the
    tail of a shorter row, otherwise than the whole call, so a strip
    computed on its own may differ from the same rows in the last bit.
    The CUDA kernels compute every element the same way in any launch, so
    on the card each shard computes its own strip."""
    lead = rep.device
    ranges = shard_ranges(rep.shape[0], len(mesh.devices))
    if lead.type == "cpu":
        cd = stage("bubble_cd", _bcd_k.bubble_core_distances, rep, n_b, extent, min_pts=min_pts, dim=rep.shape[1])
        W = stage("mutual_reach", _mr_k.mutual_reachability, rep, rep, cd, cd, zero_diag=True, n_valid=n_valid)
        return [W[a:b] for a, b in ranges], ranges
    copies = on_devices(mesh, rep, n_b, extent)
    tables = [copies[dev] for dev in mesh.devices]
    cd = stage("bubble_cd", _sharded_core_distances, tables, ranges, min_pts, lead)
    return stage("mutual_reach", _sharded_mutual_reach, tables, ranges, on_devices(mesh, cd), n_valid), ranges


def _sharded_mst_stage(rep, n_b, extent, n_valid: int, min_pts: int, mesh, spatial: bool, stage=_run_stage):
    """The offline pass's O(L²) heart over the mesh (DESIGN.md §12): Eq. 6
    core distances, Eq. 7 weights and Borůvka's per-row minima in row
    strips (or, with ``spatial``, ranges of the grid's query blocks), one
    shard each on its own device; one gather of the core distances and one
    of the row minima a round on the lead device (the table's), where the
    round tail runs.  Returns Borůvka's (Lp,) buffers on the lead, bit for
    bit the unsharded pass's on any mesh."""
    if spatial:
        grid, views = stage("build_grid", _grid_table, rep, n_valid)
        cd = stage("bubble_cd", _grid_k.grid_core_distances_shard, grid, n_b, extent, min_pts, rep.shape[1],
                   mesh, views)
        return stage("boruvka", boruvka_grid_shard, grid, cd, views, mesh)
    strips, ranges = _dense_shards(rep, n_b, extent, n_valid, min_pts, mesh, stage)
    return stage("boruvka", boruvka_shard, strips, [a for a, _ in ranges], rep.shape[0], mesh)


def bubble_mutual_reachability_sharded(rep, n_b, extent, min_pts: int, mesh) -> torch.Tensor:
    """``bubble_mutual_reachability`` with Eq. 6 and the Eq. 7 rows split
    over ``mesh`` (DESIGN.md §12): each shard computes its rows' core
    distances and its (L/k, L) strip on its own device, with one gather of
    the core distances between.  Returns the strips concatenated on the
    lead device (rep's), bit for bit ``bubble_mutual_reachability``."""
    rep, n_b, extent = _contig_f32(rep, n_b, extent)
    mesh = resolve_mesh(mesh, rep.device)
    min_pts = _clamp_min_pts(min_pts, float(n_b.sum()))
    strips, _ = _dense_shards(rep, n_b, extent, None, min_pts, mesh)
    return gather(strips, rep.device)


def bubble_table(LS, SS, N, ids):
    """Host-side f64 bubble derivation: gather the alive-leaf rows and
    apply Eqs. 3–4.  Returns (rep, extent, n, center) — ``center`` is the
    mass-weighted centroid every f32 device call site subtracts."""
    ids = np.asarray(ids)
    LSg = np.asarray(LS, dtype=np.float64)[ids]
    SSg = np.asarray(SS, dtype=np.float64)[ids]
    Ng = np.asarray(N, dtype=np.float64)[ids]
    rep = cf_rep(LSg, Ng)
    extent = cf_extent(LSg, SSg, Ng)
    center = LSg.sum(axis=0) / max(Ng.sum(), 1.0)
    return rep, extent, Ng, center


def _offline_pipeline(rep, n_b, extent, n_valid: int, mcs: float, min_pts: int,
                      method: str = "eom", allow_single: bool = False, *,
                      stage=_run_stage, with_w: bool = False, spatial: bool = False, mesh=None) -> dict:
    """Device offline pass over a size-bucketed, mean-centred bubble table:
    Eq. 6 → (Lp, Lp) W (Eq. 7, pad rows/cols at +inf so they stay isolated
    in the MST) → Borůvka → hierarchy, on a pre-clamped ``min_pts``.  With
    ``spatial`` the pass is "build_grid" → Eq. 6 and Borůvka over the grid
    (pad rows invalid, so isolated) → hierarchy, and W is built only when
    ``with_w`` asks for it.  On ``cuda`` no stage reads the host (the
    hierarchy sweeps are kernels, ``kernels/hierarchy.py``); on the CPU the
    plain EOM loop reads the label count once.  With ``mesh`` (a resolved
    ``Mesh`` led by rep's device) Eq. 6, W and Borůvka's row minima run
    sharded (``_sharded_mst_stage``) and the hierarchy on the lead; W is
    never whole, so ``with_w`` must be off.  Returns the fixed-size
    buffers, with the device W under ``"W"`` when ``with_w``;
    ``stage(name, fn, *args, **kw)`` runs each step."""
    W = None
    if mesh is not None:
        eu, ev, ew, valid = _sharded_mst_stage(rep, n_b, extent, n_valid, min_pts, mesh, spatial, stage)
    elif spatial:
        grid, views = stage("build_grid", _grid_table, rep, n_valid)
        cd = stage("bubble_cd", _grid_k.grid_core_distances, grid, n_b, extent, min_pts, rep.shape[1], views)
        eu, ev, ew, valid = stage("boruvka", boruvka_grid, grid, cd, views)
        W = _mr_k.mutual_reachability(rep, rep, cd, cd, zero_diag=True, n_valid=n_valid) if with_w else None
    else:
        cd = stage("bubble_cd", _bcd_k.bubble_core_distances, rep, n_b, extent,
                   min_pts=min_pts, dim=rep.shape[1])
        W = stage("mutual_reach", _mr_k.mutual_reachability, rep, rep, cd, cd,
                  zero_diag=True, n_valid=n_valid)
        eu, ev, ew, valid = stage("boruvka", boruvka, W)
        if not with_w:
            W = None
    slt = stage("single_linkage", _h_k.single_linkage, eu, ev, ew, valid, n_valid, n_b)
    ct = stage("condense", _h_k.condense, slt, n_b, mcs)
    ex = stage("extract", _h_k.extract, ct, method=method, allow_single_cluster=allow_single)
    out = {
        "eu": eu, "ev": ev, "ew": ew, "valid": valid,
        "labels": ex.labels,
        "stability": ex.stability,
        "selected": ex.selected,
        "point_parent": ct.point_parent,
        "point_lambda": ct.point_lambda,
        "cluster_parent": ct.cluster_parent,
        "cluster_birth": ct.cluster_birth,
        "cluster_weight": ct.cluster_weight,
        "n_labels": ct.n_labels,
    }
    if with_w:
        out["W"] = W
    return out


@dataclasses.dataclass
class OfflineClusterResult:
    """One offline pass: flat labels + the arrays behind them.

    ``labels[k]``'s cluster has stability ``stabilities[labels[k]]`` —
    flat ids are the ascending rank of the selected condensed labels.  The
    condensed tree is in the device layout (label 0 = root; see
    core/hierarchy.py); ``to_condensed()`` re-emits it in the host
    ``CondensedTree`` layout."""

    labels: np.ndarray  # (L,) int64 flat bubble labels, -1 noise
    stabilities: np.ndarray  # (n_clusters,) f64 per selected cluster
    mst: tuple  # (u, v, w) host numpy MST edge arrays
    weights: np.ndarray  # (L,) leaf weights (bubble masses)
    min_cluster_size: float
    point_parent: np.ndarray  # (L,) condensed label per leaf
    point_lambda: np.ndarray  # (L,)
    cluster_parent: np.ndarray  # (K,) condensed label of each label's parent
    cluster_birth: np.ndarray  # (K,)
    cluster_weight: np.ndarray  # (K,)
    selected: np.ndarray  # (K,) bool — flat-extraction winners
    all_stabilities: np.ndarray  # (K,) stability of every condensed label

    @property
    def n_clusters(self) -> int:
        return int(self.stabilities.shape[0])

    @property
    def n_bubbles(self) -> int:
        return int(self.labels.shape[0])

    def to_condensed(self) -> CondensedTree:
        """Device arrays → host ``CondensedTree`` (leaves 0..L-1, cluster
        ids L + device label, root = L)."""
        L = self.n_bubbles
        K = int(self.cluster_parent.shape[0])
        lbl = np.arange(1, K, dtype=np.int64)
        parent = np.concatenate([L + self.cluster_parent[1:], L + self.point_parent])
        child = np.concatenate([L + lbl, np.arange(L, dtype=np.int64)])
        lam = np.concatenate([self.cluster_birth[1:], self.point_lambda])
        w = np.concatenate([self.cluster_weight[1:], self.weights])
        return CondensedTree(
            parent=parent.astype(np.int64),
            child=child.astype(np.int64),
            lambda_val=lam.astype(np.float64),
            child_weight=w.astype(np.float64),
            n_leaves=L,
        )


def _to_host(out: dict) -> dict:
    return dict(zip(out, to_numpy(*out.values())))  # ONE host sync


def _unwrap_result(out: dict, L: int, mcs: float, weights: np.ndarray) -> OfflineClusterResult:
    return _result(_to_host(out), L, mcs, weights)


def _result(out: dict, L: int, mcs: float, weights: np.ndarray) -> OfflineClusterResult:
    """The pipeline's fixed-size host buffers → OfflineClusterResult."""
    keep = out["valid"]
    edges = (
        out["eu"].astype(np.int64)[keep],
        out["ev"].astype(np.int64)[keep],
        out["ew"].astype(np.float64)[keep],
    )
    K = int(out["n_labels"].reshape(()))
    sel = out["selected"][:K]
    all_stab = out["stability"].astype(np.float64)[:K]
    return OfflineClusterResult(
        labels=out["labels"].astype(np.int64)[:L],
        stabilities=all_stab[sel],
        mst=edges,
        weights=weights,
        min_cluster_size=mcs,
        point_parent=out["point_parent"].astype(np.int64)[:L],
        point_lambda=out["point_lambda"].astype(np.float64)[:L],
        cluster_parent=out["cluster_parent"].astype(np.int64)[:K],
        cluster_birth=out["cluster_birth"].astype(np.float64)[:K],
        cluster_weight=out["cluster_weight"].astype(np.float64)[:K],
        selected=sel,
        all_stabilities=all_stab,
    )


def _prepare_table(rep, n_b, extent, min_pts: int, dev: torch.device):
    """Host side of the offline pass: mean-centre in f64 (d_m is
    translation-invariant; the f32 ‖x‖²+‖y‖²−2xy tiles cancel
    catastrophically off-origin), clamp ``min_pts`` to the represented
    mass, pad to a power-of-two bucket with far, massless rows, and move
    the f32 table to ``dev``.  Returns (rep, n_b, extent) on the device,
    the clamped ``min_pts`` and the host f64 masses."""
    rep = np.asarray(rep, dtype=np.float64)
    Ng = np.asarray(n_b, dtype=np.float64)
    extent = np.asarray(extent, dtype=np.float64)
    L = int(rep.shape[0])
    if L > 46340:
        raise ValueError("the offline pass supports L <= 46340 (int32 edge ids)")
    rep = rep - ((Ng @ rep) / max(Ng.sum(), 1.0))[None, :]
    min_pts = _clamp_min_pts(min_pts, Ng.sum())
    pad = _pow2_rows(L) - L
    Ng_p = Ng
    if pad:
        rep = np.concatenate([rep, np.full((pad, rep.shape[1]), _PAD_COORD)])
        Ng_p = np.concatenate([Ng, np.zeros(pad)])
        extent = np.concatenate([extent, np.zeros(pad)])
    table = tuple(torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (rep, Ng_p, extent))
    return table, min_pts, Ng


def offline_recluster_from_table(
    rep, n_b, extent, min_pts: int, min_cluster_size: float | None = None, *,
    device=None, method: str = "eom", allow_single_cluster: bool = False,
    return_w: bool = False, stage=_run_stage, spatial_index: bool = False, mesh=None,
):
    """The streaming engine's offline pass, from a derived bubble table:
    ``_prepare_table`` on the host, the stages on ``device`` (None →
    cuda), and the fixed-size buffers back in one unwrap.

    Args:
      rep, n_b, extent: (L, d)/(L,)/(L,) float64 bubble table (Eqs. 3–4).
      min_pts: HDBSCAN density parameter.
      min_cluster_size: flat-extraction threshold (None = min_pts).
      method, allow_single_cluster: flat-extraction policy ("eom"/"leaf").
      return_w: also return the (L, L) d_m matrix on the host, as f32 —
        the valid corner of the device W, copied once after the unwrap.
        Off by default: at large L the copy dwarfs the pass.
      stage: ``stage(name, fn, *args, **kw)`` runs each step — "prepare",
        the device stages of ``_offline_pipeline``, "unwrap"; the default
        just calls ``fn``.
      spatial_index: the grid pass (no (Lp, Lp) W unless ``return_w``).
      mesh: ``True``, a ``Mesh`` or a list of devices led by ``device``:
        the O(L²) stage row-sharded over it, bit for bit the unsharded
        result; incompatible with ``return_w`` (the matrix the sharded
        pass never builds whole).

    Returns:
      OfflineClusterResult; with ``return_w=True``, ``(W, result)``.
    """
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    if mesh is not None and return_w:
        raise ValueError("return_w is unsupported on the sharded (mesh=) path")
    L = int(np.shape(rep)[0])
    mcs = float(min_pts if min_cluster_size is None else min_cluster_size)
    (rep_t, nb_t, ext_t), min_pts, Ng = stage("prepare", _prepare_table, rep, n_b, extent, min_pts, dev)
    out = _offline_pipeline(rep_t, nb_t, ext_t, L, mcs, min_pts, method,
                            bool(allow_single_cluster), stage=stage, with_w=return_w,
                            spatial=bool(spatial_index), mesh=mesh)
    W = out.pop("W", None)
    result = stage("unwrap", _unwrap_result, out, L, mcs, Ng)
    if return_w:
        return W[:L, :L].cpu().numpy(), result  # the unwrap has synced: one copy
    return result


def _device_table_prepare(LS, LSe, SS, SSe, N, slots):
    """Device side of the flat-table pass (Eqs. 3–4 on the card): gather
    the populated ``slots`` (host int array, ascending) of the compensated
    sums ``LS − LSe``, ``SS − SSe`` and ``N``, derive rep and extent in
    f32 on the origin-centred sums, re-centre the reps at the mass
    centroid ``mu`` and pad to ``_pow2_rows(L)`` rows (far and massless:
    isolated at +inf in W, so the partition and the MST are those of the
    L rows).  Returns (rep_c, nb, extent) padded, and (rep, mu) in the
    origin frame.  The slot ids go up as a non-blocking copy: nothing here
    waits on the device."""
    L, d = len(slots), LS.shape[1]
    if L > 46340:
        raise ValueError("the offline pass supports L <= 46340 (int32 edge ids)")
    pad = _pow2_rows(L) - L
    idx = to_device(np.asarray(slots, dtype=np.int64), LS.device)
    LSs = LS.index_select(0, idx) - LSe.index_select(0, idx)
    SSs = SS.index_select(0, idx) - SSe.index_select(0, idx)
    Ns = N.index_select(0, idx)
    safe_n = torch.clamp_min(Ns, 1.0)
    rep = LSs / safe_n[:, None]
    mu = (Ns[:, None] * rep).sum(0) / torch.clamp_min(Ns.sum(), 1.0)
    # extent = sqrt((2 n SS - 2 ||LS||^2) / (n (n-1)))  (Eq. 4, f32 on the
    # origin-centred sums)
    lsq = (LSs * LSs).sum(-1)
    rad = (2.0 * Ns * SSs - 2.0 * lsq) / torch.clamp_min(Ns * (safe_n - 1.0), 1.0)
    extent = torch.where(Ns > 1.0, torch.sqrt(torch.clamp_min(rad, 0.0)), 0.0)
    rep_c = torch.cat([rep - mu, rep.new_full((pad, d), _PAD_COORD)])
    return rep_c, torch.cat([Ns, Ns.new_zeros(pad)]), torch.cat([extent, extent.new_zeros(pad)]), rep, mu


def _device_table_pipeline(LS, LSe, SS, SSe, N, slots, mcs: float, min_pts: int,
                           method: str = "eom", allow_single: bool = False, *, stage=_run_stage,
                           spatial: bool = False, mesh=None):
    """The flat-table pass up to its unwrap: ``_device_table_prepare`` then
    ``_offline_pipeline`` over the compacted table; rep, nb and mu ride in
    the output dict so the unwrap reads everything in ONE host sync.
    Returns (out, n_valid)."""
    L = len(slots)
    rep_c, nb, extent, rep, mu = stage("prepare", _device_table_prepare, LS, LSe, SS, SSe, N, slots)
    out = _offline_pipeline(rep_c, nb, extent, L, mcs, min_pts, method, allow_single, stage=stage,
                            spatial=spatial, mesh=mesh)
    out.update(rep=rep, nb=nb, mu=mu)
    return out, L


def _unwrap_device_table(out: dict, L: int, mcs: float, origin):
    """ONE host sync for the result and the serve-plane table; the f64
    origin goes back onto rep and mu on the host."""
    host = _to_host(out)
    origin = np.asarray(origin, dtype=np.float64)
    rep = host.pop("rep").astype(np.float64) + origin[None, :]
    nb = host.pop("nb").astype(np.float64)[:L]
    center = host.pop("mu").astype(np.float64) + origin
    return _result(host, L, mcs, nb), rep, nb, center


def offline_recluster_from_device_table(
    LS, LSe, SS, SSe, N, alive, origin, min_pts: int, min_cluster_size: float | None = None, *,
    slots, method: str = "eom", allow_single_cluster: bool = False, stage=_run_stage,
    spatial_index: bool = False, mesh=None,
):
    """The streaming engine's offline pass over a device-online flat table
    (``BubbleFlat.device_view()`` or a capture's clones): no upload of the
    summary, the stages on the table's device, one unwrap.

    Args:
      LS, LSe, SS, SSe, N, alive: (Lp, d)/(Lp,) origin-centred compensated
        sums, masses and the alive mask, on one device (``alive`` is not
        read: ``slots`` names the populated rows; it is taken so that a
        ``device_view()`` unpacks into the call as in the reference).
      origin: (d,) f64 frame of the table.
      min_pts: HDBSCAN density parameter, already clamped by the caller to
        the population (the flat table's mass equals it).
      min_cluster_size: None → the clamped ``min_pts``.
      slots: the populated slots in ascending order, from the host
        (``BubbleFlat.alive_slots()``), so the pass reads nothing of the
        device before its unwrap.
      method, allow_single_cluster: flat-extraction policy.
      stage: as in ``offline_recluster_from_table`` ("prepare" is the
        device derivation here).
      spatial_index: the grid pass.
      mesh: as in ``offline_recluster_from_table``, led by the table's
        device.

    Returns:
      (OfflineClusterResult, rep, n_b, center): ``rep`` the (L, d) f64
      uncentred serve-plane representatives in ascending-slot order,
      ``center`` the f64 mass centroid every f32 assignment subtracts.
    """
    mcs = float(min_pts if min_cluster_size is None else min_cluster_size)
    mesh = resolve_mesh(mesh, LS.device)
    out, L = _device_table_pipeline(LS, LSe, SS, SSe, N, slots, mcs, int(min_pts), method,
                                    bool(allow_single_cluster), stage=stage, spatial=bool(spatial_index),
                                    mesh=mesh)
    return stage("unwrap", _unwrap_device_table, out, L, mcs, origin)


def incremental_update(state, *, insert=None, slots=None, delete=None, valid=None, min_pts: int,
                       rk_cap: int = 64, s_cap: int = 64):
    """One incremental-maintenance step over a padded block (Eqs. 11–12,
    core/dynamic_torch.py): EITHER ``insert`` ((Bp, d) rows + ``slots``) OR
    ``delete`` ((Bp,) slot ids); ``valid`` masks padding rows.  Returns the
    updated ``DynState``; ``state.ok`` False means a strip overflowed its
    bucket and the caller must rebuild."""
    from ..core import dynamic_torch as dt

    if (insert is None) == (delete is None):
        raise ValueError("pass exactly one of insert= / delete=")
    dev = state.X.device

    def on_dev(x, dtype):  # a tensor moves (no host trip when it is on dev already); host arrays go through numpy
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=dtype, device=dev)

    valid = on_dev(valid, torch.bool)
    if insert is not None:
        return dt.insert_batch(state, on_dev(insert, torch.float32), on_dev(slots, torch.int64), valid,
                               min_pts=int(min_pts), rk_cap=int(rk_cap))
    return dt.delete_batch(state, on_dev(delete, torch.int64), valid,
                           min_pts=int(min_pts), rk_cap=int(rk_cap), s_cap=int(s_cap))


def _incremental_pipeline(X, mst_u, mst_v, mst_raw, mst_valid, cd, alive, n_alive, mcs: float,
                          method: str = "eom", allow_single: bool = False) -> dict:
    """Maintained MST buffers → flat labels, skipping Eq. 6 → W → Borůvka:
    compact the alive slots to leaf ids 0..n−1 by rank (ascending slot),
    re-derive the mutual-reachability weights from the raw lengths and the
    current core distances, and run the hierarchy stages at Lp = Np with
    ``n_valid = n_alive`` (a device scalar) and unit weights.  The
    compacted coordinates, the slot order and the count ride in the output
    so the unwrap reads everything in ONE host sync."""
    Np = alive.shape[0]
    rank = torch.cumsum(alive.long(), 0) - 1
    perm = torch.argsort(torch.where(alive, 0, 1), stable=True)
    mu, mv = mst_u.long(), mst_v.long()
    eu = torch.where(mst_valid, rank[mu], 0)
    ev = torch.where(mst_valid, rank[mv], 0)
    ew = torch.maximum(mst_raw, torch.maximum(cd[mu], cd[mv])).float()
    ew = torch.where(mst_valid, ew, 0.0)
    weights = (torch.arange(Np, device=alive.device) < n_alive).float()
    slt, ct, ex = hierarchy_fixed(eu, ev, ew, mst_valid, n_alive, weights, mcs, method=method,
                                  allow_single_cluster=allow_single)
    return {
        "rep": X[perm], "slots": perm, "n": n_alive,
        "eu": eu, "ev": ev, "ew": ew, "valid": mst_valid,
        "labels": ex.labels,
        "stability": ex.stability,
        "selected": ex.selected,
        "point_parent": ct.point_parent,
        "point_lambda": ct.point_lambda,
        "cluster_parent": ct.cluster_parent,
        "cluster_birth": ct.cluster_birth,
        "cluster_weight": ct.cluster_weight,
        "n_labels": ct.n_labels,
    }


def incremental_recluster(state, min_cluster_size: float, method: str = "eom",
                          allow_single_cluster: bool = False):
    """Labels straight from an incrementally maintained MST (``DynState``).

    Returns (OfflineClusterResult, alive_slots, rep): result rows in
    ascending-slot order, ``alive_slots[i]`` the state slot of row i, and
    ``rep`` the (n, d) f32 coordinates per row (gathered on the device).
    The hierarchy stages only — O(Np) sweeps, no O(Np²) stage — and ONE
    host read, the unwrap."""
    mcs = float(min_cluster_size)
    out = _incremental_pipeline(state.X, state.mst_u, state.mst_v, state.mst_raw, state.mst_valid, state.cd,
                                state.alive, state.n_alive, mcs, method, bool(allow_single_cluster))
    host = _to_host(out)  # ONE host sync: labels, arrays, serve reps
    n = int(host.pop("n"))
    rep = host.pop("rep")[:n]
    slots = host.pop("slots")[:n]
    return _result(host, n, mcs, np.ones(n, dtype=np.float64)), slots, rep


class ClusterBackend:
    """Kernel dispatch resolved ONCE at engine construction: the device
    every call moves its inputs to.  On ``cuda`` the wrappers launch the
    hand-written kernels; on ``cpu`` they run the plain versions.  The
    engine uses it for ingest assignment and the offline pass; the other
    methods are the JAX backend's kernel API over the same device.
    ``spatial_index=True`` routes assignment, Eq. 6 and Borůvka through the
    grid (``kernels/grid.py``): the same answers, no (L, L) matrix."""

    def __init__(self, device=None, spatial_index: bool = False):
        self.device = resolve_device(device)
        self.spatial_index = bool(spatial_index)

    def __repr__(self):
        if self.spatial_index:
            return f"ClusterBackend({str(self.device)!r}, spatial_index=True)"
        return f"ClusterBackend({str(self.device)!r})"

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float32).to(self.device).contiguous()

    def pairwise_sqdist(self, x, y) -> torch.Tensor:
        return pairwise_sqdist(self._f32(x), self._f32(y))

    def knn(self, x, y, k: int):
        return knn(self._f32(x), self._f32(y), k)

    def _mask(self, valid):
        if valid is None:
            return None
        return torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid) else valid,
                               dtype=torch.bool).to(self.device)

    def assign(self, x, reps, valid=None) -> torch.Tensor:
        return assign(self._f32(x), self._f32(reps), spatial_index=self.spatial_index, valid=self._mask(valid))

    def assign_with_dist(self, x, reps, valid=None):
        return assign(self._f32(x), self._f32(reps), with_dist=True, spatial_index=self.spatial_index,
                      valid=self._mask(valid))

    def bubble_core_distances(self, rep, n_b, extent, min_pts: int) -> torch.Tensor:
        return bubble_core_distances(self._f32(rep), self._f32(n_b), self._f32(extent), min_pts,
                                     spatial_index=self.spatial_index)

    def bubble_mutual_reachability(self, rep, n_b, extent, min_pts: int) -> torch.Tensor:
        return bubble_mutual_reachability(self._f32(rep), self._f32(n_b), self._f32(extent), min_pts,
                                          spatial_index=self.spatial_index)

    def offline_recluster(self, LS, SS, N, ids, min_pts: int,
                          min_cluster_size: float | None = None) -> OfflineClusterResult:
        """Offline re-clustering over leaf CF buffers: ``bubble_table``
        (host f64, Eqs. 3–4) then ``offline_recluster_from_table``."""
        rep, extent, Ng, _ = bubble_table(LS, SS, N, ids)
        return offline_recluster_from_table(rep, Ng, extent, min_pts, min_cluster_size, device=self.device,
                                            spatial_index=self.spatial_index)

    def offline_recluster_from_table(self, rep, n_b, extent, min_pts: int,
                                     min_cluster_size: float | None = None,
                                     return_w: bool = False, **kw):
        return offline_recluster_from_table(
            rep, n_b, extent, min_pts, min_cluster_size, device=self.device,
            return_w=return_w, spatial_index=self.spatial_index, **kw)

    def offline_recluster_from_device_table(self, LS, LSe, SS, SSe, N, alive, origin, min_pts: int,
                                            min_cluster_size: float | None = None, **kw):
        return offline_recluster_from_device_table(
            LS, LSe, SS, SSe, N, alive, origin, min_pts, min_cluster_size,
            spatial_index=self.spatial_index, **kw)

    def make_flat(self, dim: int, capacity: int = 64, mesh=None):
        """Device-resident flat leaf-CF table (core/bubble_flat.py) on this
        backend's device: device-online ingest (DESIGN.md §8).  ``mesh``
        bakes the sharded offline pass into every capture (§12)."""
        from ..core.bubble_flat import BubbleFlat  # the table's captures import this module

        return BubbleFlat(dim, device=self.device, capacity=capacity, spatial_index=self.spatial_index, mesh=mesh)

    def make_dynamic(self, min_pts: int, dim: int, capacity: int = 256, **kw):
        """Exact-dynamic handle (core/dynamic_torch.py) on this backend's
        device: its strips run on the kernels of ``kernels/dynamic.py``."""
        from ..core.dynamic_torch import DynamicTorchHDBSCAN

        return DynamicTorchHDBSCAN(min_pts, dim, capacity=capacity, device=self.device, **kw)

    def incremental_recluster(self, state, min_cluster_size: float, **kw):
        return incremental_recluster(state, min_cluster_size, **kw)


def get_backend(device=None, spatial_index: bool = False) -> ClusterBackend:
    return ClusterBackend(device, spatial_index=spatial_index)
