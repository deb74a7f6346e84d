"""The offline pass and the kernel entry points of the main path.

The PyTorch counterpart of the JAX package's ``repro/kernels/ops.py``,
dense branch only:

* ``assign`` / ``bubble_core_distances`` / ``bubble_mutual_reachability``
  over the kernel wrappers (CUDA kernel for a CUDA tensor, plain version
  for a CPU tensor);
* ``bubble_table``: the host f64 derivation of Eqs. 3–4;
* ``offline_recluster_from_table``: ``_prepare_table`` (host centring,
  the ``min_pts`` clamp and the power-of-two pad), then
  ``_offline_pipeline`` on the device — Eq. 6 core distances → Eq. 7 W →
  Borůvka → single-linkage → condense → extract — and one unwrap into an
  ``OfflineClusterResult``.  Each stage runs through a ``stage`` hook, so
  a caller can time the very calls the engine makes (chip_smoke.py);
* ``ClusterBackend``: the device, resolved once by the engine.

There is no feature padding to 128 lanes (a TPU tiling) and no L cap on
the Eq. 6 kernel (a TPU VMEM sizing): the CUDA kernels stream over L.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.cf import cf_extent, cf_rep
from ..core.hierarchy import condense_fixed, extract_fixed, single_linkage_fixed
from ..core.mst import boruvka
from ..device import resolve_device, to_numpy
from . import assign as _assign_k
from . import bubble_cd as _bcd_k
from . import mutual_reach as _mr_k

__all__ = [
    "assign",
    "bubble_core_distances",
    "bubble_mutual_reachability",
    "bubble_table",
    "OfflineClusterResult",
    "offline_recluster_from_table",
    "ClusterBackend",
    "get_backend",
]

# Padding coordinate for size-bucketed bubble tables: far from any data
# (so padded bubbles are never a nearest neighbour) but small enough that
# its squared distances stay finite in f32 (1e12·d ≪ 3.4e38).
_PAD_COORD = 1e6


def _pow2_rows(n: int) -> int:
    return max(8, 1 << (max(n - 1, 1)).bit_length())


def assign(x: torch.Tensor, reps: torch.Tensor, with_dist: bool = False):
    """Nearest-representative index per row (lowest index on ties); with
    ``with_dist=True`` also the euclidean distance to it."""
    return _assign_k.assign(x.float().contiguous(), reps.float().contiguous(), with_dist=with_dist)


def _clamp_min_pts(min_pts: int, total_mass: float) -> int:
    # Eq. 6's scan can never reach min_pts beyond the represented mass
    # (the kernel's min_pts-entry prefix relies on it)
    return max(1, min(int(min_pts), int(total_mass)))


def bubble_core_distances(rep, n_b, extent, min_pts: int) -> torch.Tensor:
    """Eq. 6 bubble core distances, ``min_pts`` clamped to the mass."""
    rep, n_b, extent = (t.float().contiguous() for t in (rep, n_b, extent))
    min_pts = _clamp_min_pts(min_pts, float(n_b.sum()))
    return _bcd_k.bubble_core_distances(rep, n_b, extent, min_pts=min_pts, dim=rep.shape[1])


def bubble_mutual_reachability(rep, n_b, extent, min_pts: int) -> torch.Tensor:
    """The (L, L) bubble d_m matrix (Eqs. 6–7), diagonal 0."""
    cd = bubble_core_distances(rep, n_b, extent, min_pts)
    rep = rep.float().contiguous()
    return _mr_k.mutual_reachability(rep, rep, cd, cd, zero_diag=True)


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


def _run_stage(name: str, fn, *args, **kw):
    return fn(*args, **kw)


def _offline_pipeline(rep, n_b, extent, n_valid: int, mcs: float, min_pts: int,
                      method: str = "eom", allow_single: bool = False, *,
                      stage=_run_stage) -> dict:
    """Device offline pass over a size-bucketed, mean-centred bubble table:
    Eq. 6 → (Lp, Lp) W (Eq. 7, pad rows/cols at +inf so they stay isolated
    in the MST) → Borůvka → hierarchy, on a pre-clamped ``min_pts``, with
    no host sync but the EOM sweep's one.  Returns the fixed-size buffers;
    ``stage(name, fn, *args, **kw)`` runs each step."""
    cd = stage("bubble_cd", _bcd_k.bubble_core_distances, rep, n_b, extent,
               min_pts=min_pts, dim=rep.shape[1])
    W = stage("mutual_reach", _mr_k.mutual_reachability, rep, rep, cd, cd,
              zero_diag=True, n_valid=n_valid)
    eu, ev, ew, valid = stage("boruvka", boruvka, W)
    del W
    slt = stage("single_linkage", single_linkage_fixed, eu, ev, ew, valid, n_valid, n_b)
    ct = stage("condense", condense_fixed, slt, n_b, mcs)
    ex = stage("extract", extract_fixed, ct, method=method, allow_single_cluster=allow_single)
    return {
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


@dataclasses.dataclass
class OfflineClusterResult:
    """One offline pass: flat labels + the arrays behind them.

    ``labels[k]``'s cluster has stability ``stabilities[labels[k]]`` —
    flat ids are the ascending rank of the selected condensed labels.  The
    condensed tree is in the device layout (label 0 = root; see
    core/hierarchy.py)."""

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


def _unwrap_result(out: dict, L: int, mcs: float, weights: np.ndarray) -> OfflineClusterResult:
    out = dict(zip(out, to_numpy(*out.values())))  # ONE host sync
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
    stage=_run_stage,
) -> OfflineClusterResult:
    """The streaming engine's offline pass, from a derived bubble table:
    ``_prepare_table`` on the host, the stages on ``device`` (None →
    cuda), and the fixed-size buffers back in one unwrap.

    Args:
      rep, n_b, extent: (L, d)/(L,)/(L,) float64 bubble table (Eqs. 3–4).
      min_pts: HDBSCAN density parameter.
      min_cluster_size: flat-extraction threshold (None = min_pts).
      method, allow_single_cluster: flat-extraction policy ("eom"/"leaf").
      stage: ``stage(name, fn, *args, **kw)`` runs each step — "prepare",
        the device stages of ``_offline_pipeline``, "unwrap"; the default
        just calls ``fn``.
    """
    dev = resolve_device(device)
    L = int(np.shape(rep)[0])
    mcs = float(min_pts if min_cluster_size is None else min_cluster_size)
    (rep_t, nb_t, ext_t), min_pts, Ng = stage("prepare", _prepare_table, rep, n_b, extent, min_pts, dev)
    out = _offline_pipeline(rep_t, nb_t, ext_t, L, mcs, min_pts, method,
                            bool(allow_single_cluster), stage=stage)
    return stage("unwrap", _unwrap_result, out, L, mcs, Ng)


class ClusterBackend:
    """Kernel dispatch resolved ONCE at engine construction: the device
    every call moves its inputs to.  On ``cuda`` the wrappers launch the
    hand-written kernels; on ``cpu`` they run the plain versions.  The
    engine uses it for ingest assignment and the offline pass."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def __repr__(self):
        return f"ClusterBackend({str(self.device)!r})"

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float32).to(self.device).contiguous()

    def assign(self, x, reps) -> torch.Tensor:
        return assign(self._f32(x), self._f32(reps))

    def offline_recluster_from_table(self, rep, n_b, extent, min_pts: int,
                                     min_cluster_size: float | None = None,
                                     **kw) -> OfflineClusterResult:
        return offline_recluster_from_table(
            rep, n_b, extent, min_pts, min_cluster_size, device=self.device, **kw)


def get_backend(device=None) -> ClusterBackend:
    return ClusterBackend(device)
