"""Eq. 6 bubble core distances: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/bubble_cd.py``
(``_bubble_cd_kernel`` / ``bubble_core_distances``): per bubble, walk the
others in ascending (distance, index) order — self at 0 — until the
cumulative mass reaches ``min_pts``, then add the crossing bubble's
``dim_root(k_resid / n_C, dim) · extent_C``.

Bound on the H100: operations.  The function needs every unordered
pairwise distance once: L(L−1)/2·d FMAs, 0.54 G at Lp = 8192, d = 16 —
16 µs at 67 TFLOP/s f32; its bytes (the (L, d) table in, (L,) out) are
negligible.  The kernel computes each pair twice (once per row).
The Pallas kernel recomputes nothing but holds a (bn, L) strip and runs
``min_pts`` masked-extraction passes over it; the CUDA kernel
(``csrc/bubble_cd_ws.cu`` on ``csrc/warp_select.cuh``, the knn kernel's
core) keeps R rows per warp in registers, streams the table through a
``cp.async`` ring once per block of rows and keeps each row's
k = min(min_pts, L) nearest (d, j) in registers, then walks them in
ascending order with one f32 add at a time — so distances are computed
once, nothing of size (rows, L) is held, and no L cap applies (the
reference's 8192-row VMEM fallback is a TPU sizing).  ``min_pts`` is a
runtime argument bounded by ``MAX_MIN_PTS`` on the card.  A tensor on
the CPU takes the plain version.

``bubble_cd_lane`` runs the earlier kernel (``csrc/bubble_cd.cu``: one
warp per row, per-lane sorted buffers in local memory, min_pts ≤
``MAX_MIN_PTS_LANE``).  Its results are bitwise the new kernel's, so the
card's tests and ``chip_smoke.py`` hold the new kernel to it; nothing
else calls it.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["bubble_core_distances", "bubble_cd_lane", "MAX_MIN_PTS", "MAX_MIN_PTS_LANE", "MAX_DIM"]

MAX_MIN_PTS = 1024  # csrc/warp_select.cuh kMaxK
MAX_MIN_PTS_LANE = 64  # csrc/bubble_cd.cu kMaxMinPts
MAX_DIM = 128

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_lane = 0  # launches of the earlier kernel, through bubble_cd_lane only


def _checked(rep, n_b, extent, min_pts: int, dim: int) -> tuple[int, int]:
    if rep.dim() != 2 or n_b.shape != (rep.shape[0],) or extent.shape != (rep.shape[0],):
        raise ValueError(
            f"bubble_core_distances wants (L, d), (L,), (L,), got "
            f"{tuple(rep.shape)}, {tuple(n_b.shape)}, {tuple(extent.shape)}")
    if any(t.dtype != torch.float32 for t in (rep, n_b, extent)):
        raise TypeError("bubble_core_distances wants float32 inputs")
    if not (rep.device == n_b.device == extent.device):
        raise ValueError("bubble_core_distances inputs on different devices")
    min_pts, dim = int(min_pts), int(dim)
    if min_pts < 1 or dim < 1:
        raise ValueError(f"min_pts and dim must be >= 1, got {min_pts}, {dim}")
    return min_pts, dim


def _launch(entry: str, bound: int, rep, n_b, extent, min_pts: int, dim: int) -> torch.Tensor:
    if rep.device.type != "cuda":
        raise ValueError(f"bubble_core_distances runs on cuda or cpu, not {rep.device}")
    if not all(t.is_contiguous() for t in (rep, n_b, extent)):
        raise ValueError("bubble_core_distances wants contiguous inputs")
    L, d = rep.shape
    if min_pts > bound:
        raise ValueError(f"bubble_cd kernel takes min_pts <= {bound}, got {min_pts}")
    if d > MAX_DIM or L >= 2**31:
        raise ValueError(f"bubble_cd kernel takes d <= {MAX_DIM}, got d={d} L={L}")
    out = torch.empty(L, dtype=torch.float32, device=rep.device)
    if L:
        lib = _build.load()
        with torch.cuda.device(rep.device):
            code = getattr(lib, entry)(
                rep.data_ptr(), n_b.data_ptr(), extent.data_ptr(), L, d, min_pts, dim,
                out.data_ptr(), _build.current_stream(rep.device),
            )
        _build.check(code, "bubble_cd")
    return out


def bubble_core_distances(rep, n_b, extent, *, min_pts: int, dim: int) -> torch.Tensor:
    """(L, d), (L,), (L,) f32 → (L,) f32 Eq. 6 core distances.  ``dim`` is
    the exponent's dimensionality; callers clamp ``min_pts`` to the
    represented mass (see kernels/ops.py)."""
    global launches
    min_pts, dim = _checked(rep, n_b, extent, min_pts, dim)
    if rep.device.type == "cpu":
        return _ref.bubble_core_distances(rep, n_b, extent, min_pts, dim)
    out = _launch("repro_bubble_cd_ws_f32", MAX_MIN_PTS, rep, n_b, extent, min_pts, dim)
    if rep.shape[0]:
        launches += 1
    return out


def bubble_cd_lane(rep, n_b, extent, *, min_pts: int, dim: int) -> torch.Tensor:
    """``bubble_core_distances`` through the earlier per-lane kernel,
    min_pts <= MAX_MIN_PTS_LANE: the bitwise oracle of the new kernel on
    the card."""
    global launches_lane
    min_pts, dim = _checked(rep, n_b, extent, min_pts, dim)
    if rep.device.type == "cpu":
        return _ref.bubble_core_distances(rep, n_b, extent, min_pts, dim)
    out = _launch("repro_bubble_cd_f32", MAX_MIN_PTS_LANE, rep, n_b, extent, min_pts, dim)
    if rep.shape[0]:
        launches_lane += 1
    return out
