"""Eq. 6 bubble core distances: CUDA kernels and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/bubble_cd.py``
(``_bubble_cd_kernel`` / ``bubble_core_distances``): per bubble, walk the
others in ascending (distance, index) order — self at 0 — until the
cumulative mass reaches ``min_pts``, then add the crossing bubble's
``dim_root(k_resid / n_C, dim) · extent_C``.

Bound on the H100: operations.  The function needs every unordered
pairwise distance once: L(L−1)/2·d FMAs, 0.54 G at Lp = 8192, d = 16 —
16 µs at 67 TFLOP/s f32; its bytes (the (L, d) table in, (L,) out) are
negligible.  The Pallas kernel recomputes nothing but holds a (bn, L)
strip and runs ``min_pts`` masked-extraction passes over it.  On the card
a call takes one of two routes, chosen by ``route(d, min_pts)`` before
the launch:

* ``"ws"`` (d ≤ ``MAX_DIM``, min_pts ≤ ``MAX_MIN_PTS``):
  ``csrc/bubble_cd_ws.cu`` on ``csrc/warp_select.cuh`` (the knn kernel's
  core) keeps R rows per warp in registers, streams the table through a
  ``cp.async`` ring once per block of rows and keeps each row's
  k = min(min_pts, L) nearest (d, j) in registers, then walks them in
  ascending order with one f32 add at a time — so each pair is computed
  once per row, nothing of size (rows, L) is held, and no L cap applies
  (the reference's 8192-row VMEM fallback is a TPU sizing).
* ``"strip"`` (wider rows or larger min_pts): strips of S rows × L
  distances from the pairwise panel kernel (``pairwise.sq_into``, the same
  bits), S chosen so that one strip stays within ``pairwise.STRIP_BYTES``;
  square roots, each row's own entry set to exactly 0, a stable sort per
  row (the (distance, index) order), then the Eq. 6 walk over the first
  k entries by ``csrc/bubble_cd_walk.cu``, one warp per row adding the
  masses one ``__fadd_rn`` at a time as the warp-select kernel does.

Both routes take a row range ``rows = (a, b)``: Eq. 6 for the table's
rows ``[a, b)`` against all L bubbles, the sharded offline pass's strip
(``kernels/ops.py::_sharded_mst_stage``).  Rows keep their global index,
so a strip's values are bit for bit the same rows of the whole launch.

The route is a pure function of the shapes: it is never taken because a
kernel failed, and a failure raises.  ``launches`` counts both routes,
``launches_ws`` and ``launches_strip`` each.  A tensor on the CPU takes
the plain version.

``bubble_cd_lane`` runs the earlier kernel (``csrc/bubble_cd.cu``: one
warp per row, per-lane sorted buffers in local memory, min_pts ≤
``MAX_MIN_PTS_LANE``, d ≤ ``MAX_DIM``).  Its results are bitwise the
warp-select kernel's, so the card's tests and ``chip_smoke.py`` hold that
kernel to it; nothing else calls it.
"""

from __future__ import annotations

import torch

from . import _build
from . import pairwise as _pw_k
from . import ref as _ref

__all__ = ["bubble_core_distances", "bubble_cd_strip", "bubble_cd_lane", "route", "MAX_MIN_PTS",
           "MAX_MIN_PTS_LANE", "MAX_DIM"]

MAX_MIN_PTS = 1024  # csrc/warp_select.cuh kMaxK
MAX_MIN_PTS_LANE = 64  # csrc/bubble_cd.cu kMaxMinPts
MAX_DIM = 128  # csrc/common.cuh kMaxDim

launches = 0  # kernel launches since the last reset, both routes (chip_smoke.py reads it)
launches_ws = 0  # of the warp-select kernel
launches_strip = 0  # of the strip route
launches_lane = 0  # launches of the earlier kernel, through bubble_cd_lane only


def route(d: int, min_pts: int) -> str:
    """The route a CUDA call at width d and ``min_pts`` takes: ``"ws"`` or
    ``"strip"``."""
    return "ws" if d <= MAX_DIM and min_pts <= MAX_MIN_PTS else "strip"


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
    if rep.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bubble_core_distances runs on cuda or cpu, not {rep.device}")
    if rep.device.type == "cuda":
        if not all(t.is_contiguous() for t in (rep, n_b, extent)):
            raise ValueError("bubble_core_distances wants contiguous inputs")
        if rep.shape[0] >= 2**31:
            raise ValueError(f"bubble_cd kernel takes int32 sizes, got L={rep.shape[0]}")
    return min_pts, dim


def _row_range(rows, L: int) -> tuple[int, int]:
    a, b = (0, L) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= a <= b <= L:
        raise ValueError(f"bubble_core_distances: rows [{a}, {b}) outside a table of {L}")
    return a, b


def _plain(rep, n_b, extent, min_pts: int, dim: int, a: int, b: int) -> torch.Tensor:
    ids = torch.arange(a, b, device=rep.device)
    return _ref.bubble_core_distances_rows(rep[a:b], ids, rep, n_b, extent, min_pts, dim)


def _launch(entry: str, rep, n_b, extent, min_pts: int, dim: int, *rows) -> torch.Tensor:
    """One launch of ``entry`` over the table; ``rows`` = (a, b) passes the
    row range (the warp-select kernel), and the output has b − a rows."""
    L, d = rep.shape
    a, b = rows or (0, L)
    out = torch.empty(b - a, dtype=torch.float32, device=rep.device)
    if b > a:
        lib = _build.load()
        span = (a, b - a) if rows else ()
        with torch.cuda.device(rep.device):
            code = getattr(lib, entry)(
                rep.data_ptr(), n_b.data_ptr(), extent.data_ptr(), L, d, *span, min_pts, dim,
                out.data_ptr(), _build.current_stream(rep.device),
            )
        _build.check(code, "bubble_cd")
    return out


def bubble_core_distances(rep, n_b, extent, *, min_pts: int, dim: int, rows=None) -> torch.Tensor:
    """(L, d), (L,), (L,) f32 → (L,) f32 Eq. 6 core distances; with
    ``rows = (a, b)`` only the rows ``[a, b)``, (b − a,).  ``dim`` is the
    exponent's dimensionality; callers clamp ``min_pts`` to the represented
    mass (see kernels/ops.py)."""
    global launches, launches_ws
    min_pts, dim = _checked(rep, n_b, extent, min_pts, dim)
    a, b = _row_range(rows, rep.shape[0])
    if rep.device.type == "cpu":
        return _plain(rep, n_b, extent, min_pts, dim, a, b)
    if route(rep.shape[1], min_pts) == "strip":
        return bubble_cd_strip(rep, n_b, extent, min_pts=min_pts, dim=dim, rows=(a, b))
    out = _launch("repro_bubble_cd_ws_f32", rep, n_b, extent, min_pts, dim, a, b)
    if b > a:
        launches += 1
        launches_ws += 1
    return out


def bubble_cd_strip(rep, n_b, extent, *, min_pts: int, dim: int, rows=None) -> torch.Tensor:
    """``bubble_core_distances`` through the strip route at any d and
    min_pts (``bubble_core_distances`` takes it where ``route`` says so;
    the card's tests also call it at the warp-select kernel's bounds, where
    the two agree bit for bit)."""
    global launches, launches_strip
    min_pts, dim = _checked(rep, n_b, extent, min_pts, dim)
    L = rep.shape[0]
    a, b = _row_range(rows, L)
    if rep.device.type == "cpu":
        return _plain(rep, n_b, extent, min_pts, dim, a, b)
    out = torch.empty(b - a, dtype=torch.float32, device=rep.device)
    if b == a:
        return out
    k = min(min_pts, L)
    step = min(_pw_k.strip_rows(L), b - a)
    strip = torch.empty((step, L), dtype=torch.float32, device=rep.device)
    lib = _build.load()
    for i in range(a, b, step):
        sq = _pw_k.sq_into(rep[i : i + step], rep, strip[: min(step, b - i)]).sqrt_()
        sq.diagonal(i).zero_()  # each row's own entry, (r, i + r)
        vals, order = torch.sort(sq, dim=1, stable=True)
        with torch.cuda.device(rep.device):
            code = lib.repro_bubble_cd_walk_f32(
                vals.data_ptr(), order.data_ptr(), vals.shape[0], L, k, n_b.data_ptr(), extent.data_ptr(),
                min_pts, dim, out[i - a :].data_ptr(), _build.current_stream(rep.device))
        _build.check(code, "bubble_cd walk")
    launches += 1
    launches_strip += 1
    return out


def bubble_cd_lane(rep, n_b, extent, *, min_pts: int, dim: int) -> torch.Tensor:
    """``bubble_core_distances`` through the earlier per-lane kernel,
    min_pts <= MAX_MIN_PTS_LANE and d <= MAX_DIM: the bitwise oracle of the
    warp-select kernel on the card."""
    global launches_lane
    min_pts, dim = _checked(rep, n_b, extent, min_pts, dim)
    if rep.device.type == "cpu":
        return _ref.bubble_core_distances(rep, n_b, extent, min_pts, dim)
    if min_pts > MAX_MIN_PTS_LANE or rep.shape[1] > MAX_DIM:
        raise ValueError(f"the per-lane bubble_cd kernel takes min_pts <= {MAX_MIN_PTS_LANE} and d <= {MAX_DIM}, "
                         f"got {min_pts} and {rep.shape[1]}")
    out = _launch("repro_bubble_cd_f32", rep, n_b, extent, min_pts, dim)
    if rep.shape[0]:
        launches_lane += 1
    return out
