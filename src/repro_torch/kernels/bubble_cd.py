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
(``csrc/bubble_cd.cu``) instead streams the table through shared memory
once, with each lane keeping a sorted buffer of its ``min_pts`` nearest
(d, j), and merges the 32 buffers per row — so distances are computed
once, nothing of size (rows, L) is held, and no L cap applies (the
reference's 8192-row VMEM fallback is a TPU sizing).  ``min_pts`` is a
runtime argument bounded by ``MAX_MIN_PTS``.  A tensor on the CPU takes
the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["bubble_core_distances", "MAX_MIN_PTS", "MAX_DIM"]

MAX_MIN_PTS = 64  # csrc/bubble_cd.cu kMaxMinPts
MAX_DIM = 128

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def bubble_core_distances(rep, n_b, extent, *, min_pts: int, dim: int) -> torch.Tensor:
    """(L, d), (L,), (L,) f32 → (L,) f32 Eq. 6 core distances.  ``dim`` is
    the exponent's dimensionality; callers clamp ``min_pts`` to the
    represented mass (see kernels/ops.py)."""
    global launches
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
    if rep.device.type == "cpu":
        return _ref.bubble_core_distances(rep, n_b, extent, min_pts, dim)
    if rep.device.type != "cuda":
        raise ValueError(f"bubble_core_distances runs on cuda or cpu, not {rep.device}")
    if not all(t.is_contiguous() for t in (rep, n_b, extent)):
        raise ValueError("bubble_core_distances wants contiguous inputs")
    L, d = rep.shape
    if min_pts > MAX_MIN_PTS:
        raise ValueError(f"bubble_cd kernel takes min_pts <= {MAX_MIN_PTS}, got {min_pts}")
    if d > MAX_DIM or L >= 2**31:
        raise ValueError(f"bubble_cd kernel takes d <= {MAX_DIM}, got d={d} L={L}")
    out = torch.empty(L, dtype=torch.float32, device=rep.device)
    if L:
        lib = _build.load()
        with torch.cuda.device(rep.device):
            code = lib.repro_bubble_cd_f32(
                rep.data_ptr(), n_b.data_ptr(), extent.data_ptr(), L, d, min_pts, dim,
                out.data_ptr(), _build.current_stream(rep.device),
            )
        _build.check(code, "bubble_cd")
        launches += 1
    return out
