"""Eq. 7 mutual-reachability matrix: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/mutual_reach.py``
(``_mutual_reach_kernel`` / ``mutual_reachability``):
``max(d(x, y), cd_x, cd_y)`` tiles with the global diagonal at 0.  On the
main path it builds the (Lp, Lp) W that Borůvka reads.

Bound on the H100: bytes.  At Lp = 8192 the output alone is 256 MiB,
which takes at least 80 µs at 3.35 TB/s, while its 1.07 G FMAs take 32 µs
at 67 TFLOP/s f32.  The kernel (``csrc/dist_panel.cu``, the pairwise
kernel's core with an Eq. 7 epilogue, so both give the same
squared-distance bits) computes each row's norm once, multiplies 8 × 8
register tiles of 128 × 128 output tiles in f32 on the CUDA cores (any
d), and fuses the offline pass's pad mask (rows/columns ≥ ``n_valid`` at
+inf) into its stores: a tile wholly past ``n_valid`` is written +inf
with nothing computed, and only tiles that cross ``n_valid`` or the
diagonal compare per element — the JAX package applies the mask as a
second full pass over W.  ``row0`` makes x the rows ``row0 ..`` of the
table (a shard's strip in the sharded offline pass): the diagonal and the
row mask read global rows, so a strip is bit for bit the same rows of the
whole matrix.  A tensor on the CPU takes the plain version.

``mutual_reach_tile`` runs the earlier kernel (``csrc/mutual_reach.cu``,
one 64 × 64 tile per block).  Its output is bitwise the new kernel's, so
the card's tests and ``chip_smoke.py`` hold the new kernel to it; nothing
else calls it.
"""

from __future__ import annotations

import torch

from . import _build
from . import pairwise as _pw
from . import ref as _ref

__all__ = ["mutual_reachability", "mutual_reach_tile"]

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_tile = 0  # launches of the earlier tile kernel, through mutual_reach_tile only


def _checked(x, y, cd_x, cd_y) -> bool:
    """Validate; True for the card, False for the CPU (plain version)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"mutual_reachability wants (n, d), (m, d), got {tuple(x.shape)}, {tuple(y.shape)}")
    if cd_x.shape != (x.shape[0],) or cd_y.shape != (y.shape[0],):
        raise ValueError("mutual_reachability core distances must be (n,) and (m,)")
    if any(t.dtype != torch.float32 for t in (x, y, cd_x, cd_y)):
        raise TypeError("mutual_reachability wants float32 inputs")
    if not (x.device == y.device == cd_x.device == cd_y.device):
        raise ValueError("mutual_reachability inputs on different devices")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"mutual_reachability runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, y, cd_x, cd_y)):
        raise ValueError("mutual_reachability wants contiguous inputs")
    if max(x.shape[0], y.shape[0]) >= 2**31:
        raise ValueError(f"mutual_reach kernel takes int32 sizes, got n={x.shape[0]} m={y.shape[0]}")
    return True


def mutual_reachability(x, y, cd_x, cd_y, *, zero_diag: bool = True, n_valid: int | None = None,
                        row0: int = 0):
    """(n, d), (m, d), (n,), (m,) f32 → (n, m) f32 Eq. 7 matrix; global rows
    (``row0 + r``) and columns ≥ ``n_valid`` (when given) are +inf."""
    global launches
    row0 = int(row0)
    if row0 < 0:
        raise ValueError(f"mutual_reachability: row0 must be >= 0, got {row0}")
    if not _checked(x, y, cd_x, cd_y):
        return _ref.mutual_reachability(x, y, cd_x, cd_y, zero_diag=zero_diag, n_valid=n_valid, row0=row0)
    (n, d), m = x.shape, y.shape[0]
    if row0 + n >= 2**31:
        raise ValueError(f"mutual_reach kernel takes int32 rows, got row0={row0} n={n}")
    top = max(row0 + n, m)
    nv = top if n_valid is None else max(0, min(int(n_valid), top))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        grid, vec, floats = _pw.panel_plan(n, m, out.data_ptr(), _pw.resident_blocks(True, x.device.index))
        norms = torch.empty(floats, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            code = _build.load().repro_mutual_reach_panel_f32(
                x.data_ptr(), y.data_ptr(), cd_x.data_ptr(), cd_y.data_ptr(), n, m, d, int(bool(zero_diag)), nv,
                row0, grid, int(vec), norms.data_ptr(), out.data_ptr(), _build.current_stream(x.device))
        _build.check(code, "mutual_reach")
        launches += 1
    return out


def mutual_reach_tile(x, y, cd_x, cd_y, *, zero_diag: bool = True, n_valid: int | None = None):
    """``mutual_reachability`` through the earlier tile kernel, CUDA
    tensors only: the bitwise oracle of the panel kernel on the card."""
    global launches_tile
    if not _checked(x, y, cd_x, cd_y):
        raise ValueError("mutual_reach_tile runs the tile kernel: it takes CUDA tensors only")
    (n, d), m = x.shape, y.shape[0]
    nv = max(n, m) if n_valid is None else max(0, min(int(n_valid), max(n, m)))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        with torch.cuda.device(x.device):
            code = _build.load().repro_mutual_reach_tile_f32(
                x.data_ptr(), y.data_ptr(), cd_x.data_ptr(), cd_y.data_ptr(), n, m, d, int(bool(zero_diag)), nv,
                out.data_ptr(), _build.current_stream(x.device))
        _build.check(code, "mutual_reach tile")
        launches_tile += 1
    return out
