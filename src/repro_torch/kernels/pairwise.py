"""Pairwise squared euclidean distances: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/pairwise.py``
(``_pairwise_kernel`` / ``pairwise_sqdist``): the (n, m) tiles
``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``.  It serves ``ops.pairwise_sqdist`` and
``ClusterBackend.pairwise_sqdist``.

Bound on the H100: bytes.  At 16,384² the output alone is 1 GiB, at
least 0.32 ms at 3.35 TB/s, while its 4.3 G FMAs take 0.13 ms at
67 TFLOP/s f32.  The kernel (``csrc/dist_panel.cu``, shared with the
mutual_reach kernel, so the two give the same squared-distance bits for
the same pair) computes each row's norm once in a pre-pass, then lets
persistent blocks walk 128 × 128 output tiles in row-panel order: each
thread multiplies an 8 × 8 register tile in f32 on the CUDA cores from
feature-major panels that a two-stage ``cp.async`` ring stages 16
features at a time (any d, the chains continued across slices), and
stores it straight from registers while the next tile's copies land.
``panel_plan`` sizes the grid (from the kernel's occupancy) and picks the
16-byte stores.  ``sq_into`` launches it uncounted into a given buffer:
the strip routes of knn and bubble_cd take their (rows, m) strips from
it.  A tensor on the CPU takes the plain version.

``pairwise_tile`` runs the earlier kernel (``csrc/pairwise.cu``: one
64 × 64 tile per block, norms recomputed per tile).  Its output is bitwise
the new kernel's, so the card's tests and ``chip_smoke.py`` hold the new
kernel to it; nothing else calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ref as _ref

__all__ = ["pairwise_sqdist", "pairwise_tile", "sq_into", "panel_plan", "strip_rows", "STRIP_BYTES", "TILE"]

STRIP_BYTES = 256 << 20  # one strip of f32 distances in the strip routes
TILE = 128  # csrc/dist_panel.cu kBM = kBN: rows and columns of an output tile

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_tile = 0  # launches of the earlier tile kernel, through pairwise_tile only


def panel_plan(n: int, m: int, out_ptr: int, resident: int) -> tuple[int, bool, int]:
    """(grid, vec, norm floats) of a distance panel launch for an (n, m)
    output at address ``out_ptr``: one persistent block per tile, at most
    ``resident`` (the blocks the card holds at once, so no second wave
    runs); 16-byte row stores where every output row starts 16-byte
    aligned; the norm scratch, x's and y's rows each padded to whole tiles."""
    rows, cols = -(-n // TILE), -(-m // TILE)
    return max(1, min(rows * cols, resident)), m % 4 == 0 and out_ptr % 16 == 0, (rows + cols) * TILE


@functools.lru_cache(maxsize=None)
def resident_blocks(mutual: bool, device_index: int) -> int:
    """Blocks of the pairwise (or mutual_reach) panel kernel the card holds
    at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.load().repro_dist_panel_plan(int(mutual), ctypes.byref(per_sm))
    _build.check(code, "distance panel plan")
    return max(1, per_sm.value) * torch.cuda.get_device_properties(device_index).multi_processor_count


def _checked(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Validate; True for the card, False for the CPU (plain version)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_sqdist wants (n, d) and (m, d), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"pairwise_sqdist wants float32, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"pairwise_sqdist inputs on {x.device} and {y.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_sqdist runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pairwise_sqdist wants contiguous inputs")
    if max(x.shape[0], y.shape[0]) >= 2**31:
        raise ValueError(f"pairwise kernel takes int32 sizes, got n={x.shape[0]} m={y.shape[0]}")
    return True


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) f32 → (n, m) f32 squared distances."""
    global launches
    if not _checked(x, y):
        return _ref.pairwise_sqdist(x, y)
    n, m = x.shape[0], y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        sq_into(x, y, out)
        launches += 1
    return out


def pairwise_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``pairwise_sqdist`` through the earlier tile kernel, CUDA tensors
    only: the bitwise oracle of the panel kernel on the card."""
    global launches_tile
    if not _checked(x, y):
        raise ValueError("pairwise_tile runs the tile kernel: it takes CUDA tensors only")
    n, m = x.shape[0], y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        with torch.cuda.device(x.device):
            code = _build.load().repro_pairwise_tile_f32(x.data_ptr(), y.data_ptr(), n, m, x.shape[1],
                                                         out.data_ptr(), _build.current_stream(x.device))
        _build.check(code, "pairwise tile")
        launches_tile += 1
    return out


def sq_into(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The kernel's (n, m) squared distances of contiguous f32 CUDA x (n, d)
    and y (m, d), n, m >= 1, written into the contiguous ``out``; not
    counted in ``launches``."""
    (n, d), m = x.shape, y.shape[0]
    grid, vec, floats = panel_plan(n, m, out.data_ptr(), resident_blocks(False, x.device.index))
    norms = torch.empty(floats, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.load().repro_pairwise_panel_f32(x.data_ptr(), y.data_ptr(), n, m, d, grid, int(vec),
                                                      norms.data_ptr(), out.data_ptr(),
                                                      _build.current_stream(x.device))
    _build.check(code, "pairwise")
    return out


def strip_rows(m: int) -> int:
    """Rows per strip of the strip routes: the most whose (rows, m) f32
    distances fit in ``STRIP_BYTES``, at least one."""
    return max(1, STRIP_BYTES // (4 * max(m, 1)))
