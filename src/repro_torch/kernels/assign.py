"""Nearest-representative assignment: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/assign.py``
(``_assign_kernel`` / ``assign``): per query row, the lowest index
attaining ``min_j max(‖x‖² + ‖r_j‖² − 2·x·r_j, 0)``, optionally with the
square root of that minimum.  It serves ingest (the streaming engine's
point → leaf argmin) and the serve plane's fused query.

Bound on the H100: operations.  At the path's shapes (8192 rows × 8192
reps × d = 16) the inputs are about 1 MB, while the distance tile is
n·L·d = 1.07 G FMAs — 32 µs at the card's 67 TFLOP/s of f32 outside the
tensor cores.  The kernel (``csrc/assign_ws.cu``) keeps the work on the
CUDA cores in f32 (no TF32, no tensor cores: d is small and the contract
is f32), holds R query rows per warp in registers (d zero-padded to 16,
32, 64 or 128) and streams the rep table through a double-buffered
``cp.async`` ring with each chunk's norms computed once, so each rep read
feeds R·d FMAs and nothing of size (n, L) exists.  Where the row blocks
alone would leave the card under-filled, L is split across blocks
(``split_for``, sized by the kernel's occupancy so that no second wave
runs) and a second small kernel takes each row's minimum (sq, index) key
over the slices.  Above d = 128 the same kernel file stages query rows
and reps in feature slices of 128 (any d).  A tensor on the CPU takes the
plain version.

``assign_lane`` runs the earlier kernel (``csrc/assign.cu``: four rows
per warp read from shared memory, d ≤ ``MAX_DIM_LANE``).  Its indices and
distances are bitwise the new kernel's, so the card's tests and
``chip_smoke.py`` hold the new kernel to it; nothing else calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ref as _ref

__all__ = ["assign", "assign_lane", "split_for", "MAX_DIM_LANE", "MIN_SPAN"]

MAX_DIM_LANE = 128  # csrc/common.cuh kMaxDim: the per-lane kernel's widths
MIN_SPAN = 256  # reps per L slice, at least

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_lane = 0  # launches of the earlier kernel, through assign_lane only


def split_for(n: int, L: int, rows_per_block: int, resident: int) -> int:
    """Slices of L for n query rows: as many as keep the row blocks times
    the slices within ``resident`` (the blocks the card holds at once, so
    no second wave runs), each slice of at least ``MIN_SPAN`` reps."""
    blocks = -(-n // rows_per_block)
    return max(1, min(resident // max(blocks, 1), L // MIN_SPAN))


@functools.lru_cache(maxsize=None)
def _plan(d: int, device_index: int) -> tuple[int, int]:
    """(query rows per block, blocks the card holds at once) of the kernel
    that serves width d."""
    rows, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.load().repro_assign_ws_plan(d, ctypes.byref(rows), ctypes.byref(per_sm))
    _build.check(code, "assign plan")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return rows.value, max(1, per_sm.value) * sms


def _checked(x: torch.Tensor, reps: torch.Tensor) -> bool:
    """Validate; True for the card, False for the CPU (plain version)."""
    if x.dim() != 2 or reps.dim() != 2 or x.shape[1] != reps.shape[1]:
        raise ValueError(f"assign wants (n, d) and (L, d), got {tuple(x.shape)} and {tuple(reps.shape)}")
    if x.dtype != torch.float32 or reps.dtype != torch.float32:
        raise TypeError(f"assign wants float32, got {x.dtype} and {reps.dtype}")
    if x.device != reps.device:
        raise ValueError(f"assign inputs on {x.device} and {reps.device}")
    if reps.shape[0] == 0:
        raise ValueError("assign needs at least one representative")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"assign runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and reps.is_contiguous()):
        raise ValueError("assign wants contiguous inputs")
    if max(x.shape[0], reps.shape[0]) >= 2**31:
        raise ValueError(f"assign kernel takes int32 sizes, got n={x.shape[0]} L={reps.shape[0]}")
    return True


def _outputs(x: torch.Tensor, with_dist: bool):
    n = x.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    dist = torch.empty(n, dtype=torch.float32, device=x.device) if with_dist else None
    return idx, dist


def assign(x: torch.Tensor, reps: torch.Tensor, *, with_dist: bool = False):
    """(n, d), (L, d) f32 → (n,) int32 nearest index [, (n,) f32 distance]."""
    global launches
    if not _checked(x, reps):
        return _ref.assign_with_dist(x, reps) if with_dist else _ref.assign(x, reps)
    (n, d), L = x.shape, reps.shape[0]
    idx, dist = _outputs(x, with_dist)
    if n:
        lib = _build.load()
        split = split_for(n, L, *_plan(d, x.device.index))
        part = torch.empty((split, n), dtype=torch.int64, device=x.device) if split > 1 else None
        with torch.cuda.device(x.device):
            code = lib.repro_assign_ws_f32(
                x.data_ptr(), reps.data_ptr(), n, L, d, split, idx.data_ptr(),
                dist.data_ptr() if with_dist else None, part.data_ptr() if split > 1 else None,
                _build.current_stream(x.device))
        _build.check(code, "assign")
        launches += 1
    return (idx, dist) if with_dist else idx


def assign_lane(x: torch.Tensor, reps: torch.Tensor, *, with_dist: bool = False):
    """``assign`` through the earlier kernel, d <= MAX_DIM_LANE: the bitwise
    oracle of the new kernel on the card."""
    global launches_lane
    if not _checked(x, reps):
        return _ref.assign_with_dist(x, reps) if with_dist else _ref.assign(x, reps)
    (n, d), L = x.shape, reps.shape[0]
    if d > MAX_DIM_LANE:
        raise ValueError(f"the per-lane assign kernel takes d <= {MAX_DIM_LANE}, got {d}")
    idx, dist = _outputs(x, with_dist)
    if n:
        lib = _build.load()
        with torch.cuda.device(x.device):
            code = lib.repro_assign_f32(
                x.data_ptr(), reps.data_ptr(), n, L, d, idx.data_ptr(),
                dist.data_ptr() if with_dist else None, _build.current_stream(x.device))
        _build.check(code, "assign")
        launches_lane += 1
    return (idx, dist) if with_dist else idx
