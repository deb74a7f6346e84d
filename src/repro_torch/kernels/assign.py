"""Nearest-representative assignment: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/assign.py``
(``_assign_kernel`` / ``assign``): per query row, the lowest index
attaining ``min_j max(‖x‖² + ‖r_j‖² − 2·x·r_j, 0)``, optionally with the
square root of that minimum.  It serves ingest (the streaming engine's
point → leaf argmin) and the serve plane's fused query.

Bound on the H100: operations.  At the path's shapes (8192 rows × 8192
reps × d = 16) the inputs are about 1 MB, while the distance tile is
n·L·d = 1.07 G FMAs — 32 µs at the card's 67 TFLOP/s of f32 outside the
tensor cores.  The kernel (``csrc/assign.cu``) keeps the work on the CUDA
cores in f32 (no TF32, no tensor cores: d is small and the contract is
f32), holds four query rows per warp so each staged rep feeds four FMA
chains, and streams the rep table through shared memory, so nothing of
size (n, L) exists.  A tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["assign", "MAX_DIM"]

MAX_DIM = 128  # csrc/common.cuh kMaxDim

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def assign(x: torch.Tensor, reps: torch.Tensor, *, with_dist: bool = False):
    """(n, d), (L, d) f32 → (n,) int32 nearest index [, (n,) f32 distance]."""
    global launches
    if x.dim() != 2 or reps.dim() != 2 or x.shape[1] != reps.shape[1]:
        raise ValueError(f"assign wants (n, d) and (L, d), got {tuple(x.shape)} and {tuple(reps.shape)}")
    if x.dtype != torch.float32 or reps.dtype != torch.float32:
        raise TypeError(f"assign wants float32, got {x.dtype} and {reps.dtype}")
    if x.device != reps.device:
        raise ValueError(f"assign inputs on {x.device} and {reps.device}")
    if reps.shape[0] == 0:
        raise ValueError("assign needs at least one representative")
    if x.device.type == "cpu":
        return _ref.assign_with_dist(x, reps) if with_dist else _ref.assign(x, reps)
    if x.device.type != "cuda":
        raise ValueError(f"assign runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and reps.is_contiguous()):
        raise ValueError("assign wants contiguous inputs")
    n, d = x.shape
    L = reps.shape[0]
    if d > MAX_DIM or max(n, L) >= 2**31:
        raise ValueError(f"assign kernel takes d <= {MAX_DIM} and int32 sizes, got n={n} L={L} d={d}")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    dist = torch.empty(n, dtype=torch.float32, device=x.device) if with_dist else None
    if n:
        lib = _build.load()
        with torch.cuda.device(x.device):
            code = lib.repro_assign_f32(
                x.data_ptr(), reps.data_ptr(), n, L, d, idx.data_ptr(),
                dist.data_ptr() if with_dist else None, _build.current_stream(x.device),
            )
        _build.check(code, "assign")
        launches += 1
    return (idx, dist) if with_dist else idx
