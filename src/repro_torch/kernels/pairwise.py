"""Pairwise squared euclidean distances: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/pairwise.py``
(``_pairwise_kernel`` / ``pairwise_sqdist``): the (n, m) tiles
``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``.  It serves ``ops.pairwise_sqdist`` and
``ClusterBackend.pairwise_sqdist``.

Bound on the H100: bytes.  At 16,384² the output alone is 1 GiB, at
least 0.32 ms at 3.35 TB/s, while its 4.3 G FMAs take 0.13 ms at
67 TFLOP/s f32.  The kernel (``csrc/pairwise.cu``) writes each element
once with warp-wide 128-byte stores from 64 × 64 tiles whose row tiles
sit in shared memory, in f32 on the CUDA cores, walking d in slices of 64
features with the accumulators in registers, so any d runs in the same
34 KB of shared memory with the bits of one unsliced chain.  It shares its
tile code (``csrc/dist_tile.cuh``) with the mutual_reach kernel, so the
two give the same squared distance bits for the same pair.  ``sq_into``
launches it uncounted into a given buffer: the strip routes of knn and
bubble_cd take their (rows, m) strips from it.  A tensor on the CPU takes
the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["pairwise_sqdist", "sq_into", "strip_rows", "STRIP_BYTES"]

STRIP_BYTES = 256 << 20  # one strip of f32 distances in the strip routes

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) f32 → (n, m) f32 squared distances."""
    global launches
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_sqdist wants (n, d) and (m, d), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"pairwise_sqdist wants float32, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"pairwise_sqdist inputs on {x.device} and {y.device}")
    if x.device.type == "cpu":
        return _ref.pairwise_sqdist(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_sqdist runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pairwise_sqdist wants contiguous inputs")
    n, m = x.shape[0], y.shape[0]
    if max(n, m) >= 2**31:
        raise ValueError(f"pairwise kernel takes int32 sizes, got n={n} m={m}")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        sq_into(x, y, out)
        launches += 1
    return out


def sq_into(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The kernel's (n, m) squared distances of contiguous f32 CUDA x (n, d)
    and y (m, d), n, m >= 1, written into the contiguous ``out``; not
    counted in ``launches``."""
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.repro_pairwise_f32(x.data_ptr(), y.data_ptr(), x.shape[0], y.shape[0], x.shape[1],
                                      out.data_ptr(), _build.current_stream(x.device))
    _build.check(code, "pairwise")
    return out


def strip_rows(m: int) -> int:
    """Rows per strip of the strip routes: the most whose (rows, m) f32
    distances fit in ``STRIP_BYTES``, at least one."""
    return max(1, STRIP_BYTES // (4 * max(m, 1)))
