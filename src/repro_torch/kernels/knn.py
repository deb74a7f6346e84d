"""k nearest neighbours: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/knn.py``
(``_knn_kernel`` / ``knn``): per query row, the k smallest distances
``sqrt(max(‖x‖² + ‖y_j‖² − 2·x·y_j, 0))`` to the rows of y, ascending,
with their indices; equal distances keep the lower index first.  It
serves ``ops.knn``, ``ops.core_distances`` (Def. 1) and
``ClusterBackend.knn``.

Bound on the H100: operations.  Every query–reference distance is needed
once: n·m·d FMAs, 68.7 G at n = m = 65,536, d = 16 — 2.05 ms at
67 TFLOP/s f32; the inputs are 8 MiB.  The Pallas kernel holds the whole
reference set and a (bn, m) distance tile in VMEM and runs k masked
row-min passes over it, so the JAX package falls back to jnp above
m = 16,384.  The CUDA kernel (``csrc/knn.cu``, the design of
``csrc/bubble_cd.cu``) streams y through shared memory once per block of
rows, each lane keeping a sorted buffer of its k nearest (d, j), and
merges the 32 buffers per row: each distance is computed once, nothing
of size (n, m) is held, and no m cap applies.  ``k`` is a runtime
argument bounded by ``MAX_K``.  A tensor on the CPU takes the plain
version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["knn", "MAX_K", "MAX_DIM"]

MAX_K = 64  # csrc/knn.cu kMaxK
MAX_DIM = 128

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def knn(x: torch.Tensor, y: torch.Tensor, k: int):
    """(n, d), (m, d) f32, 1 <= k <= m → ((n, k) f32 distances ascending,
    (n, k) int32 indices into y)."""
    global launches
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"knn wants (n, d) and (m, d), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"knn wants float32, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"knn inputs on {x.device} and {y.device}")
    n, d = x.shape
    m = y.shape[0]
    k = int(k)
    if not 1 <= k <= m:
        raise ValueError(f"knn wants 1 <= k <= m, got k={k} m={m}")
    if k > MAX_K:
        raise ValueError(f"knn kernel takes k <= {MAX_K}, got {k}")
    if x.device.type == "cpu":
        return _ref.knn(x, y, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("knn wants contiguous inputs")
    if d > MAX_DIM or max(n, m) >= 2**31:
        raise ValueError(f"knn kernel takes d <= {MAX_DIM} and int32 sizes, got n={n} m={m} d={d}")
    dist = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n:
        lib = _build.load()
        with torch.cuda.device(x.device):
            code = lib.repro_knn_f32(x.data_ptr(), y.data_ptr(), n, m, d, k, dist.data_ptr(),
                                     idx.data_ptr(), _build.current_stream(x.device))
        _build.check(code, "knn")
        launches += 1
    return dist, idx
