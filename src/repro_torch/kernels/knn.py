"""k nearest neighbours: CUDA kernels and plain version.

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
m = 16,384.  On the card a call takes one of two routes, chosen by
``route(d, k)`` before the launch:

* ``"ws"`` (d ≤ ``MAX_DIM``, k ≤ ``MAX_K``): ``csrc/knn_ws.cu`` on
  ``csrc/warp_select.cuh`` keeps R query rows per warp in registers and
  streams y through a ``cp.async`` ring in shared memory once per block of
  rows, so each y element read feeds R FMAs; the k nearest (d, j) of each
  row stay in registers (WarpSelect: per-lane thread queues merged into a
  sorted warp queue by bitonic shuffles).  Each distance is computed once,
  nothing of size (n, m) is held, and no m cap applies.
* ``"strip"`` (wider rows or larger k, whose queues and row registers the
  warp-select core cannot hold): strips of S rows × m squared distances
  from the pairwise panel kernel (``pairwise.sq_into``: the same bits as the
  warp-select kernel's), S chosen so that one strip stays within
  ``pairwise.STRIP_BYTES``, then square roots and a stable sort per row,
  whose order is the (distance, index) order of the warp-select key; the
  first k are kept.  Nothing of size (n, m) exists.

The route is a pure function of the shapes: it is never taken because a
kernel failed, and a failure raises.  ``launches`` counts both routes,
``launches_ws`` and ``launches_strip`` each.  A tensor on the CPU takes
the plain version.

``knn_lane`` runs the earlier kernel (``csrc/knn.cu``: one warp per row,
per-lane sorted buffers in local memory, k ≤ ``MAX_K_LANE``, d ≤
``MAX_DIM``).  Its results are bitwise the warp-select kernel's, so the
card's tests and ``chip_smoke.py`` hold that kernel to it; nothing else
calls it.
"""

from __future__ import annotations

import torch

from . import _build
from . import pairwise as _pw_k
from . import ref as _ref

__all__ = ["knn", "knn_strip", "knn_lane", "route", "MAX_K", "MAX_K_LANE", "MAX_DIM"]

MAX_K = 1024  # csrc/warp_select.cuh kMaxK: the largest warp queue
MAX_K_LANE = 64  # csrc/knn.cu kMaxK
MAX_DIM = 128  # csrc/common.cuh kMaxDim: the widest register tile

launches = 0  # kernel launches since the last reset, both routes (chip_smoke.py reads it)
launches_ws = 0  # of the warp-select kernel
launches_strip = 0  # of the strip route
launches_lane = 0  # launches of the earlier kernel, through knn_lane only


def route(d: int, k: int) -> str:
    """The route a CUDA call at width d and k takes: ``"ws"`` or ``"strip"``."""
    return "ws" if d <= MAX_DIM and k <= MAX_K else "strip"


def _checked(x: torch.Tensor, y: torch.Tensor, k: int) -> int:
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"knn wants (n, d) and (m, d), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"knn wants float32, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"knn inputs on {x.device} and {y.device}")
    k = int(k)
    if not 1 <= k <= y.shape[0]:
        raise ValueError(f"knn wants 1 <= k <= m, got k={k} m={y.shape[0]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda":
        if not (x.is_contiguous() and y.is_contiguous()):
            raise ValueError("knn wants contiguous inputs")
        if max(x.shape[0], y.shape[0]) >= 2**31:
            raise ValueError(f"knn kernel takes int32 sizes, got n={x.shape[0]} m={y.shape[0]}")
    return k


def _launch(entry: str, x: torch.Tensor, y: torch.Tensor, k: int):
    n, d = x.shape
    dist = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n:
        lib = _build.load()
        with torch.cuda.device(x.device):
            code = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), n, y.shape[0], d, k, dist.data_ptr(),
                                       idx.data_ptr(), _build.current_stream(x.device))
        _build.check(code, "knn")
    return dist, idx


def knn(x: torch.Tensor, y: torch.Tensor, k: int):
    """(n, d), (m, d) f32, 1 <= k <= m → ((n, k) f32 distances ascending,
    (n, k) int32 indices into y)."""
    global launches, launches_ws
    k = _checked(x, y, k)
    if x.device.type == "cpu":
        return _ref.knn(x, y, k)
    if route(x.shape[1], k) == "strip":
        return knn_strip(x, y, k)
    dist, idx = _launch("repro_knn_ws_f32", x, y, k)
    if x.shape[0]:
        launches += 1
        launches_ws += 1
    return dist, idx


def knn_strip(x: torch.Tensor, y: torch.Tensor, k: int):
    """``knn`` through the strip route at any d and k (``knn`` takes it
    where ``route`` says so; the card's tests also call it at the
    warp-select kernel's bounds, where the two agree bit for bit)."""
    global launches, launches_strip
    k = _checked(x, y, k)
    if x.device.type == "cpu":
        return _ref.knn(x, y, k)
    n, m = x.shape[0], y.shape[0]
    dist = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if not n:
        return dist, idx
    rows = min(_pw_k.strip_rows(m), n)
    strip = torch.empty((rows, m), dtype=torch.float32, device=x.device)
    for i in range(0, n, rows):
        sq = _pw_k.sq_into(x[i : i + rows], y, strip[: min(rows, n - i)])
        vals, order = torch.sort(sq.sqrt_(), dim=1, stable=True)
        dist[i : i + rows] = vals[:, :k]
        idx[i : i + rows] = order[:, :k]
    launches += 1
    launches_strip += 1
    return dist, idx


def knn_lane(x: torch.Tensor, y: torch.Tensor, k: int):
    """``knn`` through the earlier per-lane kernel, k <= MAX_K_LANE and
    d <= MAX_DIM: the bitwise oracle of the warp-select kernel on the card."""
    global launches_lane
    k = _checked(x, y, k)
    if k > MAX_K_LANE:
        raise ValueError(f"the per-lane knn kernel takes k <= {MAX_K_LANE}, got {k}")
    if x.device.type == "cpu":
        return _ref.knn(x, y, k)
    if x.shape[1] > MAX_DIM:
        raise ValueError(f"the per-lane knn kernel takes d <= {MAX_DIM}, got {x.shape[1]}")
    dist, idx = _launch("repro_knn_f32", x, y, k)
    if x.shape[0]:
        launches_lane += 1
    return dist, idx
