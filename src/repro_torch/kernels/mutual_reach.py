"""Eq. 7 mutual-reachability matrix: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel ``repro/kernels/mutual_reach.py``
(``_mutual_reach_kernel`` / ``mutual_reachability``):
``max(d(x, y), cd_x, cd_y)`` tiles with the global diagonal at 0.  On the
main path it builds the (Lp, Lp) W that Borůvka reads.

Bound on the H100: bytes.  At Lp = 8192 the output alone is 256 MiB,
which takes at least 80 µs at 3.35 TB/s, while its 1.07 G FMAs take 32 µs
at 67 TFLOP/s f32.  The kernel (``csrc/mutual_reach.cu``) writes each
element once with warp-wide 128-byte stores, computes distances from
shared-memory row tiles on the CUDA cores in f32 (d in slices of 64
features, so any d runs; ``csrc/dist_tile.cuh``), and fuses the offline
pass's pad mask (rows/columns ≥ ``n_valid`` at +inf) into the same store
— the JAX package applies it as a second full pass over W.  A tensor on
the CPU takes the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["mutual_reachability"]

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def mutual_reachability(x, y, cd_x, cd_y, *, zero_diag: bool = True, n_valid: int | None = None):
    """(n, d), (m, d), (n,), (m,) f32 → (n, m) f32 Eq. 7 matrix; rows and
    columns ≥ ``n_valid`` (when given) are +inf."""
    global launches
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"mutual_reachability wants (n, d), (m, d), got {tuple(x.shape)}, {tuple(y.shape)}")
    if cd_x.shape != (x.shape[0],) or cd_y.shape != (y.shape[0],):
        raise ValueError("mutual_reachability core distances must be (n,) and (m,)")
    if any(t.dtype != torch.float32 for t in (x, y, cd_x, cd_y)):
        raise TypeError("mutual_reachability wants float32 inputs")
    if not (x.device == y.device == cd_x.device == cd_y.device):
        raise ValueError("mutual_reachability inputs on different devices")
    if x.device.type == "cpu":
        return _ref.mutual_reachability(x, y, cd_x, cd_y, zero_diag=zero_diag, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"mutual_reachability runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, y, cd_x, cd_y)):
        raise ValueError("mutual_reachability wants contiguous inputs")
    n, d = x.shape
    m = y.shape[0]
    if max(n, m) >= 2**31:
        raise ValueError(f"mutual_reach kernel takes int32 sizes, got n={n} m={m}")
    nv = max(n, m) if n_valid is None else max(0, min(int(n_valid), max(n, m)))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        lib = _build.load()
        with torch.cuda.device(x.device):
            code = lib.repro_mutual_reach_f32(
                x.data_ptr(), y.data_ptr(), cd_x.data_ptr(), cd_y.data_ptr(), n, m, d,
                int(bool(zero_diag)), nv, out.data_ptr(), _build.current_stream(x.device),
            )
        _build.check(code, "mutual_reach")
        launches += 1
    return out
