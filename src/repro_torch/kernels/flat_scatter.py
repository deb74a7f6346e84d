"""The flat leaf-CF table's block scatter: CUDA kernel and plain version.

Replaces the segment sums and the compensated add of the JAX package's
``repro/core/bubble_flat.py`` (``_flat_insert`` and ``_flat_delete``: three
``jax.ops.segment_sum`` calls and ``_kahan_add``, inside one jit with no
Pallas kernel).  Device-online ingest folds each block of rows into the
table with it: per slot, the rows' x, ``‖x‖²`` and count are summed in
ascending row order, added to the Kahan pairs (LS, LSe) and (SS, SSe) of
every slot, a zero delta included, and the count to N; the work-list flags
come back beside (``alive & N > cap`` on insert, ``alive & N < m`` on
delete).

Bound on the H100: bytes, and at the stream's shapes one launch.  The
state is read and written once and the block read once (~4.7 MB at
Lp = 16384, Bp = 8192, d = 16: 1.4 µs at 3.35 TB/s).  The kernel
(``csrc/flat_scatter.cu``) has no float atomics, so two runs give the same
bits (the checkpoint replay of DESIGN.md §11 depends on it; an
``index_add_`` would not), and it is bit for bit the plain version
(``ref.flat_scatter``): a warp owns a tile of up to 32 slots, walks the
block's slot ids (staged in shared memory, 8192 at a time) with a ballot,
and adds its rows in ascending order with round-to-nearest intrinsics that
are never contracted.  A tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["flat_scatter"]

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def _checked(LS, LSe, SS, SSe, N, alive, x, slot, valid, sign) -> bool:
    """Validate; True for the card, False for the CPU (plain version)."""
    Lp, d = LS.shape
    Bp = x.shape[0]
    shapes = {"LS": (LS, (Lp, d), torch.float32), "LSe": (LSe, (Lp, d), torch.float32),
              "SS": (SS, (Lp,), torch.float32), "SSe": (SSe, (Lp,), torch.float32),
              "N": (N, (Lp,), torch.float32), "alive": (alive, (Lp,), torch.bool),
              "x": (x, (Bp, d), torch.float32), "slot": (slot, (Bp,), torch.int32),
              "valid": (valid, (Bp,), torch.bool)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"flat_scatter: {name} is {t.dtype} {tuple(t.shape)}, wants {dtype} {shape}")
        if t.device != LS.device:
            raise ValueError(f"flat_scatter: {name} on {t.device}, the table on {LS.device}")
    if sign not in (1, -1):
        raise ValueError(f"flat_scatter: sign must be +1 or -1, got {sign}")
    if LS.device.type == "cpu":
        return False
    if LS.device.type != "cuda":
        raise ValueError(f"flat_scatter runs on cuda or cpu, not {LS.device}")
    if not all(t.is_contiguous() for t, _, _ in shapes.values()):
        raise ValueError("flat_scatter wants contiguous tensors")
    if max(Lp * d, Bp * d) >= 2**31:
        raise ValueError(f"flat_scatter takes int32 sizes, got Lp={Lp} Bp={Bp} d={d}")
    return True


def flat_scatter(LS, LSe, SS, SSe, N, alive, x, slot, valid, thresh: float, *, sign: int) -> torch.Tensor:
    """Fold the rows ``x`` (Bp, d) f32, centred at the table's origin, into
    slots ``slot`` (Bp,) int32 where ``valid`` (Bp,) bool: LS, LSe (Lp, d)
    and SS, SSe, N (Lp,) f32 are updated IN PLACE; ``sign`` +1 inserts, -1
    deletes.  Returns the (Lp,) bool work-list flags: ``alive & (N >
    thresh)`` on insert, ``alive & (N < thresh)`` on delete."""
    global launches
    if not _checked(LS, LSe, SS, SSe, N, alive, x, slot, valid, sign):
        *state, flags = _ref.flat_scatter(LS, LSe, SS, SSe, N, alive, x, slot, valid, thresh, sign)
        for t, new in zip((LS, LSe, SS, SSe, N), state):
            t.copy_(new)
        return flags
    (Lp, d), Bp = LS.shape, x.shape[0]
    flags = torch.empty(Lp, dtype=torch.bool, device=LS.device)
    lib = _build.load()
    with torch.cuda.device(LS.device):
        code = lib.repro_flat_scatter_f32(
            LS.data_ptr(), LSe.data_ptr(), SS.data_ptr(), SSe.data_ptr(), N.data_ptr(), alive.data_ptr(),
            x.data_ptr(), slot.data_ptr(), valid.data_ptr(), Bp, Lp, d, float(thresh), int(sign),
            flags.data_ptr(), _build.current_stream(LS.device))
    _build.check(code, "flat_scatter")
    launches += 1
    return flags
