"""The exact-dynamic engine's strip work: launch wrappers of the strip
kernels redesigned for Hopper (``csrc/strip_tiles.cu``: the distances and
the top-k), of the round minima's redesign (``csrc/strip_minima.cu``) and
of the first versions of all three (``csrc/dynamic.cu``), which stay as
their bitwise oracles and run on no path.

The PyTorch counterpart of the jnp strip programs of the JAX package's
exact-dynamic path (``repro/core/dynamic_jax.py`` and
``core/mst.py::boruvka_strip_jax``), which have no Pallas kernel:

  ``strip_dists``         (U, Np) diff-form distances of U gathered rows to
                          every slot, replacing ``dynamic_jax.py:145``
                          (``_strip_dists``) and ``:126`` (``_dense_dists``);
  ``strip_topk``          the masked, ascending K smallest of each strip
                          row, replacing the ``lax.top_k`` calls at
                          ``dynamic_jax.py:187``, ``:207``, ``:287``, ``:429``;
  ``strip_round_minima``  one Borůvka round's lexicographic (w, pair id,
                          payload) row and column minima of a strip,
                          replacing ``mst.py:777-819``;
  ``strip_round_minima_from_dists``  the same minima from the strip's
                          factors (distances, core distances, row and
                          column masks), the weights and the mask formed
                          in the kernel: the update's route.  The first
                          form stays as its bitwise oracle.

``strip_dists_v1`` and ``strip_topk_v1`` launch the first kernels of the
distances and the top-k, the oracles of the redesign.  Each wrapper is bit
for bit its plain version in ``kernels/ref.py``: a tensor on the CPU takes
the plain version, a CUDA tensor launches the kernel, and any other device
raises.  Bounds on the H100: instructions for the distances (3·U·Np·d FP32
instructions, no FMA), bytes for the rest (each source's header says why
and what the design does about it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ref as _ref
from .hierarchy import _on_card

__all__ = ["strip_dists", "strip_dists_v1", "strip_topk", "strip_topk_v1", "strip_round_minima",
           "strip_round_minima_from_dists", "launches"]

_INT32_MAX = 2**31 - 1

launches = {"strip_dists": 0, "strip_topk": 0, "strip_round_minima": 0, "strip_round_minima_from_dists": 0,
            "strip_dists_v1": 0, "strip_topk_v1": 0}


def _launch(name: str, entry: str, device, *args) -> None:
    lib = _build.load()
    with torch.cuda.device(device):
        code = getattr(lib, entry)(*args, _build.current_stream(device))
    _build.check(code, name)
    launches[name] += 1


def strip_dists(rows: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(U, d) rows and (Np, d) slots → (U, Np) f32 diff-form distances
    ``sqrt(Σ_k (rows[u, k] − X[j, k])²)``, the sum in ascending k with no
    FMA (``csrc/strip_tiles.cu``).  ``out``: a contiguous (U, Np) f32
    buffer to write into (a row slice of a larger strip, at any offset)."""
    return _dists("strip_dists", "repro_strip_dists_tiles_f32", rows, X, out)


def strip_dists_v1(rows: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``strip_dists`` through its first kernel (``csrc/dynamic.cu``), the
    redesign's bitwise oracle: no path calls it."""
    return _dists("strip_dists_v1", "repro_strip_dists_f32", rows, X, out)


def _dists(name: str, entry: str, rows, X, out):
    on_card = _on_card(name, rows, X)
    if rows.dim() != 2 or X.dim() != 2 or rows.shape[1] != X.shape[1]:
        raise ValueError(f"{name} wants (U, d) rows and (Np, d) slots, got {tuple(rows.shape)} "
                         f"and {tuple(X.shape)}")
    U, Np = rows.shape[0], X.shape[0]
    if out is not None and (out.shape != (U, Np) or out.dtype != torch.float32 or not out.is_contiguous()
                            or out.device != X.device):
        raise ValueError(f"{name} writes a contiguous ({U}, {Np}) f32 buffer on {X.device}")
    if not on_card:
        res = _ref.strip_dists(rows, X)
        return res if out is None else out.copy_(res)
    rows, X = rows.float().contiguous(), X.float().contiguous()
    out = torch.empty((U, Np), dtype=torch.float32, device=X.device) if out is None else out
    if U * Np:
        _launch(name, entry, X.device, rows.data_ptr(), U, X.data_ptr(), Np, rows.shape[1], out.data_ptr())
    return out


def strip_topk(D: torch.Tensor, row_ids, row_valid, alive, K: int):
    """Per row u of the (U, Np) strip ``D`` (distances ≥ 0, a row view at
    any offset), the K smallest (distance, column) pairs over the columns
    j with ``row_valid[u] & alive[j] & (j != row_ids[u])``, ascending with
    ties at the lowest column, padded with (+inf, −1)
    (``csrc/strip_tiles.cu``).  Returns ((U, K) f32, (U, K) int32)."""
    return _topk("strip_topk", "repro_strip_topk_tiles_f32", D, row_ids, row_valid, alive, K)


def strip_topk_v1(D: torch.Tensor, row_ids, row_valid, alive, K: int):
    """``strip_topk`` through its first kernel (``csrc/dynamic.cu``), the
    redesign's bitwise oracle: no path calls it."""
    return _topk("strip_topk_v1", "repro_strip_topk_f32", D, row_ids, row_valid, alive, K)


def _topk(name: str, entry: str, D, row_ids, row_valid, alive, K):
    on_card = _on_card(name, D, row_ids, row_valid, alive)
    if D.dim() != 2:
        raise ValueError(f"{name} wants a (U, Np) strip, got {tuple(D.shape)}")
    U, Np = D.shape
    K = int(K)
    if row_ids.shape != (U,) or row_valid.shape != (U,) or alive.shape != (Np,) or K < 1:
        raise ValueError(f"{name} wants ({U},) row ids and validity, ({Np},) alive and K >= 1")
    if not on_card:
        return _ref.strip_topk(D, row_ids, row_valid.bool(), alive.bool(), K)
    D = D.float().contiguous()
    row_ids = row_ids.to(torch.int32).contiguous()
    row_valid, alive = row_valid.bool().contiguous(), alive.bool().contiguous()
    out_d = torch.empty((U, K), dtype=torch.float32, device=D.device)
    out_i = torch.empty((U, K), dtype=torch.int32, device=D.device)
    if U:
        _launch(name, entry, D.device, D.data_ptr(), U, Np, row_ids.data_ptr(), row_valid.data_ptr(),
                alive.data_ptr(), K, out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


def _check_minima(name: str, U: int, n: int, E: int) -> None:
    if n * n > _INT32_MAX or E < 0 or E + U * n > _INT32_MAX:
        raise ValueError(f"{name}: pair ids and payloads must stay int32 (n = {n}, E = {E}, U = {U})")


def strip_round_minima(SW: torch.Tensor, smask, sids, lab, E: int = 0):
    """One Borůvka round's strip reductions: per strip row and per column
    of the (U, n) weights ``SW``, the lexicographic minimum of (w, pair id
    ``min(s, c)·n + max(s, c)``, payload ``E + row·n + col``) over the
    entries ``smask & (lab[sids[row]] != lab[col])``; (+inf, int32 max,
    int32 max) where none.  Returns (row_w, row_eid, row_pay, col_w,
    col_eid, col_pay): f32 weights, int64 ids."""
    on_card = _on_card("strip_round_minima", SW, smask, sids, lab)
    if SW.dim() != 2:
        raise ValueError(f"strip_round_minima wants a (U, n) strip, got {tuple(SW.shape)}")
    U, n = SW.shape
    E = int(E)
    if smask.shape != (U, n) or sids.shape != (U,) or lab.shape != (n,):
        raise ValueError(f"strip_round_minima wants a ({U}, {n}) mask, ({U},) strip ids and ({n},) labels")
    _check_minima("strip_round_minima", U, n, E)
    if not on_card:
        return _ref.strip_round_minima(SW, smask.bool(), sids, lab, E)
    dev = SW.device
    SW, smask = SW.float().contiguous(), smask.bool().contiguous()
    sids, lab = sids.to(torch.int32).contiguous(), lab.long().contiguous()
    rw = torch.empty(U, dtype=torch.float32, device=dev)
    re = torch.empty(U, dtype=torch.int32, device=dev)
    rp = torch.empty(U, dtype=torch.int32, device=dev)
    cw = torch.empty(n, dtype=torch.float32, device=dev)
    ce = torch.empty(n, dtype=torch.int32, device=dev)
    cp = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("strip_round_minima", "repro_strip_round_minima_f32", dev, SW.data_ptr(), smask.data_ptr(),
            sids.data_ptr(), lab.data_ptr(), U, n, E, rw.data_ptr(), re.data_ptr(), rp.data_ptr(),
            cw.data_ptr(), ce.data_ptr(), cp.data_ptr())
    return rw, re.long(), rp.long(), cw, ce.long(), cp.long()


@functools.lru_cache(maxsize=None)
def _minima_plan(U: int, n: int, device_index: int) -> tuple[int, int]:
    """(row chunks, column tiles) of ``strip_minima.cu`` for a (U, n) strip."""
    nrc, nct = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.load().repro_strip_minima_plan(U, n, ctypes.byref(nrc), ctypes.byref(nct))
    _build.check(code, "strip_round_minima_from_dists plan")
    return nrc.value, nct.value


def strip_round_minima_from_dists(D: torch.Tensor, cd, sids, row_valid, alive, lab, E: int = 0):
    """``strip_round_minima`` from the strip's factors: the exact insert's
    weights ``SW = max(max(D, cd[sids][:, None]), cd[None, :])`` and mask
    ``smask = row_valid[:, None] & alive[None, :] & (col != sids[:, None])``
    formed entry by entry in the kernel (one read of ``D`` a round; no (U,
    n) intermediate).  ``D`` (U, n) distances, ``cd``
    (n,), ``sids`` (U,) node ids, ``row_valid`` (U,), ``alive`` (n,),
    ``lab`` (n,) node ids in [0, n).  Returns what ``strip_round_minima``
    returns on that SW and smask, bit for bit."""
    on_card = _on_card("strip_round_minima_from_dists", D, cd, sids, row_valid, alive, lab)
    if D.dim() != 2:
        raise ValueError(f"strip_round_minima_from_dists wants a (U, n) strip, got {tuple(D.shape)}")
    U, n = D.shape
    E = int(E)
    if cd.shape != (n,) or sids.shape != (U,) or row_valid.shape != (U,) or alive.shape != (n,) or lab.shape != (n,):
        raise ValueError(f"strip_round_minima_from_dists wants ({n},) core distances, alive and labels and ({U},) "
                         "strip ids and row validity")
    _check_minima("strip_round_minima_from_dists", U, n, E)
    if not on_card:
        return _ref.strip_round_minima_from_dists(D, cd, sids, row_valid.bool(), alive.bool(), lab, E)
    dev = D.device
    D, cd = D.float().contiguous(), cd.float().contiguous()
    sids, lab = sids.to(torch.int32).contiguous(), lab.long().contiguous()
    row_valid, alive = row_valid.bool().contiguous(), alive.bool().contiguous()
    nrc, nct = _minima_plan(U, n, dev.index if dev.index is not None else torch.cuda.current_device())
    # one f32 buffer (the weights) and one int64 buffer: pair ids, payloads, then the kernel's scratch (nct·U
    # 64-bit row partials and nrc·n column partials of 12 bytes)
    w = torch.empty(U + n, dtype=torch.float32, device=dev)
    ids = torch.empty(2 * (U + n) + nct * U + (3 * nrc * n + 1) // 2, dtype=torch.int64, device=dev)
    rw, cw = w[:U], w[U:]
    re, rp, ce, cp = ids[:U], ids[U : 2 * U], ids[2 * U : 2 * U + n], ids[2 * U + n : 2 * (U + n)]
    _launch("strip_round_minima_from_dists", "repro_strip_round_minima_from_dists_f32", dev, D.data_ptr(),
            cd.data_ptr(), sids.data_ptr(), row_valid.data_ptr(), alive.data_ptr(), lab.data_ptr(), U, n, E, nrc,
            ids[2 * (U + n) :].data_ptr(), rw.data_ptr(), re.data_ptr(), rp.data_ptr(), cw.data_ptr(), ce.data_ptr(),
            cp.data_ptr())
    return rw, re, rp, cw, ce, cp
