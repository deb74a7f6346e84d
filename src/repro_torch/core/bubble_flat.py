"""Device-resident flat leaf-CF table: the device-online ingest path
(DESIGN.md §8).

The PyTorch counterpart of the JAX package's ``core/bubble_flat.py``.
`BubbleTree` keeps its topology on the host; what dominates a block op is
the dense part — point → leaf assignment (O(B·L·d)) and the CF
accumulation — and that is what this table keeps on the card:

  * the leaf CF table lives in a power-of-two slot bucket (``Lp`` rows,
    ~2× headroom), **centred** at a fixed f64 ``origin`` so the f32 rows
    never see off-origin cancellation (§2); dead slots sit at zero and are
    parked at ``_PAD_COORD`` for the assignment;
  * ``insert_block`` runs the assign kernel over the ``_pow2(_hi)`` prefix
    of live slots (with ``spatial_index``, the grid's assign with the
    live slots as its valid rows, so a dead slot is never a candidate), then the ``flat_scatter`` kernel folds the block into
    the whole bucket: per slot, the rows summed in ascending row order and
    added to compensated (Kahan hi/err) accumulators, no float atomics;
    ``delete_block`` subtracts with the same kernel at slots the host
    already knows;
  * overfull/underfilled slots come back as the work-list the host tree
    consumes for its splits and dissolves;
  * structural maintenance is mirrored by overwriting exactly the rows the
    tree marked dirty (``consume_struct_dirty``) from host f64 truth.

The tensors are updated IN PLACE (JAX's arrays are immutable; these are
not), so ``capture`` clones the six of them on the card — O(Lp·d), device
to device, ordered on the stream before any later scatter — and takes the
populated slots in ascending order from the host: ``_alive_host`` and the
host tree's N, which equals the card's exactly (integral counts in f32).
An offline pass then reads the table with no upload of the summary and no
read of the device before its unwrap (``ops.offline_recluster_from_device_table``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_device, to_numpy
from ..kernels import assign as _assign_k
from ..kernels import flat_scatter as _fs_k
from ..kernels import grid as _grid_k
from ..launch.mesh import resolve_mesh
from .device_table import FlatTableCapture

__all__ = ["BubbleFlat", "FlatFrameError"]

# the offline pass's pad coordinate: dead slots park there so no real
# (centred) point ever selects them in the argmin
_PAD_COORD = 1e6


class FlatFrameError(RuntimeError):
    """A block landed outside the table's centred frame (the dead-slot
    guard of `BubbleFlat.insert_block`): the table is stale and must reload
    at a fresh origin; the block itself belongs on the host path.  Any
    other error of the block (a kernel that fails to build or launch) is
    not this one and must reach the caller."""


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n - 1, 1)).bit_length())


class BubbleFlat:
    """Flat SoA mirror of a BubbleTree's alive-leaf CF table on the device.

    Life cycle: `load(tree)` (full upload — bucket growth, bootstrap, or
    explicit resync), then per block `insert_block`/`delete_block`
    (scatter) and `sync_struct(tree)` (patch the rows the tree's
    maintenance touched).  `capture()` hands an offline pass an isolation
    copy; `host_cfs()` reconstructs uncentred f64 CFs from the device for
    the differential tests."""

    def __init__(self, dim: int, device=None, capacity: int = 64, spatial_index: bool = False, mesh=None):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self.spatial_index = bool(spatial_index)
        # baked into every capture(): offline passes over this table run
        # the O(L²) stage sharded over the mesh (DESIGN.md §12)
        self.mesh = resolve_mesh(mesh, self.device)
        self.stale = True  # needs a full load before first use
        self.loads = 0  # full host -> device uploads (bootstrap + re-buckets)
        self.origin = np.zeros(self.dim, dtype=np.float64)
        self._tree = None  # the tree last loaded or synced: capture reads its N
        self._alloc(_pow2(capacity))

    def _alloc(self, Lp: int):
        self.Lp = int(Lp)
        z = dict(dtype=torch.float32, device=self.device)
        self.LS = torch.zeros((Lp, self.dim), **z)
        self.LSe = torch.zeros((Lp, self.dim), **z)
        self.SS = torch.zeros(Lp, **z)
        self.SSe = torch.zeros(Lp, **z)
        self.N = torch.zeros(Lp, **z)
        self.alive = torch.zeros(Lp, dtype=torch.bool, device=self.device)
        self.leaf_of_slot = np.full(Lp, -1, dtype=np.int64)
        self.slot_of_leaf: dict[int, int] = {}
        self._free = list(range(Lp - 1, -1, -1))
        self._alive_host = np.zeros(Lp, dtype=bool)
        self._hi = 0  # live-slot watermark (exact after load, then grows)

    def _upload(self, a, dtype=torch.float32) -> torch.Tensor:
        return to_device(np.ascontiguousarray(a), self.device, dtype)

    # -- full (re)load ----------------------------------------------------

    def load(self, tree):
        """Full upload from the tree's f64 SoA: re-centre at the current
        mass centroid, re-bucket to a power of two with ~2× headroom for
        structural churn.  One transfer per bucket epoch — never per
        offline pass."""
        ids = tree.alive_leaf_ids()
        ids = ids[tree.N[ids] > 0]
        L = len(ids)
        self._alloc(_pow2(max(2 * L, 8)))
        LS = tree.LS[ids].astype(np.float64)
        SS = tree.SS[ids].astype(np.float64)
        N = tree.N[ids].astype(np.float64)
        tot = max(N.sum(), 1.0)
        self.origin = LS.sum(axis=0) / tot
        LSc, SSc = self._center(LS, SS, N)
        buf_LS = np.zeros((self.Lp, self.dim), dtype=np.float32)
        buf_SS = np.zeros(self.Lp, dtype=np.float32)
        buf_N = np.zeros(self.Lp, dtype=np.float32)
        buf_LS[:L] = LSc
        buf_SS[:L] = SSc
        buf_N[:L] = N
        self.LS = self._upload(buf_LS)
        self.SS = self._upload(buf_SS)
        self.N = self._upload(buf_N)
        self._alive_host[:L] = True
        self.alive = self._upload(self._alive_host, torch.bool)
        self.leaf_of_slot[:L] = ids
        self.slot_of_leaf = {int(leaf): s for s, leaf in enumerate(ids)}
        self._free = list(range(self.Lp - 1, L - 1, -1))
        self._hi = L
        tree.consume_struct_dirty()  # the load covered everything
        self._tree = tree
        self.stale = False
        self.loads += 1

    def _center(self, LS, SS, N):
        """f64 host centring: CF of {x} → CF of {x - origin}."""
        o = self.origin
        LS = np.asarray(LS, dtype=np.float64)
        N = np.asarray(N, dtype=np.float64)
        LSc = LS - N[..., None] * o
        SSc = SS - 2.0 * (LS @ o) + N * float(o @ o)
        return LSc, SSc

    # -- block ops --------------------------------------------------------

    def _block(self, X):
        """The block centred at the origin, f32, padded to a power of two,
        on the device, with its row-valid mask."""
        X = np.asarray(X, dtype=np.float64)
        B = X.shape[0]
        Bp = _pow2(B)
        Xc = np.zeros((Bp, self.dim), dtype=np.float32)
        Xc[:B] = X - self.origin
        valid = np.zeros(Bp, dtype=bool)
        valid[:B] = True
        return B, Bp, self._upload(Xc), self._upload(valid, torch.bool)

    def insert_block(self, X, cap: float):
        """Device assignment + scatter for a block: returns (leaf ids per
        row, overfull-leaf work-list).  ``cap`` is the tree's leaf_cap at
        the post-block population (the overfull threshold the work-list
        reports against)."""
        B, _, xc, valid = self._block(X)
        hp = _pow2(self._hi)
        n = self.N[:hp]
        reps = self.LS[:hp] / torch.clamp_min(n, 1.0)[:, None]
        live = self.alive[:hp] & (n > 0)
        reps = torch.where(live[:, None], reps, _PAD_COORD).contiguous()
        if self.spatial_index:
            a, _ = _grid_k.grid_assign(_grid_k.build_grid(reps, live), xc)
            a = torch.clamp_max(a, hp - 1)  # no live slot at all: a dead row, refused below
        else:
            a = _assign_k.assign(xc, reps)
        over = _fs_k.flat_scatter(self.LS, self.LSe, self.SS, self.SSe, self.N, self.alive,
                                  xc, a, valid, float(cap), sign=1)
        slots, over = to_numpy(a[:B], over)  # the block's one read of the device
        leaf_ids = self.leaf_of_slot[slots]
        if leaf_ids.min(initial=0) < 0:
            # a point picked a dead slot: only possible when the block sits
            # further from every live rep than the _PAD_COORD parking
            # coordinate (~1e6 in the centred frame), i.e. the stream
            # drifted far outside the origin frame.  Refuse loudly — the
            # caller must reload (fresh origin) rather than let a -1 leaf
            # id reach the tree as a Python negative index.
            self.stale = True
            raise FlatFrameError(
                "flat assignment landed on a dead slot — block is outside "
                "the centered frame; reload the flat state (fresh origin)"
            )
        work = self.leaf_of_slot[np.flatnonzero(over)]
        return leaf_ids, work

    def delete_block(self, leaf_ids, X, m: int) -> torch.Tensor:
        """Scatter subtraction for a victim block whose per-point leaves
        the host already knows.  Returns the underfilled slot mask as a
        DEVICE tensor — the engine's host tree re-derives dissolves from
        its own f64 state, so reading it would be a sync the hot path does
        not need."""
        B, Bp, xc, valid = self._block(X)
        slots = np.zeros(Bp, dtype=np.int32)
        slots[:B] = [self.slot_of_leaf[int(leaf)] for leaf in leaf_ids]
        return _fs_k.flat_scatter(self.LS, self.LSe, self.SS, self.SSe, self.N, self.alive,
                                  xc, self._upload(slots, torch.int32), valid, float(m), sign=-1)

    # -- structural patching ----------------------------------------------

    def sync_struct(self, tree):
        """Consume the tree's structural-dirty set and patch those rows
        (overwrite from f64 truth, compensations reset).  Grows to a fresh
        bucket via a full reload when slots run out."""
        if self.stale:
            self.load(tree)
            return
        self._tree = tree
        dirty = tree.consume_struct_dirty()
        if not dirty:
            return
        born = [
            leaf for leaf in dirty
            if leaf not in self.slot_of_leaf
            and leaf < tree.node_alive.shape[0]
            and tree.node_alive[leaf] and tree.is_leaf[leaf]
        ]
        if len(born) > len(self._free):
            self.load(tree)  # bucket exhausted: re-bucket + fresh origin
            return
        rows, alive_leaves, al = [], [], []
        for leaf in sorted(dirty):
            leaf = int(leaf)
            alive = (
                leaf < tree.node_alive.shape[0]
                and tree.node_alive[leaf]
                and tree.is_leaf[leaf]
            )
            if alive:
                slot = self.slot_of_leaf.get(leaf)
                if slot is None:
                    slot = self._free.pop()
                    self.slot_of_leaf[leaf] = slot
                    self.leaf_of_slot[slot] = leaf
                    self._hi = max(self._hi, slot + 1)
                rows.append(slot)
                alive_leaves.append(leaf)
                al.append(True)
            else:
                slot = self.slot_of_leaf.pop(leaf, None)
                if slot is None:
                    continue  # died before it ever had a row
                self.leaf_of_slot[slot] = -1
                self._free.append(slot)
                rows.append(slot)
                al.append(False)
        if not rows:
            return
        k = len(rows)
        kp = _pow2(k)
        # dead rows zero; alive rows overwritten from centred f64 truth
        LSa = np.zeros((kp, self.dim), dtype=np.float32)
        SSa = np.zeros(kp, dtype=np.float32)
        Na = np.zeros(kp, dtype=np.float32)
        ala = np.zeros(kp, dtype=bool)
        ala[:k] = al
        if alive_leaves:
            ids = np.asarray(alive_leaves, dtype=np.int64)
            LSc, SSc = self._center(tree.LS[ids], tree.SS[ids], tree.N[ids])
            live = np.flatnonzero(ala[:k])
            LSa[live] = LSc
            SSa[live] = SSc
            Na[live] = tree.N[ids]
        # pad by repeating row 0 (duplicate targets, identical payloads —
        # an overwrite in any order gives the same rows)
        idx = np.full(kp, rows[0], dtype=np.int64)
        idx[:k] = rows
        LSa[k:] = LSa[0]
        SSa[k:] = SSa[0]
        Na[k:] = Na[0]
        ala[k:] = ala[0]
        at = self._upload(idx, torch.int64)
        self.LS[at] = self._upload(LSa)
        self.LSe[at] = 0.0
        self.SS[at] = self._upload(SSa)
        self.SSe[at] = 0.0
        self.N[at] = self._upload(Na)
        self.alive[at] = self._upload(ala, torch.bool)
        self._alive_host[np.asarray(rows)] = np.asarray(al)

    # -- consumers (core.device_table) --------------------------------------

    @property
    def ready(self) -> bool:
        """A stale table must reload from the host tree before an offline
        capture can trust its rows."""
        return not self.stale

    def sync(self, tree) -> None:
        """Protocol alias for `sync_struct` (which already covers the
        stale → full-reload case)."""
        self.sync_struct(tree)

    def capture(self, n_points: int) -> FlatTableCapture:
        """An offline pass's isolation copy: the six tensors cloned on the
        device (later in-place scatters on the same stream cannot reach
        it), the f64 origin, and the populated slots in ascending order
        from the host, with the table's mesh."""
        return FlatTableCapture(
            view=tuple(t.clone() for t in self.device_view()), origin=self.origin.copy(),
            n_points=int(n_points), slots=self.alive_slots(), mesh=self.mesh,
        )

    def device_view(self):
        """(LS, LSe, SS, SSe, N, alive): the live device tensors, which
        later blocks update in place."""
        return (self.LS, self.LSe, self.SS, self.SSe, self.N, self.alive)

    def alive_slots(self) -> np.ndarray:
        """Slot ids of populated leaves in ascending-slot order — the row
        order the device offline pass compacts to — from the host: the
        alive slots whose leaf has N > 0 in the tree last synced, which
        equals the card's N."""
        slots = np.flatnonzero(self._alive_host)
        return slots[self._tree.N[self.leaf_of_slot[slots]] > 0]

    def host_cfs(self):
        """(leaf_ids, LS, SS, N) uncentred f64 per populated slot
        (ascending-slot order), read from the DEVICE — the
        differential-parity view.  The compensation term is folded in
        (true sum ≈ hi − err)."""
        LS, LSe, SS, SSe, N = (a.astype(np.float64) for a in to_numpy(*self.device_view()[:5]))
        slots = np.flatnonzero(self._alive_host)
        slots = slots[N[slots] > 0]
        LS = LS[slots] - LSe[slots]
        SS = SS[slots] - SSe[slots]
        N = N[slots]
        o = self.origin
        LSu = LS + N[:, None] * o
        SSu = SS + 2.0 * (LS @ o) + N * float(o @ o)
        return self.leaf_of_slot[slots], LSu, SSu, N
