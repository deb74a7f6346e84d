"""Device meshes for the sharded offline pass (DESIGN.md §12).

The PyTorch counterpart of the JAX package's ``launch/mesh.py``
(``make_host_mesh``, ``resolve_mesh``) and of ``launch/sharding.py``'s
``leaf_row_owner``.  A ``Mesh`` here is one process's list of devices
along one named axis: the engine stays one object, and the sharded stage
(``kernels/ops.py::_sharded_mst_stage``) launches each shard's strip
kernels on its own device and gathers the strips' results on the lead
device, ``devices[0]``, by peer copies.  A device may be named more than
once: ``("cpu",) * k`` or ``("cuda:0",) * k`` runs k shards on one
device, the port's counterpart of the reference tests' forced host
devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_host_mesh", "resolve_mesh", "leaf_row_owner", "shard_ranges", "on_devices", "gather"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` along the axis ``axis``; shard i runs on ``devices[i]``."""

    devices: tuple
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def make_host_mesh(device=None, axis: str = "data") -> Mesh:
    """Every visible device of ``device``'s type (None → cuda), ``device``
    first: ``torch.cuda.device_count()`` cards, or one CPU shard."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,), axis)
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != dev.index]
    return Mesh((dev, *others), axis)


def resolve_mesh(mesh, device=None, axis: str | None = None) -> Mesh | None:
    """Normalise an engine's ``mesh=``: ``None``/``False`` → no mesh,
    ``True`` → ``make_host_mesh(device)``, a ``Mesh`` or a sequence of
    devices → a ``Mesh`` along ``axis`` (None: a ``Mesh``'s own, else
    ``"data"``).  A one-device mesh stays a mesh (the sharded pass on one
    shard).  Raises ``ValueError`` when the devices mix types, when the
    lead is not ``device`` (None → the lead is taken as is), or when a
    ``Mesh``'s axis is not ``axis``; ``RuntimeError`` for a cuda device on
    a machine without one."""
    if mesh is None or mesh is False:
        return None
    if mesh is True:
        return make_host_mesh(device, axis or "data")
    if isinstance(mesh, Mesh):
        if axis is not None and mesh.axis != axis:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
        axis = mesh.axis
        devs = mesh.devices
    elif isinstance(mesh, (str, torch.device)) or not hasattr(mesh, "__iter__"):
        raise ValueError(f"mesh must be True, a Mesh or a sequence of devices, got {mesh!r}")
    else:
        devs = tuple(mesh)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({torch.device(d).type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices must be of one type, got {[str(d) for d in devs]}")
    devs = tuple(resolve_device(d) for d in devs)
    if device is not None and devs[0] != resolve_device(device):
        raise ValueError(f"the mesh's lead device {devs[0]} is not the engine's {resolve_device(device)}")
    return Mesh(devs, axis or "data")


def leaf_row_owner(slots, Lp: int, mesh: Mesh) -> np.ndarray:
    """The shard owning each leaf slot under the row-block layout (shard i
    holds rows [i·Lp/k, (i+1)·Lp/k)): one integer divide; zeros when k does
    not divide Lp (the reference's replicated fallback)."""
    slots = np.asarray(slots)
    k = mesh.shape[mesh.axis]
    if k <= 1 or Lp % k != 0:
        return np.zeros(slots.shape, dtype=np.int64)
    return slots.astype(np.int64) // (Lp // k)


def shard_ranges(n: int, k: int) -> list[tuple[int, int]]:
    """Shard i's contiguous range ``[i·⌈n/k⌉, min((i+1)·⌈n/k⌉, n))`` of n
    rows (or blocks): the last ranges shorter or empty, so no shard needs a
    lifted copy of another's rows."""
    m = -(-n // k) if k else 0
    return [(min(i * m, n), min((i + 1) * m, n)) for i in range(k)]


def on_devices(mesh: Mesh, *tensors) -> dict:
    """The tensors on each distinct device of the mesh, copied once per
    device (non-blocking peer copies; on their own device, the tensors
    themselves)."""
    return {dev: tuple(t.to(dev, non_blocking=True) for t in tensors) for dev in dict.fromkeys(mesh.devices)}


def gather(parts, lead) -> torch.Tensor:
    """Per-shard pieces, in shard order, concatenated on the lead device
    (non-blocking peer copies, ordered by PyTorch with events)."""
    parts = [p.to(lead, non_blocking=True) for p in parts]
    return torch.cat(parts) if len(parts) > 1 else parts[0]
