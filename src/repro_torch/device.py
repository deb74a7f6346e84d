"""Device resolution and the float32 numerics switches of the port.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda``, and a machine without a usable GPU raises instead of
carrying on quietly on the CPU.  The CPU is a supported device only when
asked for by name (the tests do), and then every kernel wrapper takes its
plain PyTorch version.

Distance tiles are f32 over mean-centred coordinates (DESIGN.md §2): TF32
keeps about three decimal digits, so both TF32 switches are turned off
whenever a device is resolved.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_numpy", "to_device"]


def _set_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"``/a
    ``torch.device`` as given.  Raises ``RuntimeError`` for a CUDA device
    on a machine without one, ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU by default and none is "
                "available here; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    _set_numerics()
    return dev


def to_numpy(*tensors: torch.Tensor):
    """Copy tensors to host numpy with ONE device synchronisation: the
    copies go out non-blocking (into pinned memory) and a single sync
    waits for all of them."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    cuda = {t.device for t in tensors if t.device.type == "cuda"}
    for dev in cuda:
        torch.cuda.synchronize(dev)
    return [h.numpy() for h in host]


def to_device(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """A copy of a host array on ``dev`` (never an alias of it), made with
    no device synchronisation: on ``cuda`` it goes through pinned memory as
    a non-blocking copy, ordered on the current stream before whatever
    reads it."""
    t = torch.as_tensor(a, dtype=dtype)
    if dev.type != "cuda":
        return t.to(dev, copy=True)
    return t.pin_memory().to(dev, non_blocking=True)
