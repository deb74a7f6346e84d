"""repro_torch.configs — one module per assigned architecture, copied as
data from the JAX package's `configs/`."""

from .base import ARCH_IDS, SHAPES, LONG_CONTEXT_OK, ArchConfig, ShapeConfig, cells, get, get_smoke

__all__ = [
    "ARCH_IDS", "SHAPES", "LONG_CONTEXT_OK", "ArchConfig", "ShapeConfig",
    "cells", "get", "get_smoke",
]
