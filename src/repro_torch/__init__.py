"""PyTorch/CUDA port of the streaming hierarchical-clustering system.

The JAX package ``repro`` is the reference and stays as it is; this
package imports nothing of it (and never ``jax``).  Entry points run on
the card unless the caller asks for the CPU (``device="cpu"``), where the
hand-written kernels give way to their plain PyTorch versions.
"""

from .carry import (
    dyn_state_from_reference,
    dynamic_hdbscan_from_reference,
    engine_from_reference_state,
    summarizer_from_reference_state,
)
from .checkpoint import CheckpointStore
from .core.summarizer import BubbleTreeSummarizer
from .data.curation import StreamCurator
from .kernels.ops import get_backend
from .serving import QueryBatcher, StreamingClusterEngine, TenantRouter, UpdatePolicy

__all__ = [
    "StreamingClusterEngine",
    "QueryBatcher",
    "TenantRouter",
    "UpdatePolicy",
    "CheckpointStore",
    "BubbleTreeSummarizer",
    "StreamCurator",
    "get_backend",
    "engine_from_reference_state",
    "dyn_state_from_reference",
    "dynamic_hdbscan_from_reference",
    "summarizer_from_reference_state",
]
