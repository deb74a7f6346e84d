"""Data plane of the PyTorch port: the streaming curator, the synthetic
datasets and the LM stack's token pipeline (the port's own copies of the
JAX package's numpy generators)."""

from .curation import CurationReport, StreamCurator
from .pipeline import TokenPipeline
from .synthetic import DATASET_SPECS, dataset, gaussian_mixtures, sliding_window_workload, token_stream

__all__ = [
    "CurationReport",
    "DATASET_SPECS",
    "StreamCurator",
    "TokenPipeline",
    "dataset",
    "gaussian_mixtures",
    "sliding_window_workload",
    "token_stream",
]
