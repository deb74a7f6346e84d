"""Data plane of the PyTorch port: the streaming curator and the synthetic
datasets (the port's own copy of the JAX package's numpy generators).
The token pipeline of the LM stack is not ported yet."""

from .curation import CurationReport, StreamCurator
from .synthetic import DATASET_SPECS, dataset, gaussian_mixtures, sliding_window_workload, token_stream

__all__ = [
    "CurationReport",
    "DATASET_SPECS",
    "StreamCurator",
    "dataset",
    "gaussian_mixtures",
    "sliding_window_workload",
    "token_stream",
]
