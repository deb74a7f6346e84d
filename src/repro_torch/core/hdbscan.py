"""The host layout of a condensed tree: the port's own copy of the JAX
package's ``core/hdbscan.py::CondensedTree``.

Only the dataclass is here: ``OfflineClusterResult.to_condensed`` emits
it.  The rest of that numpy oracle (single linkage, condensing and flat
extraction on the host) joins the port with the summarizer and the
baselines (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CondensedTree"]


@dataclasses.dataclass
class CondensedTree:
    """Rows (parent, child, lambda_val, child_weight); cluster ids >= n."""

    parent: np.ndarray
    child: np.ndarray
    lambda_val: np.ndarray
    child_weight: np.ndarray
    n_leaves: int

    def cluster_ids(self) -> np.ndarray:
        return np.unique(self.parent)
