"""repro_torch.core — the paper's contribution on the PyTorch port: dynamic
data summarization for hierarchical spatial clustering (Bubble-tree +
exact dynamic HDBSCAN), with the host oracles and the device hierarchy.

The names of the JAX package's ``repro.core`` where the port has a
counterpart, and two that differ:

* ``boruvka_jax`` → ``boruvka`` (core/mst.py: Borůvka over the dense W on
  the backend's device);
* ``DeviceTableProtocol`` has none: the port's offline sources are
  ``SnapshotDeviceTable`` and the capture classes of core/device_table.py.
"""

from .baselines import ClusTreeLite, IncrementalBubbles
from .bubble_flat import BubbleFlat
from .bubble_tree import BubbleTree
from .bubbles import DataBubbles, bubble_mutual_reachability, bubbles_from_cf
from .cf import CFTable, cf_extent, cf_nn_dist, cf_of_points, cf_rep
from .device_table import SnapshotDeviceTable
from .dynamic import DynamicHDBSCAN
from .hdbscan import HDBSCANResult, core_distances, hdbscan, mutual_reachability
from .metrics import ari, nmi
from .mst import UnionFind, boruvka, boruvka_dense, kruskal_edges
from .summarizer import BubbleTreeSummarizer, assign_points, cluster_bubbles

__all__ = [
    "BubbleFlat",
    "BubbleTree",
    "BubbleTreeSummarizer",
    "CFTable",
    "ClusTreeLite",
    "DataBubbles",
    "DynamicHDBSCAN",
    "HDBSCANResult",
    "IncrementalBubbles",
    "SnapshotDeviceTable",
    "UnionFind",
    "ari",
    "assign_points",
    "boruvka",
    "boruvka_dense",
    "bubble_mutual_reachability",
    "bubbles_from_cf",
    "cf_extent",
    "cf_nn_dist",
    "cf_of_points",
    "cf_rep",
    "cluster_bubbles",
    "core_distances",
    "hdbscan",
    "kruskal_edges",
    "mutual_reachability",
    "nmi",
]
