"""Quickstart on the PyTorch port: the paper's online–offline pipeline.

Summarize a fully dynamic point stream with a Bubble-tree, run static
HDBSCAN over the data bubbles (their Eq. 6–7 distance matrix and the
point assignment on the card's kernels), and compare against clustering
the raw points directly.

  PYTHONPATH=src python examples/torch_quickstart.py               # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions
"""

import argparse

import numpy as np

from repro_torch.core import BubbleTreeSummarizer, hdbscan, nmi
from repro_torch.data.synthetic import gaussian_mixtures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # a dynamic dataset: 4000 points in 5 clusters
    X, y = gaussian_mixtures(4000, d=4, k=5, overlap=0.05, seed=7)

    # ---- online phase: stream the points in, then delete a third ----
    summ = BubbleTreeSummarizer(dim=4, min_pts=20, compression=0.05, device=args.device)
    print(f"offline pass on {summ.backend}")
    ids = summ.insert_block(X[:3000])
    ids += summ.insert_block(X[3000:])          # arrivals
    summ.delete_block(ids[:1500])               # retirements (fully dynamic)
    survivors = np.arange(1500, 4000)

    # ---- offline phase: cluster the ≤ L data bubbles ----
    out = summ.cluster()
    print(f"bubbles: {out.bubbles.size} (compression 5% of {len(survivors)} points)")
    print(f"clusters found: {len(set(out.bubble_labels) - {-1})}")

    # ---- reference: static HDBSCAN on the raw surviving points ----
    # (point_ids are tree-store ids in insertion order == survivors order)
    static = hdbscan(X[survivors], min_pts=20)
    score = nmi(out.point_labels, static.labels)
    print(f"NMI vs static-on-raw: {score:.3f}")
    print(f"summary size vs raw: {out.bubbles.size} vs {len(survivors)} "
          f"({100 * out.bubbles.size / len(survivors):.1f}%)")
    assert score > 0.7
    print("OK")


if __name__ == "__main__":
    main()
