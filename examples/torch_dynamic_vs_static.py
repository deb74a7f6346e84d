"""Exact dynamic HDBSCAN (paper §3) vs static recomputation, on the
PyTorch port.

Demonstrates: (a) exactness — identical MST weight after any update mix,
for the host structure (f64) and for the card's exact-dynamic handle
(f32, the kernels of kernels/dynamic.py); (b) the paper's feasibility
finding — per-update cost approaches static recompute as the update
fraction grows.

  PYTHONPATH=src python examples/torch_dynamic_vs_static.py               # on the GPU
  PYTHONPATH=src python examples/torch_dynamic_vs_static.py --device cpu  # plain versions
"""

import argparse
import time

import numpy as np

from repro_torch.core import hdbscan
from repro_torch.core.dynamic import DynamicHDBSCAN
from repro_torch.core.dynamic_torch import DynamicTorchHDBSCAN
from repro_torch.data.synthetic import gaussian_mixtures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    X, _ = gaussian_mixtures(1500, d=10, k=10, seed=0)
    dyn = DynamicHDBSCAN(min_pts=10, dim=10, capacity=2048)
    card = DynamicTorchHDBSCAN(min_pts=10, dim=10, capacity=2048, device=args.device)
    print(f"exact-dynamic handle on {card.device}")

    t0 = time.time()
    for p in X[:1000]:
        dyn.insert(p)
    print(f"built 1000-point dynamic structure in {time.time() - t0:.2f}s")
    slots = card.insert_block(X[:1000])

    # mixed workload: 200 inserts + 150 deletes
    t0 = time.time()
    for p in X[1000:1200]:
        dyn.insert(p)
    alive = np.nonzero(dyn.alive)[0]
    for i in alive[:150]:
        dyn.delete(int(i))
    t_dyn = time.time() - t0
    slots += card.insert_block(X[1000:1200])  # slots[r] holds row r
    card.delete_block([slots[r] for r in alive[:150]])  # the host's slots are its rows

    survivors = dyn.X[dyn.alive]
    t0 = time.time()
    static = hdbscan(survivors, min_pts=10)
    t_static = time.time() - t0

    w_dyn, w_static, w_card = dyn.total_weight(), static.total_mst_weight, card.total_weight()
    print(f"dynamic MST weight : {w_dyn:.6f}   ({t_dyn:.2f}s for 350 updates)")
    print(f"static  MST weight : {w_static:.6f}   ({t_static:.2f}s full recompute)")
    print(f"device  MST weight : {w_card:.6f}   (f32, {card.n} points)")
    print(f"exactness          : {'MATCH' if np.isclose(w_dyn, w_static) else 'MISMATCH'}")
    print(f"per-update cost    : {1000 * t_dyn / 350:.1f} ms vs {1000 * t_static:.0f} ms static")
    assert np.isclose(w_dyn, w_static, rtol=1e-9)
    assert card.n == survivors.shape[0] and np.isclose(w_card, w_static, rtol=1e-5)
    print("OK")


if __name__ == "__main__":
    main()
