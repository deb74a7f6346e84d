"""Clustering-quality metrics (sklearn-free).

NMI is the paper's §5.2 quality measure: agreement between the flat
clusters from a summarization technique's offline pass and the static
algorithm's clusters on the raw data.  Noise points (label -1) are kept as
their own singleton-ish class, matching how the paper's comparison treats
HDBSCAN output ("NMI is robust for comparing clustering results with
noise").

The port's own copy of the JAX package's ``core/metrics.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["nmi", "ari", "contingency"]


def contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    b = np.asarray(b)
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    C = np.zeros((ua.size, ub.size), dtype=np.int64)
    np.add.at(C, (ia, ib), 1)
    return C


def _entropy(counts: np.ndarray) -> float:
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def nmi(a, b, average: str = "arithmetic") -> float:
    """Normalized mutual information in [0, 1]."""
    C = contingency(a, b).astype(np.float64)
    n = C.sum()
    if n == 0:
        return 1.0
    pi = C.sum(axis=1)
    pj = C.sum(axis=0)
    hi = _entropy(pi)
    hj = _entropy(pj)
    if hi == 0.0 and hj == 0.0:
        return 1.0
    nz = C > 0
    P = C / n
    outer = np.outer(pi / n, pj / n)
    mi = float((P[nz] * np.log(P[nz] / outer[nz])).sum())
    if average == "arithmetic":
        denom = 0.5 * (hi + hj)
    elif average == "geometric":
        denom = np.sqrt(hi * hj)
    else:
        denom = max(hi, hj)
    if denom == 0.0:
        return 1.0
    return float(np.clip(mi / denom, 0.0, 1.0))


def ari(a, b) -> float:
    """Adjusted Rand index."""
    C = contingency(a, b).astype(np.float64)
    n = C.sum()
    sum_comb_c = (C * (C - 1) / 2.0).sum()
    ai = C.sum(axis=1)
    bj = C.sum(axis=0)
    sum_a = (ai * (ai - 1) / 2.0).sum()
    sum_b = (bj * (bj - 1) / 2.0).sum()
    total = n * (n - 1) / 2.0
    if total == 0:
        return 1.0
    expected = sum_a * sum_b / total
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        return 1.0
    return float((sum_comb_c - expected) / (max_idx - expected))
