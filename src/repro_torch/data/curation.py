"""StreamCurator — the paper's technique as a first-class framework
feature (DESIGN.md §3).

Large-scale training pipelines need *streaming data curation* over an
unbounded example stream where shards are added AND retired — exactly the
paper's fully-dynamic setting (not append-only).  The curator:

  online   embeds each arriving example (any feature_fn: pooled hidden
           states from a zoo model, router-logit vectors, …) and inserts
           it into a BubbleTreeSummarizer; retiring an example deletes it.
           Cost per update: one tree descent over ≤ height·M CFs.
  offline  at checkpoint boundaries, runs static HDBSCAN over the ≤ L
           data bubbles (O(L²) REGARDLESS of corpus size — the paper's
           core scalability argument applied to the data plane) and
           derives:
             * cluster-balanced sampling weights (inverse cluster mass),
             * near-duplicate down-weighting (β(B) over-filled bubbles,
               Eq. 8's data-summarization index),
             * drift alarms: the dendrogram's top-split λ moving by more
               than `drift_tol` relative between offline passes.

The port's counterpart of the JAX package's ``data/curation.py``: the
curator's summarizer (core/summarizer.py) takes ``device`` (None → the
card, raising without one; ``"cpu"`` for the plain versions), and its
offline passes and sampling-weight assignment run there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bubbles import DataBubbles
from ..core.summarizer import BubbleTreeSummarizer, assign_points

__all__ = ["CurationReport", "StreamCurator"]


@dataclasses.dataclass
class CurationReport:
    step: int
    n_examples: int
    n_bubbles: int
    n_clusters: int
    cluster_mass: dict
    top_split_lambda: float
    drift: float
    drifted: bool
    overfilled_frac: float


class StreamCurator:
    def __init__(
        self,
        dim: int,
        *,
        min_pts: int = 10,
        compression: float = 0.05,
        feature_fn=None,
        drift_tol: float = 0.5,
        k_sigma: float = 2.0,
        device=None,
    ):
        self.feature_fn = feature_fn or (lambda x: np.asarray(x))
        self.summ = BubbleTreeSummarizer(dim=dim, min_pts=min_pts, compression=compression, device=device)
        self.drift_tol = drift_tol
        self.k_sigma = k_sigma
        self._ids: dict[object, int] = {}
        self._last_top_lambda: float | None = None
        self.reports: list[CurationReport] = []

    # -- online ------------------------------------------------------------

    def observe(self, example_id, raw) -> None:
        """Example arrived (new shard ingested)."""
        z = np.asarray(self.feature_fn(raw), dtype=np.float64).reshape(-1)
        self._ids[example_id] = self.summ.insert(z)

    def observe_block(self, ids, raws) -> None:
        Z = np.stack([np.asarray(self.feature_fn(r), dtype=np.float64).reshape(-1) for r in raws])
        pids = self.summ.insert_block(Z)
        self._ids.update(zip(ids, pids))

    def retire(self, example_id) -> None:
        """Example left the corpus (shard retired / expired)."""
        self.summ.delete(self._ids.pop(example_id))

    @property
    def n_examples(self) -> int:
        return len(self._ids)

    # -- offline -----------------------------------------------------------

    def curate(self, step: int = 0) -> CurationReport:
        out = self.summ.cluster()
        b: DataBubbles = out.bubbles
        labels = out.bubble_labels
        # cluster mass (weighted by represented points, paper §2.2)
        mass = {}
        for lab in sorted(set(labels.tolist())):
            mass[int(lab)] = float(b.n[labels == lab].sum())
        # top-split lambda: the last (largest-distance) merge of the
        # dendrogram — where the hierarchy first splits
        merges = out.hdbscan.slt.merges
        top_lambda = float(1.0 / max(merges[-1, 2], 1e-12)) if len(merges) else 0.0
        drift = (
            abs(top_lambda - self._last_top_lambda) / max(self._last_top_lambda, 1e-12)
            if self._last_top_lambda is not None
            else 0.0
        )
        self._last_top_lambda = top_lambda
        # over-filled bubbles via the data-summarization index (Eq. 8)
        beta = b.n / max(b.n.sum(), 1.0)
        mu, sd = float(beta.mean()), float(beta.std())
        overfilled = beta > mu + self.k_sigma * sd
        rep = CurationReport(
            step=step,
            n_examples=self.n_examples,
            n_bubbles=b.size,
            n_clusters=len(set(labels.tolist()) - {-1}),
            cluster_mass=mass,
            top_split_lambda=top_lambda,
            drift=float(drift),
            drifted=bool(drift > self.drift_tol),
            overfilled_frac=float(overfilled.mean()),
        )
        self.reports.append(rep)
        return rep

    def sampling_weights(self, Z: np.ndarray) -> np.ndarray:
        """Cluster-balanced weights for a candidate batch of embeddings:
        w ∝ 1 / mass(cluster(z)); near-dups (over-filled bubbles) are
        additionally down-weighted by their β ratio."""
        out = self.summ.cluster()
        b = out.bubbles
        labels = out.bubble_labels
        a = assign_points(np.asarray(Z, dtype=np.float64), b, backend=self.summ.backend)
        lab = labels[a]
        mass = np.array([b.n[labels == lb].sum() if lb >= 0 else b.n.sum() for lb in lab])
        w = 1.0 / np.maximum(mass, 1.0)
        beta = b.n / max(b.n.sum(), 1.0)
        mu, sd = float(beta.mean()), float(beta.std())
        dup = beta[a] > mu + self.k_sigma * sd
        w = np.where(dup, w * (mu / np.maximum(beta[a], 1e-12)), w)
        return w / w.sum()
