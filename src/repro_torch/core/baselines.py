"""Baseline data-summarization techniques the paper compares against (§5).

* :class:`ClusTreeLite` — ClusTree [25]: a CF tree for *stream* clustering
  with a bounded height, adaptive absorb radius at the leaves, and a
  damped-window decay ``CF(t+Δt) = 2^(−λΔt)·CF(t)``.  Insertion-only by
  design (streams forget via decay, not deletion) — the property §5.1 shows
  makes it order-dependent and prone to over-filled micro-clusters.

* :class:`IncrementalBubbles` — the flat data-bubble list of Nassar et
  al. [32] / Liu et al. [28]: fixed-size set of bubbles maintained by the
  data-summarization-index quality measure (Eq. 8): split "over-filled"
  (β > μ+kσ) bubbles, dissolve-and-redistribute "under-filled" ones.
  O(L) scan per update — the scalability weakness Fig. 5/7 demonstrate.

Both expose ``insert``/``to_bubbles`` compatible with BubbleTree so the
benchmark harness treats all three uniformly.  The port's own copy of the
JAX package's ``core/baselines.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from .bubbles import DataBubbles, bubbles_from_cf

__all__ = ["ClusTreeLite", "IncrementalBubbles"]


class _CTNode:
    __slots__ = ("LS", "SS", "n", "children", "is_leaf", "t_updated")

    def __init__(self, dim, is_leaf=True):
        self.LS = np.zeros(dim)
        self.SS = 0.0
        self.n = 0.0
        self.children: list[_CTNode] = []
        self.is_leaf = is_leaf
        self.t_updated = 0.0


class ClusTreeLite:
    """Faithful-in-spirit ClusTree: bounded height, leaf absorb threshold,
    exponential decay; no rebalancing of leaf counts (the key difference
    from Bubble-tree the paper isolates)."""

    def __init__(self, dim: int, max_height: int = 6, fanout: int = 3, decay_lambda: float = 0.0):
        self.dim = dim
        self.max_height = int(max_height)
        self.fanout = int(fanout)
        self.decay_lambda = float(decay_lambda)
        self.root = _CTNode(dim, is_leaf=True)
        self.t = 0.0
        self.n_points = 0

    def _decay(self, node: _CTNode):
        if self.decay_lambda > 0.0:
            w = 2.0 ** (-self.decay_lambda * (self.t - node.t_updated))
            node.LS *= w
            node.SS *= w
            node.n *= w
        node.t_updated = self.t

    def _radius(self, node: _CTNode) -> float:
        if node.n <= 1:
            return np.inf  # empty/singleton leaves absorb anything nearby
        c = node.LS / node.n
        var = max(node.SS / node.n - float(c @ c), 0.0)
        return float(np.sqrt(var)) * 2.0

    def insert(self, p) -> None:
        p = np.asarray(p, dtype=np.float64)
        self.t += 1.0
        self.n_points += 1
        node, depth = self.root, 0
        path = []
        while not node.is_leaf:
            self._decay(node)
            path.append(node)
            reps = np.stack([c.LS / max(c.n, 1.0) for c in node.children])
            j = int(np.argmin(np.einsum("kd,kd->k", reps - p, reps - p)))
            node = node.children[j]
            depth += 1
        self._decay(node)
        # leaf: absorb if within adaptive threshold or height budget spent
        c = node.LS / max(node.n, 1.0)
        dist = float(np.linalg.norm(c - p)) if node.n > 0 else 0.0
        if node.n == 0 or dist <= self._radius(node) or depth >= self.max_height:
            node.LS += p
            node.SS += float(p @ p)
            node.n += 1.0
        else:
            # convert leaf into internal with the old CF + a new singleton
            old = _CTNode(self.dim, is_leaf=True)
            old.LS, old.SS, old.n, old.t_updated = node.LS.copy(), node.SS, node.n, node.t_updated
            new = _CTNode(self.dim, is_leaf=True)
            new.LS, new.SS, new.n, new.t_updated = p.copy(), float(p @ p), 1.0, self.t
            node.is_leaf = False
            node.children = [old, new]
            node.LS = old.LS + new.LS
            node.SS = old.SS + new.SS
            node.n = old.n + new.n
        for a in path:  # propagate stats up
            a.LS += p
            a.SS += float(p @ p)
            a.n += 1.0

    def leaves(self) -> list[_CTNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf:
                if n.n > 0:
                    out.append(n)
            else:
                stack.extend(n.children)
        return out

    def to_bubbles(self) -> DataBubbles:
        ls = np.stack([n.LS for n in self.leaves()])
        ss = np.array([n.SS for n in self.leaves()])
        nn = np.array([n.n for n in self.leaves()])
        return bubbles_from_cf(ls, ss, nn)

    @property
    def num_leaves(self) -> int:
        return len(self.leaves())


class IncrementalBubbles:
    """Flat list of data bubbles with β-quality maintenance [32]."""

    def __init__(self, dim: int, target_L: int | None = None, compression: float = 0.01, k_sigma: float = 2.0):
        self.dim = dim
        self.compression = float(compression)
        self._fixed_L = target_L
        self.k_sigma = float(k_sigma)
        self.LS = np.zeros((0, dim))
        self.SS = np.zeros((0,))
        self.n = np.zeros((0,))
        self.members: list[list[np.ndarray]] = []  # retained for redistribution
        self.n_points = 0

    @property
    def target_L(self) -> int:
        if self._fixed_L is not None:
            return self._fixed_L
        return max(2, int(round(self.compression * self.n_points)))

    @property
    def num_leaves(self) -> int:
        return int(self.LS.shape[0])

    def _append(self, LS, SS, n, members):
        self.LS = np.concatenate([self.LS, LS[None]])
        self.SS = np.concatenate([self.SS, [SS]])
        self.n = np.concatenate([self.n, [n]])
        self.members.append(members)

    def _drop(self, i: int):
        keep = np.arange(self.LS.shape[0]) != i
        self.LS = self.LS[keep]
        self.SS = self.SS[keep]
        self.n = self.n[keep]
        self.members.pop(i)

    def insert(self, p) -> None:
        p = np.asarray(p, dtype=np.float64)
        self.n_points += 1
        if self.LS.shape[0] < self.target_L:
            self._append(p.copy(), float(p @ p), 1.0, [p.copy()])
        else:
            reps = self.LS / np.maximum(self.n, 1.0)[:, None]
            j = int(np.argmin(np.einsum("kd,kd->k", reps - p, reps - p)))
            self.LS[j] += p
            self.SS[j] += float(p @ p)
            self.n[j] += 1.0
            self.members[j].append(p.copy())
        self._maintain()

    def delete_nearest(self, p) -> None:
        """Fully-dynamic deletion: remove the stored member closest to p."""
        p = np.asarray(p, dtype=np.float64)
        best, bi, bj = np.inf, -1, -1
        for i, mem in enumerate(self.members):
            if not mem:
                continue
            M = np.stack(mem)
            d = np.einsum("kd,kd->k", M - p, M - p)
            j = int(np.argmin(d))
            if d[j] < best:
                best, bi, bj = float(d[j]), i, j
        if bi < 0:
            return
        q = self.members[bi].pop(bj)
        self.LS[bi] -= q
        self.SS[bi] -= float(q @ q)
        self.n[bi] -= 1.0
        self.n_points -= 1
        if self.n[bi] <= 0:
            self._drop(bi)
        self._maintain()

    def _maintain(self):
        L = self.LS.shape[0]
        if L < 2 or self.n_points == 0:
            return
        beta = self.n / float(self.n_points)  # Eq. 8
        mu, sigma = float(beta.mean()), float(beta.std())
        hi = mu + self.k_sigma * sigma
        lo = mu - self.k_sigma * sigma
        over = np.nonzero(beta > hi)[0]
        under = np.nonzero(beta < lo)[0]
        if L > self.target_L and under.size:
            # dissolve the most under-filled bubble, redistribute members
            i = int(under[np.argmin(beta[under])])
            mem = self.members[i]
            self._drop(i)
            for q in mem:
                reps = self.LS / np.maximum(self.n, 1.0)[:, None]
                j = int(np.argmin(np.einsum("kd,kd->k", reps - q, reps - q)))
                self.LS[j] += q
                self.SS[j] += float(q @ q)
                self.n[j] += 1.0
                self.members[j].append(q)
        elif L < self.target_L and over.size:
            # split the most over-filled bubble by farthest-pair seeds
            i = int(over[np.argmax(beta[over])])
            mem = self.members[i]
            if len(mem) < 4:
                return
            M = np.stack(mem)
            c = M.mean(axis=0)
            s1 = int(np.argmax(np.einsum("kd,kd->k", M - c, M - c)))
            d1 = np.einsum("kd,kd->k", M - M[s1], M - M[s1])
            s2 = int(np.argmax(d1))
            d2 = np.einsum("kd,kd->k", M - M[s2], M - M[s2])
            side = d1 <= d2
            if side.all() or (~side).all():
                return
            A, B = M[side], M[~side]
            self._drop(i)
            self._append(A.sum(0), float(np.einsum("kd,kd->", A, A)), float(A.shape[0]), [a for a in A])
            self._append(B.sum(0), float(np.einsum("kd,kd->", B, B)), float(B.shape[0]), [b for b in B])

    def to_bubbles(self) -> DataBubbles:
        return bubbles_from_cf(self.LS, self.SS, self.n)
