"""Device HDBSCAN hierarchy: single-linkage → condense → extract.

The PyTorch counterpart of the JAX package's ``core/hierarchy_jax.py``,
with the same padding scheme, array layouts and dense cluster labels
(0 = root; a child's label always exceeds its parent's):

  * ``Lp`` leaves, the first ``n_valid`` real; pad leaves weigh 0;
  * the ``Lp - n_valid`` edges Borůvka could not write are synthesized:
    pad leaf ``n_valid + j`` joins node 0 at ``PAD_DIST``, so those
    merges land at the top of the tree at λ ≈ 0 with weight 0;
  * one edge slot is always left over and parked at +inf.

The O(Lp) scans of the reference (union-find single-linkage, the
top-down condense sweep, bottom-up EOM) are Python loops of small tensor
operations here: the plain versions, which CPU tensors run and the card's
tests hold the CUDA kernels to.  On the card, ``kernels/hierarchy.py``
runs the three sweeps as kernels around the same vector steps
(``sorted_edges``, ``stabilities``, ``flat_labels``).  The EOM loop reads
the label count once before it starts and visits only the labels in use
(the reference's fixed 2·Lp-step scan only writes trash slots past them).
Selection blocking and label resolution are pointer-doubling sweeps of
⌈log₂ C⌉ + 1 vector steps.  Scatter-adds use
``index_put_(accumulate=True)``, which sums in a fixed order on each
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "PAD_DIST",
    "MAX_LAMBDA",
    "SingleLinkageArrays",
    "CondensedArrays",
    "ExtractionArrays",
    "sorted_edges",
    "single_linkage_fixed",
    "condense_fixed",
    "stabilities",
    "eom_loop",
    "flat_labels",
    "extract_fixed",
    "hierarchy_fixed",
]

# Weight of the synthesized pad-leaf merges: far above any real mutual
# reachability but finite in f32, so 1/PAD_DIST is a clean ~1e-30.
PAD_DIST = 1e30
# λ = 1/dist clamp for zero distances (duplicate points); keeps
# λ · total_weight inside f32.
MAX_LAMBDA = 1e12


class SingleLinkageArrays(NamedTuple):
    """Merge records over 2·Lp−1 node ids: row k merges ``left[k]`` and
    ``right[k]`` (leaves < Lp, internal node ``Lp + k``) at ``dist[k]``
    into weight ``weight[k]``.  Skipped slots point both children at the
    trash node ``2·Lp − 1``."""

    left: torch.Tensor  # (Lp-1,) int32
    right: torch.Tensor  # (Lp-1,) int32
    dist: torch.Tensor  # (Lp-1,) f32
    weight: torch.Tensor  # (Lp-1,) f32
    node_weight: torch.Tensor  # (2*Lp,) f32 — per-node subtree weight (+ trash)


class CondensedArrays(NamedTuple):
    """Array-form condensed tree: leaf i belongs to condensed cluster
    ``point_parent[i]`` from λ ``point_lambda[i]``; label c ≥ 1 is a child
    of ``cluster_parent[c]`` born at ``cluster_birth[c]`` with
    ``cluster_weight[c]``.  Slots ≥ ``n_labels`` are unused."""

    point_parent: torch.Tensor  # (Lp,) int32
    point_lambda: torch.Tensor  # (Lp,) f32
    point_weight: torch.Tensor  # (Lp,) f32
    cluster_parent: torch.Tensor  # (C+1,) int32, C = 2*Lp
    cluster_birth: torch.Tensor  # (C+1,) f32
    cluster_weight: torch.Tensor  # (C+1,) f32
    n_labels: torch.Tensor  # () int32 — labels in use (root included)


class ExtractionArrays(NamedTuple):
    stability: torch.Tensor  # (C+1,) f32 — per condensed cluster label
    selected: torch.Tensor  # (C+1,) bool — flat-extraction winners
    labels: torch.Tensor  # (Lp,) int32 — per-leaf flat labels, -1 noise
    n_clusters: torch.Tensor  # () int32


def sorted_edges(eu, ev, ew, valid, n_valid: int):
    """The merge order: pad merges synthesized (the j-th invalid slot joins
    pad leaf ``n_valid + j`` to node 0 at ``PAD_DIST``, surplus slots park
    at +inf), then a stable sort on weight.  ``n_valid`` is an int or a 0-d
    device tensor (the exact-dynamic pass keeps its count on the device).
    Returns the (Lp,) int64 ends and f32 weights; no host sync."""
    Lp = eu.shape[0]
    eu, ev = eu.long(), ev.long()
    ew = ew.float()
    valid = valid.bool()
    inv_rank = torch.cumsum((~valid).long(), 0) - 1
    pad_leaf = inv_rank + n_valid
    is_pad = (~valid) & (pad_leaf < Lp)
    u_e = torch.where(valid, eu, torch.where(is_pad, pad_leaf, 0))
    v_e = torch.where(valid, ev, 0)
    pad_w = torch.full_like(ew, float("inf")).masked_fill_(is_pad, PAD_DIST)
    w_e = torch.where(valid, ew, pad_w)
    order = torch.sort(w_e, stable=True).indices
    return u_e[order], v_e[order], w_e[order]


def single_linkage_fixed(eu, ev, ew, valid, n_valid: int, weights) -> SingleLinkageArrays:
    """Edge-sorted union-find single-linkage over padded edge buffers
    (exactly ``n_valid - 1`` valid edges for a connected valid block).
    Union-find is component relabeling: each merge relabels the absorbed
    component with one O(Lp) ``where``."""
    dev = eu.device
    Lp = eu.shape[0]
    M = Lp - 1
    trash_node = 2 * Lp - 1
    u_s, v_s, w_s = sorted_edges(eu, ev, ew, valid, n_valid)
    uv_s = torch.stack([u_s, v_s], 1)  # (Lp, 2)

    comp = torch.arange(Lp, device=dev)
    node_of_comp = torch.cat([comp, torch.tensor([trash_node], device=dev)])  # slot Lp: trash
    node_weight = torch.zeros(2 * Lp, dtype=torch.float32, device=dev)
    node_weight[:Lp] = weights.float()
    merges = torch.full((M + 1, 2), trash_node, dtype=torch.long, device=dev)  # (left, right)
    dw = torch.zeros((M + 1, 2), dtype=torch.float32, device=dev)  # (dist, weight)
    ks = torch.arange(M, device=dev)
    for k in range(M):
        c = comp[uv_s[k]]  # (2,) components of the edge's ends
        ok = c[:1] != c[1:]  # surplus +inf slots / disconnected inputs: no-op
        nab = node_of_comp[c]
        wsum = node_weight[nab].sum(0, keepdim=True)
        slot = torch.where(ok, ks[k], M)  # rejected merges land in the trash row
        merges[slot] = torch.where(ok, nab, trash_node)[None, :]
        dw[slot] = torch.cat([w_s[k : k + 1], wsum])[None, :]
        node_weight[torch.where(ok, ks[k] + Lp, trash_node)] = wsum
        comp = torch.where(comp == c[1], c[0], comp)
        node_of_comp[torch.where(ok, c[0], Lp)] = ks[k : k + 1] + Lp
    return SingleLinkageArrays(
        merges[:M, 0].int(), merges[:M, 1].int(), dw[:M, 0].clone(), dw[:M, 1].clone(), node_weight)


def condense_fixed(slt: SingleLinkageArrays, weights, min_cluster_size: float) -> CondensedArrays:
    """Collapse the dendrogram like ``hdbscan.condense_tree``: a split
    founds two condensed clusters only when both sides are internal
    subtrees of weight ≥ min_cluster_size; one heavy side continues its
    parent's label; light sides fall out at the split's λ.  Internal ids
    grow with merge order, so one top-down sweep settles every node's
    (label, entry λ, fallen?) before it is visited."""
    dev = slt.left.device
    M = slt.left.shape[0]
    Lp = M + 1
    n_nodes = 2 * Lp - 1  # + slot n_nodes = trash
    C = 2 * Lp
    trash_label = C
    mcs = torch.tensor(float(min_cluster_size), dtype=torch.float32, device=dev)
    root = n_nodes - 1
    lam_of = torch.where(
        slt.dist > 0.0, torch.clamp_max(1.0 / slt.dist, MAX_LAMBDA), MAX_LAMBDA).float()

    # per-merge constants: children, their weights, heavy-and-internal
    lr = torch.stack([slt.left.long(), slt.right.long()], 1)  # (M, 2)
    wlr = slt.node_weight[lr]  # (M, 2)
    heavy = (wlr >= mcs) & (lr >= Lp)  # (M, 2)
    alone = heavy & ~heavy.flip(1)  # the single continuing heavy side

    cl = torch.zeros(n_nodes + 1, dtype=torch.long, device=dev)  # root enters cluster 0
    lam_in = torch.zeros(n_nodes + 1, dtype=torch.float32, device=dev)
    fallen = torch.zeros(n_nodes + 1, dtype=torch.bool, device=dev)
    cp = torch.full((C + 1,), trash_label, dtype=torch.long, device=dev)
    cb = torch.zeros(C + 1, dtype=torch.float32, device=dev)
    cw = torch.zeros(C + 1, dtype=torch.float32, device=dev)
    cw[0] = slt.node_weight[root]
    nxt = torch.ones(1, dtype=torch.long, device=dev)
    pair = torch.tensor([0, 1], device=dev)
    for i in range(M - 1, -1, -1):  # merge i is node Lp + i; root first
        node = Lp + i
        P, lin, fal = cl[node : node + 1], lam_in[node : node + 1], fallen[node : node + 1]
        kids = lr[i]
        both = heavy[i : i + 1].all(1) & ~fal
        ab = nxt + pair  # the two new labels A, B
        cl[kids] = torch.where(both, ab, P)
        lam_in[kids] = torch.where(fal, lin, lam_of[i : i + 1]).expand(2)
        fallen[kids] = fal | ~(both | alone[i])
        sab = torch.where(both, ab, trash_label)
        cp[sab] = P.expand(2)
        cb[sab] = lam_of[i : i + 1].expand(2)
        cw[sab] = wlr[i]
        nxt = nxt + 2 * both.long()
    # trash-label writes must not leak into slot C's defaults
    cp[trash_label] = trash_label
    cb[trash_label] = 0.0
    cw[trash_label] = 0.0
    return CondensedArrays(
        point_parent=cl[:Lp].int(),
        point_lambda=lam_in[:Lp].clone(),
        point_weight=weights.float(),
        cluster_parent=cp.int(),
        cluster_birth=cb,
        cluster_weight=cw,
        n_labels=nxt[0].int(),
    )


def extract_fixed(ct: CondensedArrays, method: str = "eom",
                  allow_single_cluster: bool = False) -> ExtractionArrays:
    """Excess-of-mass (or leaf) extraction: stability(c) = Σ (λ_row −
    λ_birth(c)) · w_row by two scatter-adds; EOM as one descending sweep
    over the labels in use (children are final when their parent is
    visited); selection blocking and label resolution by pointer
    doubling."""
    check_method(method)
    stab = stabilities(ct)
    sel, kid_count = eom_loop(stab, ct.cluster_parent, ct.n_labels)
    return flat_labels(ct, stab, sel, kid_count, method, allow_single_cluster)


def eom_loop(stab, cluster_parent, n_labels):
    """Bottom-up EOM over the labels in use: selected iff stability ≥ Σ
    selected-descendant; the subtree sum flips through the selection flag,
    so it stays a sweep.  One host read of the label count bounds it.
    Returns the (C+1,) bool selection and int64 child counts."""
    dev = stab.device
    n_slots = stab.shape[0]
    parent = cluster_parent.long()
    acc = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    kid_count = torch.zeros(n_slots, dtype=torch.long, device=dev)
    sel = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    one = torch.ones(1, dtype=torch.long, device=dev)
    for c in range(int(n_labels) - 1, -1, -1):
        s, ksum = stab[c : c + 1], acc[c : c + 1]
        is_sel = (kid_count[c : c + 1] == 0) | (s >= ksum)
        sel[c : c + 1] = is_sel
        if c >= 1:
            p = parent[c : c + 1]
            acc.index_put_((p,), torch.where(is_sel, s, ksum), accumulate=True)
            kid_count.index_put_((p,), one, accumulate=True)
    return sel, kid_count


def check_method(method: str) -> None:
    if method not in ("eom", "leaf"):
        raise ValueError(f"unknown extraction method {method!r} (want eom|leaf)")


def stabilities(ct: CondensedArrays) -> torch.Tensor:
    """stability(c) = Σ (λ_row − λ_birth(c)) · w_row over the leaves and
    the child labels of c, by two scatter-adds; (C+1,) f32."""
    dev = ct.cluster_parent.device
    C = ct.cluster_parent.shape[0] - 1
    ids = torch.arange(C + 1, device=dev)
    row_mask = (ids < ct.n_labels.long()) & (ids >= 1)
    pp = ct.point_parent.long()
    birth = ct.cluster_birth
    stab = torch.zeros(C + 1, dtype=torch.float32, device=dev)
    stab.index_put_((pp,), (ct.point_lambda - birth[pp]) * ct.point_weight, accumulate=True)
    par_of = torch.where(row_mask, ct.cluster_parent.long(), C)
    stab.index_put_(
        (par_of,), torch.where(row_mask, (birth - birth[par_of]) * ct.cluster_weight, 0.0),
        accumulate=True)
    return stab


def flat_labels(ct: CondensedArrays, stab, sel, kid_count, method: str,
                allow_single_cluster: bool) -> ExtractionArrays:
    """From the EOM sweep's selection flags and child counts: selection
    blocking (EOM) or the childless labels (leaf), then each leaf's flat
    label, by pointer doubling; no host sync."""
    dev = ct.cluster_parent.device
    C = ct.cluster_parent.shape[0] - 1
    trash = C
    ids = torch.arange(C + 1, device=dev)
    in_use = ids < ct.n_labels.long()
    parent = ct.cluster_parent.long()
    pp = ct.point_parent.long()
    n_jumps = max(C - 1, 1).bit_length() + 1
    parent_or_trash = torch.where(in_use & (ids >= 1), parent, trash)
    if method == "leaf":
        eff = in_use & (kid_count == 0) & (allow_single_cluster | (ids != 0))
    else:
        # a selected cluster blocks every selected descendant: OR over the
        # ancestor chain by pointer doubling
        sel_allowed = sel & (allow_single_cluster | (ids != 0)) & in_use
        g, anc = parent_or_trash, sel_allowed[parent_or_trash]
        for _ in range(n_jumps):
            g, anc = g[g], anc | anc[g]
        eff = sel_allowed & ~anc
    if allow_single_cluster:
        eff = eff.clone()
        eff[0] = eff[0] | ~eff.any()
    eff = eff & in_use

    # labels: nearest selected ancestor-or-self, ranked ascending
    rank = torch.cumsum(eff.long(), 0) - 1
    f = torch.where(eff, ids, parent_or_trash)
    for _ in range(n_jumps):
        f = torch.where(eff[f], f, f[f])
    resolved = torch.where(eff[f], rank[f], -1)
    labels = resolved[pp]
    return ExtractionArrays(
        stability=stab, selected=eff, labels=labels.int(), n_clusters=eff.sum().int())


def hierarchy_fixed(eu, ev, ew, valid, n_valid: int, weights, min_cluster_size: float,
                    method: str = "eom", allow_single_cluster: bool = False):
    """MST buffers → (SingleLinkageArrays, CondensedArrays, ExtractionArrays):
    the sweeps' CUDA kernels for CUDA tensors, the plain loops above for CPU
    tensors (``kernels/hierarchy.py``)."""
    from ..kernels import hierarchy as _kernels  # kernels/hierarchy.py imports this module

    slt = _kernels.single_linkage(eu, ev, ew, valid, n_valid, weights)
    ct = _kernels.condense(slt, weights, min_cluster_size)
    ex = _kernels.extract(ct, method=method, allow_single_cluster=allow_single_cluster)
    return slt, ct, ex
