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
runs single-linkage (after ``sorted_edges``) and condense as one kernel
each, and the whole of ``extract_fixed`` (stabilities, EOM, selection,
flat labels) as one more.  The EOM loop reads
the label count once before it starts and visits only the labels in use
(the reference's fixed 2·Lp-step scan only writes trash slots past them).
Selection blocking and label resolution are pointer-doubling sweeps of
⌈log₂ C⌉ + 1 vector steps.  The stabilities are sums in one written-down
order (``stabilities``): each label's leaves in ascending leaf index, then
its child labels in ascending label, one f32 add each from +0.0, which
the card's extract kernel gives bit for bit.  (PyTorch's CPU
``index_put_(accumulate=True)`` keeps that order only below 32,768
indices; past them it adds with parallel atomics, in no fixed order.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
    "single_linkage_chunked",
    "condense_jump",
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


def _find_halving(parent, x):
    """Root of x in a numpy union-find whose roots point at themselves,
    halving the path."""
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def single_linkage_chunked(eu, ev, ew, valid, n_valid: int, weights, chunk: int = 1024) -> SingleLinkageArrays:
    """``single_linkage_fixed`` by the card kernel's algorithm
    (``csrc/hierarchy_par.cu``), in numpy: per chunk of ``chunk`` merges,
    the roots of both ends against the state at the chunk's start, then
    one walk over the chunk in edge order with a small union-find over
    those roots (slot 2t for edge t's u, 2t + 1 for its v; a root's record
    is its node, weight and slot count), then the merged roots linked to
    the chunk's final roots.  Tests and ``chip_smoke.py`` hold the kernel
    to it; the main path never calls it."""
    Lp = eu.shape[0]
    M, trash = Lp - 1, 2 * Lp - 1
    u_s, v_s, w_s = (t.cpu().numpy() for t in sorted_edges(eu, ev, ew, valid, n_valid))
    parent = np.full(Lp, -1, np.int64)  # a root holds -1 - (its slot in the current chunk)
    node_of = np.arange(Lp)
    node_weight = np.zeros(2 * Lp, np.float32)
    node_weight[:Lp] = weights.cpu().numpy()
    left, right = np.full(M, trash, np.int32), np.full(M, trash, np.int32)
    dist, weight = np.zeros(M, np.float32), np.zeros(M, np.float32)
    trash_w = None
    for k0 in range(0, M, chunk):
        cnt = min(chunk, M - k0)
        ends = np.stack([u_s[k0 : k0 + cnt], v_s[k0 : k0 + cnt]], 1).ravel()
        roots = ends.copy()
        while (parent[roots] >= 0).any():
            roots = np.where(parent[roots] >= 0, parent[roots], roots)
        parent[ends] = np.where(parent[ends] >= 0, roots, parent[ends])  # flatten the ends' paths
        slots = np.arange(2 * cnt)
        parent[roots] = -1 - slots  # any writer wins: every end of one root reads the same slot
        local = -1 - parent[roots]
        canon = local == slots
        lpar, lsize = slots.copy(), np.ones(2 * cnt, np.int64)
        lnode, lw = np.zeros(2 * cnt, np.int64), np.zeros(2 * cnt, np.float32)
        lnode[canon] = node_of[roots[canon]]
        lw[canon] = node_weight[lnode[canon]]
        for t in range(cnt):
            k = k0 + t
            a, b = _find_halving(lpar, local[2 * t]), _find_halving(lpar, local[2 * t + 1])
            wsum = lw[a] + lw[b]  # one f32 add, u's side first
            if a == b:
                trash_w = wsum
                continue
            left[k], right[k], dist[k], weight[k] = lnode[a], lnode[b], w_s[k], wsum
            node_weight[Lp + k] = wsum
            root, other = (a, b) if lsize[a] >= lsize[b] else (b, a)
            lpar[other] = root
            lsize[root] += lsize[other]
            lnode[root], lw[root] = Lp + k, wsum
        for s in np.flatnonzero(canon):
            f = _find_halving(lpar, s)
            if f != s:
                parent[roots[s]] = roots[f]
            else:
                node_of[roots[s]] = lnode[s]
    if trash_w is not None:
        node_weight[trash] = trash_w
    dev = eu.device
    return SingleLinkageArrays(*(torch.from_numpy(a).to(dev) for a in (left, right, dist, weight, node_weight)))


def condense_jump(slt: SingleLinkageArrays, weights, min_cluster_size: float, chunk: int = 1024) -> CondensedArrays:
    """``condense_fixed`` by the card kernel's algorithm
    (``csrc/hierarchy_par.cu``), in numpy, with no sequential walk.  A
    node's parent merge has the larger id, so over the path from the top
    down to node x:

      * fallen(x) is the OR of a per-edge drop flag the merge constants
        fix, ``~((hl & hr) | alone[side])``;
      * entry λ(x) is the λ of the merge above the topmost drop, else of
        x's parent merge (0 at a top node);
      * label P(x) is the label that x's nearest ancestor split
        (``hl & hr`` at a node that has not fallen) gave its side, else 0;
      * split i takes labels 1 + 2·#{splits j > i} and that plus 1.

    The merges go in chunks of ``chunk`` from the top id down; inside a
    chunk, fallen / topmost-drop λ and then P come by pointer jumping (a
    parent outside the chunk is already final), and the labels by a
    suffix count.  Every value is a copy or a comparison of the loop's.
    Tests and ``chip_smoke.py`` hold the kernel to it; the main path
    never calls it."""
    M = slt.left.shape[0]
    Lp = M + 1
    C = 2 * Lp
    left, right = slt.left.cpu().numpy().astype(np.int64), slt.right.cpu().numpy().astype(np.int64)
    dist, nw = slt.dist.cpu().numpy(), slt.node_weight.cpu().numpy()
    mcs = np.float32(min_cluster_size)
    with np.errstate(divide="ignore"):
        lam = np.where(dist > 0, np.minimum(np.float32(1) / dist, np.float32(MAX_LAMBDA)),
                       np.float32(MAX_LAMBDA)).astype(np.float32)
    wl, wr = nw[left], nw[right]
    hl, hr = (wl >= mcs) & (left >= Lp), (wr >= mcs) & (right >= Lp)
    hh = hl & hr
    ids = np.arange(M)
    par = np.full(M, -1, np.int64)  # the parent merge of node Lp + i
    elam = np.zeros(M, np.float32)  # that merge's λ
    edrop, eside = np.zeros(M, bool), np.zeros(M, np.int64)
    for side, kids, drop in ((0, left, ~(hh | (hl & ~hr))), (1, right, ~(hh | (hr & ~hl)))):
        m = (kids >= Lp) & (kids < 2 * Lp - 1)  # internal, not the trash node
        y = kids[m] - Lp
        par[y], elam[y], edrop[y], eside[y] = ids[m], lam[m], drop[m], side
    fT = np.zeros(M, np.float32)  # topmost-drop λ, -1 where node Lp + i has not fallen
    fP = np.zeros(M, np.int64)  # P(node Lp + i)
    flab = np.full(M, -1, np.int64)  # split i's first label, -1 if no split

    def jump(val, ptr, up_wins):
        while (ptr >= 0).any():
            m = ptr >= 0
            q = np.where(m, ptr, 0)
            if up_wins:
                new = np.where(val[q] >= 0, val[q], val)
            else:
                new = np.where(val >= 0, val, val[q])
            val = np.where(m, new, val)
            ptr = np.where(m, ptr[q], -1)
            if not up_wins:  # the nearest split wins: a node that has one is final
                ptr = np.where(val >= 0, -1, ptr)
        return val

    above = 0
    for hi in range(M, 0, -chunk):
        lo = max(0, hi - chunk)
        p = par[lo:hi]
        top, inside = p < 0, (p >= lo) & (p < hi)
        pc = np.where(top, 0, p)
        edge_t = np.where(edrop[lo:hi], elam[lo:hi], np.float32(-1))
        aT = np.where(top, np.float32(-1), np.where(inside, edge_t, np.where(fT[pc] >= 0, fT[pc], edge_t)))
        ptr = np.where(inside, p - lo, -1)
        aT = jump(aT.astype(np.float32), ptr, up_wins=True)
        fT[lo:hi] = aT
        split = hh[lo:hi] & ~(aT >= 0)
        after = np.cumsum(split[::-1])[::-1] - split  # splits of this chunk with a larger id
        flab[lo:hi] = np.where(split, 1 + 2 * (above + after), -1)
        above += int(split.sum())
        lab_p = np.where(flab[pc] >= 0, flab[pc] + eside[lo:hi], -1)
        aP = np.where(top, 0, np.where(inside | (lab_p >= 0), lab_p, fP[pc]))
        fP[lo:hi] = jump(aP, np.where(inside & (aP < 0), p - lo, -1), up_wins=False)

    cp = np.full(C + 1, C, np.int64)
    cb, cw = np.zeros(C + 1, np.float32), np.zeros(C + 1, np.float32)
    cw[0] = nw[2 * Lp - 2]
    s = flab >= 0
    for off, w in ((0, wl), (1, wr)):
        cp[flab[s] + off], cb[flab[s] + off], cw[flab[s] + off] = fP[s], lam[s], w[s]
    point_parent, point_lambda = np.zeros(Lp, np.int64), np.zeros(Lp, np.float32)
    for kids in (left, right):
        m = kids < Lp
        point_parent[kids[m]] = fP[m]
        point_lambda[kids[m]] = np.where(fT[m] >= 0, fT[m], lam[m])
    dev = slt.left.device

    def as_t(a, dtype):
        return torch.from_numpy(a).to(dev, dtype)

    return CondensedArrays(
        point_parent=as_t(point_parent, torch.int32), point_lambda=as_t(point_lambda, torch.float32),
        point_weight=weights.float(), cluster_parent=as_t(cp, torch.int32),
        cluster_birth=as_t(cb, torch.float32), cluster_weight=as_t(cw, torch.float32),
        n_labels=torch.tensor(1 + 2 * above, dtype=torch.int32, device=dev))


def extract_fixed(ct: CondensedArrays, method: str = "eom",
                  allow_single_cluster: bool = False) -> ExtractionArrays:
    """Excess-of-mass (or leaf) extraction: stability(c) = Σ (λ_row −
    λ_birth(c)) · w_row in ``stabilities``' fixed order; EOM as one descending sweep
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
    the child labels of c; (C+1,) f32.  Each term is one f32 subtract and
    one multiply; a label's terms are added one f32 add at a time from
    +0.0, its leaves in ascending leaf index, then its child labels in
    ascending label (two ``np.add.at`` on the host, which applies its
    terms unbuffered in index order).  Slots ≥ ``n_labels`` hold 0; slot
    C takes the masked rows' 0.0 terms.  The sum reads the tensors on the
    host: this plain version never runs on the card's main path."""
    dev = ct.cluster_parent.device
    C = ct.cluster_parent.shape[0] - 1
    ids = torch.arange(C + 1, device=dev)
    row_mask = (ids < ct.n_labels.long()) & (ids >= 1)
    pp = ct.point_parent.long()
    birth = ct.cluster_birth
    par_of = torch.where(row_mask, ct.cluster_parent.long(), C)
    leaf_terms = (ct.point_lambda - birth[pp]) * ct.point_weight
    kid_terms = torch.where(row_mask, (birth - birth[par_of]) * ct.cluster_weight, 0.0)
    stab = np.zeros(C + 1, np.float32)
    np.add.at(stab, pp.cpu().numpy(), leaf_terms.cpu().numpy())
    np.add.at(stab, par_of.cpu().numpy(), kid_terms.cpu().numpy())
    return torch.from_numpy(stab).to(dev)


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
