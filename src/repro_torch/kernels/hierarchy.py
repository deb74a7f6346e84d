"""The offline pass's hierarchy sweeps: CUDA kernels and plain versions.

Replaces the three O(Lp) ``lax.scan`` sweeps of the JAX package's
``repro/core/hierarchy_jax.py`` (single-linkage, the top-down condense
sweep, and ``extract_fixed`` with its bottom-up EOM sweep), which the
reference runs inside one jit; it has no Pallas kernel for them.  The
plain versions are the torch loops of ``core/hierarchy.py``: a tensor on
the CPU runs them, a CUDA tensor runs the kernels and any other device
raises.

On the card each stage is one launch of one thread block, and nothing
between the Borůvka buffers and the outputs reads the host:

* ``single_linkage``: the pad-merge synthesis and the stable sort stay
  torch ops (``core.hierarchy.sorted_edges``), then the kernel of
  ``csrc/hierarchy_par.cu`` runs the Lp − 1 merges: per chunk of 1024
  edges, the ends' roots found in parallel, one walk over a union-find of
  those roots in shared memory, the records written out coalesced;
* ``condense``: the kernel of ``csrc/hierarchy_par.cu`` computes the
  per-merge constants and settles every node's label, entry λ and fallen
  flag by pointer jumping over chunks of merges, with no sequential walk;
* ``extract``: the kernel of ``csrc/hierarchy_extract.cu`` does the whole
  stage: the stabilities in ``core.hierarchy.stabilities``' fixed order
  (a stable counting sort of the terms by label, then a warp folds each
  label's), the EOM walk over the labels in use (their count read on the
  device), selection blocking or the leaf rule, ranks, resolution by
  pointer jumping and the leaves' labels; every field equals the plain
  ``extract_fixed`` bit for bit.

The first versions stay as the new kernels' oracles on the card, CUDA
tensors only, never on the main path: ``single_linkage_sorted_v1`` and
``condense_v1`` (``csrc/hierarchy.cu``, one thread walking every step),
and ``extract_v1``, the earlier composition (stabilities by
``index_put_(accumulate=True)``, the EOM kernel of ``csrc/hierarchy.cu``
through ``eom_sweep``, then ``core.hierarchy.flat_labels``' vector steps).

Bound on the H100: latency, a chain of dependent steps per sweep (see the
sources).  The state a sweep reads back lives in shared memory where
``plan`` says it fits, else in a scratch buffer allocated here; the
extract kernel places each of its arrays on the device from the label
count it reads there, in a scratch buffer ``plan`` sizes for the largest.
"""

from __future__ import annotations

import torch

from ..core import hierarchy as _plain
from . import _build

__all__ = ["single_linkage", "single_linkage_sorted", "single_linkage_sorted_v1", "condense", "condense_v1",
           "extract", "extract_v1", "eom_sweep", "plan"]

launches_single_linkage = 0  # kernel launches since the last reset (chip_smoke.py reads them)
launches_condense = 0
launches_extract = 0
launches_single_linkage_v1 = 0  # the first versions', launched only to check the new kernels
launches_condense_v1 = 0
launches_eom = 0  # extract_v1's EOM kernel

SMEM_BYTES = 232_448  # dynamic shared memory one block may opt in to on sm_90
CHUNK = 1024  # edges or merges per chunk of csrc/hierarchy_par.cu; steps per staged chunk of csrc/hierarchy.cu
# shared bytes besides the state: csrc/hierarchy_par.cu's chunk buffers, csrc/hierarchy.cu's staging rings
_BUFFERS = {"single_linkage": (3 * CHUNK + 1) * 16 + 2 * CHUNK * 4 + 2 * (CHUNK + 2) * 4,
            "condense": 4 * CHUNK * 4 + (CHUNK // 32) * 4, "eom": 0, "extract": 256,
            "single_linkage_v1": 2 * CHUNK * 12, "condense_v1": 2 * CHUNK * 20}
MAX_LP = 1 << 29  # node ids 0 .. 2·Lp and label slots 0 .. 2·Lp in int32


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _state_bytes(kind: str, Lp: int) -> int:
    n_slots = 2 * Lp + 1
    return {"single_linkage": 8 * Lp,  # parent, node of root
            # parent merge, its λ, topmost-drop λ, P, split label; edge flags, split flag per merge
            "condense": 20 * Lp + _round4(2 * Lp),
            "eom": 8 * n_slots,  # sum and child count per label slot
            # at a label count of n_slots: six words and two flags per label (EOM sums, stabilities, child
            # offsets, parents, leaf offsets, child terms; selected, effective), 32 sort cells per label, a term per leaf
            "extract": 6 * _round16(4 * n_slots) + _round16(2 * n_slots) + _round16(128 * n_slots) + _round16(4 * Lp),
            "single_linkage_v1": 12 * Lp,  # parent, node of root, weight of root
            "condense_v1": 8 * Lp + _round4(Lp)}[kind]  # label, entry λ, fallen flag per internal node


def plan(kind: str, Lp: int) -> tuple[bool, int]:
    """(state in shared memory?, scratch bytes) of one sweep's kernel at
    bucket Lp: the state goes to shared memory when it and the kernel's
    other shared buffers fit one block's ``SMEM_BYTES``, else to a device
    scratch buffer of the returned size (0 with shared memory).  ``kind``
    is "single_linkage", "condense", "extract", or "eom" /
    "single_linkage_v1" / "condense_v1" for the first versions.  For
    "extract" the state is every array at the largest label count (2·Lp +
    1): the kernel puts each array in shared memory or in the scratch
    buffer from the count it reads on the device."""
    state = _state_bytes(kind, Lp)
    if state + _BUFFERS[kind] <= SMEM_BYTES:
        return True, 0
    return False, state


def _on_card(name: str, *ts) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); raises on mixed or other devices."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name} inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return True


def _scratch(kind: str, Lp: int, dev) -> tuple[bool, torch.Tensor]:
    smem, nbytes = plan(kind, Lp)
    return smem, torch.empty(nbytes // 4, dtype=torch.int32, device=dev)  # empty (null) with shared memory


def _i32(t):
    return t.to(torch.int32).contiguous()


def _f32(t):
    return t.to(torch.float32).contiguous()


def single_linkage(eu, ev, ew, valid, n_valid: int, weights) -> _plain.SingleLinkageArrays:
    """(Lp,) Borůvka buffers (int ends, float weights, bool valid) and
    (Lp,) leaf weights → the merge records of ``core.hierarchy``'s
    ``SingleLinkageArrays``."""
    Lp = eu.shape[0]
    if any(t.shape != (Lp,) for t in (eu, ev, ew, valid, weights)):
        raise ValueError("single_linkage wants (Lp,) edge buffers and weights")
    if not _on_card("single_linkage", eu, ev, ew, valid, weights):
        return _plain.single_linkage_fixed(eu, ev, ew, valid, n_valid, weights)
    return single_linkage_sorted(*_plain.sorted_edges(eu, ev, ew, valid, n_valid), weights)


def single_linkage_sorted(u_s, v_s, w_s, weights) -> _plain.SingleLinkageArrays:
    """The single-linkage kernel alone, CUDA tensors only: the Lp − 1
    merges over ``core.hierarchy.sorted_edges``'s (Lp,) ends and weights."""
    global launches_single_linkage
    out = _single_linkage_launch("single_linkage", "repro_single_linkage_par_f32", u_s, v_s, w_s, weights)
    launches_single_linkage += 1
    return out


def single_linkage_sorted_v1(u_s, v_s, w_s, weights) -> _plain.SingleLinkageArrays:
    """``single_linkage_sorted`` by the first version's kernel
    (``csrc/hierarchy.cu``, one thread walking every merge): the new
    kernel's oracle on the card, CUDA tensors only."""
    global launches_single_linkage_v1
    out = _single_linkage_launch("single_linkage_v1", "repro_single_linkage_f32", u_s, v_s, w_s, weights)
    launches_single_linkage_v1 += 1
    return out


def _single_linkage_launch(kind: str, entry: str, u_s, v_s, w_s, weights) -> _plain.SingleLinkageArrays:
    Lp = u_s.shape[0]
    if any(t.shape != (Lp,) for t in (v_s, w_s, weights)) or not _on_card(kind, u_s, v_s, w_s, weights):
        raise ValueError(f"{kind} runs the kernel: it takes (Lp,) CUDA tensors only")
    if not 2 <= Lp <= MAX_LP:
        raise ValueError(f"the {kind} kernel takes 2 <= Lp <= {MAX_LP}, got {Lp}")
    dev, M = u_s.device, Lp - 1
    u_s, v_s, w_s, weights = _i32(u_s), _i32(v_s), _f32(w_s), _f32(weights)
    left = torch.empty(M, dtype=torch.int32, device=dev)
    right = torch.empty(M, dtype=torch.int32, device=dev)
    dist = torch.empty(M, dtype=torch.float32, device=dev)
    weight = torch.empty(M, dtype=torch.float32, device=dev)
    node_weight = torch.empty(2 * Lp, dtype=torch.float32, device=dev)
    smem, scratch = _scratch(kind, Lp, dev)
    with torch.cuda.device(dev):
        code = getattr(_build.load(), entry)(
            u_s.data_ptr(), v_s.data_ptr(), w_s.data_ptr(), weights.data_ptr(), Lp, int(smem), scratch.data_ptr(),
            left.data_ptr(), right.data_ptr(), dist.data_ptr(), weight.data_ptr(), node_weight.data_ptr(),
            _build.current_stream(dev))
    _build.check(code, kind)
    return _plain.SingleLinkageArrays(left, right, dist, weight, node_weight)


def condense(slt: _plain.SingleLinkageArrays, weights, min_cluster_size: float) -> _plain.CondensedArrays:
    """Merge records → the array-form condensed tree (``CondensedArrays``)."""
    global launches_condense
    _check_condense_inputs(slt, weights)
    if not _on_card("condense", slt.left, slt.right, slt.dist, slt.node_weight, weights):
        return _plain.condense_fixed(slt, weights, min_cluster_size)
    out = _condense_launch("condense", "repro_condense_par_f32", slt, weights, min_cluster_size)
    launches_condense += 1
    return out


def condense_v1(slt: _plain.SingleLinkageArrays, weights, min_cluster_size: float) -> _plain.CondensedArrays:
    """``condense`` by the first version's kernel (``csrc/hierarchy.cu``,
    one thread walking the merges from the root down): the new kernel's
    oracle on the card, CUDA tensors only."""
    global launches_condense_v1
    _check_condense_inputs(slt, weights)
    if not _on_card("condense_v1", slt.left, slt.right, slt.dist, slt.node_weight, weights):
        raise ValueError("condense_v1 runs the kernel: it takes CUDA tensors only")
    out = _condense_launch("condense_v1", "repro_condense_f32", slt, weights, min_cluster_size)
    launches_condense_v1 += 1
    return out


def _check_condense_inputs(slt, weights) -> None:
    M = slt.left.shape[0]
    Lp = M + 1
    if (any(t.shape != (M,) for t in (slt.left, slt.right, slt.dist))
            or slt.node_weight.shape != (2 * Lp,) or weights.shape != (Lp,)):
        raise ValueError("condense wants (Lp-1,) merge records, (2·Lp,) node weights and (Lp,) weights")


def _condense_launch(kind: str, entry: str, slt, weights, min_cluster_size: float) -> _plain.CondensedArrays:
    Lp = slt.left.shape[0] + 1
    if not 2 <= Lp <= MAX_LP:
        raise ValueError(f"the {kind} kernel takes 2 <= Lp <= {MAX_LP}, got {Lp}")
    dev, C = slt.left.device, 2 * Lp
    left, right, dist, node_weight = _i32(slt.left), _i32(slt.right), _f32(slt.dist), _f32(slt.node_weight)
    point_parent = torch.empty(Lp, dtype=torch.int32, device=dev)
    point_lambda = torch.empty(Lp, dtype=torch.float32, device=dev)
    cluster_parent = torch.empty(C + 1, dtype=torch.int32, device=dev)
    cluster_birth = torch.empty(C + 1, dtype=torch.float32, device=dev)
    cluster_weight = torch.empty(C + 1, dtype=torch.float32, device=dev)
    n_labels = torch.empty((), dtype=torch.int32, device=dev)
    smem, scratch = _scratch(kind, Lp, dev)
    with torch.cuda.device(dev):
        code = getattr(_build.load(), entry)(
            left.data_ptr(), right.data_ptr(), dist.data_ptr(), node_weight.data_ptr(), Lp,
            float(min_cluster_size), int(smem), scratch.data_ptr(), point_parent.data_ptr(),
            point_lambda.data_ptr(), cluster_parent.data_ptr(), cluster_birth.data_ptr(), cluster_weight.data_ptr(),
            n_labels.data_ptr(), _build.current_stream(dev))
    _build.check(code, kind)
    return _plain.CondensedArrays(
        point_parent=point_parent, point_lambda=point_lambda, point_weight=weights.float(),
        cluster_parent=cluster_parent, cluster_birth=cluster_birth, cluster_weight=cluster_weight,
        n_labels=n_labels)


def extract(ct: _plain.CondensedArrays, method: str = "eom",
            allow_single_cluster: bool = False) -> _plain.ExtractionArrays:
    """Stabilities, EOM (or leaf) selection and per-leaf flat labels
    (``ExtractionArrays``): one launch of ``csrc/hierarchy_extract.cu`` on
    the card, ``core.hierarchy.extract_fixed`` on the CPU."""
    global launches_extract
    _plain.check_method(method)
    _check_extract_inputs(ct)
    if not _on_card("extract", ct.cluster_parent, ct.cluster_birth, ct.cluster_weight, ct.n_labels,
                    ct.point_parent, ct.point_lambda, ct.point_weight):
        return _plain.extract_fixed(ct, method=method, allow_single_cluster=allow_single_cluster)
    Lp, n_slots = ct.point_parent.shape[0], ct.cluster_parent.shape[0]
    if n_slots != 2 * Lp + 1 or not 2 <= Lp <= MAX_LP:
        raise ValueError(f"the extract kernel takes 2·Lp + 1 label slots, 2 <= Lp <= {MAX_LP}; got {n_slots}, {Lp}")
    dev = ct.point_parent.device
    stab = torch.empty(n_slots, dtype=torch.float32, device=dev)
    sel = torch.empty(n_slots, dtype=torch.bool, device=dev)
    labels = torch.empty(Lp, dtype=torch.int32, device=dev)
    n_clusters = torch.empty((), dtype=torch.int32, device=dev)
    _, scratch = _scratch("extract", Lp, dev)
    args = (_i32(ct.point_parent), _f32(ct.point_lambda), _f32(ct.point_weight), _i32(ct.cluster_parent),
            _f32(ct.cluster_birth), _f32(ct.cluster_weight), _i32(ct.n_labels))
    with torch.cuda.device(dev):
        code = _build.load().repro_extract_f32(
            *(a.data_ptr() for a in args), Lp, n_slots, int(method == "leaf"), int(allow_single_cluster),
            scratch.data_ptr(), stab.data_ptr(), sel.data_ptr(), labels.data_ptr(), n_clusters.data_ptr(),
            _build.current_stream(dev))
    _build.check(code, "extract")
    launches_extract += 1
    return _plain.ExtractionArrays(stability=stab, selected=sel, labels=labels, n_clusters=n_clusters)


def extract_v1(ct: _plain.CondensedArrays, method: str = "eom",
               allow_single_cluster: bool = False) -> _plain.ExtractionArrays:
    """``extract`` by the earlier card composition, CUDA tensors only: the
    stabilities by ``index_put_(accumulate=True)`` (CUDA's own order, so
    within 1e-5 of the kernel's), the EOM kernel (``eom_sweep``), then
    ``core.hierarchy.flat_labels``' vector steps.  The extract kernel's
    oracle on the card; never on the main path."""
    _plain.check_method(method)
    _check_extract_inputs(ct)
    if not _on_card("extract_v1", ct.cluster_parent, ct.cluster_birth, ct.n_labels, ct.point_parent):
        raise ValueError("extract_v1 runs the kernels: it takes CUDA tensors only")
    stab = _stabilities_index_put(ct)
    sel, kid_count = eom_sweep(stab, ct.cluster_parent, ct.n_labels)
    return _plain.flat_labels(ct, stab, sel, kid_count, method, allow_single_cluster)


def _check_extract_inputs(ct) -> None:
    n_slots = ct.cluster_parent.shape[0]
    if (any(t.shape != (n_slots,) for t in (ct.cluster_birth, ct.cluster_weight)) or ct.n_labels.shape != ()
            or ct.point_lambda.shape != ct.point_parent.shape or ct.point_weight.shape != ct.point_parent.shape):
        raise ValueError("extract wants (C+1,) label arrays, a () label count and matching leaf arrays")


def _stabilities_index_put(ct) -> torch.Tensor:
    """``core.hierarchy.stabilities``' sums by two device scatter-adds
    (``index_put_(accumulate=True)``), in the device's own order."""
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
        (par_of,), torch.where(row_mask, (birth - birth[par_of]) * ct.cluster_weight, 0.0), accumulate=True)
    return stab


def eom_sweep(stab, cluster_parent, n_labels):
    """The EOM kernel of ``extract_v1``, CUDA tensors only: ``core.hierarchy.eom_loop``
    over (2·Lp + 1,) stabilities and parents with the label count read on
    the device.  Returns the bool selection and int32 child counts."""
    global launches_eom
    n_slots = stab.shape[0]
    if (cluster_parent.shape != (n_slots,) or n_labels.shape != ()
            or not _on_card("eom", stab, cluster_parent, n_labels)):
        raise ValueError("eom_sweep runs the kernel: it takes (C+1,), (C+1,) and () CUDA tensors only")
    Lp = (n_slots - 1) // 2
    if n_slots != 2 * Lp + 1 or not 2 <= Lp <= MAX_LP:
        raise ValueError(f"the eom kernel takes 2·Lp + 1 label slots, 2 <= Lp <= {MAX_LP}; got {n_slots}")
    dev = stab.device
    stab, parent, n_labels = _f32(stab), _i32(cluster_parent), _i32(n_labels)
    sel = torch.empty(n_slots, dtype=torch.bool, device=dev)
    kid_count = torch.empty(n_slots, dtype=torch.int32, device=dev)
    smem, scratch = _scratch("eom", Lp, dev)
    with torch.cuda.device(dev):
        code = _build.load().repro_eom_f32(
            stab.data_ptr(), parent.data_ptr(), n_labels.data_ptr(), n_slots, int(smem), scratch.data_ptr(),
            sel.data_ptr(), kid_count.data_ptr(), _build.current_stream(dev))
    _build.check(code, "eom")
    launches_eom += 1
    return sel, kid_count
