"""Carry a running stream across from the JAX package.

``engine_from_reference_state`` takes the numpy dict that the JAX
package's ``StreamingClusterEngine.checkpoint_state()`` returns — keys
``cfg/*``, ``tree/*``, ``eng/*``, ``snap/*`` and, from a device-online
engine, ``flat/*`` — and returns a port engine with the same Bubble-tree
(free-list order included, so point ids keep replaying identically), the
same ε accounting, the same version counter, the same published snapshot
and, device-online, the same flat leaf-CF table (origin, slot order, free
list and Kahan compensations).  An exact-mode engine (``cfg/exact``)
comes across in exact mode; its dynamic state is rebuilt from the tree at
the next refresh, as the reference's restore does.
``dyn_state_from_reference`` carries the reference's exact-dynamic
``DynState`` itself, as a dict of numpy arrays, into the port's.
``dynamic_hdbscan_from_reference`` carries the reference's host
``DynamicHDBSCAN`` (core/dynamic.py), and ``summarizer_from_reference_state``
puts a port ``BubbleTreeSummarizer`` over the Bubble-tree of a reference
engine's checkpoint.  ``lm_params_from_reference`` and
``lm_cache_from_reference`` carry an LM's parameter tree and KV cache
(the reference's ``init_params`` values and ``init_cache``/``prefill``
caches, leaves as numpy; the dense, MoE, vision, ssm, hybrid and audio
families, RWKV's and the hybrid's state trees among the caches) into the
port's ``models`` and
``ServeEngine``; ``adamw_state_from_reference``
carries the reference's ``adamw_init`` / ``adamw_update`` state (``mu``,
``nu``, ``step``) beside them, so a port train step continues a reference
run.
These read only numpy and never import the JAX package.  The engine's
fields load through its own loader, the one ``restore`` uses.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.dynamic import DynamicHDBSCAN
from .core.dynamic_torch import DynState
from .core.summarizer import BubbleTreeSummarizer
from .device import resolve_device
from .models import model as M
from .serving.stream import _CKPT_FORMAT, StreamingClusterEngine, load_tree_state
from .tree import tree_map

__all__ = ["engine_from_reference_state", "dyn_state_from_reference", "dynamic_hdbscan_from_reference",
           "summarizer_from_reference_state", "lm_params_from_reference", "lm_cache_from_reference",
           "adamw_state_from_reference", "DYNAMIC_HDBSCAN_FIELDS"]

# the array attributes of a host DynamicHDBSCAN, and their dtypes
DYNAMIC_HDBSCAN_FIELDS = {
    "X": np.float64, "alive": np.bool_, "knn_idx": np.int64, "knn_dst": np.float64, "cd": np.float64,
    "mst_u": np.int64, "mst_v": np.int64, "mst_d": np.float64, "_free": np.int64,
}

_DYN_DTYPES = {
    "X": torch.float32, "alive": torch.bool, "knn_idx": torch.int32, "knn_dst": torch.float32,
    "cd": torch.float32, "mst_u": torch.int32, "mst_v": torch.int32, "mst_raw": torch.float32,
    "mst_valid": torch.bool, "n_alive": torch.int32, "ok": torch.bool,
}


def engine_from_reference_state(state: dict, *, device=None, mesh=None, **engine_kw) -> StreamingClusterEngine:
    """A port engine resuming the reference engine's checkpointed state.

    ``mesh`` shards its offline passes (the checkpoint does not record one;
    the passes are bit for bit the unsharded ones).  ``engine_kw`` sets
    what the checkpoint does not record either (``max_block``,
    ``async_offline``, ``min_offline_points``, the tree's fan-out …); the
    configuration it does record (dim, min_pts, min_cluster_size,
    compression, epsilon, exact, device_online) comes from ``cfg/*``.
    Raises ``ValueError`` on an unknown format."""
    eng = StreamingClusterEngine(
        int(state["cfg/dim"]),
        min_pts=int(state["cfg/min_pts"]),
        min_cluster_size=float(state["cfg/min_cluster_size"]),
        compression=float(state["cfg/compression"]),
        epsilon=float(state["cfg/epsilon"]),
        exact=bool(state["cfg/exact"]),
        device_online=bool(state["cfg/device_online"]),
        device=device,
        mesh=mesh,
        **engine_kw,
    )
    eng._load_state(state)
    return eng


def dyn_state_from_reference(arrays, device=None) -> DynState:
    """The port's ``DynState`` from the reference's, given as a mapping of
    its eleven field names to numpy arrays (``state._asdict()`` through
    ``np.asarray``): the same values in the same dtypes, on ``device``
    (None → cuda)."""
    dev = resolve_device(device)
    return DynState(**{f: torch.as_tensor(np.array(arrays[f]), dtype=_DYN_DTYPES[f]).to(dev)
                       for f in DynState._fields})


def dynamic_hdbscan_from_reference(arrays) -> DynamicHDBSCAN:
    """A port ``DynamicHDBSCAN`` resuming the reference's: ``arrays`` maps
    each name of ``DYNAMIC_HDBSCAN_FIELDS`` to the reference object's
    attribute as a numpy array (``np.asarray(getattr(dyn, name))``; ``_free``
    is the free list, whose order decides the slots of later inserts).
    The same values in the same dtypes; min_pts and dim come from the
    shapes, the update statistics start empty."""
    X = np.array(arrays["X"], dtype=np.float64)
    knn_idx = np.array(arrays["knn_idx"], dtype=np.int64)
    dyn = DynamicHDBSCAN(knn_idx.shape[1], X.shape[1], capacity=X.shape[0])
    for name, dtype in DYNAMIC_HDBSCAN_FIELDS.items():
        if name != "_free":
            setattr(dyn, name, np.array(arrays[name], dtype=dtype))
    dyn._free = np.asarray(arrays["_free"], dtype=np.int64).tolist()
    dyn.n = int(dyn.alive.sum())
    return dyn


def summarizer_from_reference_state(state: dict, device=None, **kw) -> BubbleTreeSummarizer:
    """A port summarizer over the Bubble-tree of a reference engine's
    ``checkpoint_state()`` (its ``tree/*`` keys, through the loader that
    ``engine_from_reference_state`` uses): dim, min_pts and compression
    from ``cfg/*``, ``device`` for its offline pass (None → cuda), ``kw``
    the summarizer's other arguments (the tree's fan-out …).  Raises
    ``ValueError`` on an unknown format."""
    if int(state["cfg/format"]) != _CKPT_FORMAT:
        raise ValueError(f"unknown checkpoint format {int(state['cfg/format'])}")
    summ = BubbleTreeSummarizer(int(state["cfg/dim"]), min_pts=int(state["cfg/min_pts"]),
                                compression=float(state["cfg/compression"]), device=device, **kw)
    load_tree_state(summ.tree, state)
    return summ


def _leaf_tensor(a, dev) -> torch.Tensor:
    """A numpy leaf (bf16 leaves come as ml_dtypes arrays, which torch
    does not read: they cross as f32, exactly) on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.as_tensor(np.array(a)).to(dev)


def lm_params_from_reference(values, cfg, device=None) -> dict:
    """The port's params tree from the reference's ``init_params(cfg,
    key)[0]`` (a nested dict, leaves as numpy through ``np.asarray``,
    layers stacked on axis 0; the MoE's experts as bare (E, …) arrays
    under ``moe``, the vlm's ``self_blocks`` stacked (n_groups, n_self)
    and its ``cross_blocks`` (n_groups,), RWKV's ``ln0`` and its blocks'
    bare mixing and decay leaves under ``tm`` / ``cm``, the hybrid's
    ``mamba_groups`` (n_groups, G), ``shared_attn`` (no leading axis) and
    ``mamba_tail``, whisper's ``enc_pos`` / ``dec_pos`` tables beside its
    ``enc_blocks`` and ``dec_blocks``): the same keys,
    shapes and values (f32 as the reference draws them), on ``device``
    (None → cuda).  Raises ``ValueError`` when the
    tree is not the port's layout for ``cfg``."""
    dev = resolve_device(device)
    want = tree_map(lambda t: tuple(t.shape), M.init_params(cfg, device="meta"))
    got = tree_map(lambda a: tuple(np.shape(a)), values)
    if got != want:
        raise ValueError(f"{cfg.name}: the reference's params tree does not match the port's layout")
    return tree_map(lambda a: _leaf_tensor(a, dev), values)


def lm_cache_from_reference(caches, device=None) -> dict:
    """The port's KV cache from the reference's (``{"self": {"k", "v"},
    "pos"}``, whisper's among them, or the vlm's ``{"self_groups": …,
    "cross_groups": …}`` of two such trees), RWKV's state tree (``{"shift_tm", "shift_cm", "S"}``,
    stacked on the layer axis) or the hybrid's (``{"mamba_groups",
    "mamba_tail": {"conv", "ssd"}, "attn": a KV cache per application}``);
    leaves as numpy: the same values and dtypes (bf16 K/V, int32 write
    heads; RWKV's shifts and the Mamba-2 conv rows bf16 or in the compute
    dtype as the reference returned them, S and the SSD states f32), on
    ``device`` (None → cuda)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_tensor(a, dev), caches)


def adamw_state_from_reference(state, device=None) -> dict:
    """The port's AdamW state from the reference's (``{"mu", "nu": trees
    like the params, "step": int32 scalar}``, leaves as numpy): the same
    keys, values and dtypes, ``step`` a 0-dim int32 tensor, on ``device``
    (None → cuda)."""
    dev = resolve_device(device)
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"an AdamW state has mu, nu and step, not {sorted(state)}")
    return {"mu": tree_map(lambda a: _leaf_tensor(a, dev), state["mu"]),
            "nu": tree_map(lambda a: _leaf_tensor(a, dev), state["nu"]),
            "step": torch.as_tensor(np.array(state["step"], np.int32)).to(dev)}
