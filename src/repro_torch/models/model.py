"""Model facade: build a zoo architecture and its serving steps.

The port's copy of the JAX package's ``models/model.py`` for serving the
dense, MoE and vision families:

  model = build_model(cfg)                    # the family's backbone
  params = init_params(cfg, generator)        # f32 master params (values only)
  cparams = compute_copy(params, cfg)         # the compute-dtype working copy
  cparams = init_compute_params(cfg, generator)  # the same bits, leaf by leaf
  prefill = make_prefill(cfg)
  serve_step = make_serve_step(cfg)           # one decode step over caches

The reference casts every weight to the compute dtype where it is used
(``x @ w.astype(x.dtype)``); casting once, at load, gives the same bits,
so the serving engine keeps only the compute copy.  Norm scales and
biases are read in f32 by the norms, and the cross-attention gates by
``tanh``, so they stay f32.  ``init_compute_params`` draws each leaf in
f32 and casts it before the next: a model whose f32 master and compute
copy together outgrow the card (qwen2-moe-a2.7b: 57 + 29 GB) is built
with the compute copy and one f32 leaf at a time.

The training step, the loss, the XLA dry-run helpers (``abstract_params``,
``input_specs``) and ``model_flops_per_token`` wait for the training
slice (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .transformer import UniformDecoder, VisionDecoder

__all__ = ["build_model", "init_params", "init_compute_params", "compute_copy", "count_params", "make_prefill",
           "make_serve_step"]

FAMILIES = {"dense": UniformDecoder, "moe": UniformDecoder, "vlm": VisionDecoder}
# the families of the reference's zoo still to come, each a later slice
_LATER = ("ssm", "hybrid", "audio")

# tensor leaves that dense / embed / unembed and the experts (bare "gate" /
# "up" / "down" arrays) cast to the compute dtype; the norms' "scale" and
# "bias" and the cross-attention gates are cast to f32 where they are used
_COMPUTE_LEAVES = ("w", "b", "table", "gate", "up", "down")


def build_model(cfg: ArchConfig):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family](cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP queue 1, "
                                  f"item 9: the LM stack beyond the dense, MoE and vision families)")
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _init_device(device):
    return torch.device("meta") if str(device) == "meta" else resolve_device(device)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None):
    """f32 master params with the reference's distributions, drawn from
    ``generator`` (on ``device``'s type; None → a fresh default stream).
    ``device``: None → cuda, ``"cpu"``, or ``"meta"`` for shapes alone.
    The reference returns (values, axes); the port has no logical axes
    and returns the values tree."""
    return build_model(cfg).init(generator, _init_device(device))


def init_compute_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None):
    """``compute_copy(init_params(cfg, generator, device), cfg)``, bit for
    bit, drawn leaf by leaf: each leaf in f32 from ``generator`` in
    ``init_params``'s order and cast before the next is drawn, so the peak
    is the compute copy and the largest f32 leaf."""
    return build_model(cfg).init(generator, _init_device(device), dtype=cfg.compute_dtype)


def compute_copy(params, cfg: ArchConfig, device=None):
    """The params tree with every matmul weight, bias, embedding table and
    expert array in ``cfg.compute_dtype`` and the norms' leaves and the
    gates in f32, on ``device`` (None: where they are).  Leaves already so
    are not copied."""
    def cast(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cast(v)
            else:
                out[k] = v.to(device=device, dtype=cfg.compute_dtype if k in _COMPUTE_LEAVES else torch.float32)
        return out

    return cast(params)


def count_params(values) -> int:
    if isinstance(values, dict):
        return sum(count_params(v) for v in values.values())
    return int(values.numel())


def make_prefill(cfg: ArchConfig):
    model = build_model(cfg)

    def prefill(params, batch):
        if cfg.family == "vlm":
            return model.prefill(params, batch["tokens"], batch["media"])
        return model.prefill(params, batch["tokens"])

    return prefill


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, caches, token, pos, extras) -> (logits, caches)."""
    model = build_model(cfg)

    def serve_step(params, caches, token, pos, extras=None):
        if cfg.family == "vlm":
            return model.decode(params, caches, token, pos, extras["media"])
        return model.decode(params, caches, token, pos)

    return serve_step
