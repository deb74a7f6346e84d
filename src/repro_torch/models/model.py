"""Model facade: build a zoo architecture and its serving steps.

The port's copy of the JAX package's ``models/model.py`` for serving the
dense family:

  model = build_model(cfg)                    # the dense backbone
  params = init_params(cfg, generator)        # f32 master params (values only)
  cparams = compute_copy(params, cfg)         # the compute-dtype working copy
  prefill = make_prefill(cfg)
  serve_step = make_serve_step(cfg)           # one decode step over caches

The reference casts every weight to the compute dtype where it is used
(``x @ w.astype(x.dtype)``); casting once, at load, gives the same bits,
so the serving engine keeps only the compute copy.  Norm scales and
biases are read in f32 by the norms, so they stay f32.

The training step, the loss, the XLA dry-run helpers (``abstract_params``,
``input_specs``) and ``model_flops_per_token`` wait for the training
slice (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .transformer import UniformDecoder

__all__ = ["build_model", "init_params", "compute_copy", "count_params", "make_prefill", "make_serve_step"]

# the families of the reference's zoo still to come, each a later slice
_LATER = ("moe", "vlm", "ssm", "hybrid", "audio")

# leaves that dense / embed / unembed cast to the compute dtype; the norms'
# "scale" and "bias" are cast to f32 where they are used
_COMPUTE_LEAVES = ("w", "b", "table")


def build_model(cfg: ArchConfig):
    if cfg.family == "dense":
        return UniformDecoder(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP queue 1, "
                                  f"item 9: the LM stack beyond the dense family)")
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None):
    """f32 master params with the reference's distributions, drawn from
    ``generator`` (on ``device``'s type; None → a fresh default stream).
    ``device``: None → cuda, ``"cpu"``, or ``"meta"`` for shapes alone.
    The reference returns (values, axes); the port has no logical axes
    and returns the values tree."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    return build_model(cfg).init(generator, dev)


def compute_copy(params, cfg: ArchConfig, device=None):
    """The params tree with every matmul weight, bias and embedding table
    in ``cfg.compute_dtype`` and the norms' leaves in f32, on ``device``
    (None: where they are).  Leaves already so are not copied."""
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
        return model.prefill(params, batch["tokens"])

    return prefill


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, caches, token, pos, extras) -> (logits, caches)."""
    model = build_model(cfg)

    def serve_step(params, caches, token, pos, extras=None):
        return model.decode(params, caches, token, pos)

    return serve_step
