"""Optimizer substrate: AdamW (and int8 gradient compression).

The port's copy of the JAX package's ``train/optim.py`` over the port's
params trees (nested dicts of tensors; ``adamw_update`` and
``global_norm`` also take lists and tuples).  The reference's arithmetic
is kept in f32, step by step: the step count is an int32 tensor, and the
learning rate, the clip scale and the bias corrections are f32 tensors
computed from it, never Python floats.  The decay rule is the
reference's ``p.ndim >= 2`` on the stacked shapes, so the blocks' norm
scales, stacked (n_layers, d), are decayed too, whatever the rule's
comment intends.

Where the reference returns new trees, ``adamw_update`` writes the new
params and moments into the tensors it is given (the port's master
params, μ and ν are each a model's size: no second copy), and returns
the same trees.

``global_norm`` sums the leaves in the reference's order
(``jax.tree.leaves``: dict keys sorted), each leaf's squares summed in
f32; the per-leaf sums are taken in the backend's own order, so the norm
agrees with the reference's to f32 rounding, not bit for bit.

``compressed_psum`` (the reference's error-feedback int8 all-reduce over
a named ``shard_map`` axis) is not ported: no path calls it, and the
port trains on one card (ROADMAP, multi-card training).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "lr_schedule", "global_norm", "adamw_update", "compress_int8"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params) -> dict:
    """μ and ν as zeros of each param's shape, dtype and device, and the
    step, an int32 zero on the params' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it at ``total_steps``: an f32 tensor from the int32 ``step``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), in f32, the leaves in sorted-key order."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step with global-norm clipping, in place.  Returns
    (params, state, metrics): the same trees, updated, and the f32
    ``grad_norm`` and ``lr`` tensors of this step."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) if cfg.grad_clip else 1.0
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_mu, flat_nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("adamw_update: params, grads and moments differ in structure")
    for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu, strict=True):
        g = g.to(torch.float32) * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0  # the reference's rule: stacked norm scales decay too
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (delta + decay * p32))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Quantise g + err to int8 with one per-tensor scale.  Returns
    (q, scale, new_err); dequantise as q · scale."""
    x = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, x - deq
