"""Model facade: build a zoo architecture and its train and serve steps.

The port's copy of the JAX package's ``models/model.py`` for every family
of its zoo: dense, MoE, vision, ssm (RWKV-6), hybrid (zamba2: Mamba-2 and
a shared attention block) and audio (whisper: an encoder over frame
embeddings and a decoder with cross-attention):

  model = build_model(cfg)                    # the family's backbone
  params = init_params(cfg, generator)        # f32 master params (values only)
  cparams = compute_copy(params, cfg)         # the compute-dtype working copy
  cparams = init_compute_params(cfg, generator)  # the same bits, leaf by leaf
  train_step = make_train_step(cfg, opt)      # grad accumulation + AdamW
  prefill = make_prefill(cfg)
  serve_step = make_serve_step(cfg)           # one decode step over caches
  model_flops_per_token(cfg)                  # 6·N_active, counted on ``meta``

The reference casts every weight to the compute dtype where it is used
(``x @ w.astype(x.dtype)``); casting once, at load, gives the same bits,
so the serving engine keeps only the compute copy.  Norm scales and
biases are read in f32 by the norms, and the cross-attention gates by
``tanh``, so they stay f32, as do whisper's position tables (``enc_pos``,
``dec_pos``, cast where they are read), RWKV's mixing and decay leaves,
which its model casts where it reads them (``models/rwkv.py``), and Mamba-2's
``A_log`` and ``dt_bias``, which it reads in f32 (``models/ssm.py``).
``init_compute_params`` draws each leaf in
f32 and casts it before the next: a model whose f32 master and compute
copy together outgrow the card (qwen2-moe-a2.7b: 57 + 29 GB) is built
with the compute copy and one f32 leaf at a time.

Training casts as the reference's ``_cast_compute`` does: every floating
leaf to the compute dtype, norm scales and gates included, inside the
step and under autograd, so the gradients land in f32 on the master.
``compute_copy`` keeps the norms in f32, which gives the reference's bits
only while every scale is exact in bf16 (true at init, false after one
AdamW step), so training never uses it.  ``make_train_step`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` as the
reference's does; the params and moments are updated in place
(``train/optim.py``), and the metrics (``loss``, ``grad_norm``, ``lr``)
are f32 tensors on the params' device.  Microbatches accumulate f32
gradients in order from the first and divide once, as the reference's
scan does.

The XLA dry-run helpers (``abstract_params``, ``input_specs``) have no
counterpart: ``count_params`` and ``model_flops_per_token`` count on the
``meta`` device instead.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..train.optim import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_unflatten
from . import layers as L
from .rwkv import RWKVModel
from .transformer import HybridDecoder, UniformDecoder, VisionDecoder
from .whisper import WhisperModel

__all__ = ["build_model", "init_params", "init_compute_params", "compute_copy", "count_params", "make_prefill",
           "make_serve_step", "make_train_step", "make_value_and_grad", "model_flops_per_token", "xent_loss",
           "loss_fn"]

FAMILIES = {"dense": UniformDecoder, "moe": UniformDecoder, "vlm": VisionDecoder, "ssm": RWKVModel,
            "hybrid": HybridDecoder, "audio": WhisperModel}
# the families of the reference's zoo still to port: none
_LATER = ()

# tensor leaves that dense / embed / unembed, the experts (bare "gate" /
# "up" / "down" arrays) and Mamba-2 ("in_proj", "out_proj", "conv_w",
# "conv_b", "D") cast to the compute dtype; the norms' "scale" and "bias"
# and the cross-attention gates are cast to f32 where they are used,
# whisper's position tables ("enc_pos", "dec_pos") cast where they are read,
# Mamba-2's "A_log" and "dt_bias" read in f32, and RWKV's bare leaves
# ("mu", "maa_w1", "decay_mu", "bonus_u", ...) cast to the compute dtype or
# to f32 where they are used
_COMPUTE_LEAVES = ("w", "b", "table", "gate", "up", "down", "in_proj", "out_proj", "conv_w", "conv_b", "D")


def build_model(cfg: ArchConfig):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family](cfg)
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
    """The params tree with every matmul weight, bias, embedding table,
    expert array and Mamba-2 projection, convolution and ``D`` in
    ``cfg.compute_dtype`` and the norms' leaves, the gates, whisper's
    position tables, Mamba-2's ``A_log`` and ``dt_bias`` and RWKV's bare
    leaves in f32, on ``device`` (None: where they are).
    Leaves already so are not copied."""
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


def model_flops_per_token(cfg: ArchConfig, values=None) -> float:
    """6·N_active, N_active = params taking part per token (the input
    embedding's gather excluded, the MoE's experts scaled by k/E, the
    hybrid's shared attention block counted once per application, by the
    reference's rule: its q/k/v/o projections and a 3·d·d_ff MLP; whisper's
    position tables and encoder counted whole, as the reference counts
    them).  The params are counted on the ``meta`` device unless
    ``values`` is given."""
    if values is None:
        values = init_params(cfg, device="meta")
    total = count_params(values)
    # the input embedding is a gather (~0 FLOPs); the (tied or separate) output table is a matmul
    vp = L.padded_vocab(cfg.vocab_size, cfg.vocab_pad_multiple)
    embed = vp * cfg.d_model
    n_active = total - embed
    if cfg.tie_embeddings:
        n_active += embed
    if cfg.n_experts > 0:
        dff = cfg.moe_d_ff or cfg.d_ff
        expert = 3 * cfg.d_model * dff
        n_active = n_active - cfg.n_layers * cfg.n_experts * expert + cfg.n_layers * cfg.n_experts_per_tok * expert
    if cfg.family == "hybrid":
        n_groups = (cfg.n_layers - cfg.hybrid_tail) // (cfg.hybrid_group + 1)
        dh = cfg.head_dim
        attn_block = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh + cfg.n_heads * dh * cfg.d_model
                      + 3 * cfg.d_model * cfg.d_ff)
        n_active += (n_groups - 1) * attn_block
    return 6.0 * n_active


# --------------------------------------------------------------------------
# loss + train step
# --------------------------------------------------------------------------

def xent_loss(logits, labels, vocab_size: int):
    """Mean token cross-entropy in f32; padded-vocab columns are masked out."""
    vp = logits.shape[-1]
    if vp > vocab_size:
        col = torch.arange(vp, device=logits.device)
        logits = logits.masked_fill(col >= vocab_size, -1e9)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def loss_fn(model, params, batch, cfg: ArchConfig):
    logits = model.forward(params, batch)
    return xent_loss(logits, batch["labels"], cfg.vocab_size)


def _cast_compute(params, dtype):
    """f32 master params → the compute-dtype working copy at step entry:
    every floating leaf, differentiably (gradients come back in f32)."""
    if isinstance(params, dict):
        return {k: _cast_compute(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def make_value_and_grad(cfg: ArchConfig, microbatches: int = 1):
    """``(params, batch) -> (loss, grads)``: the mean cross-entropy and its
    f32 gradient tree (the params' structure) through the compute-dtype
    cast, as the reference's ``jax.value_and_grad`` of its step's loss.
    ``batch`` holds ``tokens`` and ``labels`` (B, S) (and the vlm's
    ``media``, whisper's ``frames``) as tensors on the params' device; it
    splits into ``microbatches`` equal slices of every entry along B, whose
    gradients are summed in order and divided once."""
    model = build_model(cfg)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch of {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        loss, grads = None, None
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()} if microbatches > 1 else batch
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                try:
                    loss_mb = loss_fn(model, _cast_compute(params, cfg.compute_dtype), mb, cfg)
                    g = torch.autograd.grad(loss_mb, leaves)
                finally:
                    for p in leaves:
                        p.requires_grad_(False)
            loss_mb = loss_mb.detach()
            if grads is None:
                loss, grads = loss_mb, [x.to(torch.float32) for x in g]
            else:
                loss = loss + loss_mb
                for acc, x in zip(grads, g, strict=True):
                    acc.add_(x)
            del g
        if microbatches > 1:
            loss = loss / microbatches
            for acc in grads:
                acc.div_(microbatches)
        return loss, tree_unflatten(params, grads)

    return value_and_grad


def make_train_step(cfg: ArchConfig, opt: AdamWConfig | None = None, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    ``make_value_and_grad`` and one AdamW update, in place."""
    opt = opt or AdamWConfig()
    value_and_grad = make_value_and_grad(cfg, microbatches)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        params, opt_state, metrics = adamw_update(opt, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_prefill(cfg: ArchConfig):
    model = build_model(cfg)

    def prefill(params, batch):
        if cfg.family == "audio":
            return model.prefill(params, batch["tokens"], batch["frames"])
        if cfg.family == "vlm":
            return model.prefill(params, batch["tokens"], batch["media"])
        return model.prefill(params, batch["tokens"])

    return prefill


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, caches, token, pos, extras) -> (logits, caches);
    ``extras`` holds the vlm's ``media`` or whisper's ``enc`` (the encoder's
    output)."""
    model = build_model(cfg)

    def serve_step(params, caches, token, pos, extras=None):
        if cfg.family == "audio":
            return model.decode(params, caches, token, pos, extras["enc"])
        if cfg.family == "vlm":
            return model.decode(params, caches, token, pos, extras["media"])
        return model.decode(params, caches, token, pos)

    return serve_step
