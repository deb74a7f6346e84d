"""Decoder backbones: the dense and MoE stacks, the vision interleave and
the hybrid's Mamba-2 groups around one shared attention block.

The port's copy of the JAX package's ``models/transformer.py`` for four
of its five block layouts:

  dense  — uniform [attn + MLP] blocks (``UniformDecoder``);
  moe    — uniform [attn + MoE] blocks (``UniformDecoder`` with
           ``n_experts > 0``: dbrx, qwen2-moe);
  vlm    — llama-3.2-vision (``VisionDecoder``): groups of (period − 1)
           self blocks and one block with an extra gated cross-attention
           into the media embeddings;
  hybrid — zamba2 (``HybridDecoder``): groups of Mamba-2 blocks
           (``models/ssm.py``), each group followed by one application of
           a single shared attention block with a KV cache of its own,
           then a tail of Mamba-2 blocks.

The stacked params and caches keep the reference's layout — every block
leaf has a leading ``n_layers`` axis (the vlm's self blocks
(n_groups, n_self), its cross blocks (n_groups,)), the dense cache is
``{"self": {"k", "v": (n_layers, B, Sc, KV, Dh)}, "pos": (n_layers, B)}``
— so trees carry across; the layers run in Python loops over views of
those axes instead of ``lax.scan``, and the cache is written in place.

``init(generator, device, dtype=None)`` → params;  ``forward(params,
batch)`` → logits;  ``prefill(params, tokens)`` → (last logits, cache);
``decode(params, caches, token, pos)`` → (logits, caches); the vlm's
``prefill`` and ``decode`` also take ``media``.

``forward`` (training) recomputes the blocks as ``cfg.remat`` says, where
the reference wraps its scan bodies in ``jax.checkpoint``: ``"full"``
saves each block's input alone and recomputes the block in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` also saves the
outputs of the matrix products with no batch dimension (``mm`` /
``addmm``: the dense layers; the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest,
``"none"`` saves everything.  The vlm's cross blocks and the hybrid's
shared block are not recomputed, as in the reference.  It acts only
while grad is enabled; serving (``prefill``, ``decode``) never
recomputes.

The ssm family (RWKV-6) is ``models/rwkv.py``, on ``_Draw``, ``_remat``
and ``unstack`` from here.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint as ckpt

from . import layers as L
from . import moe as MOE
from . import ssm as SSM


# --------------------------------------------------------------------------
# generic helpers
# --------------------------------------------------------------------------

class _Draw:
    """Draws params leaf by leaf with the reference's distributions, each
    in f32 from ``gen``: N(0, 1/d_in) weights, zero biases and gates, unit
    norms, N(0, 0.02²) embedding tables.  With ``dtype`` every matmul
    weight, bias and table is cast to it as soon as it is drawn — the
    compute copy's bits (``model.compute_copy``) without the whole f32
    master on the device — while the norms, the cross-attention gates and
    the draws asked for with ``f32=True`` (RWKV's mixing and decay
    leaves, which the model casts where it reads them) stay f32."""

    def __init__(self, gen, device, dtype=None):
        self.gen, self.device, self.dtype = gen, device, dtype

    def normal(self, shape, scale, f32=False):
        t = torch.empty(shape, dtype=torch.float32, device=self.device).normal_(generator=self.gen).mul_(scale)
        return t if self.dtype is None or f32 else t.to(self.dtype)

    def dense(self, lead, d_in, d_out, bias=False):
        p = {"w": self.normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = torch.zeros(lead + (d_out,), dtype=self.dtype or torch.float32, device=self.device)
        return p

    def norm(self, lead, d, bias=False):
        p = {"scale": torch.ones(lead + (d,), device=self.device)}
        if bias:
            p["bias"] = torch.zeros(lead + (d,), device=self.device)
        return p


def _attn_init(draw, lead, cfg):
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": draw.dense(lead, d, H * dh, cfg.qkv_bias), "wk": draw.dense(lead, d, KV * dh, cfg.qkv_bias),
         "wv": draw.dense(lead, d, KV * dh, cfg.qkv_bias), "wo": draw.dense(lead, H * dh, d)}
    if cfg.qk_norm:
        p["q_norm"] = draw.norm(lead, dh)
        p["k_norm"] = draw.norm(lead, dh)
    return p


def _mlp_init(draw, lead, d, d_ff, gated):
    p = {"up": draw.dense(lead, d, d_ff), "down": draw.dense(lead, d_ff, d)}
    if gated:
        p["gate"] = draw.dense(lead, d, d_ff)
    return p


def _moe_init(draw, lead, cfg):
    """The reference's ``moe_init``: a router, the experts' stacked GLU
    weights (bare arrays, expert axis first) and the shared experts as
    one gated MLP of width ``n_shared_experts · moe_d_ff``."""
    d, E = cfg.d_model, cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": draw.dense(lead, d, E), "gate": draw.normal(lead + (E, d, dff), 1.0 / math.sqrt(d)),
         "up": draw.normal(lead + (E, d, dff), 1.0 / math.sqrt(d)),
         "down": draw.normal(lead + (E, dff, d), 1.0 / math.sqrt(dff))}
    if cfg.n_shared_experts:
        p["shared"] = _mlp_init(draw, lead, d, cfg.n_shared_experts * dff, gated=True)
    return p


def _block_init(draw, lead, cfg, moe=False, cross=False):
    ln_bias = cfg.norm == "layernorm"
    attn = _attn_init(draw, lead, cfg)
    ffn = ("moe", _moe_init(draw, lead, cfg)) if moe else (
        "mlp", _mlp_init(draw, lead, cfg.d_model, cfg.d_ff, cfg.gated_mlp))
    p = {"ln1": draw.norm(lead, cfg.d_model, ln_bias), "attn": attn, "ln2": draw.norm(lead, cfg.d_model, ln_bias),
         ffn[0]: ffn[1]}
    if cross:
        p["ln_x"] = draw.norm(lead, cfg.d_model, ln_bias)
        p["xattn"] = _attn_init(draw, lead, cfg)
        p["xattn_gate"] = torch.zeros(lead + (1,), device=draw.device)
    return p


def _embed_init(draw, cfg):
    vp = L.padded_vocab(cfg.vocab_size, cfg.vocab_pad_multiple)
    return {"table": draw.normal((vp, cfg.d_model), 0.02)}


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the 2-D products."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` recomputed in the backward as ``cfg.remat`` says (see the
    module docstring); ``fn`` itself when grad is off or remat is "none"."""
    mode = cfg.remat
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: remat must be none, full or dots, not {mode!r}")
    if mode == "none":
        return fn
    extra = {} if mode == "full" else {"context_fn": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                                       _save_dots)}

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **extra, **kw)

    return run


def unstack(tree, n: int) -> list:
    """A tree of stacked leaves → n trees of per-layer views."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------------
# standard decoder block (attn + mlp|moe, optional cross-attention)
# --------------------------------------------------------------------------

def block_apply(p, x, cfg, *, pos, cache=None, media=None, window=None):
    """Returns (x, new_cache).  cache = {"self": {k, v}, "pos": (B,)}.
    A block with ``xattn`` adds the gated cross-attention into ``media``
    (none without media)."""
    new_cache = {} if cache is not None else None
    h = L.norm(p["ln1"], x, cfg.norm)
    a, sc = L.attn_apply(p["attn"], h, cfg, qpos=pos, window=window,
                         cache=cache["self"] if cache is not None else None,
                         cache_pos=cache["pos"] if cache is not None else None)
    if new_cache is not None:
        new_cache["self"] = {"k": sc["k"], "v": sc["v"]}
        new_cache["pos"] = sc["pos"]
    x = x + a
    if "xattn" in p and media is not None:
        h = L.norm(p["ln_x"], x, cfg.norm)
        a, _ = L.attn_apply(p["xattn"], h, cfg, kv_src=media, qpos=pos, causal=False, use_rope=False)
        x = x + torch.tanh(p["xattn_gate"]).to(x.dtype) * a
    h = L.norm(p["ln2"], x, cfg.norm)
    x = x + (MOE.moe_apply(p["moe"], h, cfg) if "moe" in p else L.mlp_apply(p["mlp"], h, act=cfg.act))
    return x, new_cache


def _cached_block(blk, x, cfg, pos, k, v, cp, window=None, media=None):
    """``block_apply`` over one layer's cache views, its write heads
    ``cp`` advanced in place."""
    x, nc = block_apply(blk, x, cfg, pos=pos, cache={"self": {"k": k, "v": v}, "pos": cp}, media=media,
                        window=window)
    cp.copy_(nc["pos"])
    return x


def _zero_cache(lead, batch_size, cache_len, cfg, dtype, device):
    shape = lead + (batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)},
            "pos": torch.zeros(lead + (batch_size,), dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# family: dense / moe (uniform stack)
# --------------------------------------------------------------------------

class UniformDecoder:
    def __init__(self, cfg):
        self.cfg = cfg
        self.moe = cfg.n_experts > 0

    def init(self, generator, device, dtype=None):
        """Params with the reference's distributions (``_Draw``), over the
        padded vocab; f32, or with ``dtype`` the compute copy drawn leaf by
        leaf.  ``device`` may be ``meta`` (shapes only)."""
        cfg = self.cfg
        draw = _Draw(generator, device, dtype)
        blocks = _block_init(draw, (cfg.n_layers,), cfg, moe=self.moe)
        p = {"embed": _embed_init(draw, cfg), "blocks": blocks,
             "final_norm": draw.norm((), cfg.d_model, cfg.norm == "layernorm")}
        if not cfg.tie_embeddings:
            p["unembed"] = _embed_init(draw, cfg)
        return p

    def _run_blocks(self, params, x, pos, caches=None, window=None):
        n = self.cfg.n_layers
        blocks = unstack(params["blocks"], n)
        if caches is None:
            body = _remat(block_apply, self.cfg)
            for blk in blocks:
                x, _ = body(blk, x, self.cfg, pos=pos, window=window)
            return x, None
        ks, vs, ps = (torch.unbind(t, 0) for t in (caches["self"]["k"], caches["self"]["v"], caches["pos"]))
        for blk, k, v, cp in zip(blocks, ks, vs, ps, strict=True):
            x = _cached_block(blk, x, self.cfg, pos, k, v, cp, window=window)
        return x, caches

    def _logits(self, params, x):
        x = L.norm(params["final_norm"], x, self.cfg.norm)
        return L.unembed_apply(params.get("unembed", params["embed"]), x)

    def forward(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = L.embed_apply(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(S, device=tokens.device)
        x, _ = self._run_blocks(params, x, pos, window=cfg.sliding_window)
        return self._logits(params, x)

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16, device=None):
        """cache_len is caller-chosen: decode sizes it to the window (ring
        buffer); prefill always uses a full-length cache (the window only
        masks attention).  Per-row write heads ``pos`` (n_layers, B) let
        the serving engine run continuous batching."""
        return _zero_cache((self.cfg.n_layers,), batch_size, cache_len, self.cfg, dtype, device)

    def prefill(self, params, tokens):
        cfg = self.cfg
        B, S = tokens.shape
        caches = self.init_cache(B, S, device=tokens.device)
        x = L.embed_apply(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(S, device=tokens.device)
        x, caches = self._run_blocks(params, x, pos, caches=caches, window=cfg.sliding_window)
        return self._logits(params, x[:, -1:, :]), caches

    def decode(self, params, caches, token, pos):
        """token: (B, 1); pos: scalar (lockstep) or (B,) per-request
        positions (continuous-batching engine).  Writes ``caches`` in place
        and returns it."""
        cfg = self.cfg
        B = token.shape[0]
        x = L.embed_apply(params["embed"], token, cfg.compute_dtype)
        qpos = torch.zeros((B,), dtype=torch.int32, device=token.device) + pos
        x, caches = self._run_blocks(params, x, qpos[:, None], caches=caches, window=cfg.sliding_window)
        return self._logits(params, x), caches


# --------------------------------------------------------------------------
# family: vlm (llama-3.2-vision interleave)
# --------------------------------------------------------------------------

class VisionDecoder(UniformDecoder):
    """Groups of (period − 1) self blocks + 1 cross-attn block, as two
    nested loops.  Caches: ``self_groups`` (G, n_self, B, S, KV, Dh) and
    ``cross_groups`` (G, B, S, KV, Dh), each with its ``pos`` heads."""

    def __init__(self, cfg):
        super().__init__(cfg)
        period = cfg.cross_attn_period
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {period}")
        self.n_groups = cfg.n_layers // period
        self.n_self = period - 1

    def init(self, generator, device, dtype=None):
        cfg = self.cfg
        draw = _Draw(generator, device, dtype)
        selfs = _block_init(draw, (self.n_groups, self.n_self), cfg)
        cross = _block_init(draw, (self.n_groups,), cfg, cross=True)
        p = {"embed": _embed_init(draw, cfg), "self_blocks": selfs, "cross_blocks": cross,
             "final_norm": draw.norm((), cfg.d_model)}
        if not cfg.tie_embeddings:
            p["unembed"] = _embed_init(draw, cfg)
        return p

    def _run_blocks(self, params, x, pos, caches=None, media=None):
        cfg, G, n = self.cfg, self.n_groups, self.n_self
        selfs = [unstack(t, n) for t in unstack(params["self_blocks"], G)]
        crosses = unstack(params["cross_blocks"], G)
        if caches is None:
            inner = _remat(block_apply, cfg)
            for g in range(G):
                for blk in selfs[g]:
                    x, _ = inner(blk, x, cfg, pos=pos)
                x, _ = block_apply(crosses[g], x, cfg, pos=pos, media=media)
            return x, None
        sc, cc = caches["self_groups"], caches["cross_groups"]
        for g in range(G):
            for i, blk in enumerate(selfs[g]):
                x = _cached_block(blk, x, cfg, pos, sc["self"]["k"][g, i], sc["self"]["v"][g, i], sc["pos"][g, i])
            x = _cached_block(crosses[g], x, cfg, pos, cc["self"]["k"][g], cc["self"]["v"][g], cc["pos"][g],
                              media=media)
        return x, caches

    def _media(self, media, B, device):
        """The media as given, or zeros in the compute dtype."""
        cfg = self.cfg
        if media is not None:
            return media
        return torch.zeros((B, cfg.n_media_tokens, cfg.d_model), dtype=cfg.compute_dtype, device=device)

    def forward(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        media = batch["media"].to(cfg.compute_dtype)  # (B, n_media, d_model) stub embeds
        x = L.embed_apply(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x, _ = self._run_blocks(params, x, pos, media=media)
        return self._logits(params, x)

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16, device=None):
        cfg, G = self.cfg, self.n_groups
        return {"self_groups": _zero_cache((G, self.n_self), batch_size, cache_len, cfg, dtype, device),
                "cross_groups": _zero_cache((G,), batch_size, cache_len, cfg, dtype, device)}

    def prefill(self, params, tokens, media=None):
        cfg = self.cfg
        B, S = tokens.shape
        caches = self.init_cache(B, S, device=tokens.device)
        x = L.embed_apply(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(S, device=tokens.device)
        x, caches = self._run_blocks(params, x, pos, caches=caches, media=self._media(media, B, tokens.device))
        return self._logits(params, x[:, -1:, :]), caches

    def decode(self, params, caches, token, pos, media=None):
        cfg = self.cfg
        B = token.shape[0]
        x = L.embed_apply(params["embed"], token, cfg.compute_dtype)
        qpos = torch.zeros((B,), dtype=torch.int32, device=token.device) + pos
        x, caches = self._run_blocks(params, x, qpos[:, None], caches=caches,
                                     media=self._media(media, B, token.device))
        return self._logits(params, x), caches


# --------------------------------------------------------------------------
# family: hybrid (zamba2: Mamba-2 blocks + one shared attention block)
# --------------------------------------------------------------------------

class HybridDecoder:
    """``hybrid_group`` Mamba-2 blocks then one application of the shared
    attention block, × ``n_groups``, then ``hybrid_tail`` Mamba-2 blocks.

    Params: ``{"embed", "mamba_groups" (every leaf (n_groups, G, …)),
    "shared_attn" (one block, no leading axis), "mamba_tail" ((tail, …)),
    "final_norm", "unembed"}``, each Mamba-2 block ``{"ln", "mamba"}``.
    States: ``{"mamba_groups": {"conv", "ssd": (n_groups, G, B, …)},
    "attn": {"self": {"k", "v": (n_groups, B, S, KV, Dh)}, "pos":
    (n_groups, B)}, "mamba_tail": {"conv", "ssd": (tail, B, …)}}``: one KV
    cache and write head per application of the shared block.  A run with
    states writes the KV caches in place and returns new Mamba states.
    ``forward`` recomputes the Mamba-2 blocks as ``cfg.remat`` says; the
    shared block is not recomputed, as in the reference."""

    def __init__(self, cfg):
        self.cfg = cfg
        G = cfg.hybrid_group
        self.n_groups = (cfg.n_layers - cfg.hybrid_tail) // (G + 1)
        if self.n_groups * (G + 1) + cfg.hybrid_tail != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {G} + 1 and a tail of "
                             f"{cfg.hybrid_tail}")

    def init(self, generator, device, dtype=None):
        cfg = self.cfg
        draw = _Draw(generator, device, dtype)

        def mamba(lead):
            return {"ln": draw.norm(lead, cfg.d_model), "mamba": SSM.mamba2_init(draw, lead, cfg)}

        return {"embed": _embed_init(draw, cfg), "mamba_groups": mamba((self.n_groups, cfg.hybrid_group)),
                "shared_attn": _block_init(draw, (), cfg), "mamba_tail": mamba((cfg.hybrid_tail,)),
                "final_norm": draw.norm((), cfg.d_model), "unembed": _embed_init(draw, cfg)}

    def _mamba_apply(self, blk, h, st=None):
        y, ns = SSM.mamba2_apply(blk["mamba"], L.rmsnorm(blk["ln"], h), self.cfg, st)
        return h + y, ns

    def _run(self, params, x, pos, states=None):
        cfg, G, tail = self.cfg, self.cfg.hybrid_group, self.cfg.hybrid_tail
        groups = [unstack(t, G) for t in unstack(params["mamba_groups"], self.n_groups)]
        tail_blocks = unstack(params["mamba_tail"], tail)
        shared = params["shared_attn"]
        if states is None:
            step = _remat(self._mamba_apply, cfg)
            for g in range(self.n_groups):
                for blk in groups[g]:
                    x, _ = step(blk, x)
                x, _ = block_apply(shared, x, cfg, pos=pos)
            for blk in tail_blocks:
                x, _ = step(blk, x)
            return x, None
        mg, attn = states["mamba_groups"], states["attn"]
        new_groups, new_tail = [], []
        for g in range(self.n_groups):
            for i, blk in enumerate(groups[g]):
                x, ns = self._mamba_apply(blk, x, {k: t[g, i] for k, t in mg.items()})
                new_groups.append(ns)
            x = _cached_block(shared, x, cfg, pos, attn["self"]["k"][g], attn["self"]["v"][g], attn["pos"][g])
        for i, blk in enumerate(tail_blocks):
            x, ns = self._mamba_apply(blk, x, {k: t[i] for k, t in states["mamba_tail"].items()})
            new_tail.append(ns)

        def stacked(new, lead):
            return {k: torch.stack([ns[k] for ns in new]).reshape(lead + tuple(new[0][k].shape)) for k in new[0]}

        return x, {"mamba_groups": stacked(new_groups, (self.n_groups, G)), "attn": attn,
                   "mamba_tail": stacked(new_tail, (tail,))}

    def _logits(self, params, x):
        return L.unembed_apply(params["unembed"], L.rmsnorm(params["final_norm"], x))

    def forward(self, params, batch):
        tokens = batch["tokens"]
        x = L.embed_apply(params["embed"], tokens, self.cfg.compute_dtype)
        x, _ = self._run(params, x, torch.arange(tokens.shape[1], device=tokens.device))
        return self._logits(params, x)

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16, device=None):
        """Zero states for ``batch_size`` rows, every leaf allocated at its
        full shape (the engine writes slots in place): bf16 conv rows
        (``dtype``), f32 SSD states, ``dtype`` K/V of ``cache_len``."""
        cfg, G = self.cfg, self.cfg.hybrid_group
        st = SSM.mamba2_init_state(cfg, batch_size, dtype, device="meta")  # shapes and dtypes

        def mamba(lead):
            return {k: torch.zeros(lead + tuple(t.shape), dtype=t.dtype, device=device) for k, t in st.items()}

        return {"mamba_groups": mamba((self.n_groups, G)),
                "attn": _zero_cache((self.n_groups,), batch_size, cache_len, cfg, dtype, device),
                "mamba_tail": mamba((cfg.hybrid_tail,))}

    def prefill(self, params, tokens):
        B, S = tokens.shape
        states = self.init_cache(B, S, device=tokens.device)
        x = L.embed_apply(params["embed"], tokens, self.cfg.compute_dtype)
        x, states = self._run(params, x, torch.arange(S, device=tokens.device), states)
        return self._logits(params, x[:, -1:, :]), states

    def decode(self, params, states, token, pos):
        """token: (B, 1); pos: a scalar or (B,) positions.  Writes the KV
        caches in place and returns the tree with new Mamba states."""
        B = token.shape[0]
        x = L.embed_apply(params["embed"], token, self.cfg.compute_dtype)
        qpos = torch.zeros((B,), dtype=torch.int32, device=token.device) + pos
        x, states = self._run(params, x, qpos[:, None], states)
        return self._logits(params, x), states
