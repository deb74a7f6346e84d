"""The dense decoder: uniform [attn + MLP] blocks.

The port's copy of the JAX package's ``models/transformer.py`` for the
dense family (``block_apply`` without MoE or cross-attention, and
``UniformDecoder``).  The stacked params and caches keep the reference's
layout — every block leaf has a leading ``n_layers`` axis, the cache is
``{"self": {"k", "v": (n_layers, B, Sc, KV, Dh)}, "pos": (n_layers, B)}``
— so trees carry across; the layers run in a Python loop over views of
that axis instead of ``lax.scan``, and the cache is written in place.

``init(generator, device)`` → params;  ``forward(params, batch)`` → logits;
``prefill(params, tokens)`` → (last logits, cache);
``decode(params, caches, token, pos)`` → (logits, caches).

The VLM, RWKV and hybrid families are later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import math

import torch

from . import layers as L


# --------------------------------------------------------------------------
# generic helpers
# --------------------------------------------------------------------------

def _normal(gen, shape, scale, device):
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(generator=gen) * scale


def _dense_init(gen, n, d_in, d_out, device, bias=False):
    """Stacked (n, d_in, d_out) weights, N(0, 1/d_in), zero biases."""
    p = {"w": _normal(gen, (n, d_in, d_out), 1.0 / math.sqrt(d_in), device)}
    if bias:
        p["b"] = torch.zeros((n, d_out), device=device)
    return p


def _norm_init(lead, d, device, bias=False):
    p = {"scale": torch.ones(lead + (d,), device=device)}
    if bias:
        p["bias"] = torch.zeros(lead + (d,), device=device)
    return p


def unstack(tree, n: int) -> list:
    """A tree of stacked leaves → n trees of per-layer views."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------------
# standard decoder block (attn + mlp)
# --------------------------------------------------------------------------

def block_apply(p, x, cfg, *, pos, cache=None, window=None):
    """Returns (x, new_cache).  cache = {"self": {k, v}, "pos": (B,)}."""
    new_cache = {} if cache is not None else None
    h = L.norm(p["ln1"], x, cfg.norm)
    a, sc = L.attn_apply(p["attn"], h, cfg, qpos=pos, window=window,
                         cache=cache["self"] if cache is not None else None,
                         cache_pos=cache["pos"] if cache is not None else None)
    if new_cache is not None:
        new_cache["self"] = {"k": sc["k"], "v": sc["v"]}
        new_cache["pos"] = sc["pos"]
    x = x + a
    h = L.norm(p["ln2"], x, cfg.norm)
    x = x + L.mlp_apply(p["mlp"], h, act=cfg.act)
    return x, new_cache


# --------------------------------------------------------------------------
# family: dense (uniform stack)
# --------------------------------------------------------------------------

class UniformDecoder:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device):
        """f32 params with the reference's distributions: N(0, 1/d_in)
        weights, zero biases, unit norms, N(0, 0.02²) embedding tables
        over the padded vocab.  ``device`` may be ``meta`` (shapes only)."""
        cfg = self.cfg
        n, d, H, KV, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        ln_bias = cfg.norm == "layernorm"
        vp = L.padded_vocab(cfg.vocab_size, cfg.vocab_pad_multiple)
        attn = {
            "wq": _dense_init(generator, n, d, H * dh, device, bias=cfg.qkv_bias),
            "wk": _dense_init(generator, n, d, KV * dh, device, bias=cfg.qkv_bias),
            "wv": _dense_init(generator, n, d, KV * dh, device, bias=cfg.qkv_bias),
            "wo": _dense_init(generator, n, H * dh, d, device),
        }
        if cfg.qk_norm:
            attn["q_norm"] = _norm_init((n,), dh, device)
            attn["k_norm"] = _norm_init((n,), dh, device)
        mlp = {"up": _dense_init(generator, n, d, cfg.d_ff, device),
               "down": _dense_init(generator, n, cfg.d_ff, d, device)}
        if cfg.gated_mlp:
            mlp["gate"] = _dense_init(generator, n, d, cfg.d_ff, device)
        p = {
            "embed": {"table": _normal(generator, (vp, d), 0.02, device)},
            "blocks": {"ln1": _norm_init((n,), d, device, ln_bias), "attn": attn,
                       "ln2": _norm_init((n,), d, device, ln_bias), "mlp": mlp},
            "final_norm": _norm_init((), d, device, ln_bias),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = {"table": _normal(generator, (vp, d), 0.02, device)}
        return p

    def _run_blocks(self, params, x, pos, caches=None, window=None):
        n = self.cfg.n_layers
        blocks = unstack(params["blocks"], n)
        if caches is None:
            for blk in blocks:
                x, _ = block_apply(blk, x, self.cfg, pos=pos, window=window)
            return x, None
        ks, vs, ps = (torch.unbind(t, 0) for t in (caches["self"]["k"], caches["self"]["v"], caches["pos"]))
        for blk, k, v, cp in zip(blocks, ks, vs, ps, strict=True):
            x, nc = block_apply(blk, x, self.cfg, pos=pos, cache={"self": {"k": k, "v": v}, "pos": cp},
                                window=window)
            cp.copy_(nc["pos"])
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
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)},
                "pos": torch.zeros((cfg.n_layers, batch_size), dtype=torch.int32, device=device)}

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
