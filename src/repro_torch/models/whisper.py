"""Whisper-style encoder–decoder backbone (arXiv:2212.04356): the audio family.

The port's copy of the JAX package's ``models/whisper.py``.  The conv
front end is a stub, as in the reference: the encoder takes precomputed
frame embeddings (B, n_frames, d_model), adds learned positions and runs
bidirectional blocks without RoPE.  The decoder adds learned positions
to the token embeddings and runs blocks of causal self-attention (with
the bf16 KV cache), cross-attention into the encoder's output and a
non-gated GELU MLP; every norm is a LayerNorm with a bias, and the
output table is the tied embedding.

Params: ``{"enc_pos" (n_frames, d), "enc_blocks" (every leaf
(encoder_layers, …)), "enc_norm", "embed", "dec_pos" (max_dec_pos, d),
"dec_blocks" (every leaf (n_layers, …)), "dec_norm"}``; an encoder block
is ``{"ln1", "attn", "ln2", "mlp"}``, a decoder block ``{"ln1", "attn",
"ln_x", "xattn", "ln2", "mlp"}``.  The cache is the dense family's,
``{"self": {"k", "v": (n_layers, B, S, KV, Dh)}, "pos": (n_layers, B)}``,
written in place.

The position tables stay f32 in the compute copy and are cast where they
are read, as the reference's ``astype`` casts them; only the rows read
are cast (a cast is elementwise: the same bits as casting the table).
``decode`` takes the encoder's output and computes the cross K/V from it
at every step, as the reference's code does; the query position's table
row is clamped to ``max_dec_pos − 1``.  ``forward`` recomputes the
encoder and decoder blocks as ``cfg.remat`` says, as the reference wraps
both scans in ``jax.checkpoint``.
"""

from __future__ import annotations

import torch

from . import layers as L
from .transformer import _attn_init, _block_init, _Draw, _embed_init, _remat, _zero_cache, unstack


def _dec_block_init(draw, lead, cfg):
    """An encoder block (``_block_init``: LayerNorms with a bias and a
    non-gated MLP for this config) with the cross-attention and its norm."""
    p = _block_init(draw, lead, cfg)
    p.update(ln_x=draw.norm(lead, cfg.d_model, bias=True), xattn=_attn_init(draw, lead, cfg))
    return p


def _enc_block(blk, h, cfg, pos):
    a, _ = L.attn_apply(blk["attn"], L.layernorm(blk["ln1"], h), cfg, qpos=pos, causal=False, use_rope=False)
    h = h + a
    return h + L.mlp_apply(blk["mlp"], L.layernorm(blk["ln2"], h), act="gelu")


def _dec_block(blk, h, enc, cfg, pos, cache=None, cache_pos=None):
    """One decoder block; with ``cache`` ({k, v} views of one layer) and
    ``cache_pos`` (its write heads) the self-attention's K/V are written
    into the cache in place.  Returns (h, the advanced write heads or
    None)."""
    a, nc = L.attn_apply(blk["attn"], L.layernorm(blk["ln1"], h), cfg, qpos=pos, causal=True, use_rope=False,
                         cache=cache, cache_pos=cache_pos)
    h = h + a
    a, _ = L.attn_apply(blk["xattn"], L.layernorm(blk["ln_x"], h), cfg, kv_src=enc, qpos=pos, causal=False,
                        use_rope=False)
    h = h + a
    h = h + L.mlp_apply(blk["mlp"], L.layernorm(blk["ln2"], h), act="gelu")
    return h, None if nc is None else nc["pos"]


class WhisperModel:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device, dtype=None):
        """Params with the reference's distributions (``_Draw``): the
        position tables N(0, 0.02²) and kept in f32 (cast where read), the
        blocks and the padded vocab table as the other families draw them;
        with ``dtype`` the compute copy drawn leaf by leaf."""
        cfg = self.cfg
        draw = _Draw(generator, device, dtype)
        return {"enc_pos": draw.normal((cfg.n_frames, cfg.d_model), 0.02, f32=True),
                "enc_blocks": _block_init(draw, (cfg.encoder_layers,), cfg),
                "enc_norm": draw.norm((), cfg.d_model, bias=True),
                "embed": _embed_init(draw, cfg),
                "dec_pos": draw.normal((cfg.max_dec_pos, cfg.d_model), 0.02, f32=True),
                "dec_blocks": _dec_block_init(draw, (cfg.n_layers,), cfg),
                "dec_norm": draw.norm((), cfg.d_model, bias=True)}

    # -- encoder ---------------------------------------------------------
    def encode(self, params, frames):
        """(B, n_frames, d_model) frame embeddings → the encoder's output in
        the compute dtype."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        x = frames.to(cd) + params["enc_pos"].to(cd)[None]
        pos = torch.arange(x.shape[1], device=x.device)
        body = _remat(_enc_block, cfg)
        for blk in unstack(params["enc_blocks"], cfg.encoder_layers):
            x = body(blk, x, cfg, pos)
        return L.layernorm(params["enc_norm"], x)

    # -- decoder ---------------------------------------------------------
    def _dec_blocks(self, params, x, enc, pos, caches=None):
        cfg = self.cfg
        blocks = unstack(params["dec_blocks"], cfg.n_layers)
        if caches is None:
            body = _remat(_dec_block, cfg)
            for blk in blocks:
                x, _ = body(blk, x, enc, cfg, pos)
            return x, None
        ks, vs, ps = (torch.unbind(t, 0) for t in (caches["self"]["k"], caches["self"]["v"], caches["pos"]))
        for blk, k, v, cp in zip(blocks, ks, vs, ps, strict=True):
            x, new_pos = _dec_block(blk, x, enc, cfg, pos, cache={"k": k, "v": v}, cache_pos=cp)
            cp.copy_(new_pos)
        return x, caches

    def _embed(self, params, tokens, rows):
        """Token embeddings plus the position table's ``rows``, both in the
        compute dtype."""
        x = L.embed_apply(params["embed"], tokens, self.cfg.compute_dtype)
        return x + params["dec_pos"][rows].to(x.dtype)

    def _logits(self, params, x):
        return L.unembed_apply(params["embed"], L.layernorm(params["dec_norm"], x))

    def forward(self, params, batch):
        """Training: frames (B, F, D) and tokens (B, S) → logits."""
        enc = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x, _ = self._dec_blocks(params, self._embed(params, tokens, pos[None]), enc, pos)
        return self._logits(params, x)

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16, device=None):
        return _zero_cache((self.cfg.n_layers,), batch_size, cache_len, self.cfg, dtype, device)

    def prefill(self, params, tokens, frames):
        """Encodes ``frames`` and runs the prompt: (last logits, a cache of
        the prompt's length)."""
        B, S = tokens.shape
        enc = self.encode(params, frames)
        caches = self.init_cache(B, S, device=tokens.device)
        pos = torch.arange(S, device=tokens.device)
        x, caches = self._dec_blocks(params, self._embed(params, tokens, pos[None]), enc, pos, caches)
        return self._logits(params, x[:, -1:, :]), caches

    def decode(self, params, caches, token, pos, enc):
        """token: (B, 1); pos: a scalar or (B,) positions; ``enc``: the
        encoder's output (B, n_frames, d_model), its K/V computed anew.
        Writes ``caches`` in place and returns it."""
        B = token.shape[0]
        qpos = (torch.zeros((B,), dtype=torch.int32, device=token.device) + pos)[:, None]
        rows = torch.clamp(qpos, max=params["dec_pos"].shape[0] - 1)
        x, caches = self._dec_blocks(params, self._embed(params, token, rows), enc, qpos, caches)
        return self._logits(params, x), caches
