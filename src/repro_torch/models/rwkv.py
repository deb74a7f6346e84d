"""RWKV-6 "Finch" (arXiv:2404.05892): the ssm family's block and model.

The port's copy of the JAX package's ``models/rwkv.py`` and of
``RWKVModel`` in its ``models/transformer.py``.  Attention-free: each
head carries a (dh, dh) state through a linear recurrence with a
data-dependent per-channel decay,

    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t),

so decoding keeps O(1) state per layer: the two token-shift vectors and
S, ``{"shift_tm", "shift_cm": (n_layers, B, d_model), "S": (n_layers, B,
H, dh, dh)}``, the same at any sequence length.

``_wkv_chunked`` is the chunkwise-parallel form: in chunks of ``CHUNK``
tokens the intra-chunk part is a strictly lower-triangular (C × C)
product of decay-weighted r and k, and the state crosses chunks once per
chunk.  The reference runs the chunks in a ``lax.scan`` of ~20 ops each;
here every chunk's intra-chunk terms and state increment are one batch
of products over a (B, n, C, H, dh) view, the carry is a loop of two
ops a chunk, and the carried state's term is one more batched product
over the stacked chunk-start states.  Each cast of the reference sits in
the same place.  Cumulative log decays are clipped to [-30, 0] as the
reference clips them.

Facts of the reference, kept as they are:

* A sequence longer than ``CHUNK`` tokens must be a multiple of it (the
  reference asserts ``T % min(64, T) == 0``; here a ``ValueError``): a
  prompt, a teacher-forced prefill or a training sequence of 65–127
  tokens is refused.
* ``ln_x`` is one LayerNorm over all H·dh channels, not RWKV-6's
  per-head GroupNorm.
* ``rwkv_block_apply`` always returns a state; ``decode`` ignores ``pos``.
* ``init_cache`` gives bf16 token shifts and an f32 S; a run returns its
  shifts in the compute dtype (the layer input's last row), so under f32
  compute the engine's shifts are bf16 until its first decode step and
  f32 from then on, as the reference engine's are.

The mixing and decay leaves (``mu``, ``maa_w1``, ``maa_w2``,
``decay_mu``, ``decay_w1``, ``decay_w2``, ``bonus_u``, ``mu_k``,
``mu_r``) stay f32 in the compute copy: the model casts each where it
reads it, to the compute dtype or to f32, as the reference does.  The
reference's ``constrain`` calls are sharding hints with no counterpart
on one card.
"""

from __future__ import annotations

import math

import torch

from . import layers as L
from .transformer import _Draw, _embed_init, _remat, unstack

__all__ = ["LORA_MIX", "LORA_DECAY", "CHUNK", "check_length", "rwkv_block_init", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_block_apply", "rwkv_init_state", "RWKVModel"]

LORA_MIX = 32
LORA_DECAY = 64
CHUNK = 64
CLIP = 30.0  # cumulative log decays are clipped to [-CLIP, 0]


def check_length(T: int):
    """The reference's chunk rule (``T % min(CHUNK, T) == 0``): raises
    ``ValueError`` for a sequence longer than ``CHUNK`` tokens that is not
    a multiple of it."""
    if T % min(CHUNK, T):
        raise ValueError(f"RWKV's chunked scan takes a sequence of at most {CHUNK} tokens or a multiple of {CHUNK}, "
                         f"not {T}")


def rwkv_block_init(draw: _Draw, lead: tuple, cfg) -> dict:
    """One block's params (``lead`` stacks them) with the reference's
    distributions: the mixes ``mu`` zeros, the LoRA weights N(0, 1/d)
    in and N(0, 0.01²) out, ``decay_mu`` -6, ``bonus_u`` zeros,
    ``mu_k`` / ``mu_r`` ones, biased LayerNorms."""
    d, H, dh, dff = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_size, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    dev = draw.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32, device=dev)

    return {
        "ln1": draw.norm(lead, d, bias=True),
        "ln2": draw.norm(lead, d, bias=True),
        "tm": {
            "mu": full((5, d), 0.0),
            "maa_w1": draw.normal(lead + (d, 5 * LORA_MIX), s, f32=True),
            "maa_w2": draw.normal(lead + (5, LORA_MIX, d), 0.01, f32=True),
            "decay_mu": full((H * dh,), -6.0),
            "decay_w1": draw.normal(lead + (d, LORA_DECAY), s, f32=True),
            "decay_w2": draw.normal(lead + (LORA_DECAY, H * dh), 0.01, f32=True),
            "bonus_u": full((H, dh), 0.0),
            "wr": draw.dense(lead, d, H * dh),
            "wk": draw.dense(lead, d, H * dh),
            "wv": draw.dense(lead, d, H * dh),
            "wg": draw.dense(lead, d, H * dh),
            "wo": draw.dense(lead, H * dh, d),
            "ln_x": draw.norm(lead, H * dh, bias=True),
        },
        "cm": {
            "mu_k": full((d,), 1.0),
            "mu_r": full((d,), 1.0),
            "wk": draw.dense(lead, d, dff),
            "wv": draw.dense(lead, dff, d),
            "wr": draw.dense(lead, d, d),
        },
    }


def _token_shift(x, x_prev_last):
    """x: (B, T, D); x_{t-1}, with ``x_prev_last`` (B, D) in slot 0, in
    the two dtypes' promotion (``jnp.concatenate``'s)."""
    dt = torch.promote_types(x.dtype, x_prev_last.dtype)
    return torch.cat([x_prev_last[:, None, :].to(dt), x[:, :-1, :].to(dt)], dim=1)


def _time_mix_inputs(p_tm, x, xs):
    """RWKV-6's data-dependent lerp: the five mixed streams (r, k, v, w, g)."""
    xx = xs - x  # (B, T, D)
    base = x + xx * p_tm["mu"][:, None, None, :].to(x.dtype)  # (5, B, T, D)
    low = torch.tanh(x @ p_tm["maa_w1"].to(x.dtype))  # (B, T, 5·r)
    B, T, _ = x.shape
    low = low.reshape(B, T, 5, LORA_MIX).permute(2, 0, 1, 3)  # (5, B, T, r)
    delta = torch.einsum("nbtr,nrd->nbtd", low, p_tm["maa_w2"].to(x.dtype))
    mixed = base + xx[None] * delta
    return mixed.unbind(0)


def _decay(p_tm, xw, H: int, dh: int):
    """Log decays lw < 0 in f32 (w = exp(lw) = exp(-exp(decay))), (B, T, H, dh)."""
    dec = p_tm["decay_mu"].float() + (torch.tanh(xw @ p_tm["decay_w1"].to(xw.dtype)).float()
                                      @ p_tm["decay_w2"].float())
    B, T = xw.shape[:2]
    return (-torch.exp(dec)).reshape(B, T, H, dh)


def _wkv_chunked(r, k, v, lw, u, S0):
    """Chunkwise-parallel WKV.  r / k / v: (B, T, H, dh); lw: (B, T, H,
    dh) log decays; u: (H, dh); S0: (B, H, dh, dh).  Returns (o (B, T,
    H, dh) in r's dtype, S_T in f32).  Raises ``ValueError`` for T above
    ``CHUNK`` that is not a multiple of it."""
    B, T, H, dh = r.shape
    check_length(T)
    C = min(CHUNK, T)
    n = T // C
    f32 = torch.float32
    rc, kc, vc = (t.reshape(B, n, C, H, dh) for t in (r, k, v))
    lwc = lw.reshape(B, n, C, H, dh).to(f32)
    cum = torch.cumsum(lwc, dim=2).clamp(-CLIP, 0.0)  # inclusive
    cum_prev = (cum - lwc).clamp(-CLIP, 0.0)  # exclusive: cum_{i-1}
    r_t = (rc.to(f32) * torch.exp(cum_prev)).to(r.dtype)
    k_t = (kc.to(f32) * torch.exp(-cum)).to(k.dtype)
    # intra-chunk: A[i, j] = r̃_i · k̃_j, strictly lower triangular
    A = torch.einsum("bnihd,bnjhd->bnhij", r_t, k_t).to(f32).tril(-1)
    # the diagonal bonus: (r_i ⊙ u) · k_i
    diag = torch.einsum("bnihd,hd,bnihd->bnhi", rc.to(f32), u.to(f32), kc.to(f32))
    o_intra = torch.einsum("bnhij,bnjhd->bnihd", A.to(v.dtype), vc)
    o_intra = o_intra + diag.transpose(-1, -2)[..., None].to(v.dtype) * vc
    # each chunk's state increment, and the carry: S <- S·exp(cum_last) + ΔS
    decay_tail = torch.exp((cum[:, :, -1:] - cum).clamp(-CLIP, 0.0))
    k_tail = (kc.to(f32) * decay_tail).to(k.dtype)
    dS = torch.einsum("bnjhd,bnjhe->bnhde", k_tail, vc).to(f32)
    w_last = torch.exp(cum[:, :, -1])[..., None]  # (B, n, H, dh, 1)
    S = S0.to(f32)
    starts = []
    for c in range(n):
        starts.append(S)
        S = S * w_last[:, c] + dS[:, c]
    # inter-chunk: r̃ against each chunk's carried state
    o_inter = torch.einsum("bnihd,bnhde->bnihe", r_t, torch.stack(starts, 1).to(r_t.dtype))
    return (o_intra + o_inter).to(r.dtype).reshape(B, T, H, dh), S


def rwkv_time_mix(p_tm, x, cfg, state=None):
    """state: None (training: zero shift and S) or a dict with ``shift_tm``
    (B, D) and ``S`` (B, H, dh, dh).  Returns (y, {shift_tm, S})."""
    B, T, D = x.shape
    H, dh = cfg.rwkv_heads, cfg.rwkv_head_size
    shift_in = state["shift_tm"] if state is not None else torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, shift_in)
    xr, xk, xv, xw, xg = _time_mix_inputs(p_tm, x, xs)
    r = L.dense(p_tm["wr"], xr).reshape(B, T, H, dh)
    k = L.dense(p_tm["wk"], xk).reshape(B, T, H, dh)
    v = L.dense(p_tm["wv"], xv).reshape(B, T, H, dh)
    g = L.dense(p_tm["wg"], xg)
    g = g * torch.sigmoid(g)
    lw = _decay(p_tm, xw, H, dh)
    S0 = state["S"] if state is not None else torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    o, S_T = _wkv_chunked(r, k, v, lw, p_tm["bonus_u"], S0)
    o = L.layernorm(p_tm["ln_x"], o.reshape(B, T, H * dh))
    y = L.dense(p_tm["wo"], o * g)
    return y, {"shift_tm": x[:, -1, :], "S": S_T}


def rwkv_channel_mix(p_cm, x, cfg, state=None):
    B, T, D = x.shape
    shift_in = state["shift_cm"] if state is not None else torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xx = _token_shift(x, shift_in) - x
    xk = x + xx * p_cm["mu_k"].to(x.dtype)
    xr = x + xx * p_cm["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(L.dense(p_cm["wk"], xk)))
    vv = L.dense(p_cm["wv"], kk)
    rr = torch.sigmoid(L.dense(p_cm["wr"], xr))
    return rr * vv, {"shift_cm": x[:, -1, :]}


def rwkv_block_apply(p, x, cfg, state=None):
    """LN → time-mix → residual → LN → channel-mix → residual.  Returns
    (x, {shift_tm, S, shift_cm}), with or without an input state."""
    h, st_tm = rwkv_time_mix(p["tm"], L.layernorm(p["ln1"], x), cfg, state)
    x = x + h
    h, st_cm = rwkv_channel_mix(p["cm"], L.layernorm(p["ln2"], x), cfg, state)
    x = x + h
    return x, {**st_tm, **st_cm}


def rwkv_init_state(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    H, dh, D = cfg.rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    return {"shift_tm": torch.zeros((batch, D), dtype=dtype, device=device),
            "shift_cm": torch.zeros((batch, D), dtype=dtype, device=device),
            "S": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device)}


class RWKVModel:
    """The stacked RWKV-6 model: ``{"embed", "ln0", "blocks" (every leaf
    with a leading n_layers axis), "final_norm", "unembed"}``, the
    reference's layout (``carry.lm_params_from_reference`` takes its tree
    unchanged); the blocks run in a Python loop over views of that axis.

    ``init(generator, device, dtype=None)`` → params;  ``forward(params,
    batch)`` → logits;  ``prefill(params, tokens)`` → (last logits,
    states);  ``decode(params, states, token, pos)`` → (logits, new
    states; ``pos`` is ignored).  ``forward`` recomputes each block in
    the backward as ``cfg.remat`` says (``transformer._remat``)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device, dtype=None):
        cfg = self.cfg
        draw = _Draw(generator, device, dtype)
        return {"embed": _embed_init(draw, cfg), "ln0": draw.norm((), cfg.d_model, bias=True),
                "blocks": rwkv_block_init(draw, (cfg.n_layers,), cfg),
                "final_norm": draw.norm((), cfg.d_model, bias=True), "unembed": _embed_init(draw, cfg)}

    def _run(self, params, x, states=None):
        cfg = self.cfg
        blocks = unstack(params["blocks"], cfg.n_layers)
        if states is None:
            body = _remat(rwkv_block_apply, cfg)
            for blk in blocks:
                x, _ = body(blk, x, cfg)
            return x, None
        new = []
        for blk, st in zip(blocks, unstack(states, cfg.n_layers), strict=True):
            x, ns = rwkv_block_apply(blk, x, cfg, st)
            new.append(ns)
        return x, {k: torch.stack([ns[k] for ns in new]) for k in new[0]}

    def _embed(self, params, tokens):
        return L.layernorm(params["ln0"], L.embed_apply(params["embed"], tokens, self.cfg.compute_dtype))

    def _logits(self, params, x):
        return L.unembed_apply(params["unembed"], L.layernorm(params["final_norm"], x))

    def forward(self, params, batch):
        x, _ = self._run(params, self._embed(params, batch["tokens"]))
        return self._logits(params, x)

    def init_cache(self, batch_size, cache_len=0, dtype=torch.bfloat16, device=None):
        """Zero states for ``batch_size`` rows; ``cache_len`` changes
        nothing (the state is O(1) in the sequence)."""
        st = rwkv_init_state(self.cfg, batch_size, dtype, device="meta")  # shapes and dtypes
        return {k: torch.zeros((self.cfg.n_layers,) + tuple(t.shape), dtype=t.dtype, device=device)
                for k, t in st.items()}

    def prefill(self, params, tokens):
        states = self.init_cache(tokens.shape[0], device=tokens.device)
        x, states = self._run(params, self._embed(params, tokens), states)
        return self._logits(params, x[:, -1:, :]), states

    def decode(self, params, states, token, pos=None):
        x, states = self._run(params, self._embed(params, token), states)
        return self._logits(params, x), states
