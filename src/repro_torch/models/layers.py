"""Shared model layers: plain functions over a params tree of tensors.

The port's copy of the JAX package's ``models/layers.py`` for the dense,
MoE and vision families.  A params tree is a nested dict of tensors with
the reference's keys, so a tree carried across from the reference
(``carry.py``) drops in.  The reference's ``Leaf`` / ``split`` (logical
sharding axes) and its ``constrain`` calls are left out: the axes feed
only the reference's ``launch/sharding.py``, and ``constrain`` is a
no-op without a mesh.

Attention supports GQA (n_kv < n_heads), QKV biases (qwen1.5/qwen2),
qk-norm (qwen3), sliding windows (danube, a ring cache), per-row cache
write heads (the serving engine) and cross-attention (llama-3.2-vision).
``attention_core`` keeps the reference's dispatch by score-tile size:
small tiles and single-token decode go through plain einsum-and-softmax
(``_sdpa``); above ``flash_threshold`` the call goes to the port's flash
kernel (``kernels.ops.flash_attention``), where the reference runs its
jnp online softmax (``_flash_sdpa``).  On a CPU tensor that call takes
the kernel's plain version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -1e30


# --------------------------------------------------------------------------
# primitive ops
# --------------------------------------------------------------------------

def dense(p, x):
    """``x @ w + b`` with the weights cast to x's dtype (a no-op on the
    compute copy)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(dt)


def layernorm(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def check_length(T: int, chunk: int = 64):
    """The reference's rule for its chunked scans, RWKV's WKV and Mamba-2's
    SSD (``T % min(chunk, T) == 0``; both chunks are 64): raises
    ``ValueError`` for a sequence longer than ``chunk`` tokens that is not
    a multiple of it."""
    if T % min(chunk, T):
        raise ValueError(f"a chunked scan takes a sequence of at most {chunk} tokens or a multiple of {chunk}, "
                         f"not {T}")


def norm(p, x, kind="rmsnorm"):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def act_fn(name):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}[name]


# --------------------------------------------------------------------------
# rotary embedding
# --------------------------------------------------------------------------

def rope(x, positions, theta=10_000.0):
    """x: (B, S, H, Dh), positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _mask_bias(qpos, kpos, causal, window):
    """(..., Sq, Sk) additive f32 bias from positions."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    mask = k < 0  # unwritten ring-buffer slots
    if causal:
        mask = mask | (k > q)
    if window is not None:
        mask = mask | (k <= q - window)
    shape = qpos.shape[:-1] + (qpos.shape[-1], kpos.shape[-1])
    return torch.zeros(shape, dtype=torch.float32, device=qpos.device).masked_fill_(mask, NEG_INF)


def _sdpa(q, k, v, bias):
    """q: (B,Sq,H,Dh) k/v: (B,Sk,KV,Dh); GQA by head grouping."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(Dh)
    scores = scores + bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, Dh)


def attention_core(q, k, v, *, qpos, kpos, causal=True, window=None, flash_threshold=8192 * 2048):
    """Dispatch plain vs the flash kernel by score-tile size.  The kernel
    takes the model layout and picks its own blocks (the reference's
    ``cq`` / ``ck`` size its jnp loop)."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    if Sq * Sk <= flash_threshold or Sq == 1:
        if qpos.dim() == 1:
            qpos = torch.broadcast_to(qpos[None], (B, Sq))
        if kpos.dim() == 1:
            kpos = torch.broadcast_to(kpos[None], (B, Sk))
        return _sdpa(q, k, v, _mask_bias(qpos, kpos, causal, window))
    return ops.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window)


# --------------------------------------------------------------------------
# attention block
# --------------------------------------------------------------------------

def _write_cache(buf, new, start):
    """``buf[b, start_b : start_b + S] = new[b]`` in place, the start
    clamped into ``[0, Sc - S]`` as ``lax.dynamic_update_slice`` clamps
    it; ``start`` is a scalar or a (B,) tensor of per-row write heads."""
    B, S = new.shape[:2]
    Sc = buf.shape[1]
    start = torch.clamp(torch.as_tensor(start, device=buf.device), max=Sc - S).clamp(min=0)
    idx = start.reshape(-1, 1) + torch.arange(S, device=buf.device)  # (B or 1, S)
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = new.to(buf.dtype)


def attn_apply(p, x, cfg, *, qpos, kv_src=None, kpos=None, causal=True, window=None, cache=None, cache_pos=None,
               use_rope=True):
    """Self- or cross-attention.

    Cross-attention takes its K/V from ``kv_src`` (the vlm's media), at
    key positions ``arange`` of its length unless ``kpos`` is given; RoPE
    rotates q, and k where it has positions (``use_rope=False`` turns it
    off).  K/V keep ``kv_src``'s dtype (``dense`` casts the weight to its
    input's), and the three are promoted to one dtype as ``jnp`` promotes
    them before ``attention_core`` picks a route.

    cache: optional dict {k: (B, Sc, KV, Dh), v: ...}; when given with
    ``cache_pos`` (a scalar or (B,) per-row write heads), the new K/V are
    written into it in place at that slot (ring-buffer semantics for
    windowed caches: slot = pos % Sc) and attention runs over the whole
    cache, read back in x's dtype, with position masking.
    Returns (out, new_cache): the same k/v tensors and ``pos`` advanced.
    """
    B, S, d = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    q = dense(p["wq"], x).reshape(B, S, H, Dh)
    k = dense(p["wk"], src).reshape(B, src.shape[1], KV, Dh)
    v = dense(p["wv"], src).reshape(B, src.shape[1], KV, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if use_rope:
        q = rope(q, qpos, cfg.rope_theta)
        if kpos is None and kv_src is None:
            k = rope(k, qpos, cfg.rope_theta)
        elif kpos is not None:
            k = rope(k, kpos, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        Sc = cache["k"].shape[1]
        cache_pos = torch.as_tensor(cache_pos, device=x.device)
        # cache_pos: scalar (lockstep decode) or (B,) per-row write heads
        # (continuous-batching serving engine)
        per_row = cache_pos.dim() >= 1
        slot = cache_pos % Sc if window is not None else cache_pos
        _write_cache(cache["k"], k, slot)
        _write_cache(cache["v"], v, slot)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache_pos + S}
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        idx = torch.arange(Sc, device=x.device)
        if window is not None:
            # ring buffer: key positions relative to the write head
            head = slot[:, None] if per_row else slot
            cp = cache_pos[:, None] if per_row else cache_pos
            kpos = cp + S - 1 - ((head + S - 1 - idx) % Sc)
        else:
            kpos = torch.broadcast_to(idx[None], (B, Sc)) if per_row else idx
    if kpos is None:
        kpos = qpos if kv_src is None else torch.arange(src.shape[1], device=x.device)
    dt = torch.promote_types(q.dtype, k.dtype)
    out = attention_core(q.to(dt), k.to(dt), v.to(dt), qpos=qpos, kpos=kpos, causal=causal, window=window,
                         flash_threshold=getattr(cfg, "flash_threshold", 8192 * 2048))
    y = dense(p["wo"], out.reshape(B, S, H * Dh))
    return y, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_apply(p, x, act="silu"):
    h = dense(p["up"], x)
    h = act_fn(act)(dense(p["gate"], x)) * h if "gate" in p else act_fn(act)(h)
    return dense(p["down"], h)


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def padded_vocab(v, mult):
    return ((v + mult - 1) // mult) * mult


def embed_apply(p, tokens, dtype):
    """The table's rows at ``tokens``, in ``dtype``.  ``F.embedding``, not
    indexing: its backward sums each row's gradients in token order, where
    indexing's (``index_put_`` with accumulate) sums them in a thread
    order that varies from run to run on the CPU."""
    return F.embedding(tokens, p["table"].to(dtype))


def unembed_apply(p, x):
    """Logits against the (padded) vocab table, in x's dtype."""
    return x @ p["table"].to(x.dtype).T
