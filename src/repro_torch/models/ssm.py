"""Mamba-2 (SSD, arXiv:2405.21060): the hybrid family's state-space block.

The port's copy of the JAX package's ``models/ssm.py``.  A state-space
recurrence with one scalar decay per head,

    h_t = exp(Δ_t·A) h_{t-1} + Δ_t · x_t ⊗ B_t
    y_t = C_t · h_t + D ⊙ x_t,

so decoding keeps O(1) state per layer: the convolution's trailing
``CONV_W − 1`` rows and the (N, P) state of each head, ``{"conv": (B,
CONV_W − 1, conv_dim), "ssd": (B, H, N, P)}``.

``_ssd_chunked`` is the chunked "state-space dual" form: within a chunk
of ``CHUNK`` tokens the output is a masked (C × C) product weighted by
pairwise decays, taken as exp of *differences* of cumulative log decays
clamped at 0 before the mask (never exp of a positive number: masked
afterwards by a product, an ``inf`` would give ``inf·0 = NaN``, and
under ``torch.where`` NaN gradients), and the state crosses chunks once
per chunk.  The reference runs the chunks in a ``lax.scan``; here every
chunk's intra-chunk terms and state increment are one batch of products
over a (B, n, C, H, P) view, ``C·Bᵀ`` once per B/C group and broadcast
to its heads, the carry a loop of two ops a chunk, and the carried
state's term one more batched product over the stacked chunk-start
states.  Each cast of the reference sits in the same place.

Facts of the reference, kept as they are:

* A sequence longer than ``CHUNK`` tokens must be a multiple of it (the
  reference asserts ``T % min(64, T) == 0``; here a ``ValueError``).
* ``A_log`` and ``dt_bias`` start at 0 (a decay of about 0.5 a token),
  not at Mamba-2's published ranges; the gated RMSNorm covers all of
  ``d_inner``, not each group.
* ``mamba2_apply`` returns the convolution's state in the compute dtype
  (the layer input's last rows) where ``mamba2_init_state`` gives bf16,
  so under f32 compute an engine's conv state is bf16 until its first
  decode step and f32 from then on, as the reference engine's is.

``in_proj``, ``out_proj``, ``conv_w``, ``conv_b`` and ``D`` are cast to
the input's dtype where they are read, so the compute copy holds them in
the compute dtype; ``A_log``, ``dt_bias`` and the norm are read in f32
and stay f32.  The reference's ``constrain`` is a sharding hint with no
counterpart on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L

__all__ = ["CHUNK", "CONV_W", "ssm_dims", "mamba2_init", "mamba2_apply", "mamba2_init_state"]

CHUNK = 64
CONV_W = 4


def ssm_dims(cfg):
    """(d_inner, SSD heads, the convolution's channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, H, conv_dim


def mamba2_init(draw, lead: tuple, cfg) -> dict:
    """One block's params (``lead`` stacks them), drawn by ``draw`` (a
    ``transformer._Draw``) with the reference's distributions: ``in_proj``
    N(0, 1/d), ``conv_w`` N(0, 0.1²), ``conv_b``, ``A_log`` and
    ``dt_bias`` zeros, ``D`` ones, a unit norm, ``out_proj`` N(0,
    1/d_inner).  ``A_log``, ``dt_bias`` and the norm are f32 in the
    compute copy."""
    d = cfg.d_model
    d_inner, H, conv_dim = ssm_dims(cfg)
    in_dim = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + H
    dev, dt = draw.device, draw.dtype or torch.float32
    return {
        "in_proj": draw.normal(lead + (d, in_dim), 1.0 / math.sqrt(d)),
        "conv_w": draw.normal(lead + (CONV_W, conv_dim), 0.1),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=dev),
        "A_log": torch.zeros(lead + (H,), device=dev),
        "D": torch.ones(lead + (H,), dtype=dt, device=dev),
        "dt_bias": torch.zeros(lead + (H,), device=dev),
        "norm": draw.norm(lead, d_inner),
        "out_proj": draw.normal(lead + (d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _causal_conv(xBC, w, b, conv_state=None):
    """Depthwise causal convolution of width ``CONV_W`` over xBC (B, T, C).
    ``conv_state`` (B, CONV_W − 1, C): the trailing context (decode).
    Returns (out, new conv state) in xBC's dtype."""
    B, T, C = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((B, CONV_W - 1, C), dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out = torch.zeros((B, T, C), dtype=xBC.dtype, device=xBC.device)
    for i in range(CONV_W):
        out = out + full[:, i:i + T, :] * w[i].to(xBC.dtype)
    out = F.silu(out + b.to(xBC.dtype))
    return out, full[:, T:, :].clone()  # a copy: a view would hold the whole (B, T + 3, C) input


def _segsum_decay(cum):
    """L[..., i, j] = exp(cum_i − cum_j) for j <= i, else 0; cum: (..., C)."""
    idx = torch.arange(cum.shape[-1], device=cum.device)
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.where(idx[None, :] <= idx[:, None], torch.exp(torch.clamp(diff, max=0.0)), 0.0)


def _ssd_chunked(x, dt, Bm, Cm, A_log, h0):
    """The chunked SSD scan.  x: (B, T, H, P); dt: (B, T, H) f32; Bm / Cm:
    (B, T, G, N); A_log: (H,); h0: (B, H, N, P).  Returns (y (B, T, H, P)
    in x's dtype, h_T (B, H, N, P) f32).  Raises ``ValueError`` for T
    above ``CHUNK`` that is not a multiple of it."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L.check_length(T, CHUNK)
    C = min(CHUNK, T)
    n = T // C
    f32, xdt = torch.float32, x.dtype
    A = -torch.exp(A_log.to(f32))  # (H,), negative
    lg = dt.to(f32) * A  # (B, T, H) log decays
    xd = x * dt[..., None].to(xdt)  # Δ_t · x_t
    xs = xd.reshape(B, n, C, H, P)
    Bs, Cs = Bm.reshape(B, n, C, G, N), Cm.reshape(B, n, C, G, N)
    cum = torch.cumsum(lg.reshape(B, n, C, H), dim=2)  # (B, n, C, H)
    Lm = _segsum_decay(cum.transpose(-1, -2))  # (B, n, H, C, C)
    # M[i, j] = C_i · B_j, once per group, broadcast to the group's heads
    M = torch.einsum("bnigk,bnjgk->bngij", Cs, Bs).to(f32)
    ML = (M[:, :, :, None] * Lm.reshape(B, n, G, rep, C, C)).reshape(B, n, H, C, C)
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", ML.to(xdt), xs)
    # each chunk's state increment Σ_j exp(cum_last − cum_j) B_j ⊗ xd_j, and the carry h <- h·exp(cum_last) + ΔS
    tail = torch.exp(torch.clamp(cum[:, :, -1:] - cum, max=0.0)).to(xdt)  # (B, n, C, H)
    Bt = (Bs[:, :, :, :, None] * tail.reshape(B, n, C, G, rep)[..., None]).reshape(B, n, C, H, N)
    dS = torch.einsum("bnjhk,bnjhp->bnhkp", Bt, xs).to(f32)
    w_last = torch.exp(cum[:, :, -1]).to(f32)[..., None, None]  # (B, n, H, 1, 1)
    h = h0.to(f32)
    starts = []
    for c in range(n):
        starts.append(h)
        h = h * w_last[:, c] + dS[:, c]
    # the carried state's term: exp(cum_i) C_i · h_start, per group over its heads
    hs = torch.stack(starts, 1).to(xdt).reshape(B, n, G, rep, N, P)
    y_inter = torch.einsum("bnigk,bngrkp->bnigrp", Cs, hs).reshape(B, n, C, H, P)
    y_inter = y_inter * torch.exp(cum).to(xdt)[..., None]
    return (y_intra + y_inter).reshape(B, T, H, P), h


def mamba2_apply(p, x, cfg, state=None):
    """x: (B, T, D) → (y (B, T, D), {"conv", "ssd"}); ``state`` carries the
    conv and SSD states in (decode), None from zeros (training)."""
    B, T, _ = x.shape
    d_inner, H, conv_dim = ssm_dims(cfg)
    g, ds, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], state["conv"] if state is not None else None)
    xs, Bm, Cm = torch.split(xBC, [d_inner, g * ds, g * ds], dim=-1)
    xs = xs.reshape(B, T, H, P)
    Bm, Cm = Bm.reshape(B, T, g, ds), Cm.reshape(B, T, g, ds)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    h0 = state["ssd"] if state is not None else torch.zeros((B, H, ds, P), dtype=torch.float32, device=x.device)
    y, h_T = _ssd_chunked(xs, dt, Bm, Cm, p["A_log"], h0)
    y = y + xs * p["D"].to(x.dtype)[:, None]
    y = L.rmsnorm(p["norm"], y.reshape(B, T, d_inner) * F.silu(z))
    return y @ p["out_proj"].to(x.dtype), {"conv": new_conv, "ssd": h_T}


def mamba2_init_state(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    """Zero states: the conv rows in ``dtype``, the SSD state f32."""
    _, H, conv_dim = ssm_dims(cfg)
    return {"conv": torch.zeros((batch, CONV_W - 1, conv_dim), dtype=dtype, device=device),
            "ssd": torch.zeros((batch, H, cfg.ssm_state, cfg.ssm_head_dim), dtype=torch.float32, device=device)}
