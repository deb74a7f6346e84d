"""Top-k routed Mixture-of-Experts with sort-based capacity dispatch.

The port's copy of the JAX package's ``models/moe.py`` (``moe_apply`` and
its group count; the params come from ``transformer.py``'s init) and of
its ``aux_load_balance_loss``, which the reference's train loss does not
add either:

  1. router: (T, E) logits → top-k probabilities, renormalised;
  2. per dispatch group, a stable sort of the (token, choice) pairs by
     expert; the rank inside an expert decides the slot, and pairs past
     the capacity C go to the trash slot E·C;
  3. gather into an (E, C, D) buffer, three batched GLU products over the
     expert axis;
  4. combine: each token adds its kept slots' weighted outputs.

Capacity C = max(8, round_up_8(ceil(T/G · k / E · capacity_factor))).
The reference's G grows with the mesh's batch sharding; the port has no
mesh for the LM, so G starts at 1 (``_group_count``).

Where the reference leaves the order to its backend, the port fixes it
to the reference's on the CPU, so the same tokens reach the same slots
and the same sums come out on every run: ties among the router's
probabilities go to the lower expert (``lax.top_k``'s order; a stable
descending sort), and the combine adds each token's kept slots in
ascending slot order e·C + c from zero, one add at a time in the compute
dtype, with no atomic float add (XLA's CPU scatter-add applies its
updates in slot order; ``index_add_`` on CUDA would add in a different
order on every run).
"""

from __future__ import annotations

import math

import torch

from . import layers as L

__all__ = ["aux_load_balance_loss", "capacity", "moe_apply", "route"]


def _group_count(T: int, target: int = 8192) -> int:
    """The reference's dispatch groups without a mesh (dp = 1): G doubles
    while G < 64, T splits into 2G equal groups and each keeps at least
    ``target`` tokens."""
    g = 1
    while g < 64 and T % (2 * g) == 0 and T // (2 * g) >= target:
        g *= 2
    return g


def capacity(Tg: int, cfg) -> int:
    """Slots per expert for a group of Tg tokens, in the reference's
    order of operations (Python floats)."""
    C = int(math.ceil(Tg * cfg.n_experts_per_tok / cfg.n_experts * cfg.capacity_factor))
    return max(8, ((C + 7) // 8) * 8)


def route(p, x, cfg):
    """The router over x (B, S, D): returns (G, C, top_e, top_p) with
    top_e (G, Tg, k) int64 experts (the lower one first among equal
    probabilities) and top_p (G, Tg, k) f32 weights summing to 1."""
    B, S, D = x.shape
    T = B * S
    G = _group_count(T)
    Tg = T // G
    logits = (x.reshape(G, Tg, D) @ p["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    return G, capacity(Tg, cfg), top_e, top_p / top_p.sum(dim=-1, keepdim=True)


def _slots(top_e, E: int, C: int):
    """One group's dispatch: (Tg, k) experts → the slot of each (token,
    choice) pair, (Tg, k) int64 in [0, E·C] with E·C the trash slot.
    Pairs are ranked inside their expert in (token, choice) order, and
    the first C keep a slot."""
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=flat_e.device))
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - seg_start[sorted_e]
    dest = torch.where(rank < C, sorted_e * C + rank, E * C)
    slot = torch.empty_like(dest)
    slot[order] = dest
    return slot.reshape(top_e.shape)


def moe_apply(p, x, cfg, act=torch.nn.functional.silu):
    """x: (B, S, D) -> (B, S, D).  Grouped sort-based capacity dispatch."""
    B, S, D = x.shape
    T = B * S
    E = cfg.n_experts
    G, C, top_e, top_p = route(p, x, cfg)
    Tg = T // G
    xf = x.reshape(G, Tg, D)
    src_tok = torch.arange(Tg, device=x.device).repeat_interleave(cfg.n_experts_per_tok)
    out = []
    for g in range(G):
        slot = _slots(top_e[g], E, C)  # (Tg, k)
        # slot -> source token (Tg: the zero row) and slot -> weight, the reference's inverse maps; the
        # dropped pairs all land in the trash entry E·C, which is cut off
        tok_idx = torch.full((E * C + 1,), Tg, dtype=torch.int64, device=x.device)
        tok_idx[slot.reshape(-1)] = src_tok
        w_slot = torch.zeros(E * C + 1, dtype=torch.float32, device=x.device)
        w_slot[slot.reshape(-1)] = top_p[g].reshape(-1)
        xs = torch.cat([xf[g], x.new_zeros(1, D)])[tok_idx[: E * C]].reshape(E, C, D)
        h = act(xs @ p["gate"].to(x.dtype)) * (xs @ p["up"].to(x.dtype))
        ys = (h @ p["down"].to(x.dtype)).reshape(E * C, D)
        upd = torch.cat([ys * w_slot[: E * C, None].to(x.dtype), x.new_zeros(1, D)])  # row E·C: the trash
        # each token's kept slots in ascending slot order, added one at a time from zero
        acc = x.new_zeros(Tg, D)
        for s in torch.sort(slot, dim=-1).values.unbind(-1):
            acc = acc + upd[s]
        out.append(acc)
    out = torch.stack(out).reshape(T, D)
    if "shared" in p:
        out = out + L.mlp_apply(p["shared"], x, act="silu").reshape(T, D)
    return out.reshape(B, S, D)


def aux_load_balance_loss(logits, top_e, E: int):
    """Switch-style load-balance loss: E · Σ_e mean router probability of e
    × the share of tokens whose first choice is e.  ``logits`` (T, E),
    ``top_e`` (T, k) expert ids."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top_e[:, 0].long(), E).to(torch.float32).mean(dim=0)
    return E * torch.sum(me * ce)
