"""Slot-based token serving engine with continuous batching.

The port's copy of the JAX package's ``serving/engine.py`` (``Request``,
``ServeEngine``) over the port's dense, MoE, vision and ssm models (the
vision model gets zero media, as the reference's engine gives it): a
fixed device batch of ``slots``, each slot holding one request's decode
state inside ONE batched state tree (so a decode step is one call over
every slot): a KV cache, or RWKV's per-layer token shifts and (dh, dh)
states, whose size does not depend on ``cache_len``.  Continuous
batching = admit new requests into free slots between decode steps;
finished requests free their slot immediately.

  * prefill: per-request prefill produces a length-S cache whose first
    min(S, cache_len) positions are copied into the slot's rows of the
    batched cache (the rest of the slot is left as it was); an RWKV
    state, which has no sequence axis, is copied whole into the slot's
    row, cast to the slot tree's dtype;
  * decode: one ``serve_step`` advances every slot by one token at one
    scalar position, the largest of the active slots' (each row writes
    its K/V at its own head; RWKV ignores the position); inactive slots
    decode garbage that is masked out.  The engine keeps the state tree
    that the step returns: the dense models' caches written in place,
    RWKV's new tree, whose token shifts come back in the compute dtype
    (so under f32 compute they are bf16 until the first decode step and
    f32 after it, as in the reference engine);
  * greedy or temperature sampling on the host in f64 from
    ``np.random.default_rng(seed)``, EOS/max-token termination.

These are the reference's semantics, kept as they are so both engines
give the same tokens: a row whose prompt is shorter than its neighbour's
is decoded at the neighbour's position (RoPE angle and causal limit).
The engine holds the compute-dtype copy of the params
(``models.compute_copy``; a tree already in the compute dtype is not
copied) on its device (None → cuda).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from .batcher import HostBatcher

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    temperature: float = 0.0
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, cache_len: int = 256, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.compute_copy(params, cfg, self.device)
        self.slots = slots
        self.cache_len = cache_len
        self.model = M.build_model(cfg)  # raises for the families still to come, audio among them
        self.serve_step = M.make_serve_step(cfg)
        self.caches = self.model.init_cache(slots, cache_len, device=self.device)  # owner: serve thread
        self.slot_req: list[Request | None] = [None] * slots  # owner: serve thread
        self.slot_pos = np.zeros(slots, dtype=np.int64)  # owner: serve thread
        self.queue = HostBatcher(max_block=slots)
        self.rng = np.random.default_rng(seed)
        self.steps = 0  # owner: serve thread
        self.tokens_out = 0  # owner: serve thread

    # -- internals ----------------------------------------------------------

    def _media(self, batch: int):
        """The vision model's media: bf16 zeros, as the reference's engine gives."""
        cfg = self.cfg
        return torch.zeros((batch, cfg.n_media_tokens, cfg.d_model), dtype=torch.bfloat16, device=self.device)

    def _prefill_one(self, params, tokens):
        """(1, S) prompt -> (last logits, cache of length S)."""
        if self.cfg.family == "vlm":
            return self.model.prefill(params, tokens, self._media(1))
        return self.model.prefill(params, tokens)

    def _write_slot_cache(self, slot: int, cache):
        """Copy a freshly prefilled cache into the batched slot cache, leaf
        by leaf as the reference's ``put`` does: the batch axis is the
        first where the slot cache has ``slots`` and the prefill cache 1,
        the sequence axis the first other axis whose lengths differ, of
        which the first min(S, cache_len) positions are copied; the write
        heads and RWKV's states (no sequence axis) are copied whole."""

        def put(slot_arr, new_arr):
            if isinstance(slot_arr, dict):
                for k in slot_arr:
                    put(slot_arr[k], new_arr[k])
                return
            bdim = next((ax for ax in range(min(slot_arr.dim(), new_arr.dim()))
                         if slot_arr.shape[ax] == self.slots and new_arr.shape[ax] == 1), None)
            if bdim is None:
                return
            idx = [slice(None)] * slot_arr.dim()
            idx[bdim] = slice(slot, slot + 1)
            sdim = next((ax for ax in range(min(slot_arr.dim(), new_arr.dim()))
                         if ax != bdim and new_arr.shape[ax] != slot_arr.shape[ax]), None)
            if sdim is not None:
                take = min(new_arr.shape[sdim], slot_arr.shape[sdim])
                new_arr = new_arr.narrow(sdim, 0, take)
                idx[sdim] = slice(0, take)
            slot_arr[tuple(idx)] = new_arr.to(slot_arr.dtype)

        put(self.caches, cache)

    # -- public API -----------------------------------------------------------

    def submit(self, req: Request):
        self.queue.push(req, kind="req")

    @torch.no_grad()
    def _admit(self):
        for slot in range(self.slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop_one()
                toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64, device=self.device)[None, :]
                logits, cache = self._prefill_one(self.params, toks)
                self._write_slot_cache(slot, cache)
                tok = self._sample(logits[0, -1].float().cpu().numpy(), req)
                req.generated.append(int(tok))
                self.tokens_out += 1
                # the prefill-produced token can itself terminate
                if (req.eos_id is not None and tok == req.eos_id) or len(
                    req.generated
                ) >= req.max_new_tokens:
                    req.done = True
                    continue
                self.slot_req[slot] = req
                self.slot_pos[slot] = len(req.prompt)

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        logits = logits[: self.cfg.vocab_size].astype(np.float64)
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / req.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    @torch.no_grad()
    def step(self):
        """One continuous-batching iteration: admit + decode + retire."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return False
        last = np.zeros((self.slots, 1), dtype=np.int64)
        for s in active:
            last[s, 0] = self.slot_req[s].generated[-1]
        pos = int(max(self.slot_pos[s] for s in active))  # scalar step pos
        extras = {"media": self._media(self.slots)} if self.cfg.family == "vlm" else None
        logits, self.caches = self.serve_step(self.params, self.caches,
                                              torch.as_tensor(last, device=self.device), pos, extras)
        logits = logits[:, -1].float().cpu().numpy()
        self.steps += 1
        for s in active:
            req = self.slot_req[s]
            tok = self._sample(logits[s], req)
            req.generated.append(tok)
            self.tokens_out += 1
            self.slot_pos[s] += 1
            if (
                (req.eos_id is not None and tok == req.eos_id)
                or len(req.generated) >= req.max_new_tokens
                or self.slot_pos[s] >= self.cache_len - 1
            ):
                req.done = True
                self.slot_req[s] = None  # free the slot for the next admit
        return True

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Step until the queue and the slots are empty.  Returns ``[]``, as
        the reference does: the requests themselves carry the results."""
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return finished
