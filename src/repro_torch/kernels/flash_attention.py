"""Forward attention with positional masks: CUDA kernel and plain version.

Replaces the JAX package's Pallas kernel
``repro/kernels/flash_attention.py`` (``_flash_kernel`` /
``flash_attention``): online-softmax attention over head-major tensors,
scores scaled by 1/√D, with three masks taken from position vectors —
dead keys (``kpos < 0``), causal (``kpos > qpos``) and a sliding window
(``kpos <= qpos - window``).  A masked score is the finite ``-1e30``, so
a row with no live key gets the uniform mean of V (the plain version's
answer; the Pallas path pads K/V with zero rows, so there its result
depends on the block size).  It serves ``ops.flash_attention``.

Bound on the H100: operations.  QKᵀ and PV need 4·D FLOPs per live
(query, key) pair and head: 51.5 GFLOP for qwen2-1.5b's attention at
S = 4096 (causal, 12 heads of 128) — 0.052 ms at 989 TFLOP/s dense bf16
— while q, k, v and the output are 29 MB in bf16 (9 µs at 3.35 TB/s).  The kernel (``csrc/flash_attention.cu``) is
a simple one on the CUDA cores in f32: one block per (batch × query
head, 64-row q block), K/V tiles of 32 keys through shared memory, the
running (max, sum, acc) in f32 registers, tiles without a live pair
skipped.  It reads kv head ``h // G`` for query head ``h`` and takes the
layout as strides, so there is no copy of K/V per query head and no
head-major copy of the model-layout tensors.  ``wgmma`` and TMA are
later work.  The same kernel runs f32 and bf16; the output is in q's
dtype.  A tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def flash_attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, H, Sq, D), k and v (B, KV, Sk, D) with H a multiple of KV,
    f32 or bf16 views with contiguous features; qpos (B, Sq) and kpos
    (B, Sk) int32.  Query head h attends with kv head h // (H / KV).
    Returns (B, H, Sq, D) in q's dtype, written into ``out`` (a view of
    that shape, features contiguous) when given."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants (B, H, Sq, D) and two (B, KV, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not pair with k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention wants f32 or bf16 throughout, got {q.dtype}, {k.dtype}, {v.dtype}")
    if qpos.shape != (B, Sq) or kpos.shape != (B, Sk) or qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("flash_attention wants int32 positions of shape (B, Sq) and (B, Sk)")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device):
        raise ValueError("flash_attention: out must match q's shape, dtype and device")
    if Sk == 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes Sk >= 1 and D <= {MAX_HEAD_DIM}, got Sk={Sk} D={D}")
    if len({t.device for t in (q, k, v, qpos, kpos)}) != 1:
        raise ValueError("flash_attention inputs on different devices")
    if q.device.type == "cpu":
        res = _ref.gqa_flash_attention(q, k, v, qpos, kpos, causal, window)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    views = (q, k, v, out)
    if any(t.stride(-1) != 1 for t in views) or not (qpos.is_contiguous() and kpos.is_contiguous()):
        raise ValueError("flash_attention wants contiguous features and contiguous positions")
    if B * H > 65535 or max(Sq, Sk) >= 2**31:
        raise ValueError(f"flash_attention kernel takes B*H <= 65535, got {B * H}")
    if Sq and B:
        strides = [s for t in views for s in t.stride()[:3]]
        lib = _build.load()
        with torch.cuda.device(q.device):
            code = lib.repro_flash_attention(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
                kpos.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, D, *strides, int(bool(causal)),
                int(window is not None), 0 if window is None else int(window), 1.0 / math.sqrt(D),
                _build.current_stream(q.device))
        _build.check(code, "flash_attention")
        launches += 1
    return out
