"""Forward attention with positional masks: two CUDA kernels and a plain version.

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
S = 4096 (causal, 12 heads of 128) — 0.052 ms at 989 TFLOP/s dense bf16,
0.77 ms at 67 TFLOP/s f32 off the tensor cores — while q, k, v and the
output are 29 MB in bf16 (9 µs at 3.35 TB/s).

Two kernels, one per route, chosen before the launch by ``route`` from
dtype, head width, strides and data pointers alone:

- ``"mma"`` (``csrc/flash_attention_wgmma.cu``): bf16 on Hopper's
  warpgroup tensor cores — blocks of 128 query rows, two consumer
  warpgroups running ``wgmma`` (Q·Kᵀ from shared memory, P·V with P in
  registers and V read MN-major) with f32 accumulators, and a producer
  warp feeding 128-key K/V tiles by TMA into a ring of stages with
  ``mbarrier``s.  P enters PV as two bf16 terms (hi + lo, p to 2^-17):
  rounded once, as the Pallas kernel does, it is off by up to 2^-9 per
  weight, which on rows with a few live keys is more than the attention
  check allows.  It takes a call when the dtype is bf16, D ≤ 128 with
  D % 8 == 0, every data pointer is 16-byte aligned and every batch, head
  and sequence stride of an axis longer than 1 is a multiple of 8
  elements: TMA needs all that.
- ``"simt"`` (``csrc/flash_attention_panel.cu``): the CUDA-core kernel in
  f32 arithmetic, for everything else — every f32 call, bf16 with D in
  (128, 256], and bf16 views that the 16-byte copies cannot read.  Each
  thread holds a 4 × 4 tile of S and its 4 rows of O in registers, fed by
  16-byte shared loads; the softmax stays in registers within a warp; a
  two-stage ``cp.async`` ring brings 32-key K/V tiles (16-byte copies
  where the rows allow, 4-byte ones otherwise; bf16 by plain loads,
  converted as staged); blocks of 12 warps on 192 query rows (4 warps on
  64 rows above D = 128).  f32 stays off the tensor cores: without TF32,
  which the port forbids, they take no IEEE f32 operands.

Both take blocks of query rows per (batch × query head), skip tiles
without a live pair, give rows without a live key the mean of V from a
separate sweep, read kv head ``h // G`` for query head ``h`` and take the
layout as strides, so there is no copy of K/V per query head and no
head-major copy of the model-layout tensors.  The output is in q's
dtype.  A failed build or launch raises; there is no fallback from one
route to the other.  A tensor on the CPU takes the plain version and
counts no launch.

Training (``flash_attention(..., lse=)`` and ``flash_attention_backward``).
Given an f32 (B, H, Sq) ``lse``, both forward kernels also write each
row's log-sum-exp of the scaled scores from the (m, l) they keep anyway;
a row with no live key gets +inf there.  Without it their output is bit
for bit what it was.  ``flash_attention_backward`` is FlashAttention-2's
backward (a pre-pass for D = rowsum(dO ∘ O), a dK/dV kernel per key block
looping over the group's query heads, a dQ kernel per query block, no
atomic adds) on two routes, chosen by ``backward_route``: ``route`` over
all eight views (q, k, v, o, dO, dq, dk, dv).

- ``"mma"`` (``csrc/flash_attention_bwd_mma.cu``): bf16 on the tensor
  cores, ``mma.sync`` with f32 sums; P and dS stay in registers as the A
  operands of the dV, dK and dQ products, as two bf16 terms (hi + lo, the
  forward's PV split); Q/dO or K/V tiles through a two-stage ``cp.async``
  ring; the dK/dV and dQ blocks in one grid.
- ``"simt"`` (``csrc/flash_attention_bwd.cu``): the CUDA cores in f32
  arithmetic, for every f32 call, bf16 with D in (128, 256] and the views
  the 16-byte copies refuse.

Its bound on the H100 is operations: 10·D FLOPs per live pair and head,
515.5 GFLOP for qwen2-1.5b's attention at S = 8192 (0.52 ms at the bf16
tensor-core peak, 7.69 ms at the f32 peak).  A row with no live key adds
dO / Sk to every key's dV and nothing to dQ or dK, as autograd through
the plain version gives.  ``flash_attention_backward_simt`` runs the
CUDA-core kernel on any CUDA call: the card's oracle of the tensor-core
route, called by no path.

``flash_attention_mma_v1`` runs the first tensor-core kernel
(``csrc/flash_attention_mma.cu``: ``mma.sync`` m16n8k16, 64 query rows and
64-key tiles a block, a two-stage ``cp.async`` ring, ldmatrix operands) on
any call the ``"mma"`` route takes; the card's tests and ``chip_smoke.py``
hold the ``wgmma`` kernel to it.  Nothing else calls it.

``flash_attention_scalar`` runs the earlier CUDA-core kernel
(``csrc/flash_attention.cu``: scalar shared loads, five barriers per
32-key tile) on any call the ``"simt"`` route takes; the card's tests and
``chip_smoke.py`` hold the new kernel to it.  Nothing else calls it.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention", "flash_attention_backward", "flash_attention_backward_simt", "flash_attention_mma_v1",
           "flash_attention_scalar", "route", "backward_route", "MAX_HEAD_DIM", "MMA_MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, in all and per route (chip_smoke.py reads them)
launches = 0
launches_mma = 0
launches_simt = 0
launches_mma_v1 = 0  # launches of the first tensor-core kernel, through flash_attention_mma_v1 only
launches_scalar = 0  # launches of the earlier CUDA-core kernel, through flash_attention_scalar only
launches_bwd = 0  # calls of the backward (its launches counted once a call), in all and per route
launches_bwd_mma = 0
launches_bwd_simt = 0


def route(dtype: torch.dtype, head_dim: int, shapes, strides, data_ptrs) -> str:
    """The kernel a CUDA call takes: ``"mma"`` or ``"simt"`` (see the module
    docstring).  ``shapes`` and ``strides`` hold the (B, heads, S, D)
    shapes and element strides of the q, k, v and out views, ``data_ptrs``
    their addresses.  The stride of an axis of length 1 is never used, so
    it is not checked."""
    if dtype != torch.bfloat16 or head_dim > MMA_MAX_HEAD_DIM or head_dim % 8:
        return "simt"
    if any(p % 16 for p in data_ptrs):
        return "simt"
    for shape, stride in zip(shapes, strides, strict=True):
        if any(n > 1 and st % 8 for n, st in zip(shape[:3], stride[:3], strict=True)):
            return "simt"
    return "mma"


def backward_route(q, k, v, o, do, dq, dk, dv) -> str:
    """The backward kernel a CUDA call takes: ``route`` over all eight
    (B, heads, S, D) views, from their dtype, shapes, strides and data
    pointers alone."""
    views = (q, k, v, o, do, dq, dk, dv)
    return route(q.dtype, q.shape[3], [t.shape for t in views], [t.stride() for t in views],
                 [t.data_ptr() for t in views])


def _checked(q, k, v, qpos, kpos, out) -> bool:
    """Validate; True for the card, False for the CPU (plain version)."""
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
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return True


def _checked_lse(lse, q):
    B, H, Sq, _ = q.shape
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous f32 ({B}, {H}, {Sq}) tensor on {q.device}")


def _launch(entry: str, which: str, q, k, v, qpos, kpos, causal, window, out, lse=None) -> bool:
    """Run the C entry ``entry`` of the kernel library on CUDA tensors that
    ``_checked`` passed, into ``out`` (and ``lse`` where the entry takes
    it: every entry but the scalar kernel's); False when there is nothing
    to do (B or Sq is 0)."""
    views = (q, k, v, out)
    if any(t.stride(-1) != 1 for t in views) or not (qpos.is_contiguous() and kpos.is_contiguous()):
        raise ValueError("flash_attention wants contiguous features and contiguous positions")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B * H > 65535 or max(Sq, Sk) >= 2**31:
        raise ValueError(f"flash_attention kernel takes B*H <= 65535, got {B * H}")
    if not (B and Sq):
        return False
    strides = [s for t in views for s in t.stride()[:3]]
    ptrs = [out.data_ptr()] + ([] if which == "scalar" else [None if lse is None else lse.data_ptr()])
    with torch.cuda.device(q.device):
        code = getattr(_build.load(), entry)(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            *ptrs, B, H, KV, Sq, Sk, D, *strides, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), 1.0 / math.sqrt(D), _build.current_stream(q.device))
    _build.check(code, f"flash_attention ({which})")
    return True


def flash_attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int | None = None,
                    out: torch.Tensor | None = None, lse: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, H, Sq, D), k and v (B, KV, Sk, D) with H a multiple of KV,
    f32 or bf16 views with contiguous features; qpos (B, Sq) and kpos
    (B, Sk) int32.  Query head h attends with kv head h // (H / KV).
    Returns (B, H, Sq, D) in q's dtype, written into ``out`` (a view of
    that shape, features contiguous) when given; each row's log-sum-exp
    (+inf without a live key) goes into ``lse``, a contiguous f32
    (B, H, Sq) tensor, when given."""
    global launches, launches_mma, launches_simt
    _checked_lse(lse, q)
    if not _checked(q, k, v, qpos, kpos, out):
        if lse is not None:
            lse.copy_(_ref.gqa_flash_lse(q, k, qpos, kpos, causal, window))
        res = _ref.gqa_flash_attention(q, k, v, qpos, kpos, causal, window)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    views = (q, k, v, out)
    which = route(q.dtype, q.shape[3], [t.shape for t in views], [t.stride() for t in views],
                  [t.data_ptr() for t in views])
    entry = "repro_flash_attention_wgmma" if which == "mma" else "repro_flash_attention_panel"
    if _launch(entry, which, q, k, v, qpos, kpos, causal, window, out, lse):
        launches += 1
        if which == "mma":
            launches_mma += 1
        else:
            launches_simt += 1
    return out


def flash_attention_mma_v1(q, k, v, qpos, kpos, *, causal: bool = True, window: int | None = None,
                           out: torch.Tensor | None = None, lse: torch.Tensor | None = None) -> torch.Tensor:
    """``flash_attention`` through the first tensor-core kernel
    (``csrc/flash_attention_mma.cu``), CUDA tensors the ``"mma"`` route
    takes only: the card's oracle of the ``wgmma`` kernel."""
    global launches_mma_v1
    _checked_lse(lse, q)
    if not _checked(q, k, v, qpos, kpos, out):
        raise ValueError("flash_attention_mma_v1 runs the first tensor-core kernel: it takes CUDA tensors only")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    views = (q, k, v, out)
    if route(q.dtype, q.shape[3], [t.shape for t in views], [t.stride() for t in views],
             [t.data_ptr() for t in views]) != "mma":
        raise ValueError("flash_attention_mma_v1 takes only the calls of the tensor-core route")
    if _launch("repro_flash_attention_mma", "mma_v1", q, k, v, qpos, kpos, causal, window, out, lse):
        launches_mma_v1 += 1
    return out


def flash_attention_scalar(q, k, v, qpos, kpos, *, causal: bool = True, window: int | None = None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """``flash_attention`` through the earlier CUDA-core kernel, CUDA
    tensors only: the card's oracle of the ``"simt"`` route."""
    global launches_scalar
    if not _checked(q, k, v, qpos, kpos, out):
        raise ValueError("flash_attention_scalar runs the earlier CUDA-core kernel: it takes CUDA tensors only")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if _launch("repro_flash_attention", "scalar", q, k, v, qpos, kpos, causal, window, out):
        launches_scalar += 1
    return out


def _backward_args(q, k, v, o, lse, do, qpos, kpos, dq, dk, dv):
    """Validate the backward's arguments; the gradient buffers (new
    contiguous tensors where None) and True for the card, False for the
    CPU."""
    on_card = _checked(q, k, v, qpos, kpos, o)
    _checked_lse(lse, q)
    if lse is None or do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("flash_attention_backward: lse is required and do must match q")
    grads = []
    for t, want in ((dq, q), (dk, k), (dv, v)):
        if t is None:
            t = torch.empty_like(want, memory_format=torch.contiguous_format)
        elif t.shape != want.shape or t.dtype != want.dtype or t.device != want.device:
            raise ValueError("flash_attention_backward: a gradient buffer does not match its input")
        grads.append(t)
    return grads, on_card


def _launch_bwd(entry: str, q, k, v, o, lse, do, qpos, kpos, causal, window, grads) -> bool:
    """Run the backward's C entry ``entry`` on CUDA tensors that
    ``_backward_args`` passed; False when there is nothing to do (B or Sq
    is 0: the gradients are zeroed)."""
    views = (q, k, v, o, do, *grads)
    if any(t.stride(-1) != 1 for t in views) or not (qpos.is_contiguous() and kpos.is_contiguous()):
        raise ValueError("flash_attention_backward wants contiguous features and contiguous positions")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B * H > 65535:
        raise ValueError(f"flash_attention_backward takes B*H <= 65535, got {B * H}")
    if not (B and Sq):
        for g in grads:
            g.zero_()
        return False
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s for t in views for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        code = getattr(_build.load(), entry)(
            _DTYPES[q.dtype], *(t.data_ptr() for t in (q, k, v, o, do, qpos, kpos, lse, delta, *grads)),
            B, H, KV, Sq, Sk, D, *strides, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), 1.0 / math.sqrt(D), _build.current_stream(q.device))
    _build.check(code, f"flash_attention_backward ({entry})")
    return True


def flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, *, causal: bool = True, window: int | None = None,
                             dq: torch.Tensor | None = None, dk: torch.Tensor | None = None,
                             dv: torch.Tensor | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention``'s output against
    ``do``: q, o, do (B, H, Sq, D), k and v (B, KV, Sk, D) views of one
    dtype with contiguous features, ``lse`` the forward's f32 (B, H, Sq),
    the same positions and masks.  Each gradient is written into the view
    given for it (features contiguous), or a new tensor, in the inputs'
    dtype.  A CUDA call takes the kernel ``backward_route`` names; a CPU
    call takes the plain version and counts no launch."""
    global launches_bwd, launches_bwd_mma, launches_bwd_simt
    grads, on_card = _backward_args(q, k, v, o, lse, do, qpos, kpos, dq, dk, dv)
    if not on_card:
        for t, g in zip(grads, _ref.gqa_flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal, window),
                        strict=True):
            t.copy_(g)
        return tuple(grads)
    which = backward_route(q, k, v, o, do, *grads)
    entry = "repro_flash_attention_bwd_mma" if which == "mma" else "repro_flash_attention_bwd"
    if _launch_bwd(entry, q, k, v, o, lse, do, qpos, kpos, causal, window, grads):
        launches_bwd += 1
        if which == "mma":
            launches_bwd_mma += 1
        else:
            launches_bwd_simt += 1
    return tuple(grads)


def flash_attention_backward_simt(q, k, v, o, lse, do, qpos, kpos, *, causal: bool = True,
                                  window: int | None = None, dq: torch.Tensor | None = None,
                                  dk: torch.Tensor | None = None, dv: torch.Tensor | None = None):
    """``flash_attention_backward`` through the CUDA-core kernel whatever
    the route, CUDA tensors only: the card's oracle of the tensor-core
    route.  Counts no launch."""
    grads, on_card = _backward_args(q, k, v, o, lse, do, qpos, kpos, dq, dk, dv)
    if not on_card:
        raise ValueError("flash_attention_backward_simt runs the CUDA-core kernel: it takes CUDA tensors only")
    _launch_bwd("repro_flash_attention_bwd", q, k, v, o, lse, do, qpos, kpos, causal, window, grads)
    return tuple(grads)
