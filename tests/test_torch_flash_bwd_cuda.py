"""The flash attention backward kernels and the training path on the card.

``kernels/flash_attention.py::flash_attention_backward`` on both routes
(``csrc/flash_attention_bwd_mma.cu`` on the tensor cores for bf16 with
D <= 128, ``csrc/flash_attention_bwd.cu`` on the CUDA cores otherwise)
against its plain version on the same saved output and log-sum-exp, and
against autograd through the plain forward; the tensor-core route also
against the CUDA-core kernel (``flash_attention_backward_simt``) on the
same inputs; the forward kernels' ``lse`` against the plain log-sum-exp,
their output bit for bit what it is without it; ``ops.FlashAttentionFn``
under autograd on the card; a train step on the card against the same
step on the CPU.  The limits are chip_smoke.py's
``[train]`` readings: in bf16 2^-7 of each |value| (the gradients are
rounded once to bf16, up to 2^-8) plus 1e-3 of the tensor's root mean
square; in f32 1e-4 and 1e-4 (the sums' order); against autograd plus
twice what Δ = rowsum(dO ∘ O) from the saved (in bf16, rounded) O moves
the plain version.

Needs an NVIDIA GPU (marker ``cuda``; skips without one):

    python -m pytest -m cuda -q tests/test_torch_flash_bwd_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as M
from repro_torch.train import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _reading(got, want, dt, allow=None):
    rtol, atol = (1e-4, 1e-4) if dt == "f32" else (2.0**-7, 1e-3)
    got, want = got.float(), want.float()
    lim = rtol * want.abs() + max(atol * float(want.square().mean().sqrt()), 1e-30)
    if allow is not None:
        lim = lim + allow
    return float(((got - want).abs() / lim).max())


def _inputs(dev, dt, B, Sq, Sk, H, KV, D, dead_head, dead_tail, causal, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, H, Sq, D, generator=gen, device=dev).to(DTYPES[dt]) for _ in range(2))
    k, v = (torch.randn(B, KV, Sk, D, generator=gen, device=dev).to(DTYPES[dt]) for _ in range(2))
    qpos = (torch.arange(Sq, device=dev, dtype=torch.int32) + (Sk - Sq if causal else 0)).expand(B, Sq).contiguous()
    kpos = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
    kpos[:, :dead_head] = -1
    kpos[:, Sk - dead_tail:] = -1
    return q, k, v, do, qpos, kpos


CASES = [  # (dtype, B, Sq, Sk, H, KV, D, causal, window, dead keys at the head, at the tail)
    ("bf16", 1, 300, 311, 3, 1, 8, True, None, 0, 0),
    ("bf16", 2, 300, 311, 6, 1, 64, True, None, 20, 7),
    ("bf16", 1, 300, 311, 4, 4, 120, True, 33, 0, 9),
    ("bf16", 2, 300, 311, 6, 2, 128, True, 100, 20, 7),
    ("bf16", 2, 129, 700, 3, 3, 32, True, 64, 40, 0),
    ("bf16", 2, 100, 311, 4, 2, 64, False, None, 0, 9),
    ("bf16", 1, 200, 200, 4, 2, 256, True, None, 0, 0),
    ("bf16", 1, 130, 130, 4, 2, 200, True, 50, 0, 0),
    ("f32", 2, 300, 311, 6, 2, 128, True, 100, 20, 7),
    ("f32", 1, 257, 257, 4, 1, 17, True, None, 0, 0),
    ("f32", 1, 64, 1601, 8, 2, 128, False, None, 0, 0),
    ("f32", 1, 100, 120, 2, 2, 256, True, None, 30, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,B,Sq,Sk,H,KV,D,causal,window,dead_head,dead_tail", CASES)
def test_backward_against_plain(cuda_device, dt, B, Sq, Sk, H, KV, D, causal, window, dead_head, dead_tail):
    """G in {1, 2, 3, 4, 6}, D in every bucket (8 to 256, 17 and 200 off a
    multiple of 8), Sq != Sk, windows, no causal mask, dead keys at the
    head (rows with no live key: +inf lse, dO / Sk into dV) and the tail;
    both forward routes; bit for bit on repeat; a causal mask off by one
    rejected."""
    q, k, v, do, qpos, kpos = _inputs(cuda_device, dt, B, Sq, Sk, H, KV, D, dead_head, dead_tail, causal)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda_device)
    o0 = t_fa.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window)
    o = t_fa.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window, lse=lse)
    assert torch.equal(o, o0)
    want_lse = tref.gqa_flash_lse(q, k, qpos, kpos, causal, window)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isinf(lse), ~fin) and bool((lse[~fin] > 0).all())
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-5 * max(1.0, float(want_lse[fin].abs().max()))
    before = (t_fa.launches_bwd, t_fa.launches_bwd_mma)
    got = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal=causal, window=window)
    again = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal=causal, window=window)
    torch.cuda.synchronize()
    mma = dt == "bf16" and D <= 128 and D % 8 == 0
    assert (t_fa.launches_bwd, t_fa.launches_bwd_mma) == (before[0] + 2, before[1] + 2 * mma)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(g.dtype == q.dtype and bool(torch.isfinite(g).all()) for g in got)
    f32 = [t.float() for t in (q, k, v, o)]
    plain = tref.gqa_flash_attention_backward(*f32, lse, do.float(), qpos, kpos, causal, window)
    leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    tref.gqa_flash_attention(*leaves, qpos, kpos, causal, window).backward(do.float())
    for g, pl, lf in zip(got, plain, leaves):
        assert _reading(g, pl, dt) <= 1
        assert _reading(g, lf.grad, dt, allow=2 * (pl - lf.grad).abs()) <= 1
    if causal:
        wrong = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos + 1, kpos, causal=causal, window=window)
        assert max(_reading(w, pl, dt) for w, pl in zip(wrong, plain)) > 1


MMA_CASES = [  # bf16: (B, Sq, Sk, H, KV, D, causal, window, dead keys at the head, at the tail)
    (1, 300, 1601, 6, 1, 128, False, None, 0, 0),
    (2, 333, 1601, 8, 2, 64, True, None, 40, 17),
    (2, 300, 311, 6, 1, 64, True, None, 20, 7),
    (1, 300, 311, 4, 4, 120, True, 33, 0, 9),
    (1, 1000, 1000, 8, 2, 120, True, 300, 0, 0),
    (1, 2048, 2048, 12, 2, 128, True, None, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,dead_head,dead_tail", MMA_CASES)
def test_mma_backward_against_simt(cuda_device, B, Sq, Sk, H, KV, D, causal, window, dead_head, dead_tail):
    """The tensor-core route against the CUDA-core kernel on the same
    saved tensors, the plain backward and autograd, with the same limits:
    both head-width buckets (64, 128; 120 padded), Sq and Sk off a
    multiple of 64 (Sk = 1601), dead keys at the head (rows with no live
    key) and the tail, a window, G in {1, 4, 6}; bit for bit on repeat; a
    causal mask off by one rejected."""
    q, k, v, do, qpos, kpos = _inputs(cuda_device, "bf16", B, Sq, Sk, H, KV, D, dead_head, dead_tail, causal, seed=7)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda_device)
    o = t_fa.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window, lse=lse)
    before = (t_fa.launches_bwd, t_fa.launches_bwd_mma, t_fa.launches_bwd_simt)
    got = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal=causal, window=window)
    again = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos, causal=causal, window=window)
    simt = t_fa.flash_attention_backward_simt(q, k, v, o, lse, do, qpos, kpos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (t_fa.launches_bwd, t_fa.launches_bwd_mma, t_fa.launches_bwd_simt) == (
        before[0] + 2, before[1] + 2, before[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in got)
    f32 = [t.float() for t in (q, k, v, o)]
    plain = tref.gqa_flash_attention_backward(*f32, lse, do.float(), qpos, kpos, causal, window)
    leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    tref.gqa_flash_attention(*leaves, qpos, kpos, causal, window).backward(do.float())
    for g, sm, pl, lf in zip(got, simt, plain, leaves):
        assert _reading(g, sm, "bf16") <= 1
        assert _reading(g, pl, "bf16") <= 1
        assert _reading(g, lf.grad, "bf16", allow=2 * (pl - lf.grad).abs()) <= 1
    if causal:
        wrong = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos + 1, kpos, causal=causal, window=window)
        assert max(_reading(w, pl, "bf16") for w, pl in zip(wrong, plain)) > 1


@pytest.mark.cuda
def test_mma_long_sums_against_simt(cuda_device):
    """qwen2-1.5b's attention at S = 8192 (12/2 heads of 128, causal): the
    early keys' dK and dV sum 49,152 rows.  Kept in the tensor cores'
    accumulators over the whole sweep (their f32 sums are not rounded to
    nearest) they read 1.29 against the CUDA-core kernel; each tile is
    summed from zero and added in round-to-nearest f32.  The plain
    backward at this size builds several (1, 2, 6, 8192, 8192) f32
    tensors of 3.2 GB, so the CUDA-core kernel is the reference here
    (chip_smoke.py [train] holds both to the plain backward, per kv
    head)."""
    B, S, H, KV, D = 1, 8192, 12, 2, 128
    q, k, v, do, qpos, kpos = _inputs(cuda_device, "bf16", B, S, S, H, KV, D, 0, 0, True, seed=8)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda_device)
    o = t_fa.flash_attention(q, k, v, qpos, kpos, lse=lse)
    got = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos)
    again = t_fa.flash_attention_backward(q, k, v, o, lse, do, qpos, kpos)
    simt = t_fa.flash_attention_backward_simt(q, k, v, o, lse, do, qpos, kpos)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert max(_reading(g, sm, "bf16") for g, sm in zip(got, simt)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_autograd_function_on_the_card(cuda_device, dt):
    """ops.flash_attention under grad: one forward launch with lse, one
    backward (bf16 on the tensor-core route, f32 on the CUDA cores), the
    gradients in the model layout bit for bit the wrappers' own on the
    same tensors (f32: also against the CPU's autograd through the plain
    version); without grad the forward alone."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, S, H, KV, D = 2, 200, 6, 2, 64
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=cuda_device).to(DTYPES[dt]) for h in (H, KV, KV, H))
    t_fa.launches = t_fa.launches_mma = t_fa.launches_simt = t_fa.launches_bwd = 0
    t_fa.launches_bwd_mma = t_fa.launches_bwd_simt = 0
    with torch.no_grad():
        tops.flash_attention(q, k, v, window=50)
    assert (t_fa.launches, t_fa.launches_bwd) == (1, 0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, window=50)
    out.backward(do)
    torch.cuda.synchronize()
    assert (t_fa.launches, t_fa.launches_bwd) == (2, 1)
    assert t_fa.launches_mma == (2 if dt == "bf16" else 0)
    assert (t_fa.launches_bwd_mma, t_fa.launches_bwd_simt) == ((1, 0) if dt == "bf16" else (0, 1))
    pos = torch.arange(S, device=cuda_device, dtype=torch.int32).expand(B, S).contiguous()
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda_device)
    o = t_fa.flash_attention(*heads, pos, pos, window=50, lse=lse)
    assert torch.equal(o.transpose(1, 2), out.detach())
    direct = t_fa.flash_attention_backward(*heads, o, lse, do.transpose(1, 2), pos, pos, window=50)
    for lf, d in zip(leaves, direct):
        assert lf.grad.shape == lf.shape and lf.grad.is_contiguous() and torch.equal(lf.grad, d.transpose(1, 2))
    if dt == "f32":
        cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
        tops.flash_attention(*cpu, window=50).backward(do.cpu())
        assert all(_reading(lf.grad.cpu(), c.grad, dt) <= 1 for lf, c in zip(leaves, cpu))


@pytest.mark.cuda
def test_train_step_card_against_cpu(cuda_device):
    """SMOKE qwen2-1.5b in f32 with the flash threshold lowered: three
    AdamW steps on the card (the CUDA-core forward and the backward
    kernel) and on the CPU from the same params and batches."""
    cfg = C.get_smoke("qwen2-1.5b").replace(compute_dtype=torch.float32, flash_threshold=64 * 64, remat="full")
    master = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, size=(2, 97)).astype(np.int64)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        params = _copy(master, dev)
        state, step, losses = adamw_init(params), M.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0)), []
        t_fa.launches_bwd = 0
        for b in batches:
            params, state, m = step(params, state, {k: torch.as_tensor(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs.append((losses, _copy(params, torch.device("cpu")), t_fa.launches_bwd))
    (card, card_p, n_bwd), (cpu, cpu_p, _) = runs
    assert n_bwd == cfg.n_layers * len(batches)
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card, cpu)), (card, cpu)
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p))) <= 2e-3 * 3


def _copy(tree, dev):
    return {k: _copy(v, dev) if isinstance(v, dict) else v.detach().to(dev, copy=True) for k, v in tree.items()}
