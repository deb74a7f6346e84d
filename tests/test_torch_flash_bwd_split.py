"""The tensor-core flash backward's rounding, modelled on the CPU and held
against the JAX package.

``ref.gqa_flash_attention_backward_mma`` models the arithmetic of
``csrc/flash_attention_bwd_mma.cu``: bf16 operands, f32 sums, P (into dV)
and dS (into dK and dQ) entering the products as two bf16 terms (hi +
lo) or, with ``split=False``, rounded once, and the gradients rounded
once to bf16.  On ``test_torch_train.py``'s five ``FLASH_BWD`` shapes and
a qwen2-like narrow GQA shape (12/2 heads), from numpy seeds, with the
inputs rounded to bf16 and the saved output O rounded to bf16 as the
forward kernel writes it:

- the split reads ≤ 1 against the plain backward on the same saved
  tensors under ``chip_smoke.py``'s ``[train]`` limits (``grad_reading``
  in bf16: 2^-7 of each |value| plus 1e-3 of the tensor's root mean
  square);
- the split reads ≤ 1 against ``jax.grad`` through the reference's f32
  ``_flash_sdpa`` (blocks of 16, as ``test_torch_train.py`` runs it) with
  ``[train]``'s allowance, twice |plain − JAX| elementwise: what Δ from
  the rounded O moves the plain version and, on rows with no live key,
  what the reference's finite −1e30 bias passes through the masked
  scores (the port passes nothing) and its mean over the 16-key padding;
- a causal mask shifted by one (non-causal: the mask switched on) reads
  > 1.

The single rounding's reading is printed for PERF.md
(``python -m pytest -s -q tests/test_torch_flash_bwd_split.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import FLASH_BWD, _flash_inputs

from repro.models.layers import _flash_sdpa
from repro_torch.kernels import ref as tref

SHAPES = dict(FLASH_BWD, **{"qwen2-like GQA": (1, 12, 2, 96, 96, 32, True, None, 0, 0, 0)})


def _reading(got, want, allow=None):
    """``chip_smoke.py``'s ``grad_reading`` in bf16 (passing while ≤ 1)."""
    got, want = got.float(), want.float()
    lim = 2.0**-7 * want.abs() + max(1e-3 * float(want.square().mean().sqrt()), 1e-30)
    if allow is not None:
        lim = lim + allow
    return float(((got - want).abs() / lim).max())


def _jax_grads(q, k, v, do, qpos, kpos, causal, window):
    """jax.grad of <_flash_sdpa(q, k, v), do> in f32, in the port's
    head-major layout."""
    q, k, v, do = (jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v, do))

    def loss(q, k, v, qpos, kpos):
        return jnp.sum(_flash_sdpa(q, k, v, qpos, kpos, causal, window, cq=16, ck=16) * do)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v, jnp.asarray(qpos.numpy()), jnp.asarray(kpos.numpy()))
    return [torch.from_numpy(np.array(g)).transpose(1, 2) for g in grads]


@pytest.mark.parametrize("case", SHAPES, ids=list(SHAPES))
def test_split_rounding_against_plain_and_jax(case):
    B_, H, KV, Sq, Sk, D, causal, window, dead_head, dead_tail, off = SHAPES[case]
    q, k, v, do, qpos, kpos = (t.to(torch.bfloat16) if t.is_floating_point() else t
                               for t in _flash_inputs(B_, H, KV, Sq, Sk, D, dead_head, dead_tail, off))
    o = tref.gqa_flash_attention(q.float(), k.float(), v.float(), qpos, kpos, causal, window).to(torch.bfloat16)
    lse = tref.gqa_flash_lse(q.float(), k.float(), qpos, kpos, causal, window)
    plain = tref.gqa_flash_attention_backward(*(t.float() for t in (q, k, v, o)), lse, do.float(), qpos, kpos,
                                              causal, window)
    split = tref.gqa_flash_attention_backward_mma(q, k, v, o, lse, do, qpos, kpos, causal, window)
    once = tref.gqa_flash_attention_backward_mma(q, k, v, o, lse, do, qpos, kpos, causal, window, split=False)
    want = _jax_grads(*(t.float() for t in (q, k, v, do)), qpos, kpos, causal, window)
    wrong = tref.gqa_flash_attention_backward_mma(q, k, v, o, lse, do, qpos + 1 if causal else qpos, kpos, True,
                                                  window)
    own = max(_reading(s, p) for s, p in zip(split, plain, strict=True))
    jax_ = max(_reading(s, w, allow=2 * (p - w).abs()) for s, p, w in zip(split, plain, want, strict=True))
    bad = max(_reading(x, p) for x, p in zip(wrong, plain, strict=True))
    single = max(_reading(x, p) for x, p in zip(once, plain, strict=True))
    print(f"\n{case}: split {own:.4f} against the plain backward, {jax_:.4f} against jax.grad; rounded once "
          f"{single:.4f}; a wrong mask {bad:.4g}")
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in split)
    assert own <= 1 and jax_ <= 1
    assert bad > 1


def test_bf16_terms_carry_the_value():
    """hi + lo carries x to 2^-17 relative; rounded once, to 2^-8 (bf16's
    8-bit significand), more than 2^-9 on some value."""
    x = torch.from_numpy(np.random.default_rng(11).uniform(-4, 4, size=4096).astype(np.float32))
    split, once = tref.bf16_terms(x), tref.bf16_terms(x, split=False)
    assert float(((split - x).abs() / x.abs()).max()) <= 2.0**-17
    assert 2.0**-9 < float(((once - x).abs() / x.abs()).max()) <= 2.0**-8
