"""The port's GQA flash attention against the JAX package's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` (model layout; on a CPU
tensor the plain version its kernel wrapper takes) is held against
``repro.kernels.ops.flash_attention`` with the Pallas kernel in
interpret mode (small blocks, S ≤ 256) and against the jnp oracle
``repro.kernels.ref.flash_attention`` (head-major, K/V expanded per
query head), on the same numpy inputs from a seed: causal, sliding
window, dead keys (``kpos < 0``), GQA group sizes 1 and 3, Sq ≠ Sk,
sequence lengths and head dims that are not powers of two.

A row with no live key is where the two JAX paths part: the oracle gives
the uniform mean of V over the real keys, while the Pallas path pads K/V
with zero rows up to its key block, so its answer there depends on the
block size.  The port follows the oracle: it is held to the oracle on
every row and to the Pallas path on rows with at least one live key.

Tolerances: f32 within rtol 1e-4 and atol 2e-4 (as in
tests/test_flash_attention.py); bf16 within rtol 2e-2 and atol 2e-3, two
bf16 ulps (2^-7 relative each) of the value, not the flat atol 3e-2 of
that file, which a whole output value (~0.1–0.3 at these lengths) nearly
fits under.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as tops

BF16 = ml_dtypes.bfloat16

# (B, Sq, Sk, H, KV, Dh, causal, window, dead key tail)
CASES = {
    "causal-gqa3": (2, 48, 48, 6, 2, 16, True, None, 0),
    "window-gqa1": (1, 50, 50, 3, 3, 24, True, 11, 0),
    "cross-sq-ne-sk": (1, 40, 72, 6, 2, 20, False, None, 0),
    "dead-tail-window": (2, 33, 45, 3, 1, 12, True, 7, 9),
}


def _inputs(rng, B, Sq, Sk, H, KV, Dh, dead, np_dtype=np.float32):
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np_dtype)
    k = rng.normal(size=(B, Sk, KV, Dh)).astype(np_dtype)
    v = rng.normal(size=(B, Sk, KV, Dh)).astype(np_dtype)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + (Sk - Sq if Sk > Sq else 0), (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    if dead:
        kpos[:, Sk - dead:] = -1
    return q, k, v, qpos, kpos


def _torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _live(qpos, kpos, causal, window):
    """(B, Sq, Sk) mask of live (query, key) pairs."""
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    live = (kp >= 0) & np.ones_like(qp, bool)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= kp > qp - window
    return live


def _oracle(q, k, v, qpos, kpos, causal, window):
    """repro.kernels.ref.flash_attention on the head-major layout, K/V
    expanded per query head, back in the model layout."""
    B, Sq, H, Dh = q.shape
    G = H // k.shape[2]
    hm = lambda a: jnp.asarray(np.moveaxis(a, 2, 1).reshape(-1, a.shape[1], Dh))  # noqa: E731
    kx, vx = (np.repeat(a, G, axis=2) for a in (k, v))
    out = jref.flash_attention(hm(q), hm(kx), hm(vx), jnp.asarray(np.repeat(qpos, H, 0)),
                               jnp.asarray(np.repeat(kpos, H, 0)), causal=causal, window=window)
    return np.moveaxis(np.asarray(out).reshape(B, H, Sq, Dh), 1, 2)


def _close(got, want, dtype, rows=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_and_oracle(rng, case, dtype):
    B, Sq, Sk, H, KV, Dh, causal, window, dead = CASES[case]
    np_dtype = np.float32 if dtype == "f32" else BF16
    q, k, v, qpos, kpos = _inputs(rng, B, Sq, Sk, H, KV, Dh, dead, np_dtype)
    got = tops.flash_attention(*map(_torch, (q, k, v, qpos, kpos)), causal=causal, window=window)
    assert got.shape == (B, Sq, H, Dh) and got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    got = got.float().numpy()
    pallas = jops.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window, bq=16, bk=16)
    assert pallas.dtype == q.dtype
    live_rows = _live(qpos, kpos, causal, window).any(-1)
    _close(got, pallas, dtype, live_rows)
    _close(got, _oracle(q, k, v, qpos, kpos, causal, window), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fully_masked_rows_follow_the_oracle(rng, dtype):
    """Queries whose every key is dead or in the future: the uniform mean
    of V over the real keys, never NaN."""
    np_dtype = np.float32 if dtype == "f32" else BF16
    q, k, v, qpos, kpos = _inputs(rng, 1, 37, 37, 4, 2, 10, 0, np_dtype)
    kpos[:, :6] = -1  # queries 0..5 see only dead keys
    got = tops.flash_attention(*map(_torch, (q, k, v, qpos, kpos)), causal=True).float().numpy()
    want = _oracle(q, k, v, qpos, kpos, True, None)
    dead_rows = ~_live(qpos, kpos, True, None).any(-1)
    assert dead_rows.sum() == 6 and np.isfinite(got).all()
    _close(got, want, dtype)
    mean_v = np.repeat(np.asarray(v, np.float32).mean(axis=1), 2, axis=1)  # (B, H, Dh)
    _close(got[:, :6], np.broadcast_to(mean_v[:, None], got[:, :6].shape), dtype)


def test_default_and_1d_positions(rng):
    """Default positions are arange; 1-D positions broadcast over the batch."""
    q, k, v, qpos, _ = _inputs(rng, 2, 40, 40, 6, 3, 8, 0)
    tq, tk, tv = map(_torch, (q, k, v))
    base = tops.flash_attention(tq, tk, tv, window=9)
    pos = torch.arange(40)
    torch.testing.assert_close(tops.flash_attention(tq, tk, tv, pos, pos, window=9), base, rtol=0, atol=0)
    pallas = jops.flash_attention(q, k, v, window=9, bq=16, bk=16)
    _close(base.numpy(), pallas, "f32")


def test_head_major_kernel_wrapper(rng):
    """The kernel module's own layout: (B, H, S, D) views, kv head h // G."""
    q, k, v, qpos, kpos = _inputs(rng, 1, 24, 24, 6, 2, 8, 0)
    hm = lambda a: _torch(a).transpose(1, 2)  # noqa: E731
    got = t_fa.flash_attention(hm(q), hm(k), hm(v), _torch(qpos), _torch(kpos), causal=True)
    want = _oracle(q, k, v, qpos, kpos, True, None)
    _close(got.transpose(1, 2).numpy(), want, "f32")


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    pos = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_fa.flash_attention(q.half(), kv.half(), kv.half(), pos, pos)
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16), pos, pos)
    with pytest.raises(ValueError):
        t_fa.flash_attention(torch.zeros(1, 4, 8, 264), torch.zeros(1, 2, 8, 264),
                             torch.zeros(1, 2, 8, 264), pos, pos)
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, kv, kv, pos.long(), pos)
