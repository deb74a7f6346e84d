"""The wgmma flash forward's arithmetic, modelled on the CPU and held
against the JAX package.

``ref.gqa_flash_attention_wgmma`` models ``csrc/flash_attention_wgmma.cu``
(the tensor-core route of ``kernels/flash_attention.py``): bf16 operands,
an online softmax over 128-key tiles in the log2 domain, P entering P·V as
two bf16 terms (hi + lo) or, with ``split=False``, rounded once, f32 sums,
the output rounded once to bf16.  From numpy seeds, on shapes whose Sq and
Sk are not multiples of the 128-key tile (causal GQA, a sliding window,
a non-causal cross call with Sq ≠ Sk, dead keys at the head and the tail
with rows that meet no live key), it is held under ``chip_smoke.py``'s
bf16 readings (per element |o − want| / (2e-3 + 1e-2·|want|), per row
‖o − want‖ / ‖want‖ over 1e-2; each passes while ≤ 1):

- to the plain version ``ref.gqa_flash_attention`` on every row;
- to the JAX package's Pallas kernel in interpret mode
  (``repro.kernels.ops.flash_attention``, blocks of 128) on rows with a
  live key (its rows without one depend on its padding;
  ``tests/test_torch_flash.py`` says why).

A row whose three live keys carry values that cancel shows what the split
is for: P rounded once (the Pallas kernel's ``p.astype(v.dtype)``) is off
by up to 2^-9 per weight, which there is many times the check's limit,
while hi + lo passes it.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref as tref

BF16 = ml_dtypes.bfloat16

# (B, Sq, Sk, H, KV, Dh, causal, window, dead keys at the head, at the tail)
CASES = {
    "causal-gqa2-d64": (1, 300, 300, 4, 2, 64, True, None, 0, 0),
    "window-gqa4-d120": (1, 260, 260, 4, 1, 120, True, 100, 0, 0),
    "cross-noncausal-d32": (2, 100, 290, 2, 2, 32, False, None, 0, 0),
    "dead-head-tail-d64": (1, 200, 211, 2, 1, 64, True, None, 30, 7),
}


def _reading(o, want):
    """chip_smoke.py's bf16 attention readings (elements, rows)."""
    o, want = o.float(), want.float()
    d = o - want
    elem = float((d.abs() / (2e-3 + 1e-2 * want.abs())).max())
    row = float((d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max()) / 1e-2
    return elem, row


def _inputs(seed, B, Sq, Sk, H, KV, Dh, dead_head, dead_tail):
    """Model-layout bf16 numpy inputs and int32 positions (queries at the
    last Sq key positions)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, h, Dh)).astype(BF16) for S, h in ((Sq, H), (Sk, KV), (Sk, KV)))
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + (Sk - Sq), (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    kpos[:, :dead_head] = -1
    kpos[:, Sk - dead_tail :] = -1
    return q, k, v, qpos, kpos


def _heads(a):
    """A model-layout bf16 numpy array as a head-major torch bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a.astype(np.float32), 2, 1))).to(torch.bfloat16)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain_and_pallas(case):
    B, Sq, Sk, H, KV, Dh, causal, window, dead_head, dead_tail = CASES[case]
    q, k, v, qpos, kpos = _inputs(7, B, Sq, Sk, H, KV, Dh, dead_head, dead_tail)
    hq, hk, hv = map(_heads, (q, k, v))
    tq, tk = torch.from_numpy(qpos), torch.from_numpy(kpos)
    got = tref.gqa_flash_attention_wgmma(hq, hk, hv, tq, tk, causal, window)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    plain = tref.gqa_flash_attention(hq, hk, hv, tq, tk, causal, window)
    elem, row = _reading(got, plain)
    assert elem <= 1 and row <= 1, (elem, row)

    live = (kpos[:, None, :] >= 0) & ((kpos[:, None, :] <= qpos[:, :, None]) | (not causal))
    if window is not None:
        live &= kpos[:, None, :] > qpos[:, :, None] - window
    live_rows = torch.from_numpy(live.any(-1))  # (B, Sq)
    assert bool((~live_rows).any()) == (dead_head > Sk - Sq)
    pallas = jops.flash_attention(q, k, v, qpos, kpos, causal=causal, window=window, bq=128, bk=128)
    pallas = _heads(np.asarray(pallas))
    rows = live_rows[:, None, :].expand(B, H, Sq)
    elem, row = _reading(got[rows], pallas[rows])
    assert elem <= 1 and row <= 1, (elem, row)


def test_split_passes_a_row_whose_values_cancel():
    """Row 2 of a causal call meets keys 0, 1 and 2 only; their values are
    chosen from the row's own softmax weights so that p0·v0 + p1·v1 +
    p2·v2 nearly cancels.  hi + lo reads within the limits; P rounded once
    does not."""
    B, S, H, KV, Dh = 1, 140, 2, 1, 64
    q, k, v, qpos, kpos = _inputs(11, B, S, S, H, KV, Dh, 0, 0)
    hq, hk, hv = map(_heads, (q, k, v))
    s = (hq[0, :, 2].float() @ hk[0, 0, :3].float().T) / math.sqrt(Dh)  # (H, 3) scores of row 2
    p = torch.softmax(s, dim=-1)[0].double()  # head 0's weights
    u = torch.from_numpy(np.random.default_rng(12).uniform(0.5, 1.0, size=Dh))
    vals = [16 * u, -8 * u * p[0] / p[1], -8 * u * p[0] / p[2]]
    for j, val in enumerate(vals):
        hv[0, 0, j] = val.to(torch.bfloat16)
    tq, tk = torch.from_numpy(qpos), torch.from_numpy(kpos)
    plain = tref.gqa_flash_attention(hq, hk, hv, tq, tk, True, None)
    assert float(plain[0, 0, 2].float().abs().max()) < 0.05 * float((16 * u).max())  # it does cancel
    split = tref.gqa_flash_attention_wgmma(hq, hk, hv, tq, tk, True, None)
    once = tref.gqa_flash_attention_wgmma(hq, hk, hv, tq, tk, True, None, split=False)
    elem, row = _reading(split, plain)
    assert elem <= 1 and row <= 1, (elem, row)
    elem, row = _reading(once, plain)
    assert max(elem, row) > 1, (elem, row)


@pytest.mark.parametrize("tile", [64, 128])
def test_tile_width_changes_only_the_rounding(tile):
    """64- and 128-key tiles (the variants' and the shipped kernel's) read
    within the limits of each other and of the plain version on a ragged
    window case."""
    q, k, v, qpos, kpos = _inputs(13, 1, 190, 333, 4, 2, 64, 5, 3)
    hq, hk, hv = map(_heads, (q, k, v))
    tq, tk = torch.from_numpy(qpos), torch.from_numpy(kpos)
    got = tref.gqa_flash_attention_wgmma(hq, hk, hv, tq, tk, True, 150, tile=tile)
    other = tref.gqa_flash_attention_wgmma(hq, hk, hv, tq, tk, True, 150, tile=192 - tile)
    for want in (other, tref.gqa_flash_attention(hq, hk, hv, tq, tk, True, 150)):
        elem, row = _reading(got, want)
        assert elem <= 1 and row <= 1, (elem, row)
