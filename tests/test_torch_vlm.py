"""The port's vision family (llama-3.2-vision) against the JAX package's, on the CPU.

The reference's ``init_params(cfg, PRNGKey(0))`` carried across by
``carry.lm_params_from_reference``, at the SMOKE size (5 layers: one
group of 4 self blocks and a cross block, 8 media tokens).  Both
packages' cross-attention gates are set to 0.5 (they start at 0, where
the branch adds exactly 0) and the media are seeded normals, so the
cross branch moves the logits: ``VisionDecoder.forward``, ``prefill`` and
one ``decode`` step from the reference's carried cache, in f32 (with the
media in bf16 at prefill and decode, as the engine gives them: K/V in
bf16 beside an f32 query) and bf16, and through the flash branch (the
cross-attention non-causal there), under ``tests/test_torch_lm.py``'s
bounds; then ``ServeEngine``'s greedy tokens against the JAX
``ServeEngine``'s (zero media), the zero gates' exact 0, the compute
copy's dtypes and the carry's refusal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (DECODE_RTOL, FORWARD_RTOL, PREFILL_RTOL, ROOT, _close, _compare_engines, _jnp, _np,
                           _prompts)
from test_torch_lm import models  # noqa: F401  (the shared module-scoped fixture)

import repro_torch.configs as C
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.serving import ServeEngine

ARCH = "llama-3.2-vision-11b"
GATE = 0.5
CASES = [("f32", False), ("bf16", False), ("f32", True)]


def _gated(m):
    """The reference's values and the port's params with every
    cross-attention gate at GATE."""
    values = dict(m["values"], cross_blocks=dict(m["values"]["cross_blocks"]))
    values["cross_blocks"]["xattn_gate"] = jnp.full_like(values["cross_blocks"]["xattn_gate"], GATE)
    params = dict(m["params"], cross_blocks=dict(m["params"]["cross_blocks"]))
    params["cross_blocks"]["xattn_gate"] = torch.full_like(params["cross_blocks"]["xattn_gate"], GATE)
    return values, params


def _media(cfg, B, rng):
    return rng.normal(size=(B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dt,flash", CASES, ids=[f"{dt}{'-flash' if f else ''}" for dt, f in CASES])
def test_forward_prefill_and_decode_logits(models, dt, flash):
    """3 prompts of 20 tokens with nonzero media and gates: forward,
    prefill, and one decode step per row from the reference's prefill
    cache carried into a 32-slot cache."""
    m = models(ARCH, dt, flash)
    values, params = _gated(m)
    model = M.build_model(m["pc"])
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m["rc"].vocab_size, size=(3, 20)).astype(np.int32)
    media = _media(m["rc"], 3, rng)
    tt = torch.as_tensor(toks, dtype=torch.int64)
    lf = model.forward(params, {"tokens": tt, "media": torch.as_tensor(media)})
    want = m["forward"](values, {"tokens": jnp.asarray(toks), "media": jnp.asarray(media)})
    _close(_np(lf), _jnp(want), FORWARD_RTOL[dt], "forward logits")
    jmedia, tmedia = jnp.asarray(media, jnp.bfloat16), torch.as_tensor(media).to(torch.bfloat16)
    lr, cr = m["prefill"](values, jnp.asarray(toks), jmedia)
    lp, cp = M.make_prefill(m["pc"])(params, {"tokens": tt, "media": tmedia})
    assert lp.dtype == m["pc"].compute_dtype and tuple(lp.shape) == lr.shape
    _close(_np(lp), _jnp(lr), PREFILL_RTOL[dt], "prefill logits")
    for group in ("self_groups", "cross_groups"):
        assert np.array_equal(cp[group]["pos"].numpy(), np.asarray(cr[group]["pos"]))
        assert cp[group]["self"]["k"].dtype == torch.bfloat16
    cache = jax.tree.map(lambda a, c: a.at[..., :20, :, :].set(c) if a.ndim > 3 else c,
                         m["rm"].init_cache(3, 32), cr)
    tok = rng.integers(0, m["rc"].vocab_size, size=(3, 1)).astype(np.int32)
    ld, cd = m["decode"](values, cache, jnp.asarray(tok), jnp.asarray(20, jnp.int32), jmedia)
    pcache = lm_cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    ldp, cdp = M.make_serve_step(m["pc"])(params, pcache, torch.as_tensor(tok, dtype=torch.int64), 20,
                                          {"media": tmedia})
    assert cdp is pcache  # written in place
    _close(_np(ldp), _jnp(ld), DECODE_RTOL[dt], "decode logits")
    for group in ("self_groups", "cross_groups"):
        assert np.array_equal(cdp[group]["pos"].numpy(), np.asarray(cd[group]["pos"]))


def test_the_cross_branch_moves_the_logits_and_adds_zero_at_zero_gates(models):
    """Gates at 0.5 move the prefill logits; at their initial 0 the branch
    adds exactly 0 whatever the media (the engine's case)."""
    m = models(ARCH)
    _, params = _gated(m)
    model = M.build_model(m["pc"])
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, m["rc"].vocab_size, size=(2, 12)), dtype=torch.int64)
    media = torch.as_tensor(_media(m["rc"], 2, rng))
    gated, _ = model.prefill(params, toks, media)
    shut, _ = model.prefill(m["params"], toks, media)
    zero, _ = model.prefill(m["params"], toks)
    assert not torch.equal(gated, shut)
    assert torch.equal(shut, zero)


def test_engine_greedy_matches_reference(models):
    m = models(ARCH)
    _compare_engines(m, _prompts(m))


def test_compute_copy_dtypes(models):
    m = models(ARCH)
    cp = M.compute_copy(m["params"], m["pc"].replace(compute_dtype=torch.bfloat16))
    cross = cp["cross_blocks"]
    assert cross["xattn"]["wk"]["w"].dtype == torch.bfloat16 and cross["mlp"]["up"]["w"].dtype == torch.bfloat16
    assert cp["self_blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert cross["xattn_gate"].dtype == torch.float32 and cross["ln_x"]["scale"].dtype == torch.float32
    assert tuple(cp["self_blocks"]["ln1"]["scale"].shape) == (1, 4, m["pc"].d_model)


def test_params_carry_refuses_another_layout(models):
    m = models(ARCH)
    values = jax.tree.map(np.asarray, m["values"])
    with pytest.raises(ValueError, match="layout"):  # two groups of 2 + 1 where the tree has one of 4 + 1
        lm_params_from_reference(values, m["pc"].replace(n_layers=6, cross_attn_period=3), device="cpu")
    del values["cross_blocks"]["xattn_gate"]
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_reference(values, m["pc"], device="cpu")
    with pytest.raises(ValueError, match="layout"):  # the vlm's tree into the dense config of the same widths
        lm_params_from_reference(jax.tree.map(np.asarray, m["values"]), C.get_smoke("qwen1.5-0.5b"), device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                           "--max-new", "4"]) == 0
    assert "served 5/5 requests" in capsys.readouterr().out


def test_example_on_the_cpu():
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"), "--arch", ARCH,
                          "--device", "cpu"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"


def test_engine_default_device_raises_without_a_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    m = models(ARCH)
    with pytest.raises(RuntimeError, match="GPU"):
        ServeEngine(m["pc"], m["params"])
