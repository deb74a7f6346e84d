"""The port's MoE family against the JAX package's, on the CPU.

``models/moe.py::moe_apply`` on the reference's layer-0 MoE params
(``carry.lm_params_from_reference``) and the same numpy inputs, in f32,
within 1e-5 of the largest |output|, in four cases that each decide which
(token, choice) pairs reach which slots:

- a tie-heavy router: its columns duplicated in pairs and every value
  a multiple of 1/8 over inputs in {-1, 0, 1}, so the logits are exact
  and every token's probabilities tie in pairs; with k = 3 the third
  choice splits a pair, and the lower expert must win (``lax.top_k``);
- ``capacity_factor`` 0.25: slots are dropped, the later pairs of an
  expert first;
- T = 16,384 tokens: two dispatch groups (G = 2), each with its own ranks;
- a decode-sized T = 4: the capacity's floor of 8.

A wrong tie-break or drop order sends whole rows to other experts, far
past the bound (``test_the_moe_bound_rejects_the_other_tie_break``).
Then the two SMOKE configurations (``qwen2-moe-a2.7b`` with its shared
experts, ``dbrx-132b``) through forward, prefill and decode in f32 and
bf16 under ``tests/test_torch_lm.py``'s bounds, and ``ServeEngine``'s
greedy tokens against the JAX ``ServeEngine``'s; the compute copy's
dtypes, the leaf-by-leaf build, the carry's refusal and the default
device.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (DECODE_RTOL, DTYPES, FORWARD_RTOL, PREFILL_RTOL, ROOT, _close, _compare_engines, _jnp,
                           _np, _prompts)
from test_torch_lm import models  # noqa: F401  (the shared module-scoped fixture)

import repro.configs as RC
import repro_torch.configs as C
from repro.models import moe as RMOE
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving import ServeEngine

MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
MOE_RTOL = 1e-5
# (case, tokens, config changes): see the module docstring
APPLY_CASES = [("ties", 96, dict(n_experts_per_tok=3)), ("drops", 512, dict(capacity_factor=0.25)),
               ("two-groups", 16_384, dict(capacity_factor=0.5)), ("decode", 4, {})]


@pytest.fixture(scope="module")
def moe_layer(models):
    """arch -> the reference's layer-0 MoE params (jnp) and the port's."""
    def get(arch):
        m = models(arch)
        ref = jax.tree.map(lambda t: t[0], m["values"]["blocks"]["moe"])
        return ref, jax.tree.map(lambda t: t[0], m["params"]["blocks"]["moe"])

    return get


def _apply_inputs(case, T, d, ref, rng):
    """x (T as (2, T/2) or (T, 1)), and the router for the tie case."""
    shape = (2, T // 2, d) if T > 4 else (T, 1, d)
    if case != "ties":
        return rng.normal(size=shape).astype(np.float32), None
    x = rng.integers(-1, 2, size=shape).astype(np.float32)
    E = ref["router"]["w"].shape[1]
    w = rng.integers(-8, 9, size=(d, E // 2)).astype(np.float32) / 8
    return x, np.repeat(w, 2, axis=1)  # columns 2j and 2j+1 equal


def _moe_pair(moe_layer, arch, case, T, kw, rng):
    """The reference's and the port's moe_apply on the same inputs."""
    ref, port = moe_layer(arch)
    rc, pc = RC.get_smoke(arch).replace(compute_dtype=jnp.float32, **kw), C.get_smoke(arch).replace(
        compute_dtype=torch.float32, **kw)
    x, router = _apply_inputs(case, T, rc.d_model, ref, rng)
    if router is not None:
        ref = dict(ref, router={"w": jnp.asarray(router)})
        port = dict(port, router={"w": torch.as_tensor(router)})
    want = jax.jit(lambda p, x: RMOE.moe_apply(p, x, rc))(ref, jnp.asarray(x))
    return pc, port, torch.as_tensor(x), np.asarray(want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case,T,kw", APPLY_CASES, ids=[c[0] for c in APPLY_CASES])
def test_moe_apply_matches_reference(moe_layer, arch, case, T, kw):
    pc, port, x, want = _moe_pair(moe_layer, arch, case, T, kw, np.random.default_rng(11))
    G, C_, top_e, _ = MOE.route(port, x, pc)
    assert G == (2 if T == 16_384 else 1)
    assert C_ == MOE.capacity(T // G, pc)
    if case == "decode":
        assert C_ == 8
    if case in ("drops", "two-groups"):  # the capacity does drop pairs
        counts = torch.stack([torch.bincount(e.reshape(-1), minlength=pc.n_experts) for e in top_e])
        assert int((counts - C_).clamp(min=0).sum()) > 0
    got = MOE.moe_apply(port, x, pc)
    _close(_np(got), want, MOE_RTOL, f"moe_apply ({case})")


def test_the_moe_bound_rejects_the_other_tie_break(moe_layer, monkeypatch):
    """The tie case's bound catches a router that puts the higher expert
    first among equal probabilities: the same sort over the reversed
    expert axis, mapped back."""
    case, T, kw = APPLY_CASES[0]
    pc, port, x, want = _moe_pair(moe_layer, "qwen2-moe-a2.7b", case, T, kw, np.random.default_rng(11))
    route, E = MOE.route, pc.n_experts

    def higher_first(p, x, cfg):
        G, C_, top_e, top_p = route(dict(p, router={"w": p["router"]["w"].flip(-1)}), x, cfg)
        return G, C_, E - 1 - top_e, top_p

    monkeypatch.setattr(MOE, "route", higher_first)
    with pytest.raises(AssertionError, match="moe_apply"):
        _close(_np(MOE.moe_apply(port, x, pc)), want, MOE_RTOL, "moe_apply")


def test_group_count_and_capacity():
    """The reference's rule without a mesh, and C at the chip's shapes."""
    assert [MOE._group_count(T) for T in (4, 6144, 16_383, 16_384, 32_768, 24_576)] == [1, 1, 1, 2, 4, 2]
    assert MOE._group_count(2**30) == 64
    assert [RMOE._group_count(T) for T in (4, 6144, 16_383, 16_384, 32_768, 24_576)] == [1, 1, 1, 2, 4, 2]
    cfg = C.get("qwen2-moe-a2.7b")
    assert MOE.capacity(6144, cfg) == 512 and MOE.capacity(4, cfg) == 8
    assert MOE.capacity(6144, C.get("dbrx-132b")) == 1920


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

MODEL_CASES = [(a, dt) for a in MOE_ARCHS for dt in DTYPES]


@pytest.mark.parametrize("arch,dt", MODEL_CASES, ids=[f"{a}-{dt}" for a, dt in MODEL_CASES])
def test_prefill_and_decode_logits(models, arch, dt):
    """Forward, prefill (3 prompts of 20 tokens) and one decode step per
    row from the reference's prefill cache carried into a 32-slot cache."""
    m = models(arch, dt)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m["rc"].vocab_size, size=(3, 20)).astype(np.int32)
    lf = M.build_model(m["pc"]).forward(m["params"], {"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    _close(_np(lf), _jnp(m["forward"](m["values"], {"tokens": jnp.asarray(toks)})), FORWARD_RTOL[dt],
           "forward logits")
    lr, cr = m["prefill"](m["values"], jnp.asarray(toks))
    lp, cp = M.make_prefill(m["pc"])(m["params"], {"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    assert lp.dtype == m["pc"].compute_dtype and tuple(lp.shape) == lr.shape
    _close(_np(lp), _jnp(lr), PREFILL_RTOL[dt], "prefill logits")
    assert np.array_equal(cp["pos"].numpy(), np.asarray(cr["pos"]))
    cache = m["rm"].init_cache(3, 32)
    cache = {"self": {n: cache["self"][n].at[:, :, :20].set(cr["self"][n]) for n in ("k", "v")}, "pos": cr["pos"]}
    tok = rng.integers(0, m["rc"].vocab_size, size=(3, 1)).astype(np.int32)
    ld, cd = m["decode"](m["values"], cache, jnp.asarray(tok), jnp.asarray(20, jnp.int32))
    pcache = lm_cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    ldp, cdp = M.make_serve_step(m["pc"])(m["params"], pcache, torch.as_tensor(tok, dtype=torch.int64), 20)
    _close(_np(ldp), _jnp(ld), DECODE_RTOL[dt], "decode logits")
    assert np.array_equal(cdp["pos"].numpy(), np.asarray(cd["pos"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_matches_reference(models, arch):
    m = models(arch)
    _compare_engines(m, _prompts(m))


# --------------------------------------------------------------------------
# params, carry, device
# --------------------------------------------------------------------------

def test_compute_copy_dtypes(models):
    """The experts' bare arrays and the router in bf16, the norms in f32."""
    m = models("qwen2-moe-a2.7b")
    cp = M.compute_copy(m["params"], m["pc"].replace(compute_dtype=torch.bfloat16))
    moe = cp["blocks"]["moe"]
    assert all(moe[k].dtype == torch.bfloat16 for k in ("gate", "up", "down"))
    assert moe["router"]["w"].dtype == torch.bfloat16
    assert all(t["w"].dtype == torch.bfloat16 for t in moe["shared"].values())
    assert cp["blocks"]["attn"]["wq"]["b"].dtype == torch.bfloat16
    assert cp["blocks"]["ln1"]["scale"].dtype == torch.float32 and cp["final_norm"]["scale"].dtype == torch.float32


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path


@pytest.mark.parametrize("arch", MOE_ARCHS + ("llama-3.2-vision-11b", "qwen2-1.5b"))
def test_leaf_by_leaf_build_is_the_compute_copy(arch):
    cfg = C.get_smoke(arch)
    want = M.compute_copy(M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu"), cfg)
    got = M.init_compute_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    _same_tree(got, want)
    assert M.count_params(M.init_compute_params(C.get(arch), device="meta")) == M.count_params(
        M.init_params(C.get(arch), device="meta"))


def test_params_carry_refuses_another_layout(models):
    m = models("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_reference(jax.tree.map(np.asarray, m["values"]), C.get_smoke("dbrx-132b"), device="cpu")
    values = jax.tree.map(np.asarray, m["values"])
    values["blocks"]["moe"]["gate"] = values["blocks"]["moe"]["gate"][:, :-1]  # an expert short
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_reference(values, m["pc"], device="cpu")


def test_engine_default_device_raises_without_a_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    m = models("qwen2-moe-a2.7b")
    with pytest.raises(RuntimeError, match="GPU"):
        ServeEngine(m["pc"], m["params"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                           "--max-new", "4"]) == 0
    assert "served 5/5 requests" in capsys.readouterr().out


def test_example_on_the_cpu():
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"), "--arch", "qwen2-moe-a2.7b",
                          "--device", "cpu"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"
