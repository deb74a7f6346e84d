"""The port's dense LM serving path against the JAX package's, on the CPU.

The same parameters — the reference's ``init_params(cfg, PRNGKey(seed))``
carried across by ``carry.lm_params_from_reference`` — and the same numpy
inputs go through both packages at the SMOKE sizes of the four dense
configurations: the layers (``rmsnorm``, ``layernorm``, ``rope``,
``_mask_bias``, ``attention_core`` on both branches, ``attn_apply`` over a
per-row cache and over a ring cache), ``UniformDecoder.forward`` /
``prefill`` / ``decode`` logits in f32 and bf16, and ``ServeEngine`` against the JAX
``ServeEngine`` on 7 ragged requests on 3 slots (slots reused, one prompt
longer than ``cache_len``): greedy, temperature 0.8 and ``eos_id``.  The
flash branch runs on the JAX side with ``flash_threshold=64`` and blocks
of 16 (its jnp online softmax, ``_flash_sdpa``), on the port's side
through ``kernels.ops.flash_attention``'s plain version.

Tolerances, each relative to the largest |value| of the reference's
output, with the largest reading measured on an x86-64 CPU (torch 2.13,
jax 0.9):

- layers and ``forward`` logits in f32 with no cache: 1e-5 (summation
  order; forward ≤ 2e-6);
- ``attn_apply`` over a bf16 cache in f32: 1e-5 plus one bf16 ulp of the
  largest |V| (2^-8), the most that a K/V element rounding the other way
  into the cache can move an output;
- prefill logits in f32: 2e-3 (measured ≤ 4.1e-4).  The KV cache is bf16
  whatever the compute dtype, and prefill attends over the rounded K/V:
  a K/V value that the two BLAS round to neighbouring f32s falls on the
  other side of a bf16 rounding boundary now and then (1 of 4608 in the
  first layer of qwen2-1.5b's SMOKE), and the next layer carries it on;
- decode logits in f32 from the same (carried) cache: 1e-4 (≤ 2.1e-5);
- logits in bf16: 5e-2 (≤ 1.7e-2: a few bf16 ulps);
- the engines' logits at every sampled step in f32: 2e-3, as prefill.

Tokens: the engines must give the same tokens.  Where the f32 logits
differ by up to their bound, a greedy pick can part only at a
reference-side near-tie: the first token where the two streams part must
have the reference's margin between the two candidates within twice the
bound (for sampling: the draw within the bound's reach of a boundary of
the reference's cumulative distribution), and later requests are not
compared after it (a later request in the same slot reads the parted
request's K/V past its own head: the reference's single step position).
On that CPU no request parts.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as C
from repro.models import layers as RL
from repro.models import model as RM
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as PL
from repro_torch.models import model as M
from repro_torch.serving import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("qwen1.5-0.5b", "qwen2-1.5b", "h2o-danube-3-4b", "qwen3-14b")
# the reference's count_params(abstract_params(cfg)) at full width
FULL_PARAMS = {"qwen1.5-0.5b": 463_987_712, "qwen2-1.5b": 1_543_714_304,
               "h2o-danube-3-4b": 3_961_839_360, "qwen3-14b": 14_768_307_200,
               "qwen2-moe-a2.7b": 14_315_735_040, "dbrx-132b": 131_596_523_520,
               "llama-3.2-vision-11b": 10_110_734_344, "rwkv6-1.6b": 1_599_823_872,
               "zamba2-7b": 5_737_416_000, "whisper-tiny": 49_646_592}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYER_RTOL = 1e-5
FORWARD_RTOL = {"f32": 1e-5, "bf16": 5e-2}
PREFILL_RTOL = {"f32": 2e-3, "bf16": 5e-2}
DECODE_RTOL = {"f32": 1e-4, "bf16": 5e-2}
FLASH = dict(flash_threshold=64, flash_block_q=16, flash_block_k=16)
# the engines' requests: 7 ragged prompts on 3 slots, one longer than CACHE_LEN
PROMPT_LENS = (3, 9, 5, 12, 3, 40, 9)
SLOTS, CACHE_LEN, MAX_NEW, ENGINE_SEED = 3, 32, 6, 5


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, f"{what}: max |port - reference| {err:.3e} > {rtol:g} x {scale:.3e}"
    return err / scale


def _cfgs(arch, dt="f32", **kw):
    jdt, tdt = DTYPES[dt]
    return RC.get_smoke(arch).replace(compute_dtype=jdt, **kw), C.get_smoke(arch).replace(compute_dtype=tdt, **kw)


@pytest.fixture(scope="module")
def models():
    """(arch, dtype, flash) -> the reference cfg, values and jitted
    prefill/decode, the port cfg and params: each built once."""
    built = {}

    def get(arch, dt="f32", flash=False):
        key = (arch, dt, flash)
        if key not in built:
            rc, pc = _cfgs(arch, dt, **(FLASH if flash else {}))
            values, _ = RM.init_params(rc, jax.random.PRNGKey(0))
            rm = RM.build_model(rc)
            built[key] = dict(rc=rc, pc=pc, values=values, rm=rm, forward=jax.jit(rm.forward),
                              prefill=jax.jit(rm.prefill), decode=jax.jit(rm.decode),
                              params=lm_params_from_reference(jax.tree.map(np.asarray, values), pc, device="cpu"))
        return built[key]

    return get


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
    want = RL.norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    got = PL.norm({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), kind)
    _close(_np(got), want, LAYER_RTOL, kind)


@pytest.mark.parametrize("per_row", [False, True], ids=["1d-positions", "per-row-positions"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(per_row, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 11, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 64, size=(3, 11)) if per_row else np.arange(11) + 5
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    got = PL.rope(torch.as_tensor(x), torch.as_tensor(pos, dtype=torch.int32), theta)
    _close(_np(got), want, LAYER_RTOL, "rope")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_mask_bias(causal, window):
    rng = np.random.default_rng(2)
    qpos = rng.integers(0, 20, size=(2, 7)).astype(np.int32)
    kpos = rng.integers(-3, 20, size=(2, 13)).astype(np.int32)  # negative: unwritten ring slots
    want = np.asarray(RL._mask_bias(jnp.asarray(qpos), jnp.asarray(kpos), causal, window))
    got = PL._mask_bias(torch.as_tensor(qpos), torch.as_tensor(kpos), causal, window).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("window", [None, 9])
def test_attention_core(flash, window):
    """Both branches: per-row query positions, dead keys, GQA (6 query
    heads on 2 kv heads).  The flash branch takes Sq·Sk above the
    threshold: the reference's jnp online softmax against the port's
    flash kernel wrapper (its plain version on the CPU).  Every query
    keeps a live key: where none is, the jnp loop's answer depends on its
    key blocks (ROADMAP queue 3, reference facts)."""
    rng = np.random.default_rng(3)
    B, S, H, KV, Dh = 2, 40, 6, 2, 16
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, Dh)).astype(np.float32) for _ in range(2))
    qpos = np.stack([np.arange(S), np.arange(S) + 3]).astype(np.int32)
    kpos = np.stack([np.arange(S), np.arange(S) + 3]).astype(np.int32)
    kpos[1, -3:] = -1
    thresh = 64 if flash else S * S
    want = RL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qpos=jnp.asarray(qpos),
                             kpos=jnp.asarray(kpos), causal=True, window=window, flash_threshold=thresh, cq=16, ck=16)
    got = PL.attention_core(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), qpos=torch.as_tensor(qpos),
                            kpos=torch.as_tensor(kpos), causal=True, window=window, flash_threshold=thresh)
    _close(_np(got), want, LAYER_RTOL, "attention_core")


@pytest.mark.parametrize("arch,Sc,heads", [("qwen2-1.5b", 24, (5, 17, 0)), ("h2o-danube-3-4b", 16, (20, 33, 7))],
                         ids=["per-row-cache", "ring-cache"])
def test_attn_apply_with_cache(models, arch, Sc, heads):
    """One decode token per row into a cache at per-row write heads; the
    danube SMOKE window (16) makes the cache a ring, with heads past Sc.
    The step's query position is the largest head, as the engine gives."""
    m = models(arch)
    rc, pc = m["rc"], m["pc"]
    rng = np.random.default_rng(4)
    B = len(heads)
    x = rng.normal(size=(B, 1, rc.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, Sc, rc.n_kv_heads, rc.head_dim)).astype(np.float32)
    cache_pos = np.asarray(heads, np.int32)
    qpos = np.full((B, 1), max(heads), np.int32)
    p0 = jax.tree.map(lambda t: t[0], m["values"]["blocks"]["attn"])
    jcache = {"k": jnp.asarray(kv[0], jnp.bfloat16), "v": jnp.asarray(kv[1], jnp.bfloat16)}
    want, wcache = RL.attn_apply(p0, jnp.asarray(x), rc, qpos=jnp.asarray(qpos), window=rc.sliding_window,
                                 cache=jcache, cache_pos=jnp.asarray(cache_pos))
    tcache = lm_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    got, gcache = PL.attn_apply(jax.tree.map(lambda t: t[0], m["params"]["blocks"]["attn"]), torch.as_tensor(x), pc,
                                qpos=torch.as_tensor(qpos), window=pc.sliding_window, cache=tcache,
                                cache_pos=torch.as_tensor(cache_pos))
    assert np.array_equal(gcache["pos"].numpy(), np.asarray(wcache["pos"]))
    for name in ("k", "v"):
        g, w = _np(gcache[name]), _jnp(wcache[name])
        assert np.allclose(g, w, rtol=2.0**-8, atol=0), name  # at most one bf16 ulp apart
    ulp_v = 2.0**-8 * float(np.abs(_jnp(wcache["v"])).max())
    err = float(np.abs(_np(got) - _jnp(want)).max())
    assert err <= LAYER_RTOL * float(np.abs(_jnp(want)).max()) + ulp_v, err


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

MODEL_CASES = [(a, dt, False) for a in DENSE for dt in DTYPES] + [
    (a, dt, True) for a in ("qwen2-1.5b", "h2o-danube-3-4b") for dt in DTYPES]


@pytest.mark.parametrize("arch,dt,flash", MODEL_CASES,
                         ids=[f"{a}-{dt}{'-flash' if f else ''}" for a, dt, f in MODEL_CASES])
def test_prefill_and_decode_logits(models, arch, dt, flash):
    """Forward (no cache: fresh K/V) and prefill logits and caches on 3
    prompts of 20 tokens (with ``flash``: through the flash branch), then
    one decode step per row from the reference's prefill cache, carried
    into a 32-slot cache."""
    m = models(arch, dt, flash)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m["rc"].vocab_size, size=(3, 20)).astype(np.int32)
    lf = M.build_model(m["pc"]).forward(m["params"], {"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    _close(_np(lf), _jnp(m["forward"](m["values"], {"tokens": jnp.asarray(toks)})),
           FORWARD_RTOL[dt], "forward logits")
    lr, cr = m["prefill"](m["values"], jnp.asarray(toks))
    lp, cp = M.make_prefill(m["pc"])(m["params"], {"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    assert lp.dtype == m["pc"].compute_dtype and tuple(lp.shape) == lr.shape
    _close(_np(lp), _jnp(lr), PREFILL_RTOL[dt], "prefill logits")
    assert np.array_equal(cp["pos"].numpy(), np.asarray(cr["pos"]))
    assert cp["self"]["k"].dtype == torch.bfloat16
    cache = m["rm"].init_cache(3, 32)
    cache = {"self": {n: cache["self"][n].at[:, :, :20].set(cr["self"][n]) for n in ("k", "v")}, "pos": cr["pos"]}
    tok = rng.integers(0, m["rc"].vocab_size, size=(3, 1)).astype(np.int32)
    ld, cd = m["decode"](m["values"], cache, jnp.asarray(tok), jnp.asarray(20, jnp.int32))
    pcache = lm_cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    ldp, cdp = M.make_serve_step(m["pc"])(m["params"], pcache, torch.as_tensor(tok, dtype=torch.int64), 20)
    assert cdp is pcache  # written in place
    _close(_np(ldp), _jnp(ld), DECODE_RTOL[dt], "decode logits")
    assert np.array_equal(cdp["pos"].numpy(), np.asarray(cd["pos"]))


def test_the_logit_bound_rejects_a_wrong_model(models):
    """The f32 prefill bound is tight enough to catch a real fault: the
    port with the default rope θ (1e4) instead of qwen2's 1e6."""
    m = models("qwen2-1.5b")
    toks = np.random.default_rng(5).integers(0, m["rc"].vocab_size, size=(3, 20)).astype(np.int32)
    lr, _ = m["prefill"](m["values"], jnp.asarray(toks))
    wrong = M.build_model(m["pc"].replace(rope_theta=10_000.0))
    lp, _ = wrong.prefill(m["params"], torch.as_tensor(toks, dtype=torch.int64))
    with pytest.raises(AssertionError, match="prefill logits"):
        _close(_np(lp), _jnp(lr), PREFILL_RTOL["f32"], "prefill logits")


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _recording(eng, log):
    """Wrap an engine's sampler to log (rid, logits over the vocab, token)
    in call order."""
    sample = eng._sample

    def wrapped(logits, req):
        tok = sample(logits, req)
        log.append((req.rid, np.asarray(logits[: eng.cfg.vocab_size], np.float64), tok))
        return tok

    eng._sample = wrapped


def _serve(m, port: bool, prompts, **req_kw):
    """Serve ``prompts`` through one engine; returns each request's tokens
    and the sampler's log.  The reference engine reuses the model's jitted
    prefill and step across tests (each engine would compile its own)."""
    log = []
    if port:
        eng = ServeEngine(m["pc"], m["params"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW, **req_kw) for i, p in enumerate(prompts)]
    else:
        eng = RServeEngine(m["rc"], m["values"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED)
        jits = m.setdefault("engine_jits", (eng._prefill, eng.serve_step))
        eng._prefill, eng.serve_step = jits
        reqs = [RRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW, **req_kw) for i, p in enumerate(prompts)]
    _recording(eng, log)
    for r in reqs:
        eng.submit(r)
    assert eng.run() == []  # the reference's run() returns nothing: the requests carry the results
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], log


def _compare_engines(m, prompts, temperature=0.0, **req_kw):
    """Hold the port's engine to the reference's (see the module
    docstring): the sampler's calls come in the same order with logits
    within the bound while every stream agrees; the first token that
    parts must part at a reference-side near-tie, and nothing after it is
    compared.  Returns the tokens of both engines."""
    ref_toks, ref_log = _serve(m, False, prompts, temperature=temperature, **req_kw)
    got_toks, got_log = _serve(m, True, prompts, temperature=temperature, **req_kw)
    rtol = PREFILL_RTOL["f32"]
    for n, ((rid, logits, want), (rid_g, got_logits, got)) in enumerate(zip(ref_log, got_log)):
        assert rid == rid_g, f"sampler call {n}: request {rid_g} where the reference serves {rid}"
        _close(got_logits, logits, rtol, f"sampler call {n} (request {rid})'s logits")
        if want == got:
            continue
        tol = rtol * float(np.abs(logits).max())
        if temperature <= 0.0:
            margin = logits[want] - logits[got]
            assert margin <= 2 * tol, f"request {rid} parts at call {n} with a margin of {margin:.3e}"
        else:
            p = np.exp((logits - logits.max()) / temperature)
            cdf = np.cumsum(p) / p.sum()
            u = np.random.default_rng(ENGINE_SEED).random(n + 1)[n]  # the n-th draw (one per call)
            lo, hi = sorted((want, got))
            gap = float(np.abs(cdf[lo:hi] - u).min())
            assert gap <= 2 * tol / temperature, f"request {rid} parts at call {n}, {gap:.3e} from a boundary"
        return ref_toks, got_toks
    assert len(ref_log) == len(got_log) and ref_toks == got_toks
    return ref_toks, got_toks


def _prompts(m, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, m["rc"].vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("arch", DENSE)
def test_engine_greedy_matches_reference(models, arch):
    m = models(arch)
    _compare_engines(m, _prompts(m))


def test_engine_temperature_matches_reference(models):
    m = models("qwen2-1.5b")
    ref, _ = _compare_engines(m, _prompts(m), temperature=0.8)
    greedy, _ = _serve(m, False, _prompts(m))
    assert ref != greedy  # the draws did move off the argmax


def test_engine_eos_matches_reference(models):
    """An eos_id that the greedy streams emit mid-way: requests end early
    (some at their prefill token), so slots free at other steps."""
    m = models("h2o-danube-3-4b")
    prompts = _prompts(m, seed=7)
    toks, _ = _serve(m, False, prompts)
    eos = toks[1][2]
    _, got = _compare_engines(m, prompts, eos_id=eos)
    assert any(len(g) < MAX_NEW and g[-1] == eos for g in got)


def test_engine_serves_from_the_compute_copy(models):
    m = models("qwen2-1.5b", "bf16")
    eng = ServeEngine(m["pc"], m["params"], slots=2, cache_len=16, device="cpu")
    blocks = eng.params["blocks"]
    assert blocks["attn"]["wq"]["w"].dtype == torch.bfloat16 and blocks["attn"]["wq"]["b"].dtype == torch.bfloat16
    assert eng.params["embed"]["table"].dtype == torch.bfloat16
    assert blocks["ln1"]["scale"].dtype == torch.float32 and eng.params["final_norm"]["scale"].dtype == torch.float32
    assert eng.caches["self"]["k"].dtype == torch.bfloat16 and eng.caches["pos"].dtype == torch.int32


# --------------------------------------------------------------------------
# sizes, families, carry, entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(FULL_PARAMS))
def test_count_params_at_full_width(arch):
    """The port built on the meta device (no allocation) against the
    reference's abstract_params (eval_shape)."""
    ref = RM.count_params(RM.abstract_params(RC.get(arch))[0])
    got = M.count_params(M.init_params(C.get(arch), device="meta"))
    assert got == ref == FULL_PARAMS[arch]


def test_build_model_refuses_an_unknown_family():
    assert M._LATER == ()  # every family of the reference's zoo is ported
    with pytest.raises(ValueError, match="unknown family 'speech'"):
        M.build_model(C.get_smoke("whisper-tiny").replace(family="speech"))


def test_params_carry_refuses_another_layout(models):
    m = models("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_reference(jax.tree.map(np.asarray, m["values"]), C.get_smoke("qwen2-1.5b"), device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--requests", "5",
                           "--slots", "2", "--max-new", "4"]) == 0
    assert "served 5/5 requests" in capsys.readouterr().out


def test_example_on_the_cpu():
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"), "--device", "cpu"],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"


def test_engine_default_device_raises_without_a_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    m = models("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="GPU"):
        ServeEngine(m["pc"], m["params"])
