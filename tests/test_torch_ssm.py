"""The port's ssm family (RWKV-6) against the JAX package's, on the CPU.

The reference's ``init_params(cfg, PRNGKey(0))`` at rwkv6-1.6b's SMOKE
size (2 layers, d_model 64, 2 heads of 32) reaches the port through
``carry.lm_params_from_reference``; inputs are made with numpy.  Three
variants of the params:

- ``init``: as drawn.  There ``mu``, ``bonus_u`` and the LayerNorm biases
  are 0, ``mu_k`` / ``mu_r`` 1, and ``decay_mu = -6`` gives log decays of
  about -0.0025 a token: those terms and the [-30, 0] clip do nothing;
- ``perturbed``: those leaves, the norm scales and the LoRA output
  weights replaced by seeded random values, so every term moves the
  output;
- ``clip``: ``perturbed`` with ``decay_mu = +1.5`` (log decays about
  -4.5 a token), so the clip of the cumulative log decays binds within
  a chunk: a clip in another place than the reference's shows there.

Tolerances, each relative to the largest |value| of the reference's
output (``tests/test_torch_lm.py``'s): f32 1e-5 for a function, a
forward or a prefill, 1e-4 for decode steps; bf16 5e-2.  The port's WKV
against a serial f64 recurrence: 1e-5 of the largest |o| and |S| (f32
chunk products against exact sums).  A train step:
``tests/test_torch_train.py``'s ``STEP_*`` bounds.  The engines' tokens
are held as in ``tests/test_torch_lm.py`` (a stream may part only at a
reference-side near-tie, within twice the logit bound), with the bf16
bound 5e-2 in bf16.

One bound is looser: the whole model in bf16 with the clip binding,
0.25 (measured 0.113 on an x86-64 CPU, torch 2.13, jax 0.9).  There
k̃ = k·e^{-cum} reaches e^30 and r̃ = r·e^{cum_prev} e^-30, each rounded
to bf16 (2^-8 relative), and every clipped pair's product r̃_i·k̃_j is of
order 1 instead of ~0, so a chunk sums dozens of full-size terms that
carry those roundings: the reference's own bf16 logits are 0.54 of the
largest away from its f32 logits there (0.019 in ``perturbed``), and
each layer's inputs in the two packages already differ by bf16 ulps.
The same functions in f32 hold 1e-5 in that case.

The chunk rule of the reference (``rwkv.py:108-109``, ``T % min(64, T)
== 0``): a sequence longer than 64 tokens must be a multiple of 64.  The
engine passes prompts as they come, so the prompts here have at most 64
tokens or 128.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import DTYPES, _close, _jnp, _np
from test_torch_train import STEP_GNORM_RTOL, STEP_LEAF_RTOL, STEP_LOSS_RTOL, _leaves, _rel_norm

import repro.configs as RC
import repro_torch.configs as C
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import rwkv as RR
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro.train import optim as RO
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models import rwkv as PR
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import optim as PO
from repro_torch.tree import tree_leaves

ARCH = "rwkv6-1.6b"
RTOL = {"f32": 1e-5, "bf16": 5e-2}
DECODE_RTOL = {"f32": 1e-4, "bf16": 5e-2}
CLIP_BF16_RTOL = 0.25  # the whole model in bf16 with the clip binding (see the module docstring)
VARIANTS = ("init", "perturbed", "clip")
WKV_T = (1, 9, 64, 128, 192)
# the engines' requests: ragged prompts within the chunk rule, one of 128 tokens (two chunks), on 3 slots
PROMPT_LENS = (5, 128, 9, 40, 9, 5, 40)
SLOTS, CACHE_LEN, MAX_NEW, ENGINE_SEED = 3, 256, 6, 5
B, S = 2, 128  # a train step: two chunks


def _cfgs(dt):
    jdt, tdt = DTYPES[dt]
    return RC.get_smoke(ARCH).replace(compute_dtype=jdt), C.get_smoke(ARCH).replace(compute_dtype=tdt)


def _perturb(values, clip: bool, seed=11):
    """The reference's values with the leaves that are constant at init
    (and the LoRA outputs, small at init) drawn from a seed."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.array, values)
    blk, tm, cm = v["blocks"], v["blocks"]["tm"], v["blocks"]["cm"]

    def normal(a, scale, shift=0.0):
        return (shift + scale * rng.normal(size=a.shape)).astype(np.float32)

    tm["mu"] = rng.uniform(-0.5, 1.0, size=tm["mu"].shape).astype(np.float32)
    tm["bonus_u"] = normal(tm["bonus_u"], 0.5)
    tm["maa_w2"] = normal(tm["maa_w2"], 0.1)
    tm["decay_w2"] = normal(tm["decay_w2"], 0.1)
    tm["decay_mu"] = normal(tm["decay_mu"], 0.5, 1.5 if clip else -4.0)
    cm["mu_k"] = rng.uniform(0.0, 1.0, size=cm["mu_k"].shape).astype(np.float32)
    cm["mu_r"] = rng.uniform(0.0, 1.0, size=cm["mu_r"].shape).astype(np.float32)
    for norm in (blk["ln1"], blk["ln2"], tm["ln_x"], v["ln0"], v["final_norm"]):
        norm["scale"] = normal(norm["scale"], 0.1, 1.0)
        norm["bias"] = normal(norm["bias"], 0.1)
    return jax.tree.map(jnp.asarray, v)


@pytest.fixture(scope="module")
def ref_fns():
    """The reference's block functions, each jitted once (a shape or
    dtype compiles anew); the config's sizes are closed over."""
    rc = _cfgs("f32")[0]
    H, dh = rc.rwkv_heads, rc.rwkv_head_size
    return dict(
        time_mix_inputs=jax.jit(RR._time_mix_inputs),
        decay=jax.jit(lambda p, xw: RR._decay(p, xw, H, dh)),
        wkv=jax.jit(RR._wkv_chunked),
        time_mix=jax.jit(lambda p, x, st: RR.rwkv_time_mix(p, x, rc, st)),
        channel_mix=jax.jit(lambda p, x, st: RR.rwkv_channel_mix(p, x, rc, st)),
        block=jax.jit(lambda p, x, st: RR.rwkv_block_apply(p, x, rc, st)))


@pytest.fixture(scope="module")
def rwkv():
    """(dtype, variant) -> the reference cfg, values and model functions
    (jitted once per dtype), the port's cfg and params."""
    jits, built = {}, {}
    # the f32 master values, the same in either compute dtype
    init = jax.jit(lambda key: RM.init_params(_cfgs("f32")[0], key)[0])(jax.random.PRNGKey(0))

    def get(dt="f32", variant="init"):
        if (dt, variant) not in built:
            rc, pc = _cfgs(dt)
            if dt not in jits:
                rm = RM.build_model(rc)

                def loss(p, b):
                    return RM.loss_fn(rm, RM._cast_compute(p, rc.compute_dtype), b, rc)

                jits[dt] = dict(rm=rm, forward=jax.jit(rm.forward), prefill=jax.jit(rm.prefill),
                                decode=jax.jit(rm.decode), vg=jax.jit(jax.value_and_grad(loss)))
            values = init if variant == "init" else _perturb(init, variant == "clip")
            built[(dt, variant)] = dict(jits[dt], rc=rc, pc=pc, values=values, params=lm_params_from_reference(
                jax.tree.map(np.asarray, values), pc, device="cpu"))
        return built[(dt, variant)]

    return get


def _tokens(n, length, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(n, length)).astype(np.int32)


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _paths(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _layer0(m):
    """Layer 0's block params: (reference jnp tree, port tree)."""
    return jax.tree.map(lambda t: t[0], m["values"]["blocks"]), jax.tree.map(lambda t: t[0], m["params"]["blocks"])


# --------------------------------------------------------------------------
# module 1: the block's functions
# --------------------------------------------------------------------------

def test_block_init_distributions():
    """The reference's leaves, shapes and distributions; f32 master."""
    rc, pc = _cfgs("f32")
    want = jax.tree.map(np.asarray, jax.jit(lambda key: RL.split(RR.rwkv_block_init(key, rc))[0])(
        jax.random.PRNGKey(3)))
    got = PR.rwkv_block_init(PR._Draw(torch.Generator().manual_seed(3), "cpu"), (), pc)
    lw, lg = _leaves(want), _leaves(got)
    assert lw.keys() == lg.keys()
    for k in lw:
        assert lg[k].shape == lw[k].shape, k
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))
    for k in ("/tm/mu", "/tm/decay_mu", "/tm/bonus_u", "/cm/mu_k", "/cm/mu_r", "/ln1/scale", "/ln1/bias",
              "/tm/ln_x/bias"):
        assert np.array_equal(lg[k], lw[k]), k
    d = pc.d_model
    for k, scale in (("/tm/maa_w1", d**-0.5), ("/tm/maa_w2", 0.01), ("/tm/decay_w1", d**-0.5),
                     ("/tm/decay_w2", 0.01), ("/tm/wr/w", d**-0.5), ("/cm/wv/w", pc.d_ff**-0.5)):
        assert abs(lg[k].std() / scale - 1) < 0.15 and abs(lw[k].std() / scale - 1) < 0.15, k


@pytest.mark.parametrize("dt", DTYPES)
def test_token_shift(dt):
    rng = np.random.default_rng(1)
    x, prev = rng.normal(size=(2, 7, 64)).astype(np.float32), rng.normal(size=(2, 64)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    want = RR._token_shift(jnp.asarray(x, jdt), jnp.asarray(prev, jnp.bfloat16))  # a bf16 shift, as init_cache's
    got = PR._token_shift(_t(x, tdt), _t(prev, torch.bfloat16))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert np.array_equal(_np(got), _jnp(want))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
def test_time_mix_inputs_and_decay(rwkv, ref_fns, dt, variant):
    m = rwkv(dt, variant)
    ref, port = _layer0(m)
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    x, xs = (rng.normal(size=(2, 20, m["pc"].d_model)).astype(np.float32) for _ in range(2))
    want = ref_fns["time_mix_inputs"](ref["tm"], jnp.asarray(x, jdt), jnp.asarray(xs, jdt))
    got = PR._time_mix_inputs(port["tm"], _t(x, tdt), _t(xs, tdt))
    for name, g, w in zip("rkvwg", got, want, strict=True):
        assert g.dtype == tdt
        _close(_np(g), _jnp(w), RTOL[dt], f"stream {name}")
    H, dh = m["pc"].rwkv_heads, m["pc"].rwkv_head_size
    lw = PR._decay(port["tm"], got[3], H, dh)
    want_lw = ref_fns["decay"](ref["tm"], jnp.asarray(_np(got[3]), jdt))
    assert lw.dtype == torch.float32
    _close(_np(lw), _jnp(want_lw), RTOL[dt], "log decays")
    if variant == "clip":
        assert float(lw.mean()) < -3  # the clip binds within a chunk: cum < -30 after ~7 tokens


def _wkv_inputs(dt, T, variant, seed=4, Bw=2, H=2, dh=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(Bw, T, H, dh)).astype(np.float32) for _ in range(3))
    mu = {"init": -6.0, "perturbed": -4.0, "clip": 1.5}[variant]
    lw = -np.exp(mu + 0.5 * rng.normal(size=(Bw, T, H, dh))).astype(np.float32)
    u = np.zeros((H, dh), np.float32) if variant == "init" else (0.5 * rng.normal(size=(H, dh))).astype(np.float32)
    S0 = rng.normal(size=(Bw, H, dh, dh)).astype(np.float32)
    return r, k, v, lw, u, S0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T", WKV_T)
def test_wkv_chunked(ref_fns, T, dt, variant):
    """One chunk (T <= 64), two and three chunks, a nonzero S0."""
    r, k, v, lw, u, S0 = _wkv_inputs(dt, T, variant)
    jdt, tdt = DTYPES[dt]
    o_w, S_w = ref_fns["wkv"](*(jnp.asarray(a, jdt) for a in (r, k, v)), jnp.asarray(lw), jnp.asarray(u), jnp.asarray(S0))
    o, S_T = PR._wkv_chunked(*(_t(a, tdt) for a in (r, k, v)), _t(lw), _t(u), _t(S0))
    assert o.dtype == tdt and S_T.dtype == torch.float32 and tuple(S_T.shape) == S_w.shape
    _close(_np(o), _jnp(o_w), RTOL[dt], "o")
    _close(_np(S_T), _jnp(S_w), RTOL[dt], "S_T")


def _serial_wkv(r, k, v, lw, u, S0):
    """The recurrence itself in f64, token by token."""
    r, k, v, w, u, S = (np.asarray(a, np.float64) for a in (r, k, v, np.exp(lw), u, S0))
    o = np.zeros_like(r)
    for t in range(r.shape[1]):
        kv = np.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        o[:, t] = np.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
    return o, S


@pytest.mark.parametrize("variant", ("init", "perturbed"))
@pytest.mark.parametrize("T", (9, 192))
def test_wkv_against_the_serial_recurrence(T, variant):
    """Where the clip does not bind, the chunked form is the recurrence."""
    args = _wkv_inputs("f32", T, variant)
    o, S_T = PR._wkv_chunked(*(_t(a) for a in args))
    o_w, S_w = _serial_wkv(*args)
    _close(_np(o), o_w, 1e-5, "o against the recurrence")
    _close(_np(S_T), S_w, 1e-5, "S_T against the recurrence")


def test_wkv_clip_binds_and_changes_the_result():
    """At log decays of ~-4.5 a token the clip binds: the chunked form
    (the reference's and the port's) leaves the recurrence."""
    args = _wkv_inputs("f32", 64, "clip")
    o, _ = PR._wkv_chunked(*(_t(a) for a in args))
    o_w, _ = _serial_wkv(*args)
    assert np.abs(_np(o) - o_w).max() > 1e-2 * np.abs(o_w).max()


@pytest.mark.parametrize("T", (65, 100, 127, 200))
def test_chunk_rule(T):
    """The reference asserts T % min(64, T) == 0; the port raises."""
    args = _wkv_inputs("f32", T, "init")
    with pytest.raises(AssertionError):
        RR._wkv_chunked(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="multiple of 64"):
        PR._wkv_chunked(*(_t(a) for a in args))


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("variant", ("perturbed", "clip"))
@pytest.mark.parametrize("dt", DTYPES)
def test_time_mix_channel_mix_and_block(rwkv, ref_fns, dt, variant, with_state):
    """Layer 0's time-mix, channel-mix and whole block at T = 128, from
    zero state (training) or a seeded state (bf16 shifts, f32 S)."""
    m = rwkv(dt, variant)
    ref, port = _layer0(m)
    cfg_p = m["pc"]
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 128, cfg_p.d_model)).astype(np.float32)
    st_r = st_p = None
    if with_state:
        st = {"shift_tm": rng.normal(size=(2, cfg_p.d_model)), "shift_cm": rng.normal(size=(2, cfg_p.d_model)),
              "S": rng.normal(size=(2, cfg_p.rwkv_heads, cfg_p.rwkv_head_size, cfg_p.rwkv_head_size))}
        st_r = {k: jnp.asarray(a, jnp.float32 if k == "S" else jnp.bfloat16) for k, a in st.items()}
        st_p = lm_cache_from_reference(jax.tree.map(np.asarray, st_r), device="cpu")
    xj, xt = jnp.asarray(x, jdt), _t(x, tdt)
    for name, fp, p_r, p_p in (("time_mix", PR.rwkv_time_mix, ref["tm"], port["tm"]),
                               ("channel_mix", PR.rwkv_channel_mix, ref["cm"], port["cm"]),
                               ("block", PR.rwkv_block_apply, ref, port)):
        y_w, s_w = ref_fns[name](p_r, xj, st_r)
        y, s = fp(p_p, xt, cfg_p, st_p)
        assert y.dtype == tdt
        _close(_np(y), _jnp(y_w), RTOL[dt], name)
        assert set(s) == set(s_w)
        for k in s_w:
            assert str(s[k].dtype).split(".")[-1] == str(s_w[k].dtype), (name, k)
            _close(_np(s[k]), _jnp(s_w[k]), RTOL[dt], f"{name} state {k}")


def test_init_state():
    rc, pc = _cfgs("f32")
    want = RR.rwkv_init_state(rc, 3)
    got = PR.rwkv_init_state(pc, 3)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
def test_forward_prefill_and_decode(rwkv, dt, variant):
    """Forward logits and prefill logits and states at 2 x 128 tokens,
    then two decode steps from the reference's prefill state, carried."""
    m = rwkv(dt, variant)
    rtol = dict(RTOL, bf16=CLIP_BF16_RTOL) if variant == "clip" else RTOL
    drtol = dict(DECODE_RTOL, bf16=CLIP_BF16_RTOL) if variant == "clip" else DECODE_RTOL
    toks = _tokens(2, 128, 5)
    want = m["forward"](m["values"], {"tokens": jnp.asarray(toks)})
    got = M.build_model(m["pc"]).forward(m["params"], {"tokens": _t(toks, torch.int64)})
    assert got.dtype == m["pc"].compute_dtype and tuple(got.shape) == want.shape
    _close(_np(got), _jnp(want), rtol[dt], "forward logits")
    lr, sr = m["prefill"](m["values"], jnp.asarray(toks))
    lp, sp = M.make_prefill(m["pc"])(m["params"], {"tokens": _t(toks, torch.int64)})
    _close(_np(lp), _jnp(lr), rtol[dt], "prefill logits")
    for k in sr:
        assert str(sp[k].dtype).split(".")[-1] == str(sr[k].dtype) and tuple(sp[k].shape) == sr[k].shape, k
        _close(_np(sp[k]), _jnp(sr[k]), rtol[dt], f"prefill state {k}")
    states = lm_cache_from_reference(jax.tree.map(np.asarray, sr), device="cpu")
    step = M.make_serve_step(m["pc"])
    for i, tok in enumerate(_tokens(2, 2, 6).T):
        lr, sr = m["decode"](m["values"], sr, jnp.asarray(tok[:, None]), 128 + i)
        lp, states = step(m["params"], states, _t(tok[:, None], torch.int64), 128 + i)
        _close(_np(lp), _jnp(lr), drtol[dt], f"decode step {i} logits")
        for k in sr:
            assert str(states[k].dtype).split(".")[-1] == str(sr[k].dtype), (i, k)


def test_decode_after_prefill_contract(rwkv):
    """The reference's TestPerArch contract at S = 8 (prefill(t[:8]) then
    decode(t[8]) against prefill(t[:9])), and prefill(128) then 64 decode
    steps against prefill(192), each step against the reference's."""
    m = rwkv("f32", "perturbed")
    model = M.build_model(m["pc"])
    toks = _tokens(2, 192, 7)
    for n, extra in ((8, 1), (128, 64)):
        _, states = model.prefill(m["params"], _t(toks[:, :n], torch.int64))
        _, sr = m["prefill"](m["values"], jnp.asarray(toks[:, :n]))
        for i in range(n, n + extra):
            tok = toks[:, i:i + 1]
            logits, states = model.decode(m["params"], states, _t(tok, torch.int64), i)
            lr, sr = m["decode"](m["values"], sr, jnp.asarray(tok), i)
            _close(_np(logits), _jnp(lr), DECODE_RTOL["f32"], f"decode step at {i}")
        full, fstates = model.prefill(m["params"], _t(toks[:, :n + extra], torch.int64))
        _close(_np(logits), _np(full), DECODE_RTOL["f32"], f"prefill({n}) + {extra} steps against prefill")
        _close(_np(states["S"]), _np(fstates["S"]), DECODE_RTOL["f32"], "the state after the steps")


@pytest.mark.parametrize("T", (100, 65))
def test_prefill_refuses_the_reference_s_rejects(rwkv, T):
    m = rwkv("f32")
    toks = _tokens(1, T, 8)
    with pytest.raises(AssertionError):
        m["prefill"](m["values"], jnp.asarray(toks))
    with pytest.raises(ValueError, match="multiple of 64"):
        M.build_model(m["pc"]).prefill(m["params"], _t(toks, torch.int64))


def test_state_is_o1_in_the_sequence():
    """The reference's test_rwkv_no_kv_cache_growth on the port, at full
    width on the meta device: the same state at cache_len 8 and 9000."""
    cfg = C.get(ARCH)
    model = M.build_model(cfg)
    c8, c9000 = (model.init_cache(2, n, device="meta") for n in (8, 9000))
    size = [sum(t.numel() * t.element_size() for t in tree_leaves(c)) for c in (c8, c9000)]
    ref = jax.eval_shape(lambda: RM.build_model(RC.get(ARCH)).init_cache(2, 8))
    assert size[0] == size[1] == sum(np.prod(a.shape) * a.dtype.itemsize for a in jax.tree.leaves(ref))
    assert {k: (tuple(t.shape), t.dtype) for k, t in c8.items()} == {
        "shift_tm": ((24, 2, 2048), torch.bfloat16), "shift_cm": ((24, 2, 2048), torch.bfloat16),
        "S": ((24, 2, 32, 64, 64), torch.float32)}


def test_leaf_by_leaf_build_is_the_compute_copy():
    """``init_compute_params`` bit for bit ``compute_copy(init_params)``:
    the dense weights and tables in bf16, the norms and RWKV's bare
    leaves f32."""
    cfg = C.get_smoke(ARCH)
    full = M.compute_copy(M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu"), cfg)
    built = M.init_compute_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    a, b = _paths(full), _paths(built)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    f32 = {k for k, t in b.items() if t.dtype == torch.float32}
    assert {"/blocks/tm/mu", "/blocks/tm/maa_w1", "/blocks/tm/maa_w2", "/blocks/tm/decay_mu", "/blocks/tm/decay_w1",
            "/blocks/tm/decay_w2", "/blocks/tm/bonus_u", "/blocks/cm/mu_k", "/blocks/cm/mu_r"} <= f32
    assert b["/blocks/tm/wr/w"].dtype == b["/embed/table"].dtype == b["/unembed/table"].dtype == torch.bfloat16


def test_full_width_counts():
    cfg = C.get(ARCH)
    assert M.count_params(M.init_params(cfg, device="meta")) == 1_599_823_872
    assert M.model_flops_per_token(cfg) == RM.model_flops_per_token(RC.get(ARCH)) == 8_793_636_864


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _serve(m, port: bool, prompts, temperature=0.0, dtypes=None):
    """Serve through one engine; returns each request's tokens and the
    sampler's log (rid, logits, token).  ``dtypes`` collects the caches'
    dtypes after the first admission and after the first decode step."""
    log = []
    if port:
        eng = ServeEngine(m["pc"], m["params"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW, temperature=temperature)
                for i, p in enumerate(prompts)]
    else:
        eng = RServeEngine(m["rc"], m["values"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED)
        # the model's jitted prefill is the engine's (its _prefill_one is model.prefill for this family)
        eng._prefill, eng.serve_step = m["prefill"], m.setdefault("serve_step", eng.serve_step)
        reqs = [RRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW, temperature=temperature)
                for i, p in enumerate(prompts)]
    sample = eng._sample

    def logged(logits, req):
        tok = sample(logits, req)
        log.append((req.rid, np.asarray(logits[: eng.cfg.vocab_size], np.float64), tok))
        return tok

    eng._sample = logged
    for r in reqs:
        eng.submit(r)
    if dtypes is not None:
        eng._admit()
        dtypes.append({k: str(t.dtype).split(".")[-1] for k, t in eng.caches.items()})
        eng.step()
        dtypes.append({k: str(t.dtype).split(".")[-1] for k, t in eng.caches.items()})
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], log


def _compare_engines(m, dt, temperature=0.0):
    """``tests/test_torch_lm.py``'s rule with this dtype's logit bound."""
    prompts = [_tokens(1, n, 20 + i)[0] for i, n in enumerate(PROMPT_LENS)]
    ref_dtypes, got_dtypes = [], []
    ref_toks, ref_log = _serve(m, False, prompts, temperature, ref_dtypes)
    got_toks, got_log = _serve(m, True, prompts, temperature, got_dtypes)
    assert got_dtypes == ref_dtypes
    rtol = RTOL[dt]
    for n, ((rid, logits, want), (rid_g, got_logits, got)) in enumerate(zip(ref_log, got_log)):
        assert rid == rid_g, f"sampler call {n}: request {rid_g} where the reference serves {rid}"
        _close(got_logits, logits, rtol, f"sampler call {n} (request {rid})'s logits")
        if want == got:
            continue
        tol = rtol * float(np.abs(logits).max())
        if temperature <= 0.0:
            assert logits[want] - logits[got] <= 2 * tol, f"request {rid} parts at call {n}"
        else:
            p = np.exp((logits - logits.max()) / temperature)
            cdf = np.cumsum(p) / p.sum()
            u = np.random.default_rng(ENGINE_SEED).random(n + 1)[n]
            lo, hi = sorted((want, got))
            assert float(np.abs(cdf[lo:hi] - u).min()) <= 2 * tol / temperature, f"request {rid} parts at call {n}"
        return ref_dtypes, ref_toks
    assert len(ref_log) == len(got_log) and ref_toks == got_toks
    return ref_dtypes, ref_toks


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temperature"])
@pytest.mark.parametrize("dt", DTYPES)
def test_engine_matches_reference(rwkv, dt, temperature):
    """7 ragged requests (one of 128 tokens) on 3 slots; the caches'
    dtypes after the first admission and the first decode step are the
    reference engine's: under f32 compute the shifts are bf16 until the
    first decode and f32 after it."""
    m = rwkv(dt, "perturbed")
    dtypes, _ = _compare_engines(m, dt, temperature)
    shift = "float32" if dt == "f32" else "bfloat16"
    assert dtypes == [{"shift_tm": "bfloat16", "shift_cm": "bfloat16", "S": "float32"},
                      {"shift_tm": shift, "shift_cm": shift, "S": "float32"}]


def test_engine_serves_from_the_compute_copy(rwkv):
    m = rwkv("bf16")
    eng = ServeEngine(m["pc"], m["params"], slots=2, cache_len=16, device="cpu")
    tm = eng.params["blocks"]["tm"]
    assert tm["wr"]["w"].dtype == eng.params["unembed"]["table"].dtype == torch.bfloat16
    assert tm["decay_w2"].dtype == tm["bonus_u"].dtype == tm["mu"].dtype == torch.float32


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(seed=1, batch=B):
    toks = _tokens(batch, S + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("variant", ("init", "perturbed"))
@pytest.mark.parametrize("dt", DTYPES)
def test_train_step_gradients(rwkv, dt, variant):
    """One step's loss, grad norm and every gradient leaf at (2, 128)
    against ``jax.value_and_grad`` of the reference step's loss."""
    m = rwkv(dt, variant)
    batch = _batch()
    loss, grads = m["vg"](m["values"], {k: jnp.asarray(v) for k, v in batch.items()})
    want_gnorm = float(RO.global_norm(grads))
    ploss, pgrads = M.make_value_and_grad(m["pc"])(m["params"], {k: _t(v) for k, v in batch.items()})
    pgnorm = float(PO.global_norm(pgrads))
    assert abs(float(ploss) - float(loss)) <= STEP_LOSS_RTOL[dt] * abs(float(loss))
    assert abs(pgnorm - want_gnorm) <= STEP_GNORM_RTOL[dt] * want_gnorm
    lp, lr_ = _leaves(pgrads), _leaves(grads)
    assert lp.keys() == lr_.keys() and all(t.dtype == torch.float32 for t in tree_leaves(pgrads))
    for k in lr_:
        assert _rel_norm(lp[k], lr_[k]) <= STEP_LEAF_RTOL[dt], (k, _rel_norm(lp[k], lr_[k]))


def test_remat_modes_and_microbatches(rwkv):
    """The three remat modes bit for bit; microbatches=2 against 1, and
    its step's loss and grad norm against the reference's on the whole
    batch."""
    m = rwkv("f32", "perturbed")
    batch = _batch(seed=9, batch=4)
    tb = {k: _t(v) for k, v in batch.items()}
    runs = {}
    for mode in ("none", "full", "dots"):
        loss, grads = M.make_value_and_grad(m["pc"].replace(remat=mode))(m["params"], tb)
        runs[mode] = (float(loss), _leaves(grads))
    for mode in ("full", "dots"):
        assert runs[mode][0] == runs["none"][0]
        assert all(np.array_equal(runs[mode][1][k], runs["none"][1][k]) for k in runs["none"][1]), mode
    l2, g2 = M.make_value_and_grad(m["pc"], microbatches=2)(m["params"], tb)
    assert abs(float(l2) - runs["none"][0]) <= 1e-6 * abs(runs["none"][0])
    g2 = _leaves(g2)
    assert all(_rel_norm(g2[k], runs["none"][1][k]) <= 1e-5 for k in g2)
    # against the reference's whole step's loss and grad norm (one batch: the jitted value_and_grad)
    loss, grads = m["vg"](m["values"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_reference(jax.tree.map(np.asarray, m["values"]), m["pc"], device="cpu")
    _, state, pm = M.make_train_step(m["pc"], PO.AdamWConfig(lr=1e-3), microbatches=2)(
        params, PO.adamw_init(params), tb)
    assert abs(float(pm["loss"]) - float(loss)) <= STEP_LOSS_RTOL["f32"] * abs(float(loss))
    want_gnorm = float(RO.global_norm(grads))
    assert abs(float(pm["grad_norm"]) - want_gnorm) <= STEP_GNORM_RTOL["f32"] * want_gnorm
    assert int(state["step"]) == 1


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_serve_cli_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                           "--max-new", "4"]) == 0
    assert "served 5/5 requests" in capsys.readouterr().out


def _train(out, *extra):
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--lr", "5e-3",
                             "--out", str(out), *extra])
    assert rc == 0
    return stdout.getvalue()


def test_train_cli_on_the_cpu(tmp_path):
    """Eight steps at S = 128 (two chunks); a --seq of 100 is refused by
    the chunk rule."""
    out = _train(tmp_path / "a", "--steps", "8", "--seq", "128")
    assert "done: 8 steps" in out
    with pytest.raises(ValueError, match="multiple of 64"):
        _train(tmp_path / "b", "--steps", "1", "--seq", "100")
