"""The port's hybrid family (zamba2: Mamba-2 + a shared attention block)
against the JAX package's, on the CPU.

The reference's ``init_params(cfg, PRNGKey(0))`` at zamba2-7b's SMOKE
size (9 layers = 2 groups of 2 Mamba-2 blocks and one application of the
shared block, then a tail of 3; d_model 64, SSD 8 heads of 16, state 16,
one B/C group; the shared block 4/4 heads of 112, the head size that
``replace`` keeps from the full config, in both packages) reaches the
port through ``carry.lm_params_from_reference``; inputs are made with
numpy.  Two variants of the params:

- ``init``: as drawn.  There ``A_log`` and ``dt_bias`` are 0, so a
  token's decay is about 0.5 and the state carries over only a few
  tokens; ``D`` is 1, ``conv_b`` 0 and the norm scales 1;
- ``seeded``: those leaves replaced by seeded values (``A_log`` about
  log 0.05, ``dt_bias`` about -4: decays near 1, so the carried state
  makes most of a chunk's output), so every term moves the output.

Tolerances, each relative to the largest |value| of the reference's
output (``tests/test_torch_lm.py``'s): f32 1e-5 for a function or a
forward, 1e-4 for decode steps; bf16 5e-2.  Prefill logits and states
in f32 and the engines' logits: 2e-3, as ``tests/test_torch_lm.py`` sets
them, because the KV cache is bf16 whatever the compute dtype and a
prefill attends over the rounded K/V; the stored K/V themselves: one
bf16 ulp of the largest, 2^-7.  The port's SSD against a serial f64
recurrence: 1e-5 of the largest |y| and |h| (f32 chunk products against
exact sums).  A train step: ``tests/test_torch_train.py``'s ``STEP_*``
bounds.

The reference's chunk rule (``ssm.py:87-88``, ``T % min(64, T) == 0``):
a sequence longer than 64 tokens must be a multiple of 64, so the
prompts here have at most 64 tokens or 128.
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
from repro.models import ssm as RS
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro.train import optim as RO
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models import ssm as PS
from repro_torch.models.transformer import _Draw
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import optim as PO
from repro_torch.tree import tree_leaves

ARCH = "zamba2-7b"
RTOL = {"f32": 1e-5, "bf16": 5e-2}
DECODE_RTOL = {"f32": 1e-4, "bf16": 5e-2}
PREFILL_RTOL = {"f32": 2e-3, "bf16": 5e-2}  # prefill attends over the bf16 KV cache (see the module docstring)
# the prefill's K/V as stored, in bf16 in either dtype: an element that the two BLAS put on either side of a bf16
# rounding boundary differs by one bf16 ulp, at most 2^-7 of the largest |value|
KV_RTOL = 2.0**-7
VARIANTS = ("init", "seeded")
SSD_T = (1, 9, 64, 128, 192)
# the engines' requests: ragged prompts within the chunk rule, one of 128 tokens (two chunks), on 3 slots
PROMPT_LENS = (5, 128, 9, 40, 9, 5, 40)
SLOTS, CACHE_LEN, MAX_NEW, ENGINE_SEED = 3, 256, 6, 5
B, S = 2, 128  # a train step: two chunks
# zamba2-7b's decode state per slot, the reference's jax.eval_shape of init_cache(1, n) at n = 8 and 8192
STATE_BYTES = {8: 129_248_308, 8192: 1_654_484_020}


def _cfgs(dt):
    jdt, tdt = DTYPES[dt]
    return RC.get_smoke(ARCH).replace(compute_dtype=jdt), C.get_smoke(ARCH).replace(compute_dtype=tdt)


def _seed_mamba(mamba, rng):
    """A Mamba-2 block's init-constant leaves from a seed (in place)."""
    def normal(a, scale, shift=0.0):
        return (shift + scale * rng.normal(size=np.shape(a))).astype(np.float32)

    mamba["A_log"] = normal(mamba["A_log"], 0.3, np.log(0.05))
    mamba["dt_bias"] = normal(mamba["dt_bias"], 0.5, -4.0)
    mamba["D"] = normal(mamba["D"], 0.5)
    mamba["conv_b"] = normal(mamba["conv_b"], 0.1)
    mamba["norm"]["scale"] = normal(mamba["norm"]["scale"], 0.1, 1.0)


def _seed(values, seed=11):
    """The reference's values with the leaves that are constant at init
    drawn from a seed: every Mamba-2 block's ``A_log``, ``dt_bias``,
    ``D``, ``conv_b`` and norms, the shared block's and the final norm."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.array, values)
    for part in ("mamba_groups", "mamba_tail"):
        _seed_mamba(v[part]["mamba"], rng)
        v[part]["ln"]["scale"] = (1.0 + 0.1 * rng.normal(size=v[part]["ln"]["scale"].shape)).astype(np.float32)
    for norm in (v["shared_attn"]["ln1"], v["shared_attn"]["ln2"], v["final_norm"]):
        norm["scale"] = (1.0 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, v)


@pytest.fixture(scope="module")
def ref_fns():
    """The reference's block functions, each jitted once (a shape or
    dtype compiles anew); the config's sizes are closed over."""
    rc = _cfgs("f32")[0]
    return dict(conv=jax.jit(RS._causal_conv), segsum=jax.jit(RS._segsum_decay), ssd=jax.jit(RS._ssd_chunked),
                mamba=jax.jit(lambda p, x, st: RS.mamba2_apply(p, x, rc, st)))


@pytest.fixture(scope="module")
def hybrid():
    """(dtype, variant) -> the reference cfg, values and model functions
    (jitted once per dtype), the port's cfg and params."""
    jits, built = {}, {}
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
            values = init if variant == "init" else _seed(init)
            built[(dt, variant)] = dict(jits[dt], rc=rc, pc=pc, values=values, params=lm_params_from_reference(
                jax.tree.map(np.asarray, values), pc, device="cpu"))
        return built[(dt, variant)]

    return get


def _tokens(n, length, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(n, length)).astype(np.int32)


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _dt(t) -> str:
    return str(t.dtype).split(".")[-1]


def _paths(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _layer0(m):
    """The first Mamba-2 block's params: (reference jnp tree, port tree)."""
    return (jax.tree.map(lambda t: t[0, 0], m["values"]["mamba_groups"]),
            jax.tree.map(lambda t: t[0, 0], m["params"]["mamba_groups"]))


# --------------------------------------------------------------------------
# module 1: the Mamba-2 block's functions
# --------------------------------------------------------------------------

def test_mamba2_init_distributions():
    """The reference's leaves, shapes and distributions; f32 master."""
    rc, pc = _cfgs("f32")
    want = jax.tree.map(np.asarray, jax.jit(lambda key: RL.split(RS.mamba2_init(key, rc))[0])(
        jax.random.PRNGKey(3)))
    got = PS.mamba2_init(_Draw(torch.Generator().manual_seed(3), "cpu"), (), pc)
    lw, lg = _leaves(want), _leaves(got)
    assert lw.keys() == lg.keys()
    for k in lw:
        assert lg[k].shape == lw[k].shape, k
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))
    for k in ("/conv_b", "/A_log", "/D", "/dt_bias", "/norm/scale"):
        assert np.array_equal(lg[k], lw[k]), k
    d_inner = PS.ssm_dims(pc)[0]
    for k, scale in (("/in_proj", pc.d_model**-0.5), ("/conv_w", 0.1), ("/out_proj", d_inner**-0.5)):
        assert abs(lg[k].std() / scale - 1) < 0.15 and abs(lw[k].std() / scale - 1) < 0.15, k


def test_ssm_dims_at_full_width():
    cfg = C.get(ARCH)
    assert PS.ssm_dims(cfg) == RS.ssm_dims(RC.get(ARCH)) == (7168, 112, 7296)


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("dt", DTYPES)
def test_causal_conv(ref_fns, dt, with_state):
    """T = 9 with a seeded bias, from zeros or a bf16 conv state (as
    init_cache gives it), and a decode step's T = 1."""
    rng = np.random.default_rng(1)
    jdt, tdt = DTYPES[dt]
    w, b = rng.normal(size=(PS.CONV_W, 40)) * 0.1, rng.normal(size=(40,)) * 0.1
    wj, bj, wt, bt = jnp.asarray(w, jdt), jnp.asarray(b, jdt), _t(w, tdt), _t(b, tdt)
    for T in (9, 1):
        x = rng.normal(size=(2, T, 40))
        st = rng.normal(size=(2, PS.CONV_W - 1, 40)) if with_state else None
        out_w, ns_w = ref_fns["conv"](jnp.asarray(x, jdt), wj, bj, None if st is None else jnp.asarray(st, jnp.bfloat16))
        out, ns = PS._causal_conv(_t(x, tdt), wt, bt, None if st is None else _t(st, torch.bfloat16))
        assert _dt(out) == str(out_w.dtype) and _dt(ns) == str(ns_w.dtype) and tuple(ns.shape) == ns_w.shape
        _close(_np(out), _jnp(out_w), RTOL[dt], f"conv out at T = {T}")
        assert np.array_equal(_np(ns), _jnp(ns_w)), f"conv state at T = {T}"


def test_segsum_decay_never_exponentiates_a_positive_number(ref_fns):
    """The masked decays against the reference's on a chunk's log decays,
    and finite values and gradients where cum_i − cum_j above the
    diagonal would overflow exp (a masked exp(+300) times 0 gives NaN)."""
    rng = np.random.default_rng(2)
    cum = -np.cumsum(rng.uniform(0, 0.5, size=(3, 64)), axis=-1).astype(np.float32)
    _close(_np(PS._segsum_decay(_t(cum))), _jnp(ref_fns["segsum"](jnp.asarray(cum))), RTOL["f32"], "decays")
    steep = -np.cumsum(rng.uniform(0, 10, size=(3, 64)), axis=-1).astype(np.float32)
    assert float(steep[:, 0].max() - steep[:, -1].min()) > 200
    t = _t(steep).requires_grad_()
    got = PS._segsum_decay(t)
    got.sum().backward()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(t.grad).all())
    assert float(got.detach().triu(1).abs().max()) == 0.0


def _ssd_inputs(T, variant, seed=4, Bw=2, H=8, P=16, G=1, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bw, T, H, P)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bw, T, G, N)).astype(np.float32) for _ in range(2))
    if variant == "init":
        A_log, dt_bias = np.zeros(H, np.float32), np.zeros(H, np.float32)
    else:
        A_log = (np.log(0.05) + 0.3 * rng.normal(size=H)).astype(np.float32)
        dt_bias = (-4.0 + 0.5 * rng.normal(size=H)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(Bw, T, H)) + dt_bias, 0.0).astype(np.float32)  # softplus
    h0 = rng.normal(size=(Bw, H, N, P)).astype(np.float32)
    return x, dt, Bm, Cm, A_log, h0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T", SSD_T)
def test_ssd_chunked(ref_fns, T, dt, variant):
    """One chunk (T <= 64), two and three chunks, a nonzero h0."""
    x, dtv, Bm, Cm, A_log, h0 = _ssd_inputs(T, variant)
    jdt, tdt = DTYPES[dt]
    y_w, h_w = ref_fns["ssd"](jnp.asarray(x, jdt), jnp.asarray(dtv), jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt),
                              jnp.asarray(A_log), jnp.asarray(h0))
    y, h = PS._ssd_chunked(_t(x, tdt), _t(dtv), _t(Bm, tdt), _t(Cm, tdt), _t(A_log), _t(h0))
    assert y.dtype == tdt and h.dtype == torch.float32 and tuple(h.shape) == h_w.shape
    _close(_np(y), _jnp(y_w), RTOL[dt], "y")
    _close(_np(h), _jnp(h_w), RTOL[dt], "h_T")


@pytest.mark.parametrize("dt", DTYPES)
def test_ssd_chunked_groups_broadcast_to_their_heads(ref_fns, dt):
    """Two B/C groups of 4 heads each (the reference's ``jnp.repeat``:
    head h reads group h // 4) at T = 128."""
    x, dtv, Bm, Cm, A_log, h0 = _ssd_inputs(128, "seeded", G=2)
    jdt, tdt = DTYPES[dt]
    y_w, h_w = ref_fns["ssd"](jnp.asarray(x, jdt), jnp.asarray(dtv), jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt),
                              jnp.asarray(A_log), jnp.asarray(h0))
    y, h = PS._ssd_chunked(_t(x, tdt), _t(dtv), _t(Bm, tdt), _t(Cm, tdt), _t(A_log), _t(h0))
    _close(_np(y), _jnp(y_w), RTOL[dt], "y")
    _close(_np(h), _jnp(h_w), RTOL[dt], "h_T")


def _serial_ssd(x, dt, Bm, Cm, A_log, h0):
    """The recurrence itself in f64, token by token:
    h_t = exp(Δ_t·A) h_{t-1} + Δ_t x_t ⊗ B_t, y_t = C_t · h_t."""
    x, dt, Bm, Cm, h = (np.asarray(a, np.float64) for a in (x, dt, Bm, Cm, h0))
    rep = x.shape[2] // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    A = -np.exp(np.asarray(A_log, np.float64))
    y = np.zeros_like(x)
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t] * A)[..., None, None] * h + dt[:, t, :, None, None] * Bh[:, t, :, :, None] * x[:, t, :, None]
        y[:, t] = np.einsum("bhn,bhnp->bhp", Ch[:, t], h)
    return y, h


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("T", (9, 192))
def test_ssd_against_the_serial_recurrence(T, variant):
    """The chunked form is the recurrence, and in ``seeded`` the carried
    state makes most of the later chunks' output."""
    args = _ssd_inputs(T, variant)
    y, h = PS._ssd_chunked(*(_t(a) for a in args))
    y_w, h_w = _serial_ssd(*args)
    _close(_np(y), y_w, 1e-5, "y against the recurrence")
    _close(_np(h), h_w, 1e-5, "h_T against the recurrence")
    if variant == "seeded" and T == 192:
        x, dtv, Bm, Cm, A_log, h0 = args
        y0, _ = _serial_ssd(x, dtv, Bm, Cm, A_log, np.zeros_like(h0))  # the same tokens with no initial state
        y_late = y_w[:, 64:]
        assert np.abs(y_late - y0[:, 64:]).max() > 0.5 * np.abs(y_late).max()


@pytest.mark.parametrize("T", (65, 100, 127, 200))
def test_chunk_rule(T):
    """The reference asserts T % min(64, T) == 0; the port raises."""
    args = _ssd_inputs(T, "init")
    with pytest.raises(AssertionError):
        RS._ssd_chunked(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="multiple of 64"):
        PS._ssd_chunked(*(_t(a) for a in args))


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
def test_mamba2_apply(hybrid, ref_fns, dt, variant, with_state):
    """The first Mamba-2 block at T = 128, from zero state (training) or a
    seeded state (bf16 conv rows, f32 SSD state)."""
    m = hybrid(dt, variant)
    ref, port = _layer0(m)
    pc = m["pc"]
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 128, pc.d_model)).astype(np.float32)
    st_r = st_p = None
    if with_state:
        _, H, conv_dim = PS.ssm_dims(pc)
        st_r = {"conv": jnp.asarray(rng.normal(size=(2, PS.CONV_W - 1, conv_dim)), jnp.bfloat16),
                "ssd": jnp.asarray(rng.normal(size=(2, H, pc.ssm_state, pc.ssm_head_dim)), jnp.float32)}
        st_p = lm_cache_from_reference(jax.tree.map(np.asarray, st_r), device="cpu")
    y_w, s_w = ref_fns["mamba"](ref["mamba"], jnp.asarray(x, jdt), st_r)
    y, s = PS.mamba2_apply(port["mamba"], _t(x, tdt), pc, st_p)
    assert y.dtype == tdt
    _close(_np(y), _jnp(y_w), RTOL[dt], "mamba2 out")
    assert set(s) == set(s_w)
    for k in s_w:
        assert _dt(s[k]) == str(s_w[k].dtype) and tuple(s[k].shape) == s_w[k].shape, k
        _close(_np(s[k]), _jnp(s_w[k]), RTOL[dt], f"state {k}")


def test_init_state():
    rc, pc = _cfgs("f32")
    want = RS.mamba2_init_state(rc, 3)
    got = PS.mamba2_init_state(pc, 3)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and _dt(got[k]) == str(want[k].dtype)
        assert not got[k].any()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _state_dtypes(tree):
    return {k: _dt(t) for k, t in _paths(tree).items()}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
def test_forward_prefill_and_decode(hybrid, dt, variant):
    """Forward logits and prefill logits and states at 2 x 128 tokens,
    then two decode steps from the reference's prefill state, carried."""
    m = hybrid(dt, variant)
    toks = _tokens(2, 128, 5)
    want = m["forward"](m["values"], {"tokens": jnp.asarray(toks)})
    got = M.build_model(m["pc"]).forward(m["params"], {"tokens": _t(toks, torch.int64)})
    assert got.dtype == m["pc"].compute_dtype and tuple(got.shape) == want.shape
    _close(_np(got), _jnp(want), RTOL[dt], "forward logits")
    lr, sr = m["prefill"](m["values"], jnp.asarray(toks))
    lp, sp = M.make_prefill(m["pc"])(m["params"], {"tokens": _t(toks, torch.int64)})
    _close(_np(lp), _jnp(lr), PREFILL_RTOL[dt], "prefill logits")
    ref_states = {k: np.asarray(a) for k, a in _paths(jax.tree.map(np.asarray, sr)).items()}
    got_states = _paths(sp)
    assert got_states.keys() == ref_states.keys()
    for k, a in ref_states.items():
        assert _dt(got_states[k]) == str(a.dtype) and tuple(got_states[k].shape) == a.shape, k
        if k.endswith("pos"):
            assert np.array_equal(got_states[k].numpy(), a), k
        else:
            rtol = max(KV_RTOL, PREFILL_RTOL[dt]) if k.startswith("/attn") else PREFILL_RTOL[dt]
            _close(_np(got_states[k]), np.asarray(jnp.asarray(a).astype(jnp.float32)), rtol, f"prefill state {k}")
    states = lm_cache_from_reference(jax.tree.map(np.asarray, sr), device="cpu")
    step = M.make_serve_step(m["pc"])
    for i, tok in enumerate(_tokens(2, 2, 6).T):
        lr, sr = m["decode"](m["values"], sr, jnp.asarray(tok[:, None]), 128 + i)
        lp, states = step(m["params"], states, _t(tok[:, None], torch.int64), 128 + i)
        _close(_np(lp), _jnp(lr), DECODE_RTOL[dt], f"decode step {i} logits")
        assert _state_dtypes(states) == {k: str(a.dtype) for k, a in _paths(sr).items()}, i
        assert np.array_equal(states["attn"]["pos"].numpy(), np.asarray(sr["attn"]["pos"]))


def test_decode_after_prefill_contract(hybrid):
    """The reference's TestPerArch contract at S = 8 (prefill(t[:8]) then
    decode(t[8]) against prefill(t[:9])), and prefill(128) then 64 decode
    steps against prefill(192), each step against the reference's."""
    m = hybrid("f32", "seeded")
    model = M.build_model(m["pc"])
    toks = _tokens(2, 192, 7)
    for n, extra in ((8, 1), (128, 64)):
        _, states = model.prefill(m["params"], _t(toks[:, :n], torch.int64))
        _, sr = m["prefill"](m["values"], jnp.asarray(toks[:, :n]))
        # decode writes at positions past the prefill's cache: grow the KV caches to n + extra, as a serving slot is
        states, sr = _grow(states, n + extra), _grow_ref(sr, n + extra)
        for i in range(n, n + extra):
            tok = toks[:, i:i + 1]
            logits, states = model.decode(m["params"], states, _t(tok, torch.int64), i)
            lr, sr = m["decode"](m["values"], sr, jnp.asarray(tok), i)
            _close(_np(logits), _jnp(lr), DECODE_RTOL["f32"], f"decode step at {i}")
        full, fstates = model.prefill(m["params"], _t(toks[:, :n + extra], torch.int64))
        _close(_np(logits), _np(full), PREFILL_RTOL["f32"], f"prefill({n}) + {extra} steps against prefill")
        for part in ("mamba_groups", "mamba_tail"):
            _close(_np(states[part]["ssd"]), _np(fstates[part]["ssd"]), PREFILL_RTOL["f32"],
                   f"the {part} SSD states after the steps")


def _grow(states, n):
    """The port's prefill states with K/V caches of length n (zeros past
    the prefill's)."""
    attn = states["attn"]
    kv = {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - t.shape[2])) for k, t in attn["self"].items()}
    return dict(states, attn={"self": kv, "pos": attn["pos"]})


def _grow_ref(states, n):
    attn = states["attn"]
    kv = {k: jnp.pad(t, ((0, 0), (0, 0), (0, n - t.shape[2]), (0, 0), (0, 0))) for k, t in attn["self"].items()}
    return dict(states, attn={"self": kv, "pos": attn["pos"]})


def test_prefill_refuses_the_reference_s_rejects(hybrid):
    m = hybrid("f32")
    toks = _tokens(1, 100, 8)
    with pytest.raises(AssertionError):
        m["prefill"](m["values"], jnp.asarray(toks))
    with pytest.raises(ValueError, match="multiple of 64"):
        M.build_model(m["pc"]).prefill(m["params"], _t(toks, torch.int64))


def test_state_bytes_at_full_width():
    """zamba2-7b's decode state per slot on the meta device against the
    reference's eval_shape: O(1) Mamba states and 13 KV caches."""
    cfg = C.get(ARCH)
    model = M.build_model(cfg)
    for n, want in STATE_BYTES.items():
        got = sum(t.numel() * t.element_size() for t in tree_leaves(model.init_cache(1, n, device="meta")))
        ref = jax.eval_shape(lambda n=n: RM.build_model(RC.get(ARCH)).init_cache(1, n))
        assert got == sum(np.prod(a.shape) * a.dtype.itemsize for a in jax.tree.leaves(ref)) == want
    c = model.init_cache(4, 8, device="meta")
    assert {k: (tuple(t.shape), t.dtype) for k, t in _paths(c).items()} == {
        "/mamba_groups/conv": ((13, 5, 4, 3, 7296), torch.bfloat16),
        "/mamba_groups/ssd": ((13, 5, 4, 112, 64, 64), torch.float32),
        "/attn/self/k": ((13, 4, 8, 32, 112), torch.bfloat16), "/attn/self/v": ((13, 4, 8, 32, 112), torch.bfloat16),
        "/attn/pos": ((13, 4), torch.int32),
        "/mamba_tail/conv": ((3, 4, 3, 7296), torch.bfloat16), "/mamba_tail/ssd": ((3, 4, 112, 64, 64), torch.float32)}


def test_init_cache_leaves_are_materialised():
    """Every layer's state is its own storage (the reference broadcasts
    one zero state; a torch ``expand`` would make the engine's in-place
    slot write hit every layer)."""
    model = M.build_model(C.get_smoke(ARCH))
    c = model.init_cache(2, 8)
    for t in tree_leaves(c):
        assert t.is_contiguous() and 0 not in t.stride()
    c["mamba_groups"]["ssd"][0, 0, 1] = 1.0
    assert float(c["mamba_groups"]["ssd"].sum()) == c["mamba_groups"]["ssd"][0, 0, 1].numel()


def test_leaf_by_leaf_build_is_the_compute_copy():
    """``init_compute_params`` bit for bit ``compute_copy(init_params)``:
    the projections, convolution, ``D`` and tables in bf16, ``A_log``,
    ``dt_bias`` and the norms f32."""
    cfg = C.get_smoke(ARCH)
    full = M.compute_copy(M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu"), cfg)
    built = M.init_compute_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    a, b = _paths(full), _paths(built)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    f32 = {k for k, t in b.items() if t.dtype == torch.float32}
    assert f32 == {f"/{part}/{leaf}" for part in ("mamba_groups", "mamba_tail")
                   for leaf in ("ln/scale", "mamba/A_log", "mamba/dt_bias", "mamba/norm/scale")} | {
        "/shared_attn/ln1/scale", "/shared_attn/ln2/scale", "/final_norm/scale"}


def test_full_width_counts():
    """The whole model and the 15-layer cut that the card trains."""
    cfg = C.get(ARCH)
    assert M.count_params(M.init_params(cfg, device="meta")) == 5_737_416_000
    assert M.model_flops_per_token(cfg) == RM.model_flops_per_token(RC.get(ARCH)) == 48_533_872_512
    cut = cfg.replace(n_layers=15)
    assert M.count_params(M.init_params(cut, device="meta")) == 1_448_622_480
    assert M.model_flops_per_token(cut) == RM.model_flops_per_token(RC.get(ARCH).replace(n_layers=15)) == 9_236_732_256


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _serve(m, port: bool, prompts, temperature=0.0, dtypes=None):
    """Serve through one engine; returns each request's tokens and the
    sampler's log (rid, logits, token).  ``dtypes`` collects the states'
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
        dtypes.append({k: _dt(t) if hasattr(t, "dtype") else None for k, t in _paths(eng.caches).items()})
        eng.step()
        dtypes.append({k: _dt(t) for k, t in _paths(eng.caches).items()})
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], log


def _compare_engines(m, dt, temperature=0.0):
    """``tests/test_torch_lm.py``'s rule: the same sampler calls with
    logits within the bound, the same tokens, or a part only at a
    reference-side near-tie (after which nothing is compared)."""
    prompts = [_tokens(1, n, 20 + i)[0] for i, n in enumerate(PROMPT_LENS)]
    ref_dtypes, got_dtypes = [], []
    ref_toks, ref_log = _serve(m, False, prompts, temperature, ref_dtypes)
    got_toks, got_log = _serve(m, True, prompts, temperature, got_dtypes)
    assert got_dtypes == ref_dtypes
    rtol = PREFILL_RTOL[dt]
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
def test_engine_matches_reference(hybrid, dt, temperature):
    """7 ragged requests (one of 128 tokens) on 3 slots; the states'
    dtypes after the first admission and the first decode step are the
    reference engine's: under f32 compute the conv rows are bf16 until
    the first decode and f32 after it."""
    m = hybrid(dt, "seeded")
    dtypes, _ = _compare_engines(m, dt, temperature)
    conv = "float32" if dt == "f32" else "bfloat16"
    fixed = {"/attn/self/k": "bfloat16", "/attn/self/v": "bfloat16", "/attn/pos": "int32",
             "/mamba_groups/ssd": "float32", "/mamba_tail/ssd": "float32"}
    assert dtypes == [dict(fixed, **{"/mamba_groups/conv": "bfloat16", "/mamba_tail/conv": "bfloat16"}),
                      dict(fixed, **{"/mamba_groups/conv": conv, "/mamba_tail/conv": conv})]


def test_engine_serves_from_the_compute_copy(hybrid):
    m = hybrid("bf16")
    eng = ServeEngine(m["pc"], m["params"], slots=2, cache_len=16, device="cpu")
    mamba = eng.params["mamba_groups"]["mamba"]
    assert all(mamba[k].dtype == torch.bfloat16 for k in ("in_proj", "out_proj", "conv_w", "conv_b", "D"))
    assert mamba["A_log"].dtype == mamba["dt_bias"].dtype == mamba["norm"]["scale"].dtype == torch.float32
    assert eng.params["shared_attn"]["attn"]["wq"]["w"].dtype == eng.params["unembed"]["table"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(seed=1, batch=B):
    toks = _tokens(batch, S + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", DTYPES)
def test_train_step_gradients(hybrid, dt, variant):
    """One step's loss, grad norm and every gradient leaf at (2, 128)
    against ``jax.value_and_grad`` of the reference step's loss."""
    m = hybrid(dt, variant)
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


def test_training_losses_follow_the_reference_step_for_step(hybrid):
    """Six SMOKE steps at lr 1e-3 with no warmup (as chip_smoke.py's
    [hybrid] trains) through both packages' train steps, from the same
    weights and the same batches: each step's loss within the one-step
    bound of the reference's.  The card's 15 layers at full width read
    11.08, 26.38, 20.25, 12.37 over four such steps; the port's update is
    the reference's step for step, so that rise is the reference's own
    behaviour on random weights, not a fault of the port.  (The grad norms
    part by ~1e-5 after a few steps: AdamW's normalised update carries the
    first steps' last-bit differences forward.)"""
    m = hybrid("f32", "seeded")
    opt = dict(lr=1e-3, warmup_steps=0)
    update = jax.jit(lambda p, g, s: RO.adamw_update(RO.AdamWConfig(**opt), p, g, s))
    values, rstate = m["values"], RO.adamw_init(m["values"])
    params = lm_params_from_reference(jax.tree.map(np.asarray, values), m["pc"], device="cpu")  # updated in place
    pstate, step = PO.adamw_init(params), M.make_train_step(m["pc"], PO.AdamWConfig(**opt))
    for i in range(6):
        batch = _batch(seed=20 + i)
        loss, grads = m["vg"](values, {k: jnp.asarray(v) for k, v in batch.items()})  # the reference step's parts
        values, rstate, _ = update(values, grads, rstate)
        params, pstate, pm = step(params, pstate, {k: _t(v) for k, v in batch.items()})
        assert abs(float(pm["loss"]) - float(loss)) <= STEP_LOSS_RTOL["f32"] * abs(float(loss)), (i, float(loss))
    assert int(pstate["step"]) == int(rstate["step"]) == 6


def test_remat_modes_and_microbatches(hybrid):
    """The three remat modes bit for bit; microbatches=2 against 1, and
    its step's loss and grad norm against the reference's on the whole
    batch."""
    m = hybrid("f32", "seeded")
    batch = _batch(seed=9)  # the train-step test's shape: the reference's jitted step compiles once
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
    """Six steps at S = 128 (two chunks); a --seq of 100 is refused by
    the chunk rule before anything is built."""
    out = _train(tmp_path / "a", "--steps", "6", "--seq", "128")
    assert "done: 6 steps" in out
    with pytest.raises(ValueError, match="multiple of 64"):
        _train(tmp_path / "b", "--steps", "1", "--seq", "100")
    assert not (tmp_path / "b").exists()
