"""The port's audio family (whisper: an encoder over frame embeddings and a
decoder with cross-attention) against the JAX package's, on the CPU.

Params at whisper-tiny's SMOKE size (2 encoder and 2 decoder layers,
d_model 64, 4/4 heads of 64 (the head size that ``replace`` keeps from
the full config, in both packages), d_ff 128, vocab 256, 16 frames, 64
decoder positions): the init's distributions, with every LayerNorm's scale and
bias (1 and 0 at init) drawn from a seed so that each moves the output,
as a numpy tree in the reference's layout (the layout itself checked
against the reference's ``abstract_params``); the reference reads it as
is and the port through ``carry.lm_params_from_reference``.  Frames and
tokens are made with numpy from a seed.  The flash branch (``tests/test_torch_lm.py``'s
``FLASH``: the reference's jnp online softmax in blocks of 16, the port's
flash wrapper on its plain version) takes the decoder's causal
self-attention and its non-causal cross-attention (S × 16) in every
case but the engines' (the plain ``_sdpa`` branch); the encoder's
bidirectional attention (16²) stays on the plain branch in f32, as it
does on the card at full width (1500² is under the threshold), and takes
the flash branch in bf16 and in the train steps.

Bounds, relative to the largest |value| of the reference's output
(``tests/test_torch_lm.py``'s): ``encode`` and ``forward`` 1e-5 in f32;
``prefill`` logits 2e-3 in f32 (the KV cache is bf16 in every dtype, and
a K/V value that the two BLAS round to neighbouring f32s can fall on
either side of a bf16 boundary), its stored K/V one bf16 ulp (2^-7 of
the largest); ``decode`` 1e-4 in f32 from the reference's carried cache
and encoder output; everything 5e-2 in bf16.  A train step:
``tests/test_torch_train.py``'s ``STEP_*`` bounds.

The reference's contracts on the port alone (``tests/test_models.py``'s
``TestPerArch``): ``decode`` fed the *encoded* frames follows ``forward``
within 5e-3 (decode reads K/V rounded to bf16, forward f32 ones; measured
≤ 2.1e-3), and two microbatches give
one batch's step.  The reference's engine decodes against raw zero
frames passed as the encoder's output, not encoded (``serving/engine.py``
there), so its cross-attention adds nothing after the prefill: the
engines are held to each other, never to teacher forcing.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (CACHE_LEN, DECODE_RTOL, DTYPES, ENGINE_SEED, FLASH, FORWARD_RTOL, MAX_NEW, PREFILL_RTOL,
                           PROMPT_LENS, SLOTS, _close, _jnp, _np)
from test_torch_train import STEP_GNORM_RTOL, STEP_LEAF_RTOL, STEP_LOSS_RTOL, _leaves, _rel_norm

import repro.configs as RC
import repro_torch.configs as C
from repro.models import model as RM
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro.train import optim as RO
from repro_torch.carry import lm_cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as PL
from repro_torch.models import model as M
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import optim as PO
from repro_torch.tree import tree_leaves

ARCH = "whisper-tiny"
# the attention branches: "sdpa" everywhere; "flash" everywhere (FLASH's threshold of 64 is below the encoder's 16²);
# "mixed", the card's split at full width: the encoder's 16² on the plain branch, the decoder's 20² self-attention
# and 20 x 16 cross-attention on the flash branch
BRANCHES = {"sdpa": {}, "flash": FLASH, "mixed": dict(FLASH, flash_threshold=300)}
CASES = [("f32", "mixed"), ("bf16", "flash")]  # the model cases
IDS = [f"{dt}-{branch}" for dt, branch in CASES]
KV_RTOL = 2.0**-7  # the prefill's stored K/V in f32 compute: one bf16 ulp of the largest |value|
B, S, CACHE = 3, 20, 32  # the model cases: 3 prompts of 20 tokens, decoded into a 32-slot cache
TRAIN_B, TRAIN_S = 2, 16
# decode fed the encoded frames against forward, in f32 on the port alone: decode reads the K/V rounded into the
# bf16 cache (up to 2^-9 relative each) where forward keeps them in f32; measured <= 2.1e-3 of the largest logit over
# four seeds of params and inputs, on both branches (the port against the reference, both over bf16 caches: 2e-3)
TEACHER_RTOL = 5e-3


def _cfgs(dt, branch="sdpa"):
    jdt, tdt = DTYPES[dt]
    kw = BRANCHES[branch]
    return (RC.get_smoke(ARCH).replace(compute_dtype=jdt, **kw),
            C.get_smoke(ARCH).replace(compute_dtype=tdt, **kw))


def _seeded_values(seed=0):
    """The numpy params tree: the port's init in f32 from a seeded
    generator, every norm's ``scale`` 1 + 0.1·N(0, 1) and ``bias``
    0.1·N(0, 1) from numpy."""
    rng = np.random.default_rng(seed)
    tree = M.init_params(_cfgs("f32")[1], torch.Generator().manual_seed(seed), device="cpu")

    def fill(t, key):
        if isinstance(t, dict):
            return {k: fill(v, k) for k, v in t.items()}
        a = t.numpy()
        if key == "scale":
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32) if key == "bias" else a

    return fill(tree, None)


@pytest.fixture(scope="module")
def audio():
    """(dtype, branch) -> the reference cfg, values and model, the port's
    cfg and params; the reference's functions are jitted once per case
    and on first use (``m["fns"]``)."""
    tree = _seeded_values()
    values = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_reference(tree, _cfgs("f32")[1], device="cpu")
    built = {}

    def get(dt="f32", branch="sdpa"):
        if (dt, branch) not in built:
            rc, pc = _cfgs(dt, branch)
            built[(dt, branch)] = dict(rc=rc, pc=pc, values=values, params=params, rm=RM.build_model(rc))
        return built[(dt, branch)]

    return get


def _model_fns(m):
    """One jitted reference run of the model cases: encode, forward,
    prefill, the prefill's cache carried into CACHE slots and one decode
    step fed the encoded frames."""
    if "fns" not in m:
        rm = m["rm"]

        def run(values, frames, toks, tok):
            enc = rm.encode(values, frames)
            logits = rm.forward(values, {"frames": frames, "tokens": toks})
            lp, cache = rm.prefill(values, toks, frames)
            big = rm.init_cache(toks.shape[0], CACHE)
            big = {"self": {n: big["self"][n].at[:, :, : toks.shape[1]].set(cache["self"][n]) for n in ("k", "v")},
                   "pos": cache["pos"]}
            ld, cd = rm.decode(values, big, tok, jnp.asarray(toks.shape[1], jnp.int32), enc)
            return dict(enc=enc, forward=logits, prefill=lp, cache=cache, big=big, decode=ld, decoded=cd)

        m["fns"] = jax.jit(run)
    return m["fns"]


def _inputs(rc, seed=5, batch=B, length=S):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(batch, rc.n_frames, rc.d_model)).astype(np.float32)
    toks = rng.integers(0, rc.vocab_size, size=(batch, length + 1)).astype(np.int32)
    return frames, toks[:, :-1], toks[:, -1:]


def _tt(a):
    """A numpy array as a tensor, int32 tokens as int64."""
    t = torch.as_tensor(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt,branch", CASES, ids=IDS)
def test_encode_forward_prefill_and_decode(audio, dt, branch):
    """3 prompts of 20 tokens over seeded frames: ``encode``, ``forward``
    and ``prefill`` (logits and cache), then one decode step per row from
    the reference's prefill cache carried into 32 slots, fed the
    reference's encoder output."""
    m = audio(dt, branch)
    pc = m["pc"]
    frames, toks, tok = _inputs(m["rc"])
    want = _model_fns(m)(m["values"], jnp.asarray(frames), jnp.asarray(toks), jnp.asarray(tok))
    model = M.build_model(pc)
    ft, tt = _tt(frames), _tt(toks)
    with torch.no_grad():
        enc = model.encode(m["params"], ft)
        assert enc.dtype == pc.compute_dtype and tuple(enc.shape) == want["enc"].shape
        _close(_np(enc), _jnp(want["enc"]), FORWARD_RTOL[dt], "encode")
        _close(_np(model.forward(m["params"], {"frames": ft, "tokens": tt})), _jnp(want["forward"]),
               FORWARD_RTOL[dt], "forward logits")
        lp, cp = M.make_prefill(pc)(m["params"], {"tokens": tt, "frames": ft})
    assert lp.dtype == pc.compute_dtype and tuple(lp.shape) == want["prefill"].shape
    _close(_np(lp), _jnp(want["prefill"]), PREFILL_RTOL[dt], "prefill logits")
    assert np.array_equal(cp["pos"].numpy(), np.asarray(want["cache"]["pos"]))
    kv_rtol = KV_RTOL if dt == "f32" else FORWARD_RTOL[dt]
    for name in ("k", "v"):
        assert cp["self"][name].dtype == torch.bfloat16
        _close(_np(cp["self"][name]), _jnp(want["cache"]["self"][name]), kv_rtol, f"prefill {name}")
    pcache = lm_cache_from_reference(jax.tree.map(np.asarray, want["big"]), device="cpu")
    penc = lm_cache_from_reference({"enc": np.asarray(want["enc"])}, device="cpu")["enc"]
    with torch.no_grad():
        ld, cd = M.make_serve_step(pc)(m["params"], pcache, _tt(tok), S, {"enc": penc})
    assert cd is pcache  # written in place
    _close(_np(ld), _jnp(want["decode"]), DECODE_RTOL[dt], "decode logits")
    assert np.array_equal(cd["pos"].numpy(), np.asarray(want["decoded"]["pos"]))


def test_the_logit_bound_rejects_a_wrong_model(audio):
    """The f32 bounds catch a real fault: the decoder's cross-attention
    reading the frames before the encoder (``enc`` := the raw frames)."""
    m = audio("f32", "mixed")
    frames, toks, tok = _inputs(m["rc"])
    want = _model_fns(m)(m["values"], jnp.asarray(frames), jnp.asarray(toks), jnp.asarray(tok))
    model = M.build_model(m["pc"])
    encode = model.encode
    model.encode = lambda params, frames: frames.to(m["pc"].compute_dtype)
    with torch.no_grad():
        got = model.forward(m["params"], {"frames": _tt(frames), "tokens": _tt(toks)})
    model.encode = encode
    with pytest.raises(AssertionError, match="forward logits"):
        _close(_np(got), _jnp(want["forward"]), PREFILL_RTOL["f32"], "forward logits")


# --------------------------------------------------------------------------
# the reference's contracts on the port alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["sdpa", "flash"])
def test_decode_fed_encoded_frames_follows_forward(audio, branch):
    """Prefill 8 tokens, then 8 decode steps teacher-forced and fed
    ``encode(frames)``: every step's logits (and the prefill's) within
    ``TEACHER_RTOL`` of ``forward``'s at that position, the same argmax."""
    m = audio("f32", branch)
    model = M.build_model(m["pc"])
    frames, toks, _ = _inputs(m["rc"], seed=7, length=16)
    ft, tt = _tt(frames), _tt(toks)
    with torch.no_grad():
        full = _np(model.forward(m["params"], {"frames": ft, "tokens": tt}))
        enc = model.encode(m["params"], ft)
        logits, cache = model.prefill(m["params"], tt[:, :8], ft)
        grown = model.init_cache(B, CACHE)
        for name in ("k", "v"):
            grown["self"][name][:, :, :8] = cache["self"][name]
        grown["pos"].copy_(cache["pos"])
        steps = [_np(logits)[:, -1]]
        for p in range(8, 16):
            logits, grown = model.decode(m["params"], grown, tt[:, p:p + 1], p, enc)
            steps.append(_np(logits)[:, -1])
    for i, got in enumerate(steps):
        _close(got, full[:, 7 + i], TEACHER_RTOL, f"position {7 + i}")
        assert np.array_equal(got.argmax(-1), full[:, 7 + i].argmax(-1))


def test_the_engine_s_unencoded_zero_frames_mute_the_cross_attention(audio):
    """The engine's decode ``enc`` is raw zero frames: the cross K/V are
    zero and the branch adds exactly 0, so its logits are not those of
    the encoded zero frames that its prefill used."""
    m = audio()
    pc = m["pc"]
    model = M.build_model(pc)
    zeros = torch.zeros((B, pc.n_frames, pc.d_model), dtype=torch.bfloat16)
    h = torch.randn((B, 1, pc.d_model), generator=torch.Generator().manual_seed(3))
    xattn = {k: {n: t[0] for n, t in v.items()} for k, v in m["params"]["dec_blocks"]["xattn"].items()}
    out, _ = PL.attn_apply(xattn, h, pc, kv_src=zeros, qpos=torch.zeros((B, 1), dtype=torch.int32), causal=False,
                           use_rope=False)
    assert torch.equal(out, torch.zeros_like(out))
    toks = _tt(_inputs(m["rc"], seed=8)[1])
    with torch.no_grad():
        raw, _ = model.decode(m["params"], model.prefill(m["params"], toks, zeros)[1], toks[:, -1:], S, zeros)
        encoded, _ = model.decode(m["params"], model.prefill(m["params"], toks, zeros)[1], toks[:, -1:], S,
                                  model.encode(m["params"], zeros))
    assert float((raw - encoded).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _serve(m, port: bool, prompts):
    """Greedy requests through one engine: each request's tokens and the
    sampler's log (rid, logits, token)."""
    log = []
    if port:
        eng = ServeEngine(m["pc"], m["params"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    else:
        eng = RServeEngine(m["rc"], m["values"], slots=SLOTS, cache_len=CACHE_LEN, seed=ENGINE_SEED)
        reqs = [RRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    sample = eng._sample

    def logged(logits, req):
        tok = sample(logits, req)
        log.append((req.rid, np.asarray(logits[: eng.cfg.vocab_size], np.float64), tok))
        return tok

    eng._sample = logged
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], log


def test_engine_matches_reference(audio):
    """``PROMPT_LENS``' 7 ragged prompts on 3 slots, one longer than
    ``cache_len``, in f32: the sampler's calls in the same order with
    logits within the prefill bound, the same tokens (or a part only at a
    reference-side near-tie, after which nothing is compared)."""
    dt = "f32"
    m = audio(dt)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, m["rc"].vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    ref_toks, ref_log = _serve(m, False, prompts)
    got_toks, got_log = _serve(m, True, prompts)
    rtol = PREFILL_RTOL[dt]
    for n, ((rid, logits, want), (rid_g, got_logits, got)) in enumerate(zip(ref_log, got_log)):
        assert rid == rid_g, f"sampler call {n}: request {rid_g} where the reference serves {rid}"
        _close(got_logits, logits, rtol, f"sampler call {n} (request {rid})'s logits")
        if want != got:
            margin = logits[want] - logits[got]
            assert margin <= 2 * rtol * float(np.abs(logits).max()), f"request {rid} parts at call {n}"
            return
    assert len(ref_log) == len(got_log) and ref_toks == got_toks


def test_engine_serves_from_the_compute_copy(audio):
    m = audio("bf16")
    eng = ServeEngine(m["pc"], m["params"], slots=2, cache_len=16, device="cpu")
    p = eng.params
    assert all(t.dtype == torch.bfloat16 for t in (p["embed"]["table"], p["enc_blocks"]["attn"]["wq"]["w"],
                                                   p["dec_blocks"]["xattn"]["wk"]["w"],
                                                   p["dec_blocks"]["mlp"]["up"]["w"]))
    assert all(t.dtype == torch.float32 for t in (p["enc_pos"], p["dec_pos"], p["dec_blocks"]["ln_x"]["bias"],
                                                  p["enc_norm"]["scale"]))
    assert eng.caches["self"]["k"].dtype == torch.bfloat16 and eng.caches["pos"].dtype == torch.int32
    built = M.init_compute_params(m["pc"], torch.Generator().manual_seed(4), device="cpu")
    want = M.compute_copy(M.init_params(m["pc"], torch.Generator().manual_seed(4), device="cpu"), m["pc"])
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(tree_leaves(built), tree_leaves(want),
                                                                        strict=True))


def test_params_layout_is_the_reference_s_and_the_carry_refuses_another():
    """The port's tree has the reference's keys and shapes
    (``abstract_params``); the carry refuses another config's."""
    ref = jax.tree.map(lambda a: tuple(a.shape), RM.abstract_params(_cfgs("f32")[0])[0])
    got = jax.tree.map(lambda t: tuple(t.shape), M.init_params(_cfgs("f32")[1], device="meta"))
    assert got == ref
    values = _seeded_values()
    with pytest.raises(ValueError, match="layout"):  # three encoder layers where the tree has two
        lm_params_from_reference(values, C.get_smoke(ARCH).replace(encoder_layers=3), device="cpu")
    with pytest.raises(ValueError, match="layout"):  # 32 frames where the table has 16
        lm_params_from_reference(values, C.get_smoke(ARCH).replace(n_frames=32), device="cpu")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(rc, seed=1, batch=TRAIN_B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rc.vocab_size, size=(batch, TRAIN_S + 1)).astype(np.int32)
    frames = rng.normal(size=(batch, rc.n_frames, rc.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def _vg(m):
    if "vg" not in m:
        rc, rm = m["rc"], m["rm"]
        m["vg"] = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(rm, RM._cast_compute(p, rc.compute_dtype), b, rc)))
    return m["vg"]


@pytest.mark.parametrize("dt", DTYPES)
def test_train_step_gradients(audio, dt):
    """One step's loss, grad norm and every gradient leaf at (2, 16) with
    seeded frames in the batch, on the flash branch (every attention of
    the step past the threshold), against ``jax.value_and_grad`` of the
    reference step's loss."""
    m = audio(dt, "flash")
    batch = _batch(m["rc"])
    loss, grads = _vg(m)(m["values"], {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pgrads = M.make_value_and_grad(m["pc"])(m["params"], {k: _tt(v) for k, v in batch.items()})
    assert ploss.dtype == torch.float32
    assert abs(float(ploss) - float(loss)) <= STEP_LOSS_RTOL[dt] * abs(float(loss))
    want_gnorm = float(RO.global_norm(grads))
    assert abs(float(PO.global_norm(pgrads)) - want_gnorm) <= STEP_GNORM_RTOL[dt] * want_gnorm
    lp, lr_ = _leaves(pgrads), _leaves(grads)
    assert lp.keys() == lr_.keys() and all(t.dtype == torch.float32 for t in tree_leaves(pgrads))
    for k in lr_:
        assert _rel_norm(lp[k], lr_[k]) <= STEP_LEAF_RTOL[dt], (k, _rel_norm(lp[k], lr_[k]))


def test_remat_modes_and_microbatches(audio):
    """The three remat modes give the same bits; two microbatches (the
    frames sliced along the batch with the tokens) give one batch's loss
    within 1e-6 and its leaves within 1e-5 in relative norm, and the
    step's loss and grad norm are the reference's on the whole batch
    (the train-step test's shape and branch: its jitted step compiles
    once)."""
    m = audio("f32", "flash")
    batch = _batch(m["rc"], seed=9)
    tb = {k: _tt(v) for k, v in batch.items()}
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
    loss, grads = _vg(m)(m["values"], {k: jnp.asarray(v) for k, v in batch.items()})
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


def test_train_cli_refuses_the_audio_family(tmp_path):
    """The token pipeline yields no frames: the CLI stops before it
    builds anything, naming them."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit, match="'frames'"):
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1", "--out", str(tmp_path / "a")])
    assert not (tmp_path / "a").exists()
