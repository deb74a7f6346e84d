"""The port's training path against the JAX package's, on the CPU.

The same inputs, made with numpy, go through both packages, and the
parameters and optimizer state are carried across from the reference
(``carry.lm_params_from_reference``, ``carry.adamw_state_from_reference``):
``TokenPipeline``, ``xent_loss``, the AdamW pieces, ``model_flops_per_token``,
``aux_load_balance_loss``, and one train step of the SMOKE dense
(qwen2-1.5b, h2o-danube-3-4b's window), MoE (qwen2-moe-a2.7b) and vision
(llama-3.2-vision-11b) models against ``jax.value_and_grad`` of the
reference step's own loss (``loss_fn`` over ``_cast_compute``), through
the plain ``_sdpa`` branch and the flash branch (``flash_threshold``
lowered to 64, the reference's jnp ``_flash_sdpa`` in blocks of 16, the
port's flash wrapper on its plain version); then the port alone:
microbatches, the three remat modes, the plain flash backward, the CLI's
resume and the example.

Tolerances, with the largest reading measured on an x86-64 CPU (torch
2.13, jax 0.9), B = 2, S = 48:

- TokenPipeline batches, ``compress_int8``: equal.
- ``lr_schedule``: within 2 f32 ulps (``cos`` of the two libraries may
  round apart; measured equal); ``global_norm``: 1e-6 relative (each
  leaf's sum in its backend's order).
- ``adamw_update`` on identical gradient trees: params, μ and ν within
  1e-6 of each leaf's largest |value|, the step equal.
- One step in f32: the loss and ``grad_norm`` within 2e-6 relative
  (measured ≤ 2.2e-7), every gradient leaf within 2e-5 in relative norm
  ‖port − ref‖ / ‖ref‖ (≤ 2.6e-6): summation order alone.
- One step in bf16 compute: the loss within 5e-4 relative (≤ 4.4e-5),
  ``grad_norm`` 2e-2 (≤ 3.8e-3), every leaf within 0.15 in relative norm
  (≤ 8.3e-2, the MoE's expert gates on the flash branch).  The two
  packages round activations to bf16 at different places (the
  reference's flash loop rounds P to bf16 before PV, the port's plain
  version keeps it in f32; each library's bf16 matmul rounds once from
  its own f32 sum), and the backward carries every such difference
  through the bf16 activations of both layers.  A gradient that misses
  a mask or a layer is off by order 1.
- ``microbatches=2`` against 1: loss 1e-6, leaves 1e-5 in relative norm;
  the reference's ``microbatches=2`` step's loss and ``grad_norm`` as in
  f32 above.
- The three remat modes: the same bits (recompute runs the same ops).
- ``ref.gqa_flash_attention_backward`` against autograd through
  ``ref.gqa_flash_attention``: 1e-5 of each gradient's largest |value|
  (f32, plain reductions in another order); a causal mask shifted by one
  is off by more than 10 % of the largest |value|.
- The CLI: the resumed loss stream equal to an uninterrupted run's.
"""

import contextlib
import io
import json
import os
import signal
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
from repro.data.pipeline import TokenPipeline as RTokenPipeline
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.train import optim as RO
from repro_torch.carry import adamw_state_from_reference, lm_params_from_reference
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels import ref as PREF
from repro_torch.models import model as M
from repro_torch.models import moe as PMOE
from repro_torch.train import optim as PO
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FLASH = dict(flash_threshold=64, flash_block_q=16, flash_block_k=16)
# llama-3.2-vision's self-attention (48²) past the threshold, its cross-attention (48 x 8 media) below it
MIXED = dict(flash_threshold=1000, flash_block_q=16, flash_block_k=16)
B, S = 2, 48
STEP_LOSS_RTOL = {"f32": 2e-6, "bf16": 5e-4}
STEP_GNORM_RTOL = {"f32": 2e-6, "bf16": 2e-2}
STEP_LEAF_RTOL = {"f32": 2e-5, "bf16": 0.15}
# (arch, dtype, attention branch): every family in both dtypes; both branches where one run takes one
STEP_CASES = [("qwen2-1.5b", dt, br) for dt in DTYPES for br in ("sdpa", "flash")] + [
    ("h2o-danube-3-4b", "f32", "flash"), ("h2o-danube-3-4b", "bf16", "flash"),
    ("qwen2-moe-a2.7b", "f32", "sdpa"), ("qwen2-moe-a2.7b", "f32", "flash"), ("qwen2-moe-a2.7b", "bf16", "flash"),
    ("llama-3.2-vision-11b", "f32", "mixed"), ("llama-3.2-vision-11b", "bf16", "mixed")]
FULL_WIDTH = ("qwen1.5-0.5b", "qwen2-1.5b", "h2o-danube-3-4b", "qwen3-14b", "qwen2-moe-a2.7b", "dbrx-132b",
              "llama-3.2-vision-11b", "rwkv6-1.6b", "zamba2-7b", "whisper-tiny")


def _cfgs(arch, dt="f32", branch="sdpa", **kw):
    jdt, tdt = DTYPES[dt]
    kw = dict({"sdpa": {}, "flash": FLASH, "mixed": MIXED}[branch], **kw)
    return RC.get_smoke(arch).replace(compute_dtype=jdt, **kw), C.get_smoke(arch).replace(compute_dtype=tdt, **kw)


def _batch(rc, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rc.vocab_size, size=(batch, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if rc.family == "vlm":
        out["media"] = rng.normal(size=(batch, rc.n_media_tokens, rc.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaves(tree, prefix=""):
    """{path: numpy f32} of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(jnp.asarray(tree).astype(jnp.float32))}


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def reference():
    """(arch, dtype, branch) -> the reference cfg, values and its jitted
    value_and_grad of the step's loss; the port's cfg and params."""
    built = {}

    def get(arch, dt="f32", branch="sdpa"):
        key = (arch, dt, branch)
        if key not in built:
            rc, pc = _cfgs(arch, dt, branch)
            values, _ = RM.init_params(rc, jax.random.PRNGKey(0))
            rm = RM.build_model(rc)

            def fwd(p, b):
                return RM.loss_fn(rm, RM._cast_compute(p, rc.compute_dtype), b, rc)

            built[key] = dict(rc=rc, pc=pc, values=values, vg=jax.jit(jax.value_and_grad(fwd)),
                              params=lm_params_from_reference(jax.tree.map(np.asarray, values), pc, device="cpu"))
        return built[key]

    return get


# --------------------------------------------------------------------------
# data, loss, optimizer pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab, batch, seq, seed, start", [(256, 4, 16, 0, 0), (151_936, 2, 33, 7, 5),
                                                            (1000, 3, 8, 3, 2)])
def test_token_pipeline_bit_for_bit(vocab, batch, seq, seed, start):
    port, ref = (P(vocab, batch, seq, seed=seed, start_step=start) for P in (TokenPipeline, RTokenPipeline))
    try:
        for _ in range(4):
            got, want = next(port), next(ref)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        assert port.step == ref.step == start + 4
        for step in (0, 9, 123):
            assert all(np.array_equal(port.batch_at(step)[k], ref.batch_at(step)[k]) for k in ("tokens", "labels"))
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_xent_loss_padded_vocab(dt):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(2, 7, 384)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    jdt, tdt = DTYPES[dt]
    want = float(RM.xent_loss(jnp.asarray(logits).astype(jdt), jnp.asarray(labels), 300))
    got = float(M.xent_loss(torch.as_tensor(logits).to(tdt), torch.as_tensor(labels), 300))
    assert abs(got - want) <= 2e-6 * abs(want)
    # the padded columns are masked: a large logit there changes nothing
    logits[..., 350] = 50.0
    assert abs(float(M.xent_loss(torch.as_tensor(logits).to(tdt), torch.as_tensor(labels), 300)) - got) <= 1e-6 * abs(got)


def test_lr_schedule():
    cfg = RO.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    pcfg = PO.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for step in range(0, 45):
        want = np.float32(RO.lr_schedule(cfg, jnp.asarray(step, jnp.int32)))
        got = PO.lr_schedule(pcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(np.float32(got.item()) - want) <= 2 * np.spacing(want), step


def _grad_tree(params, rng, scale=1.0):
    return {k: _grad_tree(v, rng, scale) if isinstance(v, dict)
            else (rng.normal(size=tuple(v.shape)) * scale).astype(np.float32) for k, v in params.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_global_norm_and_compress_int8(reference):
    params = reference("qwen2-1.5b")["params"]
    grads = _grad_tree(params, np.random.default_rng(3), 1e-2)
    want = float(RO.global_norm(_to_jax(grads)))
    got = float(PO.global_norm(_to_torch(grads)))
    assert abs(got - want) <= 1e-6 * want
    rng = np.random.default_rng(4)
    g, err = rng.normal(size=(33, 17)).astype(np.float32), (rng.normal(size=(33, 17)) * 1e-3).astype(np.float32)
    wq, ws, we = RO.compress_int8(jnp.asarray(g), jnp.asarray(err))
    pq, ps, pe = PO.compress_int8(torch.as_tensor(g), torch.as_tensor(err))
    assert pq.dtype == torch.int8 and np.array_equal(pq.numpy(), np.asarray(wq))
    assert np.float32(ps.item()) == np.float32(ws) and np.array_equal(pe.numpy(), np.asarray(we))


def test_adamw_update_on_identical_grads(reference):
    """Three updates on the same gradient trees, from carried params and
    moments; the stacked norm scales decay as the reference's
    ``p.ndim >= 2`` rule says (their gradient is zero here)."""
    got = reference("qwen2-1.5b")
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    rcfg, pcfg = RO.AdamWConfig(**cfg), PO.AdamWConfig(**cfg)
    rng = np.random.default_rng(5)
    values = got["values"]
    rstate = RO.adamw_init(values)
    params = _to_torch(jax.tree.map(np.asarray, values))
    pstate = adamw_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    for i in range(3):
        grads = _grad_tree(params, rng, 0.3)
        for blk in ("ln1", "ln2"):
            grads["blocks"][blk]["scale"][:] = 0.0
        values, rstate, rm = RO.adamw_update(rcfg, values, _to_jax(grads), rstate)
        params, pstate, pm = PO.adamw_update(pcfg, params, _to_torch(grads), pstate)
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * float(rm["grad_norm"])
        assert np.float32(pm["lr"].item()) == np.float32(rm["lr"])
        assert int(pstate["step"]) == int(rstate["step"]) == i + 1
        for tree_p, tree_r in ((params, values), (pstate["mu"], rstate["mu"]), (pstate["nu"], rstate["nu"])):
            lp, lr_ = _leaves(tree_p), _leaves(tree_r)
            for k in lr_:
                assert np.abs(lp[k] - lr_[k]).max() <= 1e-6 * max(np.abs(lr_[k]).max(), 1e-30), (i, k)
    scale = params["blocks"]["ln1"]["scale"]
    assert scale.dim() == 2 and bool((scale < 1.0).all())  # decayed with a zero gradient
    assert bool((params["final_norm"]["scale"] != 1.0).all()) and params["final_norm"]["scale"].dim() == 1


@pytest.mark.parametrize("arch", FULL_WIDTH)
def test_model_flops_per_token_at_full_width(arch):
    want = RM.model_flops_per_token(RC.get(arch))
    assert M.model_flops_per_token(C.get(arch)) == want


def test_aux_load_balance_loss():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    top_e = np.argsort(-logits, axis=-1, kind="stable")[:, :2].astype(np.int32)
    want = float(RMOE.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(top_e), 8))
    got = float(PMOE.aux_load_balance_loss(torch.as_tensor(logits), torch.as_tensor(top_e), 8))
    assert abs(got - want) <= 1e-6 * abs(want)


# --------------------------------------------------------------------------
# one train step against jax.value_and_grad
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch, dt, branch", STEP_CASES)
def test_train_step_gradients(reference, arch, dt, branch):
    got = reference(arch, dt, branch)
    batch = _batch(got["rc"])
    loss, grads = got["vg"](got["values"], {k: jnp.asarray(v) for k, v in batch.items()})
    want_gnorm = float(RO.global_norm(grads))
    ploss, pgrads = M.make_value_and_grad(got["pc"])(got["params"], _torch_batch(batch))
    pgnorm = float(PO.global_norm(pgrads))
    assert ploss.dtype == torch.float32
    assert abs(float(ploss) - float(loss)) <= STEP_LOSS_RTOL[dt] * abs(float(loss))
    assert abs(pgnorm - want_gnorm) <= STEP_GNORM_RTOL[dt] * want_gnorm
    lp, lr_ = _leaves(pgrads), _leaves(grads)
    assert lp.keys() == lr_.keys() and all(t.dtype == torch.float32 for t in tree_leaves(pgrads))
    for k in lr_:
        assert _rel_norm(lp[k], lr_[k]) <= STEP_LEAF_RTOL[dt], (k, _rel_norm(lp[k], lr_[k]))
    # the whole step: its metrics are the value_and_grad's and the reference step's
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    params = lm_params_from_reference(jax.tree.map(np.asarray, got["values"]), got["pc"], device="cpu")
    _, state, m = M.make_train_step(got["pc"], PO.AdamWConfig(**opt))(params, PO.adamw_init(params),
                                                                      _torch_batch(batch))
    assert float(m["loss"]) == float(ploss) and float(m["grad_norm"]) == pgnorm
    assert np.float32(m["lr"].item()) == np.float32(RO.lr_schedule(RO.AdamWConfig(**opt), jnp.asarray(1)))
    assert int(state["step"]) == 1


def test_microbatches(reference):
    got = reference("qwen2-1.5b", "f32", "flash")
    batch = _batch(got["rc"], seed=8, batch=4)
    l1, g1 = M.make_value_and_grad(got["pc"])(got["params"], _torch_batch(batch))
    l2, g2 = M.make_value_and_grad(got["pc"], microbatches=2)(got["params"], _torch_batch(batch))
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))
    a, b = _leaves(g1), _leaves(g2)
    assert all(_rel_norm(b[k], a[k]) <= 1e-5 for k in a)
    # against the reference's own microbatched step
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rstep = RM.make_train_step(got["rc"], RO.AdamWConfig(**opt), microbatches=2)
    _, _, rm = rstep(got["values"], RO.adamw_init(got["values"]), {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_reference(jax.tree.map(np.asarray, got["values"]), got["pc"], device="cpu")
    _, _, pm = M.make_train_step(got["pc"], PO.AdamWConfig(**opt), microbatches=2)(
        params, PO.adamw_init(params), _torch_batch(batch))
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= STEP_LOSS_RTOL["f32"] * abs(float(rm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= STEP_GNORM_RTOL["f32"] * float(rm["grad_norm"])
    with pytest.raises(ValueError):
        M.make_value_and_grad(got["pc"], microbatches=3)(got["params"], _torch_batch(batch))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama-3.2-vision-11b"])
def test_remat_modes_give_the_same_gradients(reference, arch):
    got = reference(arch, "f32", "flash")
    batch = _torch_batch(_batch(got["rc"], seed=9))
    runs = {}
    for mode in ("none", "full", "dots"):
        loss, grads = M.make_value_and_grad(got["pc"].replace(remat=mode))(got["params"], batch)
        runs[mode] = (float(loss), _leaves(grads))
    for mode in ("full", "dots"):
        assert runs[mode][0] == runs["none"][0]
        assert all(np.array_equal(runs[mode][1][k], runs["none"][1][k]) for k in runs["none"][1]), mode
    with pytest.raises(ValueError):
        M.make_value_and_grad(got["pc"].replace(remat="some"))(got["params"], batch)


# --------------------------------------------------------------------------
# the flash backward's plain version
# --------------------------------------------------------------------------

# (B, H, KV, Sq, Sk, D, causal, window, dead keys at the head, dead keys at the tail, query offset)
FLASH_BWD = {
    "causal": (2, 6, 2, 40, 40, 16, True, None, 0, 0, 0),
    "window": (2, 6, 2, 40, 40, 16, True, 8, 0, 0, 0),
    "dead keys, Sq != Sk": (2, 4, 2, 30, 50, 8, True, None, 3, 5, 20),
    "rows without a live key": (1, 4, 2, 30, 50, 8, True, None, 6, 0, 0),
    "non-causal cross": (1, 8, 2, 24, 13, 12, False, None, 0, 0, 0),
}


def _flash_inputs(B_, H, KV, Sq, Sk, D, dead_head, dead_tail, off, seed=10):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in
               ((B_, H, Sq, D), (B_, KV, Sk, D), (B_, KV, Sk, D)))
    do = torch.as_tensor(rng.normal(size=(B_, H, Sq, D)).astype(np.float32))
    qpos = (torch.arange(Sq, dtype=torch.int32) + off).expand(B_, Sq).contiguous()
    kpos = torch.arange(Sk, dtype=torch.int32).expand(B_, Sk).clone()
    kpos[:, :dead_head] = -1
    kpos[:, Sk - dead_tail:] = -1
    return q, k, v, do, qpos, kpos


@pytest.mark.parametrize("case", FLASH_BWD, ids=list(FLASH_BWD))
def test_flash_backward_plain_against_autograd(case):
    B_, H, KV, Sq, Sk, D, causal, window, dead_head, dead_tail, off = FLASH_BWD[case]
    q, k, v, do, qpos, kpos = _flash_inputs(B_, H, KV, Sq, Sk, D, dead_head, dead_tail, off)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = PREF.gqa_flash_attention(*leaves, qpos, kpos, causal, window)
    o.backward(do)
    want = [t.grad for t in leaves]
    lse = PREF.gqa_flash_lse(q, k, qpos, kpos, causal, window)
    if case == "rows without a live key":
        assert bool(torch.isinf(lse).any())
    got = PREF.gqa_flash_attention_backward(q, k, v, o.detach(), lse, do, qpos, kpos, causal, window)
    for g, w in zip(got, want, strict=True):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    # the model-layout autograd Function over the wrappers' plain versions gives the same
    model = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    ops.FlashAttentionFn.apply(*model, qpos, kpos, causal, window).backward(do.transpose(1, 2))
    for t, w in zip(model, want, strict=True):
        assert float((t.grad.transpose(1, 2) - w).abs().max()) <= 1e-5 * float(w.abs().max())
    if causal:  # a causal mask off by one: each row sees one more key
        wrong = PREF.gqa_flash_attention_backward(q, k, v, o.detach(), lse, do, qpos + 1, kpos, causal, window)
        assert max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(wrong, want)) > 0.1


# --------------------------------------------------------------------------
# the CLI and the example
# --------------------------------------------------------------------------

def _train(out, *extra, sigterm_in_step=None):
    """The trainer CLI's ``main`` in this process on the CPU; returns its
    stdout.  With ``sigterm_in_step=n`` the process receives SIGTERM
    during the n-th step of the run, a preemption at a known step."""
    from repro_torch.launch import train as T

    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-every",
            "3", "--lr", "1e-3", *([] if out is None else ["--out", str(out)]), *extra]
    make, handler, stdout = M.make_train_step, signal.getsignal(signal.SIGTERM), io.StringIO()

    def make_preempted(*a, **kw):
        step, calls = make(*a, **kw), [0]

        def preempted(*args):
            calls[0] += 1
            if calls[0] == sigterm_in_step:
                signal.raise_signal(signal.SIGTERM)
            return step(*args)

        return preempted

    M.make_train_step = make_preempted
    try:
        with contextlib.redirect_stdout(stdout):
            assert T.main(argv) == 0
    finally:
        M.make_train_step = make
        signal.signal(signal.SIGTERM, handler)
    return stdout.getvalue()


def _metrics(out):
    with open(Path(out) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_resume_is_bit_for_bit(tmp_path):
    from repro_torch.checkpoint import latest_step

    a, b = tmp_path / "a", tmp_path / "b"
    assert "SIGTERM received" in _train(a, "--steps", "10", sigterm_in_step=6)
    assert latest_step(str(a / "ckpt")) == 6
    assert "restored step 6" in _train(a, "--steps", "10", "--resume", "auto")
    assert latest_step(str(a / "ckpt")) == 10
    _train(b, "--steps", "10")
    got, want = _metrics(a), _metrics(b)
    assert [r["step"] for r in got] == list(range(10))
    for key in ("loss", "grad_norm", "lr"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    assert want[-1]["loss"] < want[0]["loss"]


def test_train_cli_out_defaults_under_tmpdir(tmp_path, monkeypatch):
    """Without --out the run writes under the temporary directory (TMPDIR),
    and --resume auto there refuses another model's checkpoint."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert "done: 2 steps" in _train(None, "--steps", "2")
    assert [r["step"] for r in _metrics(tmp_path / "repro_torch_train")] == [0, 1]
    with pytest.raises(ValueError, match="another shape"):
        _train(None, "--arch", "qwen2-1.5b", "--steps", "3", "--resume", "auto")


def test_train_cli_refuses_model_parallel(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
                        "--model-parallel", "2", "--out", str(tmp_path)], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode != 0 and "one card" in r.stderr


def test_example_on_cpu():
    # one intra-op thread: beside busy test workers, one thread per CPU in the subprocess oversubscribes the machine
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_train_lm_with_curation.py"), "--device",
                          "cpu", "--steps", "60"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "curation:" in out.stdout and out.stdout.strip().splitlines()[-1] == "OK"


def test_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    from repro_torch.launch import train as train_cli

    with pytest.raises(RuntimeError, match="GPU"):
        M.init_params(C.get_smoke("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="GPU"):
        train_cli.main(["--smoke", "--steps", "1", "--out", str(tmp_path)])
