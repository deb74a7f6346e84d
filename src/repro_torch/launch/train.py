"""Training entry point: a zoo model of the dense, MoE, vision, ssm
(RWKV-6) or hybrid (zamba2) family.  The audio family (whisper) is
refused before anything is built: its batches need ``frames``, which the
token pipeline does not yield (the reference's CLI stops at its first
step with a ``KeyError`` there); train it through
``models.make_train_step`` with the frames in the batch.

The port's copy of the JAX package's ``launch/train.py``, with its flags
(and one more, ``--device``) and its ``metrics.jsonl`` records, on the
card by default (``--device cpu`` runs the plain versions on the CPU):

  * ``--resume auto`` restarts from the newest checkpoint; the token
    pipeline replays deterministically from the restored step, so a run
    stopped and resumed gives the loss stream of one that was not.
  * A non-blocking checkpoint every ``--ckpt-every`` steps, and a final
    one on SIGTERM (the preemption hook) after the step in flight.  The
    optimizer updates the params and moments in place, so the store
    copies them to the host before ``save`` returns, ahead of the next
    step.
  * The step watchdog logs a step past ``--step-timeout`` seconds as a
    straggler.
  * ``--out`` (checkpoints and ``metrics.jsonl``) defaults to
    ``repro_torch_train`` under the temporary directory (``TMPDIR``); a
    checkpoint of another model's shapes there is refused on resume.
  * ``--curate`` feeds per-sequence features through the port's
    ``StreamCurator`` and logs its cluster and drift reports at
    checkpoint boundaries.

The params are drawn from a seeded ``torch.Generator`` on the device.
One card, no mesh: ``--model-parallel`` other than 1 raises (ROADMAP,
multi-card training).  At S > 4096 every layer's attention runs the
flash kernels forward and the hand-written backward
(``kernels/ops.py::FlashAttentionFn``; the hybrid's shared block in each
of its applications).  RWKV-6 and the hybrid's Mamba-2 blocks run
chunked scans: their ``--seq`` must be at most 64 or a multiple of 64
(the reference's chunk rule), checked before anything is built.
zamba2-7b's f32 master, gradients and AdamW moments (~92 GB) outgrow one
80 GB card: there it trains at full width only with its layers cut
(``chip_smoke.py`` ``[hybrid]`` runs 15 of its 81 through
``make_train_step``); this CLI takes the published config or ``--smoke``.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 --batch 1 --seq 8192 --out runs/qwen2
  python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 20 --batch 4 --seq 2048 --out runs/rwkv6
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu --steps 10 --batch 2 \
      --seq 128 --out runs/rwkv6-smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b --smoke --device cpu --steps 10 --batch 2 \
      --seq 128 --out runs/zamba2-smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --device cpu \\
      --steps 30 --batch 8 --seq 64 --ckpt-every 10 --out runs/smoke
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile
import time

import numpy as np
import torch

from .. import configs as C
from ..checkpoint import CheckpointStore, latest_step
from ..data.curation import StreamCurator
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..models import model as M
from ..models.layers import check_length
from ..train.optim import AdamWConfig, adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--step-timeout", type=float, default=120.0)
    ap.add_argument("--curate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: the port trains on one card (ROADMAP queue 1, "
                         f"item 9: multi-card training)")
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if cfg.family == "audio":
        raise SystemExit(f"--arch {args.arch}: a batch of the audio family needs 'frames' (B, {cfg.n_frames}, "
                         f"{cfg.d_model}), which the token pipeline does not yield; train it through "
                         f"models.make_train_step with the frames in the batch")
    if cfg.family in ("ssm", "hybrid"):
        check_length(args.seq)  # the chunk rule, before anything is built
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    store = CheckpointStore(os.path.join(args.out, "ckpt"), keep=2)
    metrics_path = os.path.join(args.out, "metrics.jsonl")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 2), warmup_steps=min(10, args.steps // 5 + 1))

    values = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = adamw_init(values)
    step0 = 0
    if args.resume == "auto" and latest_step(store.path) is not None:
        step0, (values, opt_state) = store.restore(like=(values, opt_state))
        print(f"[resume] restored step {step0} from {store.path}", flush=True)
    train_step = M.make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed, start_step=step0)
    curator = (StreamCurator(dim=min(cfg.d_model, 32), compression=0.1, min_pts=5, device=dev)
               if args.curate else None)

    # preemption hook: checkpoint on SIGTERM, then exit cleanly
    state = {"step": step0, "values": values, "opt": opt_state, "stop": False}

    def _sigterm(signum, frame):
        state["stop"] = True

    signal.signal(signal.SIGTERM, _sigterm)

    t_train0 = time.time()
    tokens_done = 0
    with open(metrics_path, "a") as mf:
        for step in range(step0, args.steps):
            batch = next(pipe)
            tbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            t0 = time.time()
            state["values"], state["opt"], m = train_step(state["values"], state["opt"], tbatch)
            loss = float(m["loss"])  # sync point
            dt = time.time() - t0
            tokens_done += args.batch * args.seq
            state["step"] = step + 1
            if dt > args.step_timeout:
                print(f"[straggler] step {step} took {dt:.1f}s > {args.step_timeout}s", flush=True)
            rec = {
                "step": step,
                "loss": loss,
                "grad_norm": float(m["grad_norm"]),
                "lr": float(m["lr"]),
                "step_s": round(dt, 4),
                "tokens_per_s": round(tokens_done / (time.time() - t_train0), 1),
            }
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} gnorm {rec['grad_norm']:.3f} {rec['step_s']:.2f}s/step",
                      flush=True)
            if curator is not None:
                # curate on cheap per-sequence features (the leading token ids as a stand-in embedding for the
                # smoke path; a real run pools model activations)
                feats = batch["tokens"][:, : min(cfg.d_model, 32)].astype(np.float64)
                curator.observe_block([f"s{step}b{i}" for i in range(feats.shape[0])], feats)
            if (step + 1) % args.ckpt_every == 0 or state["stop"] or step == args.steps - 1:
                store.save(step + 1, (state["values"], state["opt"]), blocking=False)
                if curator is not None and curator.n_examples > 20:
                    rep = curator.curate(step=step + 1)
                    print(f"[curate] step {step + 1}: {rep.n_clusters} clusters over {rep.n_bubbles} bubbles, "
                          f"drift={rep.drift:.3f}" + (" DRIFTED" if rep.drifted else ""), flush=True)
            if state["stop"]:
                print("[preempt] SIGTERM received -> checkpointed, exiting", flush=True)
                break
    store.close()
    pipe.close()
    print(f"done: {state['step']} steps, checkpoints in {store.path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
